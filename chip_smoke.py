#!/usr/bin/env python3
"""Chip smoke test of cylon_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from cylon_tpu_torch/csrc (one nvcc per
   source, all at once);
2. drives the port's main path through its public entry points
   (Table.from_pydict -> distributed_join -> distributed_groupby ->
   to_pydict) on two workloads, each with the launch counters set to 0
   just before and read just after:
     A: 8,000,000 rows a side, int32 keys uniform in [0, 8M) (about one
        match per key), float32 payloads; inner join on k, then the sums of
        both payloads by k_x;
     B: 1,000,000 orders (int64 cust in [0, 50k), float64 price) joined to
        50,000 customers (int64 cust, string segment); sum of price by
        segment;
   and checks both against plain references (torch for A, numpy for B);
   then the same two at world_size=4 through the chunked hash shuffle
   (four shards round-robin over the visible cards, all on cuda:0 with
   one card):
     A4: workload A's data, once at the default 32 MiB shuffle budget
         (K = 1 round) and once at 4 MiB (K = 4), against A's reference;
     B4: workload B, whose groupby shuffles on the string segment;
3. holds each kernel against its plain PyTorch version on the inputs the
   main path gave it (exact: the kernels move integers), and times kernel,
   plain version and the one PyTorch call that computes the same function
   where there is one;
4. profiles one join + groupby of workloads A and A4 with torch.profiler
   (device time by kernel and by op, and the card's busy share);
5. prints the profile lines, a JSON line of kernels, one JSON line per
   workload, the card's name and power limit, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check, missing launch or exception exits nonzero without the
last line. Without a CUDA card, or without the cylon_tpu_torch package
beside this file, it exits nonzero at once.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_A = 8_000_000
N_ORDERS, N_CUST = 1_000_000, 50_000
REPS = 20      # launches per kernel timing
SPIN_CYCLES = 100_000_000  # about 60 ms of card time ahead of each timed run
REPS_E2E = 5   # timed runs of workload A (the first one is counted)
REPS_E2E_4 = 3  # timed runs of workload A4 per budget
WORLD = 4
BUDGET_SMALL = 4 * 1024 * 1024  # A4's multi-round run: bucket_cap 131072, K = 4

# peak memory bandwidth by card (NVIDIA data sheets); SXM5 H100 otherwise
_PEAK_BW = {"PCIe": 2.0e12, "NVL": 3.9e12, "H200": 4.8e12}
_H100_SXM_BW = 3.35e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def peak_bandwidth(name: str) -> float:
    for tag, bw in _PEAK_BW.items():
        if tag in name:
            return bw
    return _H100_SXM_BW


def cuda_ms(fn, reps=REPS) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events, after a warm-up.
    A spin kernel holds the card while the host enqueues all ``reps`` calls,
    so the events time the calls back to back on the device and not the
    rate at which Python issues them (a kernel of a few tens of us runs
    faster than its wrapper launches it). A call that synchronizes inside
    is timed with its host time all the same."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(fn, top=12) -> dict:
    """torch.profiler over one call of ``fn``: the device kernels and the
    aten ops with the most device time, and the device's busy share of the
    wall time (kernel time only, so ops are not counted twice)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else getattr(e, "self_cuda_time_total", 0)) / 1e3

    rows = sorted(prof.key_averages(), key=dev_ms, reverse=True)
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in rows if e.device_type != torch.autograd.DeviceType.CUDA and dev_ms(e) > 0]
    busy_ms = sum(dev_ms(e) for e in kernels)
    return {
        "wall_ms": wall_ms, "kernel_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "top_kernels": [{"name": e.key[:100], "calls": e.count, "device_ms": dev_ms(e)}
                        for e in kernels[:top]],
        "top_ops": [{"name": e.key, "calls": e.count, "device_ms": dev_ms(e),
                     "cpu_ms": e.self_cpu_time_total / 1e3} for e in ops[:top]],
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import cylon_tpu_torch as ctt
        from cylon_tpu_torch import _build
        from cylon_tpu_torch.ops import cuda_codec, cuda_gather, cuda_radix
        from cylon_tpu_torch.parallel import shuffle as _sh
        from cylon_tpu_torch.ops import radix as _radix
        from cylon_tpu_torch.ops.sort import orderable_key
    except ImportError as e:
        print(f"chip_smoke: cylon_tpu_torch not found beside this script: {e}", file=sys.stderr)
        sys.exit(3)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw = peak_bandwidth(kind)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0

    # record the largest input each kernel wrapper sees on the main path
    seen = {}
    orig_pass, orig_expand = cuda_radix.radix_pass, cuda_gather.expand_rows

    def rec_pass(enc, perm, shift, bits):
        key = f"radix_{enc.element_size() * 8}"
        if key not in seen or perm.shape[0] > seen[key][1].shape[0]:
            seen[key] = (enc, perm, shift, bits)
        return orig_pass(enc, perm, shift, bits)

    def rec_expand(srcT, li):
        size = li.numel() * srcT.shape[0]
        if "expand" not in seen or size > seen["expand"][1].numel() * seen["expand"][0].shape[0]:
            seen["expand"] = (srcT, li)
        return orig_expand(srcT, li)

    orig_hist, orig_dest = cuda_codec.pack_hist, cuda_codec.pack_dest
    orig_move, orig_plan = cuda_codec.compact_move, _sh.plan_rounds
    plans = []  # (bucket_cap, n_rounds) of every shuffle of a run

    def rec_hist(words, valids, has_valid, n, P, pid=None):
        key = "hist_64" if seen.get("key64_next") else "hist"
        if pid is None and (key not in seen or words.shape[1] > seen[key][0].shape[1]):
            seen[key] = (words, valids, has_valid, n, P)
        return orig_hist(words, valids, has_valid, n, P, pid)

    def rec_dest(lane, base, round_idx, P, bc):
        if "dest" not in seen or lane.shape[0] >= seen["dest"][0].shape[0]:
            seen["dest"] = (lane, base, round_idx, P, bc)
        return orig_dest(lane, base, round_idx, P, bc)

    def rec_move(move, recv, P, bc, n_header=0):
        if "move" not in seen or move.numel() >= seen["move"][0].numel():
            seen["move"] = (move, recv, P, bc, n_header)
        return orig_move(move, recv, P, bc, n_header)

    def rec_plan(*args, **kw):
        plans.append(orig_plan(*args, **kw))
        return plans[-1]

    cuda_radix.radix_pass = rec_pass
    cuda_gather.expand_rows = rec_expand
    cuda_codec.pack_hist, cuda_codec.pack_dest = rec_hist, rec_dest
    cuda_codec.compact_move, _sh.plan_rounds = rec_move, rec_plan

    def reset_counts():
        for d in (cuda_radix.LAUNCHES, cuda_gather.LAUNCHES, cuda_codec.LAUNCHES):
            for k in d:
                d[k] = 0
        _radix.COUNTS["declined"] = 0
        plans.clear()

    def counts():
        return {**cuda_radix.LAUNCHES, **cuda_gather.LAUNCHES, **cuda_codec.LAUNCHES}

    def require_launches(c, what, names):
        for k in names:
            if c[k] <= 0:
                fail(f"{what}: kernel {k} was not launched on the main path")

    def on_card(captured):
        """The captured inputs on card 0, where the holds and the timings
        run (with several cards a shard's inputs may live on another)."""
        return {k: tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in v)
                if isinstance(v, tuple) else v for k, v in captured.items()}

    local_kernels = list(cuda_radix.LAUNCHES) + list(cuda_gather.LAUNCHES)
    all_kernels = local_kernels + list(cuda_codec.LAUNCHES)

    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig())
    if ctx.device.type != "cuda":
        fail(f"GPUConfig() resolved to {ctx.device}")

    # ------------------------------------------------------------------
    # workload A
    # ------------------------------------------------------------------
    rng = np.random.default_rng(SEED)
    left = {"k": rng.integers(0, N_A, N_A).astype(np.int32),
            "v": rng.normal(size=N_A).astype(np.float32)}
    right = {"k": rng.integers(0, N_A, N_A).astype(np.int32),
             "w": rng.normal(size=N_A).astype(np.float32)}
    tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)

    def run_a():
        j = tl.distributed_join(tr, on="k", how="inner")
        torch.cuda.synchronize()
        t_join = time.perf_counter()
        g = j.distributed_groupby("k_x", {"v": "sum", "w": "sum"})
        torch.cuda.synchronize()
        return j, g, t_join

    run_a()  # warm-up: loads the libraries, fills the caching allocator
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    j, g, t_join = run_a()
    t_end = time.perf_counter()
    launches_a = counts()
    declined_a = _radix.COUNTS["declined"]
    join_times, gb_times = [t_join - t0], [t_end - t_join]
    for _ in range(REPS_E2E - 1):
        t0 = time.perf_counter()
        _j, _g, t_join = run_a()
        join_times.append(t_join - t0)
        gb_times.append(time.perf_counter() - t_join)
        del _j, _g
    require_launches(launches_a, "workload A", local_kernels)
    if declined_a != 0:
        fail(f"workload A: {declined_a} sorts declined the radix engine")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # launches of the join alone (for the per-op split)
    reset_counts()
    j2 = tl.distributed_join(tr, on="k", how="inner")
    torch.cuda.synchronize()
    launches_join = counts()
    del j2
    t0_host = time.perf_counter()
    g_host = g.to_pydict()
    to_host_s = time.perf_counter() - t0_host

    # plain reference of the same join -> groupby, from the raw key counts
    kl = torch.from_numpy(left["k"]).to(dev).long()
    kr = torch.from_numpy(right["k"]).to(dev).long()
    vl = torch.from_numpy(left["v"]).to(dev)
    wr = torch.from_numpy(right["w"]).to(dev)
    cl, cr = torch.bincount(kl, minlength=N_A), torch.bincount(kr, minlength=N_A)
    sv = torch.zeros(N_A, dtype=torch.float64, device=dev).index_add_(0, kl, vl.double())
    sw = torch.zeros(N_A, dtype=torch.float64, device=dev).index_add_(0, kr, wr.double())
    keys = torch.nonzero((cl > 0) & (cr > 0)).squeeze(1)
    n_join = int((cl * cr).sum())
    if j.row_count != n_join:
        fail(f"workload A: join rows {j.row_count} != {n_join}")
    # left-order emit: left row i appears cr[k_i] times, in left row order
    rep = cr[kl]
    if not torch.equal(j.column("k_x").data.long(), torch.repeat_interleave(kl, rep)):
        fail("workload A: join k_x differs from the left-order reference")
    if not torch.equal(j.column("v").data, torch.repeat_interleave(vl, rep)):
        fail("workload A: join v differs from the left-order reference")
    if not torch.equal(j.column("k_y").data.long(), j.column("k_x").data.long()):
        fail("workload A: join k_y != k_x")
    if g.row_count != keys.numel() or not torch.equal(g.column("k_x").data.long(), keys):
        fail("workload A: group keys differ from the reference")
    # float32 sums of 1-10 terms against float64 references: atol 1e-4, rtol 1e-5
    for col, ref in (("v_sum", sv[keys] * cr[keys]), ("w_sum", cl[keys] * sw[keys])):
        got = g.column(col).data.double()
        err = (got - ref).abs()
        if not bool((err <= 1e-4 + 1e-5 * ref.abs()).all()):
            fail(f"workload A: {col} max abs err {float(err.max())}")
    if len(g_host["k_x"]) != keys.numel():
        fail("workload A: to_pydict row count")
    join_s, gb_s = float(np.median(join_times)), float(np.median(gb_times))
    work_a = {
        "workload": "A", "rows_per_side": N_A, "join_rows": n_join, "groups": g.row_count,
        "join_s": join_s, "groupby_s": gb_s, "join_s_all": join_times,
        "groupby_s_all": gb_times, "to_host_s": to_host_s,
        "input_rows_per_s": 2 * N_A / (join_s + gb_s),
        "launches": launches_a, "launches_join": launches_join,
        "launches_groupby": {k: launches_a[k] - launches_join[k] for k in launches_a},
        "radix_declined": declined_a, "peak_mem_gb": peak_gb, "build_s": build_s,
    }
    captured_a = dict(seen)
    del j, g, g_host
    print(json.dumps({"profile": profile(run_a)}))

    # ------------------------------------------------------------------
    # workload B
    # ------------------------------------------------------------------
    orders = {"cust": rng.integers(0, N_CUST, N_ORDERS),
              "price": rng.gamma(2.0, 50.0, N_ORDERS)}
    customers = {"cust": np.arange(N_CUST),
                 "segment": rng.choice(["consumer", "corporate", "home"], N_CUST)}

    def run_b():
        to, tc = ctt.Table.from_pydict(ctx, orders), ctt.Table.from_pydict(ctx, customers)
        jb = to.distributed_join(tc, on="cust", how="inner")
        return jb, jb.distributed_groupby("segment", {"price": "sum"}).to_pydict()

    run_b()
    seen.clear()
    reset_counts()
    t0 = time.perf_counter()
    jb, gb_host = run_b()
    b_s = time.perf_counter() - t0
    launches_b = counts()
    require_launches(launches_b, "workload B", local_kernels)
    # plain reference: every order meets its one customer (cust is a key)
    seg_names, seg_code = np.unique(customers["segment"], return_inverse=True)
    want = np.bincount(seg_code[orders["cust"]], weights=orders["price"],
                       minlength=len(seg_names))
    if jb.row_count != N_ORDERS or list(gb_host["segment"]) != list(seg_names):
        fail("workload B: join rows or segments differ from the reference")
    # float64 sums of ~330k terms in another order: rtol 1e-9
    if not np.allclose(np.asarray(gb_host["price_sum"], np.float64), want, rtol=1e-9, atol=0):
        fail("workload B: price sums differ from the reference")
    work_b = {"workload": "B", "orders": N_ORDERS, "customers": N_CUST,
              "end_to_end_s": b_s, "launches": launches_b,
              "radix_declined": _radix.COUNTS["declined"]}
    captured_b = dict(seen)
    del jb

    # ------------------------------------------------------------------
    # workload A4: A's data at world 4 through the hash shuffle
    # ------------------------------------------------------------------
    ctx4 = ctt.CylonContext.init_distributed(ctt.GPUConfig(world_size=WORLD))
    placement = [str(d) for d in ctx4.devices]
    print(json.dumps({"world": WORLD, "shard_devices": placement}))
    tl4, tr4 = ctt.Table.from_pydict(ctx4, left), ctt.Table.from_pydict(ctx4, right)
    a_sums = (("v_sum", sv[keys] * cr[keys]), ("w_sum", cl[keys] * sw[keys]))
    k_x_sum = int((kl * cr[kl]).sum())

    def run_a4():
        j = tl4.distributed_join(tr4, on="k", how="inner")
        torch.cuda.synchronize()
        t_join = time.perf_counter()
        g = j.distributed_groupby("k_x", {"v": "sum", "w": "sum"})
        torch.cuda.synchronize()
        return j, g, t_join

    def check_a4(j, g, what):
        if j.row_count != n_join:
            fail(f"{what}: join rows {j.row_count} != {n_join}")
        jk = j.column("k_x").data.long()
        if int(jk.sum()) != k_x_sum or not torch.equal(jk, j.column("k_y").data.long()):
            fail(f"{what}: join keys differ from the reference")
        gk = g.column("k_x").data.long()
        order = torch.argsort(gk)
        if g.row_count != keys.numel() or not torch.equal(gk[order], keys):
            fail(f"{what}: group keys differ from the reference (as a set)")
        for col, ref in a_sums:  # the tolerance of workload A
            err = (g.column(col).data.double()[order] - ref).abs()
            if not bool((err <= 1e-4 + 1e-5 * ref.abs()).all()):
                fail(f"{what}: {col} max abs err {float(err.max())}")

    def measure_a4(what):
        run_a4()  # warm-up at this budget
        reset_counts()
        t0 = time.perf_counter()
        j, g, t_join = run_a4()
        t_end = time.perf_counter()
        launches, plan = counts(), list(plans)
        require_launches(launches, what, all_kernels)
        check_a4(j, g, what)
        join_t, gb_t = [t_join - t0], [t_end - t_join]
        for _ in range(REPS_E2E_4 - 1):
            t0 = time.perf_counter()
            _j4, _g4, t_join = run_a4()
            join_t.append(t_join - t0)
            gb_t.append(time.perf_counter() - t_join)
            del _j4, _g4
        js, gs = float(np.median(join_t)), float(np.median(gb_t))
        return {
            "workload": what, "world": WORLD, "shard_devices": placement,
            "budget_bytes": ctx4.shuffle_byte_budget, "join_rows": j.row_count,
            "groups": g.row_count, "join_shard_rows": j.row_counts.tolist(),
            "join_s": js, "groupby_s": gs, "join_s_all": join_t, "groupby_s_all": gb_t,
            "input_rows_per_s": 2 * N_A / (js + gs), "launches": launches,
            # (bucket_cap, rounds): left and right join shuffles, then the groupby's
            "shuffle_plans": plan,
        }

    work_a4 = measure_a4("A4")
    if work_a4["shuffle_plans"][:2] != [(524288, 1), (524288, 1)]:
        fail(f"A4: join shuffle plans {work_a4['shuffle_plans'][:2]} != bucket_cap 524288, K = 1")
    seen.clear()
    ctx4.add_config("shuffle_byte_budget", BUDGET_SMALL)
    work_a4k = measure_a4("A4_K4")
    if work_a4k["shuffle_plans"][:2] != [(131072, 4), (131072, 4)]:
        fail(f"A4_K4: join shuffle plans {work_a4k['shuffle_plans'][:2]} != bucket_cap 131072, K = 4")
    captured_a4 = on_card(seen)
    print(json.dumps({"profile_a4_k4": profile(run_a4)}))
    ctx4.add_config("shuffle_byte_budget", "")
    del tl4, tr4

    # ------------------------------------------------------------------
    # workload B4: B at world 4 (the groupby shuffles on a string key)
    # ------------------------------------------------------------------
    def run_b4():
        to, tc = ctt.Table.from_pydict(ctx4, orders), ctt.Table.from_pydict(ctx4, customers)
        jb4 = to.distributed_join(tc, on="cust", how="inner")
        return jb4, jb4.distributed_groupby("segment", {"price": "sum"})

    run_b4()
    seen.clear()
    seen["key64_next"] = True  # the join shuffles hash int64 keys
    reset_counts()
    t0 = time.perf_counter()
    jb4, gb4 = run_b4()
    gb4_host = gb4.to_pydict()
    b4_s = time.perf_counter() - t0
    launches_b4, plans_b4 = counts(), list(plans)
    require_launches(launches_b4, "workload B4", all_kernels)
    order = np.argsort(np.asarray(gb4_host["segment"], dtype=str))
    if jb4.row_count != N_ORDERS or [gb4_host["segment"][i] for i in order] != list(seg_names):
        fail("workload B4: join rows or segments differ from the reference")
    if not np.allclose(np.asarray(gb4_host["price_sum"], np.float64)[order], want, rtol=1e-9, atol=0):
        fail("workload B4: price sums differ from the reference")
    work_b4 = {"workload": "B4", "world": WORLD, "orders": N_ORDERS, "customers": N_CUST,
               "end_to_end_s": b4_s, "launches": launches_b4, "shuffle_plans": plans_b4,
               "group_shard_rows": gb4.row_counts.tolist()}
    captured_b4 = on_card(seen)
    del jb4, gb4
    cuda_radix.radix_pass, cuda_gather.expand_rows = orig_pass, orig_expand
    cuda_codec.pack_hist, cuda_codec.pack_dest = orig_hist, orig_dest
    cuda_codec.compact_move, _sh.plan_rounds = orig_move, orig_plan

    # ------------------------------------------------------------------
    # each kernel against its plain version, at the main path's shapes
    # ------------------------------------------------------------------
    def max_err(a, b):
        if a.shape != b.shape:
            fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    enc, perm, shift, bits = captured_a["radix_32"]
    n, nt = perm.shape[0], cuda_radix.n_tiles(perm.shape[0])
    hist = cuda_radix.radix_hist(enc, perm, shift, bits)
    offs = cuda_radix.scan_offsets(hist)
    out = cuda_radix.radix_scatter(enc, perm, offs, shift, bits)
    torch.cuda.synchronize()
    err_h = max_err(hist, cuda_radix.radix_hist_plain(enc, perm, shift, bits))
    err_s = max(max_err(out, cuda_radix.radix_scatter_plain(enc, perm, offs, shift, bits)),
                max_err(out, cuda_radix.radix_pass_plain(enc, perm, shift, bits)))
    wide = captured_b.get("radix_64")
    if wide is None:
        fail("workload B made no 64-bit radix pass")
    e64, p64, s64, b64 = wide
    h64 = cuda_radix.radix_hist(e64, p64, s64, b64)
    o64 = cuda_radix.radix_scatter(e64, p64, cuda_radix.scan_offsets(h64), s64, b64)
    torch.cuda.synchronize()
    err_h = max(err_h, max_err(h64, cuda_radix.radix_hist_plain(e64, p64, s64, b64)))
    err_s = max(err_s, max_err(o64, cuda_radix.radix_pass_plain(e64, p64, s64, b64)))
    srcT, li = captured_a["expand"]
    xk = cuda_gather.expand_rows(srcT, li)
    torch.cuda.synchronize()
    err_x = max_err(xk, cuda_gather.expand_rows_plain(srcT, li))
    if err_h or err_s or err_x:
        fail(f"kernel mismatch: hist {err_h}, scatter {err_s}, expand {err_x}")

    # B2a (hash mode at A4's main-path shape, a 64-bit key from B4, and
    # pid-input mode), B2b (A4 K = 4's largest round) and B3 (its largest
    # received buffer)
    words, valids, hv, n_h, P = captured_a4["hist"]
    lane, hist = cuda_codec.pack_hist(words, valids, hv, n_h, P)
    torch.cuda.synchronize()
    lane_p, hist_p = cuda_codec.pack_hist_plain(words, valids, hv, n_h, P)
    err_ph = max(max_err(lane, lane_p), max_err(hist, hist_p))
    for args in (captured_b4["hist_64"], (None, None, (), n_h, P, lane)):
        got = cuda_codec.pack_hist(*args)  # a 64-bit key; pid-input mode
        torch.cuda.synchronize()
        want_h = cuda_codec.pack_hist_plain(*args)
        err_ph = max(err_ph, max_err(got[0], want_h[0]), max_err(got[1], want_h[1]))
    d_lane, d_base, d_r, d_P, d_bc = captured_a4["dest"]
    dest = cuda_codec.pack_dest(d_lane, d_base, d_r, d_P, d_bc)
    torch.cuda.synchronize()
    err_pd = max_err(dest, cuda_codec.pack_dest_plain(d_lane, d_base, d_r, d_P, d_bc))
    fd, fc = cuda_codec.fused_pack_dest(words, valids, hv, n_h, d_r, P, d_bc)
    fd_p, fc_p = cuda_codec.fused_pack_dest_plain(words, valids, hv, n_h, d_r, P, d_bc)
    err_pd = max(err_pd, max_err(fd, fd_p), max_err(fc, fc_p))
    move, recv, m_P, m_bc, m_nh = captured_a4["move"]
    moved = cuda_codec.compact_move(move, recv, m_P, m_bc, m_nh)
    torch.cuda.synchronize()
    err_cm = max_err(moved, cuda_codec.compact_move_plain(move, recv, m_P, m_bc, m_nh))
    if err_ph or err_pd or err_cm:
        fail(f"kernel mismatch: pack_hist {err_ph}, pack_dest {err_pd}, compact_move {err_cm}")

    esz = enc.element_size()
    ms_h = cuda_ms(lambda: cuda_radix.radix_hist(enc, perm, shift, bits))
    ms_hp = cuda_ms(lambda: cuda_radix.radix_hist_plain(enc, perm, shift, bits))
    ms_s = cuda_ms(lambda: cuda_radix.radix_scatter(enc, perm, offs, shift, bits))
    ms_sp = cuda_ms(lambda: cuda_radix.radix_scatter_plain(enc, perm, offs, shift, bits))
    L, cap = srcT.shape
    n_out = li.numel()
    ms_x = cuda_ms(lambda: cuda_gather.expand_rows(srcT, li))
    ms_xp = cuda_ms(lambda: cuda_gather.expand_rows_plain(srcT, li))
    ms_xl = cuda_ms(lambda: torch.index_select(srcT, 1, li))
    cap_h, nt_h = words.shape[1], cuda_codec.n_tiles(words.shape[1])
    ms_ph = cuda_ms(lambda: cuda_codec.pack_hist(words, valids, hv, n_h, P))
    ms_php = cuda_ms(lambda: cuda_codec.pack_hist_plain(words, valids, hv, n_h, P))
    cap_d, nt_d = d_lane.shape[0], cuda_codec.n_tiles(d_lane.shape[0])
    ms_pd = cuda_ms(lambda: cuda_codec.pack_dest(d_lane, d_base, d_r, d_P, d_bc))
    ms_pdp = cuda_ms(lambda: cuda_codec.pack_dest_plain(d_lane, d_base, d_r, d_P, d_bc))
    lm = move.shape[1]
    ms_cm = cuda_ms(lambda: cuda_codec.compact_move(move, recv, m_P, m_bc, m_nh))
    ms_cmp = cuda_ms(lambda: cuda_codec.compact_move_plain(move, recv, m_P, m_bc, m_nh))
    data_rows = move.view(m_P, m_bc + m_nh, lm)[:, m_nh:].reshape(m_P * m_bc, lm)
    live_mask, _total = _sh.received_row_mask(recv.clamp(0, m_bc), m_P, m_bc)
    ms_chain = cuda_ms(lambda: data_rows[torch.argsort(~live_mask, stable=True)])
    bytes_ph = 4 * cap_h * (words.shape[0] + (0 if valids is None else valids.shape[0]) + 1) \
        + 4 * P * nt_h
    bytes_pd = 4 * cap_d * 2 + 4 * d_P * nt_d
    bytes_cm = 4 * move.numel() + 4 * m_P * m_bc * lm
    touched = int(li.max()) + 1 if n_out else 0
    bytes_h = 4 * n + esz * n + 4 * 256 * nt
    bytes_s = 4 * n + esz * n + 4 * 256 * nt + 4 * n
    bytes_x = 4 * L * touched + 4 * n_out + 4 * L * n_out
    # a whole stable argsort of workload A's right keys: 4 K1 passes vs torch.sort
    kr32 = torch.from_numpy(right["k"]).to(dev)
    lane = orderable_key(kr32)
    radix_perm = _radix.argsort_perm(lane)
    torch_perm = torch.sort(kr32, stable=True).indices
    if not torch.equal(radix_perm.long(), torch_perm):
        fail("radix argsort differs from torch.sort(stable=True)")
    argsort = {
        "n": N_A, "passes": 4,
        "radix_ms": cuda_ms(lambda: _radix.argsort_perm(lane)),
        "torch_sort_stable_ms": cuda_ms(lambda: torch.sort(kr32, stable=True)),
        "bound_ms": (4 * N_A + 4 * N_A) / bw * 1e3,  # read the keys, write the perm
    }

    src_radix = "cylon_tpu_torch/csrc/radix_pass.cu"
    src_codec = "cylon_tpu_torch/csrc/shuffle_codec.cu"
    kernels = [
        {"name": "radix_hist", "route": "cuda", "source": src_radix,
         "replaces": "cylon_tpu/ops/pallas_radix.py:86",
         "launches": launches_a["radix_hist"], "max_abs_err": err_h,
         "ms": ms_h, "plain_ms": ms_hp, "bound_ms": bytes_h / bw * 1e3,
         "bound_by": "bytes", "library_ms": None, "shape": [n, esz * 8]},
        {"name": "radix_scatter", "route": "cuda", "source": src_radix,
         "replaces": "cylon_tpu/ops/pallas_radix.py:93",
         "launches": launches_a["radix_scatter"], "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": ms_sp, "bound_ms": bytes_s / bw * 1e3,
         "bound_by": "bytes", "library_ms": None, "shape": [n, esz * 8]},
        {"name": "expand_rows", "route": "cuda", "source": "cylon_tpu_torch/csrc/expand_rows.cu",
         "replaces": "cylon_tpu/ops/pallas_gather.py:52",
         "launches": launches_a["expand_rows"], "max_abs_err": err_x,
         "ms": ms_x, "plain_ms": ms_xp, "bound_ms": bytes_x / bw * 1e3,
         "bound_by": "bytes", "library_ms": ms_xl, "shape": [L, cap, n_out]},
        {"name": "shuffle_pack_hist", "route": "cuda", "source": src_codec,
         "replaces": "cylon_tpu/ops/pallas_codec.py:344",
         "launches": work_a4["launches"]["pack_hist"], "max_abs_err": err_ph,
         "ms": ms_ph, "plain_ms": ms_php, "bound_ms": bytes_ph / bw * 1e3,
         "bound_by": "bytes", "library_ms": None,
         "shape": [cap_h, len(hv), P], "launches_a4_k4": work_a4k["launches"]["pack_hist"]},
        {"name": "shuffle_pack_dest", "route": "cuda", "source": src_codec,
         "replaces": "cylon_tpu/ops/pallas_codec.py:344",
         "launches": work_a4["launches"]["pack_dest"], "max_abs_err": err_pd,
         "ms": ms_pd, "plain_ms": ms_pdp, "bound_ms": bytes_pd / bw * 1e3,
         "bound_by": "bytes", "library_ms": None,
         "shape": [cap_d, d_P, d_bc], "launches_a4_k4": work_a4k["launches"]["pack_dest"]},
        {"name": "shuffle_compact_move", "route": "cuda", "source": src_codec,
         "replaces": "cylon_tpu/ops/pallas_codec.py:508",
         "launches": work_a4["launches"]["compact_move"], "max_abs_err": err_cm,
         "ms": ms_cm, "plain_ms": ms_cmp, "bound_ms": bytes_cm / bw * 1e3,
         "bound_by": "bytes", "library_ms": None, "argsort_gather_ms": ms_chain,
         "shape": [m_P, m_bc, lm], "launches_a4_k4": work_a4k["launches"]["compact_move"]},
    ]
    print(json.dumps({"argsort": argsort, "peak_bw_bytes_per_s": bw}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(work_a))
    print(json.dumps(work_b))
    print(json.dumps(work_a4))
    print(json.dumps(work_a4k))
    print(json.dumps(work_b4))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
