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
3. holds each kernel against its plain PyTorch version on the inputs the
   main path gave it (exact: the kernels move integers), and times kernel,
   plain version and the one PyTorch call that computes the same function
   where there is one;
4. profiles one join + groupby of workload A with torch.profiler (device
   time by kernel and by op, and the card's busy share);
5. prints the profile line, a JSON line of kernels, one JSON line per
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
REPS_E2E = 5   # timed runs of workload A (the first one is counted)

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
    """Mean device time of ``fn`` in ms, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
        from cylon_tpu_torch.ops import cuda_gather, cuda_radix
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

    cuda_radix.radix_pass = rec_pass
    cuda_gather.expand_rows = rec_expand

    def reset_counts():
        for d in (cuda_radix.LAUNCHES, cuda_gather.LAUNCHES):
            for k in d:
                d[k] = 0
        _radix.COUNTS["declined"] = 0

    def counts():
        return {**cuda_radix.LAUNCHES, **cuda_gather.LAUNCHES}

    def require_launches(c, what):
        for k, v in c.items():
            if v <= 0:
                fail(f"{what}: kernel {k} was not launched on the main path")

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
    require_launches(launches_a, "workload A")
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
    require_launches(launches_b, "workload B")
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
    cuda_radix.radix_pass, cuda_gather.expand_rows = orig_pass, orig_expand

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
    ]
    print(json.dumps({"argsort": argsort, "peak_bw_bytes_per_s": bw}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(work_a))
    print(json.dumps(work_b))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
