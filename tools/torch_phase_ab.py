#!/usr/bin/env python3
"""Times the calls of chip_smoke.py's workloads A and A4 (join ->
groupby), L and L4 (q3_lazy), U4, O and TOPO8_loc (its 4x2 join) alone,
untraced, for the cylon_tpu_torch package of a given checkout, on one
card, so that two checkouts can be compared call for call.

    python3 tools/torch_phase_ab.py --root .              # this checkout
    python3 tools/torch_phase_ab.py --root /path/to/other --label parent
    python3 tools/torch_phase_ab.py --root . --device cpu --rows 20000 --trace-functions
    python3 tools/torch_phase_ab.py --diff-functions a.jsonl b.jsonl

The tables are chip_smoke.py's (A's sides with seed 0, A's left side with
seed 1, 8M rows each; TOPO8_loc's locality keys at world 8), made by this
checkout's chip_smoke.py whatever ``--root`` is. Each call is timed as
chip_smoke.py times it (a warm-up, then ``--reps`` calls, each ended by a
synchronize, on the host's clock), and one more call runs under
torch.profiler for its kernels' device time. Run the checkouts one process
each and alternately (a, b, b, a) in one session. Prints one JSON line:
{"label", "root", "smi", "calls": {name: {"s_all", "s", "kernel_ms",
"wall_ms"}}}.

``--trace-functions`` adds "functions": every function of the package
that the calls enter (its file and qualified name) with a hash of its
source; ``--diff-functions`` reads two such lines and prints how many
functions either entered and which of them differ between the two (in
source, or entered by one only). ``--device cpu`` with a small ``--rows``
runs it without a card (no device times).
"""
import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FunctionTrace:
    """The package's functions entered while on: {"file:qualname": [source
    hash, ...]}."""

    def __init__(self, pkg_dir):
        self.pkg_dir, self.codes, self.on = pkg_dir, set(), False
        sys.setprofile(self._hook)

    def _hook(self, frame, event, arg):
        if self.on and event == "call" and frame.f_code.co_filename.startswith(self.pkg_dir):
            self.codes.add(frame.f_code)

    def result(self):
        out = {}  # lambdas and generator expressions share a qualified name
        for code in self.codes:
            try:
                src = "".join(inspect.getsourcelines(code)[0])
            except (OSError, TypeError):
                src = ""
            rel = os.path.relpath(code.co_filename, os.path.dirname(self.pkg_dir))
            out.setdefault(f"{rel}:{code.co_qualname}", []).append(
                hashlib.sha1(src.encode()).hexdigest()[:12])
        return {k: sorted(v) for k, v in out.items()}


def diff_functions(path_a, path_b) -> None:
    a, b = (json.loads(open(p).readline())["functions"] for p in (path_a, path_b))
    differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    print(json.dumps({"entered": [len(a), len(b)], "differ": differ}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="checkout whose cylon_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=0, help="rows a side in place of A's 8M")
    ap.add_argument("--trace-functions", action="store_true")
    ap.add_argument("--diff-functions", nargs=2, metavar="JSONL")
    args = ap.parse_args()
    if args.diff_functions:
        diff_functions(*args.diff_functions)
        return
    import torch

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        sys.exit("torch_phase_ab: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import cylon_tpu_torch as ctt
    from cylon_tpu_torch import _build, ordering
    from cylon_tpu_torch.ops.partition import hash_partition_ids

    if not os.path.abspath(ctt.__file__).startswith(root + os.sep):
        sys.exit(f"torch_phase_ab: imported {ctt.__file__}, not the package under {root}")
    smoke = load_smoke()
    if args.rows:
        smoke.N_A = args.rows
    smi = "cpu"
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        _build.build_all()
    dev = torch.device(args.device, 0) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    trace = FunctionTrace(os.path.join(root, "cylon_tpu_torch") + os.sep) \
        if args.trace_functions else None
    calls = {}

    def config(**kw):
        return ctt.GPUConfig(**kw) if on_card else ctt.GPUConfig(device="cpu", **kw)

    def measure(name, fn):
        if trace:
            trace.on = True
        fn()
        sync()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            r = fn()
            sync()
            times.append(time.perf_counter() - t0)
            del r
        if trace:
            trace.on = False
        prof = smoke.profile(fn, top=0) if on_card else {"kernel_ms": None, "wall_ms": None}
        calls[name] = {"s_all": times, "s": float(np.median(times)),
                       "kernel_ms": prof["kernel_ms"], "wall_ms": prof["wall_ms"]}

    left, right, _rng = smoke.make_a()
    left2 = smoke.make_left2()
    ctx = ctt.CylonContext.init_distributed(config())
    ctx4 = ctt.CylonContext.init_distributed(config(world_size=smoke.WORLD))

    # A and A4 (join -> groupby) and L and L4 (q3_lazy: the join -> sum of
    # v by k, the right key renamed rk), at worlds 1 and 4
    for tag, c in (("", ctx), ("4", ctx4)):
        ta, tb = ctt.Table.from_pydict(c, left), ctt.Table.from_pydict(c, right)

        def a_call(ta=ta, tb=tb):
            j = ta.distributed_join(tb, on="k", how="inner")
            return j, j.distributed_groupby("k_x", {"v": "sum", "w": "sum"})

        measure(f"A{tag} join_groupby", a_call)
        q3 = ta.lazy().join(tb.rename({"k": "rk"}).lazy(), left_on="k", right_on="rk")
        measure(f"L{tag} q3_lazy", q3.groupby("k", {"v": "sum"}).collect)
        del ta, tb, q3

    # U4 (chip_smoke.py's u4_calls)
    tl4, tl4b = ctt.Table.from_pydict(ctx4, left), ctt.Table.from_pydict(ctx4, left2)
    pl4, pl4b = tl4.project(["k"]), tl4b.project(["k"])
    for op, fn in (("union", lambda a, b: a.distributed_union(b)),
                   ("subtract", lambda a, b: a.distributed_subtract(b)),
                   ("intersect", lambda a, b: a.distributed_intersect(b))):
        measure(f"U4 {op}", lambda: fn(tl4, tl4b))
        measure(f"U4 {op}_k", lambda: fn(pl4, pl4b))
    measure("U4 unique_k", lambda: tl4.distributed_unique(["k"]))
    measure("U4 unique_last_k", lambda: tl4.distributed_unique(["k"], keep="last"))
    del pl4, pl4b, tl4b

    # O (chip_smoke.py's o_calls), each beside its call under ordering.disabled()
    tl, tl2 = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, left2)
    tr = ctt.Table.from_pydict(ctx, right)
    sl, sl2 = tl.sort("k"), tl2.sort("k")
    psl, psl2 = sl.project(["k"]), sl2.project(["k"])
    tr_sorted = tr.sort("k")
    s4_sorted = tl4.distributed_sort("k")
    o_calls = {
        "sort": lambda: sl.sort("k"),
        "sort_kv": lambda: sl.sort(["k", "v"]),
        "unique_k": lambda: sl.unique(["k"]),
        "unique_last_k": lambda: sl.unique(["k"], keep="last"),
        "union_k": lambda: psl.union(psl2),
        "subtract_k": lambda: psl.subtract(psl2),
        "intersect_k": lambda: psl.intersect(psl2),
        "groupby_sum": lambda: sl.groupby("k", {"v": "sum"}),
        "join_presorted": lambda: tl.join(tr_sorted, on="k"),
        "dist_sort_4": lambda: s4_sorted.distributed_sort("k"),
    }
    for op, fn in o_calls.items():
        measure(f"O {op}", fn)

        def plain(fn=fn):
            with ordering.disabled():
                return fn()
        measure(f"O {op} (ordering disabled)", plain)
    del sl, sl2, psl, psl2, tr_sorted, s4_sorted, tl, tl2, tr, tl4

    # TOPO8_loc's join at 4x2 (chip_smoke.py's locality_keys)
    world, inner = smoke.SKEW_WORLD, 2
    ctx8 = ctt.CylonContext.init_distributed(config(world_size=world, mesh_shape="4x2"))
    cand = np.arange(smoke.N_A, dtype=np.int32)
    pid = hash_partition_ids([(torch.from_numpy(cand).to(dev), None)], None, world).cpu().numpy()
    pools = [cand[(pid // inner) == g] for g in range(world // inner)]
    n_shard = smoke.N_A // world
    own = int(n_shard * 0.8)
    sides = []
    for seed in (0, 1):
        rng_t = np.random.default_rng(seed)
        keys = np.concatenate([np.concatenate([rng_t.choice(pools[p // inner], own),
                                               rng_t.choice(cand, n_shard - own)])
                               for p in range(world)]).astype(np.int32)
        sides.append((keys, rng_t.normal(size=smoke.N_A).astype(np.float32)))
    tt_l = ctt.Table.from_pydict(ctx8, {"k": sides[0][0], "v": sides[0][1]})
    tt_r = ctt.Table.from_pydict(ctx8, {"k": sides[1][0], "w": sides[1][1]})
    measure("TOPO8_loc 4x2 join", lambda: tt_l.distributed_join(tt_r, on="k"))

    line = {"label": args.label, "root": root, "smi": smi, "calls": calls}
    if trace:
        line["functions"] = trace.result()
    print(json.dumps(line))


if __name__ == "__main__":
    main()
