#!/usr/bin/env python3
"""Times chip_smoke.py's MP4 calls S4 (distributed_sort), A4 (join ->
groupby) and U4's unique(k) across gloo ranks of one process a shard, for
the cylon_tpu_torch package of a given checkout, so that two checkouts can
be compared call for call on one card.

    python3 tools/torch_mp_ab.py --root .                     # this checkout
    python3 tools/torch_mp_ab.py --root /path/to/other --label parent
    python3 tools/torch_mp_ab.py --root . --device cpu --rows 100000

Starts ``--procs`` rank processes of this script (gloo over
tcp://localhost, every rank on cuda:0, or on the CPU with ``--device
cpu``); each builds A's sides (seed 0, ``--rows`` a side, 8M by default)
at world ``--procs``, warms each call twice, then times ``--reps`` calls,
each between two barriers, on its own clock. Rank 0 prints one JSON line:
{"label", "root", "smi", "ms": {call: median}, "ms_all": {call: [...]}}.
Run the checkouts one process group each and alternately in one session.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np


def rank_main(args) -> None:
    import torch

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import cylon_tpu_torch as ctt

    if not os.path.abspath(ctt.__file__).startswith(root + os.sep):
        sys.exit(f"torch_mp_ab: imported {ctt.__file__}, not the package under {root}")
    torch.set_num_threads(max(1, (os.cpu_count() or args.procs) // args.procs))
    on_card = args.device != "cpu"
    if on_card:
        from cylon_tpu_torch import _build

        _build.build_all()
    env = ctt.CylonEnv(config=ctt.GPUConfig(
        device="cuda:0" if on_card else "cpu", coordinator_address=args.address,
        num_processes=args.procs, process_id=args.rank, backend="gloo"))
    ctx = env.context
    rng = np.random.default_rng(0)
    n = args.rows
    left = {"k": rng.integers(0, n, n).astype(np.int32), "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int32), "w": rng.normal(size=n).astype(np.float32)}
    tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
    calls = {
        "S4": lambda: tl.distributed_sort("k"),
        "A4": lambda: tl.distributed_join(tr, on="k", how="inner").distributed_groupby(
            "k_x", {"v": "sum", "w": "sum"}),
        "U4 unique_k": lambda: tl.project(["k"]).distributed_unique(["k"]),
    }
    ms_all = {}
    for name, call in calls.items():
        call()
        call()
        times = []
        for _ in range(args.reps):
            ctx.barrier()
            t0 = time.perf_counter()
            call()
            ctx.barrier()
            times.append((time.perf_counter() - t0) * 1e3)
        ms_all[name] = times
    if args.rank == 0:
        smi = "cpu"
        if on_card:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip()
        print(json.dumps({"label": args.label, "root": root, "smi": smi,
                          "ms": {k: float(np.median(v)) for k, v in ms_all.items()},
                          "ms_all": ms_all}), flush=True)
    ctx.finalize()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout whose cylon_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--rows", type=int, default=8_000_000, help="rows a side")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = [sys.executable, os.path.abspath(__file__), "--root", args.root, "--label", args.label,
            "--procs", str(args.procs), "--rows", str(args.rows), "--reps", str(args.reps),
            "--device", args.device, "--address", f"tcp://localhost:{port}"]
    procs = [subprocess.Popen(base + ["--rank", str(r)]) for r in range(args.procs)]
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if codes != [0] * args.procs:
        sys.exit(f"torch_mp_ab: ranks exited {codes}")


if __name__ == "__main__":
    main()
