#!/usr/bin/env python3
"""Chip smoke test of cylon_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py           # every phase, on one card
    python3 chip_smoke.py --mp4     # phase MP4 alone (NCCL where there are four cards)

1. builds the port's CUDA kernels from cylon_tpu_torch/csrc (one nvcc per
   source, all at once);
2. drives the port's main path through its public entry points on these
   workloads, each with the launch counters set to 0 just before and read
   just after:
     A: 8,000,000 rows a side, int32 keys uniform in [0, 8M) (about one
        match per key), float32 payloads; Table.from_pydict ->
        distributed_join -> distributed_groupby (the sums of both payloads
        by k_x) -> to_pydict;
     B: 1,000,000 orders (int64 cust in [0, 50k), float64 price) joined to
        50,000 customers (int64 cust, string segment), the flow of
        examples/join_groupby.py: CylonEnv, DataFrame.merge(on="cust"),
        groupby("segment").agg({"price": "sum"}), the median of 3 calls
        after a warm-up;
   checked against plain references (torch for A, numpy for B); then the
   same two at world_size=4 through the chunked hash shuffle (four shards
   round-robin over the visible cards, all on cuda:0 with one card):
     A4: workload A's data, once at the default 32 MiB shuffle budget
         (K = 1 round) and once at 4 MiB (K = 4), against A's reference;
     B4: workload B, whose groupby shuffles on the string segment;
   then the PK-FK join (kernel B5), on benchmarks/pallas_bench.py's data
   at workload A's scale:
     PK: 8,000,000 unique int32 right keys permutation(16M)[:8M], 8M left
         keys drawn from them, float32 payloads v and w;
         distributed_join(on="k", algorithm="pallas_pk") ->
         distributed_groupby("k_x", {"v": "sum", "w": "sum"}), with no
         speculation miss, against the sort join on the same tables (join
         rows as a multiset, exactly) and a plain float64 reference (sums);
     PK4: PK's data at world_size=4;
     and a small right side with one duplicate key, which must fall back
     to the sort join exactly once and equal it;
   then the sort and the set operations of benchmarks/run_bench.py
   (configs 3 and 4) on its make_tables at A's scale (left: A's left
   side; left2: the same with seed 1):
     S: left.distributed_sort("k") at world 1, against numpy's stable
        argsort, row for row;
     S4: the same at world_size=4 through the range shuffle (kernel B2a in
         pid mode), at the default budget and at 4 MiB (several rounds):
         shards in global order, shard rows equal to numpy's float64 range
         bins, the rows a multiset of the input;
     U: union, subtract and intersect of left and left2, the same three on
        project(["k"]), and unique(["k"]) keeping the first and the last,
        at world 1, against numpy in first-occurrence order;
     U4: their distributed forms at world_size=4: each shard's rows, as a
         multiset, the plain result's rows of that shard's murmur3
         partition;
     O: the order-descriptor fast paths over sorted input: sort (elided,
        and on a sorted prefix), unique, the key-only set ops, groupby and
        a join whose right side is sorted, at world 1 over left, left2 and
        A's right side sorted by k, and distributed_sort of S4's output;
        each op the median of 3 calls beside the same call under
        ordering.disabled(), whose rows it must equal in order;
   then the DataFrame surface of the reference's op benchmarks
   (python/examples/op_benchmark) on A's left side widened to 8M rows of
   k, v (10% null by an explicit mask), w, g = k % 65536 and s (64
   names):
     F: filter v > 0.5, x = v * 2.0 + w, isnull, fillna(0.0), dropna,
        isin of 1024 values, astype, sort_values(["g", "k"]),
        drop_duplicates(["g"]) keeping the first and the last, a groupby
        on g of v's var, std, nunique and median and s's nunique, and
        set_index("k") with loc of 1024 labels, a loc slice and an iloc
        slice, each timed alone and gated against numpy (in row order;
        var and std within rtol 1e-6 of numpy's float64);
     F4: the same frame at world_size=4, the sort, dedup and groupby
         through env= (distributed_sort, distributed_unique, the raw-row
         distributed_groupby), each shard against the plain result's
         partition;
   then the lazy query planner (ROADMAP A4) on A's tables, the right
   side's key renamed rk, at world 1 (L) and at world_size=4 at the
   default 32 MiB budget (L4), each query the median of 3 calls after a
   warm-up, gated against the plain reference A's eager join -> groupby is
   held to (group keys exactly, sums and means within A's tolerance), its
   rules and order fast paths required to fire and its warm collects to
   hit the plan cache:
     q3_lazy: left.lazy().join(right.lazy(), left_on="k", right_on="rk")
              .groupby("k", {"v": "sum"}).collect(), the fused join-sum
              (benchmarks/run_bench.py's q3_lazy);
     plan_filter: the same with .filter(col("w") > 0.0) after the join
              (benchmarks/plan_bench.py's query), pushed below it;
     q3_ordered: distributed_join(on="k", emit_order="key") ->
              distributed_groupby("k_x", {"v": "sum"}) (run_bench.py's
              q3_ordered), the groupby run-detecting;
     q3_ordered_lazy: the lazy q3 with {"v": ["sum", "mean"]}, where
              order_reuse turns the join into the key-order emit;
   then the shuffle tiers the reference runs by default (ROADMAP A6's first
   slice: the semi-join sketch filter and lane packing), each beside the
   same call with the tier off and required to give the same rows:
     SEMI4: benchmarks/semi_filter_bench.make_pair at 8M rows a side (int32
            key uniform in a window of 2M, three float32 payloads; seed 7,
            as run_bench.py's config 1b) at world 4, joined on k at
            selectivity 0.10 (the gate must apply the filter to both
            sides) and 1.00 (it must skip it), beside sketch.disabled():
            rows pruned, bucket_cap and rounds, shipped bytes (rounds x
            W^2 x bucket_cap x row bytes, plus the sketches), ms;
     PACK: lane_pack_bench.make_sort_table at 8M rows (keys of about 12,
           16 and 20 bits): sort(["a", "b", "c"]) on one fused uint64 word
           beside stats.disabled()'s three lanes, K1a and K1b launches, ms;
     PACK4: lane_pack_bench.make_join_pair at 8M rows a side, world 4: the
            join on (k1, k2) (fused factorize lanes, wire-narrowed rows),
            then the groupby sum, beside stats.disabled(): wire row bytes,
            rounds, ms;
   every world-4 workload line says which gates fired (``tiers``: the
   semi filter, the wire narrowing, the fusions, the sketch bytes);
   then the skew split and the spill tiers (ROADMAP A7's first slice),
   each beside the same call with the split off or at tier 0:
     SKEW8_shuffle: benchmarks/spill_bench.py's bench_skew at 8M rows (k
            int32 all zero, v float32 = arange) shuffled on k at world 8
            (at W = 4 a bucket can reach at most 4x the mean, and the
            static 4x trigger never fires), beside
            ``spill.skew_disabled()``: shipped bytes (rounds plus the
            relay's rows), rounds, relay rows, ms; the shipped bytes must
            fall by at least 40% and every shard hold the same rows;
     SKEW8_join: an inner join at world 8 of 8M left rows, half of them on
            the key of A's right row 0 and the rest uniform, with A's
            right side: the same numbers, the rows of the reference count,
            equal as row multisets a shard;
     FB: the feedback re-coster (plan/feedback.py) at world 8: an 8M-row
            lazy join with 30% of the left rows on one key, under an
            observation directory and the profiler, repeated until its
            decisions settle (the skew trigger must flip to 2, one new
            executor a flip, the rows' digest equal to the NO_AUTOTUNE
            run's every time), beside that oracle: each run's decisions,
            shipped bytes and ms;
     SERVE: q3_lazy over A's sides for eight bindings, serially and from
            eight threads through ``collect_async`` into the context's
            scheduler: every threaded result bit-equal to its serial one,
            no shed, no batch fallen back, no failed query, at least one
            stacked batch; the executions run, shed and backpressure
            counters, the SLO states, latency and queries/s, launches;
     SPILL4: spill_bench.py's bench_tier1_join at A4_K4's scale: A4's join
            at the 4 MiB budget forced through tiers 1 and 2
            (``CYLON_TPU_TORCH_SPILL_TIER``, the spill dir under a
            temporary directory) beside tier 0: ms, staged rounds and
            bytes, the peak gauge, ``torch.cuda.max_memory_allocated`` of
            the join and of its left side's shuffle; equal shard for
            shard, and tier 1's gauge and measured shuffle peak below tier
            0's;
   then the two-hop topology exchange (ROADMAP A6 topo), each call
   beside the same call under ``topo.disabled()`` on the same context:
     TOPO8_loc: tools/topo_smoke.py's locality shards at 8M rows a side
            (80% of each shard's int32 keys hash to its own outer group,
            by the port's murmur3 partition ids over arange(8M); float32
            payloads; seeds 0 and 1) at world 8, declared 4x2 and 2x4:
            shuffle(["k"]), distributed_join on k and the q3 join ->
            groupby sum: ms, the per-axis bytes
            (``shuffle.coll_bytes.{intra,inter,inter_alt}``), exchanged
            bytes, rounds and cap_o; the rows equal the flat call's as
            multisets a shard (the q3 sums within A's tolerance), and the
            cross-outer bytes at most 0.75 of the flat exchange's;
     TOPO8_ring: SKEW8_shuffle's one-hot table at 4x2 and 2x4: the
            same-group relay tail on the device ring (``ring_rows``), the
            rest through the host relay, beside the flat split plan; the
            ring must engage and the rows equal the flat split's;
     FUSED4_2x2: A4's join with mode="fused" on a 2x2 mesh (the
            structured two-hop), equal shard for shard to the flat fused
            join;
   then the out-of-core layers (ROADMAP A7's second slice):
     OOC: benchmarks/run_bench.py's config 5 (ooc_join_16chunks) at
          workload A's scale: 8M rows a side (seed 2, int32 k uniform in
          [0, 8M), float32 v and w), 16 host chunks of 500,000 a side and
          16 buckets, through OutOfCoreJoin at world 1, beside the
          in-memory distributed_join of the same host arrays: ms,
          cost_split, max_device_cap and join_phase_device_cap,
          torch.cuda.max_memory_allocated of both calls (the bounded device
          memory is the result, time its cost); sink.rows equal and the
          rows equal as a multiset;
     OOC4: the same at world 4 (32 MiB budget), at the default tier and
          at CYLON_TPU_TORCH_SPILL_TIER=2 under a temporary directory;
     TASK4: A's left side at world 4 in T = 12 tasks (task_partition,
          examples/task_parallel.py's 3x over-decomposition) beside
          shuffle(["k"]): each task's rows on its owner alone, all of them
          the input's;
     DAG4: DisJoinOp over A's tables in 8 chunks a side beside
          distributed_join, DisUnionOp over U's project(["k"]) sides in 8
          chunks beside distributed_union: the same rows as multisets a
          shard;
   then the torch.distributed backend, one process per shard:
     MP4: four processes of this script (``--mp4-worker``), each one rank
          of ``GPUConfig(coordinator_address=..., num_processes=4)``: gloo
          with every rank on cuda:0, or NCCL with rank r on cuda:r where
          there are four cards. Each makes A4's, S4's, U4's and PK4's
          data from the same seeds, stages only its own block (the tiers
          on, every rank required to take one process's gates), and runs
          distributed_join -> distributed_groupby, distributed_sort("k"),
          distributed_union and distributed_unique(["k"]), the pallas_pk
          join -> groupby, and L4's lazy q3 (every rank optimizes the same
          plan), then A4 and S4 again on the same ranks declared as a
          2x2 mesh (the grouped exchanges on the whole process group), then the small
          task_partition and OutOfCoreJoin cases of
          tests/_torch_mp_worker.py (each rank's ingest sinks, bucket
          plan and result rows its own); it reports a sha256 of each output
          column of its shard, its kernel launches and the median of 3
          barrier-synchronised calls on rank 0's clock. Rank d's digests
          must equal those of shard d of the same calls at world_size=4
          in this process, in row order (float sums, which the card adds
          in no fixed order, within workload A's tolerance);
     MP2x2: several shards a process: two gloo processes of this script,
          each ``GPUConfig(devices=["cuda:0", "cuda:0"],
          coordinator_address=..., num_processes=2)``, rank p owning
          shards 2p and 2p + 1, run MP4's A4, S4, U4, PK4 and L4 calls and
          A4 and S4 on the 2x2 mesh (an inner group inside one process,
          both outer groups across the two) on MP4's data; each shard's
          digests equal the same shard at world_size=4 in this process;
     OBS: A's join -> groupby and L's q3_lazy untraced and under
          ``obs.trace.query_trace`` with the profiler on (the traced
          outputs bit-equal, the host_sync counts and the card's own
          synchronizing calls equal), then
          ``explain(analyze=True)`` of q3_lazy; it prints the span tree's
          size, each span's and profiled stage's device ms from its CUDA
          events beside the call's torch.profiler device time, both
          calls' ms, and loads the Chrome export back;
3. holds each kernel against its plain PyTorch version on the inputs the
   main path gave it (exact: the kernels move integers; the compact B3
   also on B4's largest received buffer whose rows are not a multiple of
   16 bytes; B2a in pid mode, B2b and B3 also on S4's range shuffle; B2a
   in pid mode also on SEMI4's filtered pid lane with its pruned rows at P;
   B2b and B3 also on SKEW8_shuffle's cold-bucket round; B3 on both parts
   of TOPO8_loc's and TOPO8_ring's two-hop rounds, the same-group rows
   [inner x bucket_cap] and the combined chunks [outer x (cap_o + 1)];
   K1 also on PACK's fused uint64 word), and
   times kernel, plain version and the one PyTorch call that computes the
   same function where there is one, beside each kernel's ptxas registers
   and spills;
4. profiles one join + groupby of workloads A, A4_K4, PK and PK4, one
   distributed_sort of S4, one union of U and of U4, F's groupby and L's
   q3_lazy with
   torch.profiler (device time by kernel and by op, and the card's busy
   share);
5. prints the profile lines, a JSON line of kernels, one JSON line per
   workload (MP4's beside A4, S4, U4 and PK4 of the same run), the card's
   name and power limit, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check, missing launch or exception exits nonzero without the
last line. Without a CUDA card, or without the cylon_tpu_torch package
beside this file, it exits nonzero at once.
"""
import contextlib
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
N_A = 8_000_000
N_ORDERS, N_CUST = 1_000_000, 50_000
REPS = 20      # launches per kernel timing
SPIN_CYCLES = 100_000_000  # about 60 ms of card time ahead of each timed run
REPS_E2E = 5   # timed runs of workload A (the first one is counted)
REPS_E2E_4 = 3  # timed runs of workload A4 per budget
REPS_OPS = 3   # timed runs of each sort and set operation (S, S4, U, U4)
REPS_B = 3     # timed runs of workload B (the first one is counted), after a warm-up
REPS_L = 3     # timed runs of each lazy-planner query (L, L4), after a warm-up
WORLD = 4
BUDGET_SMALL = 4 * 1024 * 1024  # A4's multi-round run: bucket_cap 131072, K = 4

N_DUP = 100_000  # rows a side of the duplicate-key fallback check
N_ISIN = 1024  # values of F's isin and labels of its loc list
F_GROUPS = 65536  # F's g = k % F_GROUPS
F_NAMES = np.array([f"name{i:02d}" for i in range(64)])  # F's string column, sorted
MP4_LIMIT_S = 420  # wall-clock limit of the four MP4 processes
N_CAPI = 1_000_000  # rows a side of the C ABI client's CSVs (workload CAPI)
N_SEMI = 8_000_000  # rows a side of SEMI4 (run_bench.py config 1b's make_pair)
N_PACK = 8_000_000  # rows of PACK and a side of PACK4 (lane_pack_bench's tables)
REPS_T = 3  # timed calls of each SEMI4, PACK and PACK4 variant, after a warm-up
#: the counter families of the shuffle tiers (the semi filter, lane packing)
TIER_PREFIXES = ("shuffle.semi_filter.", "semi_filter.", "lane_pack.", "shuffle.quant.")
REPS_MP4 = 3  # barrier-synchronised timed calls of each MP4 op
N_SKEW = 8_000_000  # rows of SKEW8_shuffle (spill_bench.py's bench_skew)
OOC_CHUNK = N_A // 16  # run_bench.py config 5: 16 chunks a side ...
OOC_BUCKETS = 16  # ... and 16 buckets
REPS_OOC = 2  # timed calls of OOC and OOC4 after a warm-up (tier 2: one)
DAG_CHUNKS = 8  # chunks a side of DAG4's graphs
SKEW_WORLD = 8  # at W = 4 a hot bucket can reach only 4x the mean: the 4x trigger never fires
#: FB: the share of the left rows on one key (the right side's keys are a
#: permutation). At world 8 its bucket holds 1 + 7 x 0.3 = 3.1x the mean,
#: which the static 4x trigger ignores, and the hot shard receives
#: (0.3 + 0.7 / 8 + 1 / 8) / (2 / 8) = 2.05x the mean rows: the straggler
#: ratio the re-coster asks for (2.0)
FB_HOT = 0.3
FB_MAX_RUNS = 12  # collects of FB until its decisions settle
REPS_FB = 3  # timed collects of FB before (NO_AUTOTUNE) and after the flip
SERVE_THREADS = 8  # SERVE's submitting threads, one binding each
REPS_SERVE = 3  # timed rounds of SERVE, serial and threaded, after a warm-up
SERVE_INFLIGHT = 32 << 30  # SERVE's admission budget: eight A-sized queries fit
#: STREAM: benchmarks/stream_bench.py's shape at A's scale: 8M appendable
#: left rows (k in [0, 512)), a static right side of rows // 32, 1% appends
N_STREAM = N_A
STREAM_KEYS = 512
STREAM_SEED = 11
STREAM_DELTA = N_STREAM // 100
STREAM_ROUNDS = 5  # measured rounds of STREAM_q3 at each world, after the warm-up
STREAM_JOIN_ROUNDS = 4  # STREAM_join's rounds, appends to the left and right in turn

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


#: the CUDA runtime calls that hold the host until the card catches up
SYNC_APIS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
             "cudaMemcpy")


def sync_census(fn) -> dict:
    """The card's synchronizing calls in one call of ``fn``, counted
    directly, not through the engine's own ``host_sync`` counter: the
    warnings of torch's sync debug mode (a blocking device-to-host copy,
    ``.item()``, ``.cpu()``, ``nonzero``) and the CUDA runtime's
    synchronize and blocking-copy calls in a torch.profiler trace (which
    also sees ``torch.cuda.synchronize`` and ``Event.synchronize``)."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages() if e.key in SYNC_APIS}
    # the mode's own one-time notice ("... prototype feature ...") is no sync
    return {"debug_mode_warnings": sum("called a synchronizing CUDA operation" in str(w.message)
                                       for w in caught),
            "runtime_calls": calls}


def make_a():
    """Workload A's sides (seed SEED), and the generator, which workload B
    draws on from."""
    rng = np.random.default_rng(SEED)
    left = {"k": rng.integers(0, N_A, N_A).astype(np.int32),
            "v": rng.normal(size=N_A).astype(np.float32)}
    right = {"k": rng.integers(0, N_A, N_A).astype(np.int32),
             "w": rng.normal(size=N_A).astype(np.float32)}
    return left, right, rng


def make_left2():
    """run_bench.py's second table: A's left side with seed 1."""
    rng2 = np.random.default_rng(1)
    return {"k": rng2.integers(0, N_A, N_A).astype(np.int32),
            "v": rng2.normal(size=N_A).astype(np.float32)}


def make_ooc():
    """run_bench.py config 5's sides (seed 2) at workload A's scale: int32 k
    uniform in [0, N_A), float32 v and w."""
    rng5 = np.random.default_rng(2)
    lk = rng5.integers(0, N_A, N_A).astype(np.int32)
    lv = rng5.normal(size=N_A).astype(np.float32)
    rk = rng5.integers(0, N_A, N_A).astype(np.int32)
    rv = rng5.normal(size=N_A).astype(np.float32)
    return {"k": lk, "v": lv}, {"k": rk, "w": rv}


def make_pk():
    """Workload PK's sides: unique right keys, left keys drawn from them."""
    rng_pk = np.random.default_rng(SEED)
    r_key = rng_pk.permutation(np.arange(2 * N_A, dtype=np.int32))[:N_A]  # unique PK
    l_key = rng_pk.choice(r_key, size=N_A, replace=True)  # FK, every row hits
    pk_left = {"k": l_key, "v": rng_pk.normal(size=N_A).astype(np.float32)}
    pk_right = {"k": r_key, "w": rng_pk.normal(size=N_A).astype(np.float32)}
    return pk_left, pk_right


def make_f():
    """Workload F's frame: A's left side (k, v; seed SEED) widened to the op
    benchmarks' shape: v with 10% of rows null by an explicit mask, w
    uniform float32, g = k % 65536, s one of 64 names (dictionary codes);
    and the values of the isin and loc calls, all from the seed."""
    left, _right, _rng = make_a()
    rng = np.random.default_rng(SEED + 8)
    n = len(left["k"])
    return {
        "k": left["k"], "v": left["v"], "valid": rng.random(n) >= 0.1,
        "w": rng.random(n).astype(np.float32), "g": (left["k"] % F_GROUPS).astype(np.int32),
        "s": rng.integers(0, len(F_NAMES), n).astype(np.int32), "names": F_NAMES,
        "isin": rng.choice(N_A, N_ISIN, replace=False).astype(np.int32),
        "labels": rng.integers(0, N_A, N_ISIN).astype(np.int32),  # about a third missing
        # at 8M rows: loc[1_000_000:1_000_999] and iloc[1_000_000:2_000_000]
        "loc_range": (n // 8, n // 8 + 999), "iloc_range": (n // 8, n // 4),
    }


def mp4_calls(ctt, ctx, ctx22, io_dir):
    """Phase MP4's calls on a world-4 context, each returning its output
    tables: A4 (join -> groupby), S4 (distributed_sort), U4 (union and
    unique on k) and PK4 (the PK join -> groupby), on the data of those
    workloads; then A4 and S4 again on ``ctx22``, the same shards
    declared as a 2x2 mesh (the two-hop exchange: the grouped exchanges
    and the ring's ``ppermute`` routed through the whole process group).
    Every rank passes
    the same host data and stages its own block. IO4_rank reads A's left
    side from the four files under ``io_dir`` (:func:`write_mp4_inputs`),
    each rank only its own shard's (the others' paths name no file), and
    writes its shard's file (:func:`io_rank_call`)."""
    left, right, _rng = make_a()
    tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
    t22_l, t22_r = ctt.Table.from_pydict(ctx22, left), ctt.Table.from_pydict(ctx22, right)
    tl2 = ctt.Table.from_pydict(ctx, make_left2())
    pk_left, pk_right = make_pk()
    pl, pr = ctt.Table.from_pydict(ctx, pk_left), ctt.Table.from_pydict(ctx, pk_right)
    sums = {"v": "sum", "w": "sum"}
    q3 = tl.lazy().join(tr.rename({"k": "rk"}).lazy(), left_on="k", right_on="rk")

    def a4_on(left_t, right_t):
        j = left_t.distributed_join(right_t, on="k", how="inner")
        return {"join": j, "groupby": j.distributed_groupby("k_x", sums)}

    def a4():
        return a4_on(tl, tr)

    def pk4():
        j = pl.distributed_join(pr, on="k", how="inner", algorithm="pallas_pk")
        return {"join": j, "groupby": j.distributed_groupby("k_x", sums)}

    return {
        "A4": a4,
        "S4": lambda: {"sort": tl.distributed_sort("k")},
        "U4": lambda: {"union": tl.distributed_union(tl2), "unique": tl.distributed_unique(["k"])},
        "PK4": pk4,
        # workload L4's lazy q3: every rank optimizes the same plan
        "L4": lambda: {"q3_lazy": q3.groupby("k", {"v": "sum"}).collect()},
        "A4_2x2": lambda: a4_on(t22_l, t22_r),
        "S4_2x2": lambda: {"sort": t22_l.distributed_sort("k")},
        **small_out_of_core_calls(ctt, ctx),
        "IO4_rank": lambda: io_rank_call(ctt, ctx, io_dir),
    }


def mp4_io_paths(io_dir, sub, world=WORLD):
    return [os.path.join(io_dir, sub, f"part{s}.csv") for s in range(world)]


def write_mp4_inputs(ctt, ctx4, io_dir):
    """IO4_rank's input: A's left side at world 4, one CSV file a shard,
    written by this one process."""
    left, _right, _rng = make_a()
    os.makedirs(os.path.join(io_dir, "in"), exist_ok=True)
    ctt.write_csv(ctt.Table.from_pydict(ctx4, left), mp4_io_paths(io_dir, "in"))


def io_rank_call(ctt, ctx, io_dir):
    """Per-rank I/O: read_csv of the world's input files, where another
    process's shard names a file that does not exist (so a rank reads only
    its own), then write_csv one file a shard (a rank writes only its own,
    under ``out_mp``; one process under ``out_1p``), then a groupby on k."""
    local = ctx.local_shards
    paths = [p if s in local else os.path.join(io_dir, "absent", f"part{s}.csv")
             for s, p in enumerate(mp4_io_paths(io_dir, "in", ctx.world_size))]
    t = ctt.read_csv(ctx, paths)
    sub = "out_mp" if len(local) < ctx.world_size else "out_1p"
    os.makedirs(os.path.join(io_dir, sub), exist_ok=True)
    ctt.write_csv(t, mp4_io_paths(io_dir, sub, ctx.world_size))
    return {"read": t, "groupby": t.distributed_groupby("k", {"v": "sum"})}


def small_out_of_core_calls(ctt, ctx):
    """MP4's small out-of-core cases (those of tests/_torch_mp_worker.py's
    case_out_of_core): task_partition of 900 rows into T = 3W tasks, and
    OutOfCoreJoin in 4 buckets of 3000 x 1500 rows in chunks of 500, its
    rows a shard each as one table (``Table.from_shards``)."""
    from cylon_tpu_torch.parallel import LogicalTaskPlan
    from cylon_tpu_torch.parallel.ooc import OutOfCoreJoin

    world = ctx.world_size
    rng = np.random.default_rng(22)
    t = ctt.Table.from_pydict(ctx, {"k": rng.integers(0, 300, 900), "v": rng.normal(size=900)})
    cols = {"k": rng.integers(0, 4000, 4500).astype(np.int32), "v": rng.normal(size=4500)}

    def chunks(lo, hi):
        for a in range(lo, hi, 500):
            yield {c: v[a:a + 500] for c, v in cols.items()}

    def ooc():
        job = OutOfCoreJoin(ctx, on="k", num_buckets=4)
        sink = job.execute(chunks(0, 3000), chunks(3000, 4500))
        out = ctt.Table.from_shards(ctx, [
            sink.result_pydict(shard=s) if s in ctx.local_shards else None for s in range(world)])
        sink.close()
        return {"ooc": out}

    return {
        "TASK4_small": lambda: {f"task{i}": p for i, p in t.task_partition(
            ["k"], LogicalTaskPlan(3 * world, world)).items()},
        "OOC4_small": ooc,
    }


#: the kernels each MP4 call launches on every rank
MP4_KERNELS = {
    "A4": ("radix_lane_hist", "radix_onesweep", "expand_rows", "pack_hist", "pack_dest",
           "compact_move"),
    "S4": ("radix_lane_hist", "radix_onesweep", "pack_hist", "pack_dest", "compact_move"),
    "U4": ("radix_lane_hist", "radix_onesweep", "pack_hist", "pack_dest", "compact_move"),
    "PK4": ("radix_lane_hist", "radix_onesweep", "pk_probe", "pack_hist", "pack_dest",
            "compact_move"),
    "L4": ("radix_lane_hist", "radix_onesweep", "pack_hist", "pack_dest", "compact_move"),
    "A4_2x2": ("radix_lane_hist", "radix_onesweep", "expand_rows", "pack_hist", "pack_dest",
               "compact_move"),
    "S4_2x2": ("radix_lane_hist", "radix_onesweep", "pack_hist", "pack_dest", "compact_move"),
    "TASK4_small": ("radix_lane_hist", "radix_onesweep", "pack_hist", "pack_dest", "compact_move"),
    "OOC4_small": ("radix_lane_hist", "radix_onesweep", "expand_rows", "pack_hist", "pack_dest",
                   "compact_move"),
    "IO4_rank": ("radix_lane_hist", "radix_onesweep", "pack_hist", "pack_dest", "compact_move"),
}


def _wire_row_bytes(st) -> int:
    """The exchange row bytes a planned shuffle ships: narrowed or plain."""
    from cylon_tpu_torch.ops.gather import wire_row_bytes

    return wire_row_bytes(st["wire"]) if st["wire"] is not None else st["row_bytes"]


def tier_counts(tracing) -> dict:
    """{counter: [count, rows]} of the shuffle tiers' counters so far."""
    out = {}
    for prefix in TIER_PREFIXES:
        for k, v in tracing.report(prefix).items():
            out[k] = [int(v["count"]), int(v.get("rows", 0))]
    return out


def tier_delta(after: dict, before: dict) -> dict:
    """The tier counters a call added: which gates fired, the rows pruned,
    the sketch bytes and the bytes the wire narrowing saved."""
    out = {}
    for k, (c, r) in after.items():
        c0, r0 = before.get(k, (0, 0))
        if c != c0:
            out[k] = [c - c0, r - r0]
    return out


def make_semi(sel: float):
    """SEMI4's sides, benchmarks/semi_filter_bench.make_pair's shape at
    N_SEMI rows a side (seed 7, as run_bench.py's config 1b): left keys
    U[0, K), right keys U[(1 - sel) K, (2 - sel) K), K = n / 4, so about
    ``sel`` of each side's rows have a partner; three float32 payloads a
    side."""
    rng = np.random.default_rng(7)
    n, K = N_SEMI, N_SEMI // 4
    shift = int((1.0 - sel) * K)

    def cols(lo, hi, prefix):
        out = {"k": rng.integers(lo, hi, n).astype(np.int32)}
        for i in range(3):
            out[f"{prefix}{i}"] = rng.normal(size=n).astype(np.float32)
        return out

    return cols(0, K, "v"), cols(shift, shift + K, "w")


def make_pack():
    """benchmarks/lane_pack_bench.py's make_sort_table (PACK) and
    make_join_pair (PACK4) at N_PACK rows, seed 0: keys of about 12, 16 and
    20 bits, float32 payloads."""
    rng = np.random.default_rng(SEED)
    n = N_PACK
    sort_t = {"a": rng.integers(0, 4000, n).astype(np.int32),
              "b": rng.integers(0, 60000, n).astype(np.int32),
              "c": rng.integers(0, 1000000, n).astype(np.int32),
              "v": rng.normal(size=n).astype(np.float32)}

    def side(vname):
        return {"k1": rng.integers(0, 4000, n).astype(np.int32),
                "k2": rng.integers(0, 60000, n).astype(np.int32),
                vname: rng.normal(size=n).astype(np.float32)}

    return sort_t, side("v"), side("w")


def shard_digests(outputs, s):
    """{table: {column: sha256 of shard s's data (and validity) bytes}},
    and shard s's float sum columns, which the card adds in no fixed
    order, as host arrays."""
    digests, sums = {}, {}
    for name, t in outputs.items():
        digests[name] = {}
        for c in t.column_names:
            col = t._shards[s][c]
            data = col.data.cpu().numpy()
            if c.endswith("_sum") and data.dtype.kind == "f":
                sums[f"{name}.{c}"] = data
                continue
            h = hashlib.sha256(data.tobytes())
            if col.valid is not None:
                h.update(col.valid.cpu().numpy().tobytes())
            digests[name][c] = h.hexdigest()
    return digests, sums


def mp4_worker(rank: int, world: int, address: str, backend: str, out_dir: str,
               io_dir: str, per: int = 1, ops: str = "") -> None:
    """One MP4 rank: its shards of every MP4 call (``ops``: the calls named
    there, comma-separated), digests, launches and times into
    ``out_dir``. ``world`` is the number of processes; with ``per`` > 1
    the rank owns ``per`` shards on its one card (MP2x2), shards
    ``[rank * per, (rank + 1) * per)``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cylon_tpu_torch as ctt
    from cylon_tpu_torch.ops import cuda_codec, cuda_gather, cuda_probe, cuda_radix, pk_join
    from cylon_tpu_torch.utils import tracing

    torch.set_num_threads(max(1, (os.cpu_count() or WORLD) // WORLD))  # the host's cores, shared
    device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    where = dict(devices=[device] * per) if per > 1 else dict(device=device)
    env = ctt.CylonEnv(config=ctt.GPUConfig(
        coordinator_address=address, num_processes=world, process_id=rank,
        backend=backend, **where,
    ))
    ctx = env.context
    # the same ranks as a 2x2 mesh, on the same process group
    ctx22 = ctt.CylonContext.init_distributed(ctt.GPUConfig(
        coordinator_address=address, num_processes=world, process_id=rank,
        backend=backend, mesh_shape="2x2", **where,
    ))
    counters = (cuda_radix.LAUNCHES, cuda_gather.LAUNCHES, cuda_codec.LAUNCHES, cuda_probe.LAUNCHES)
    result = {"rank": env.rank, "device": device, "backend": backend,
              "shards": list(ctx.local_shards), "ops": {}}
    calls = mp4_calls(ctt, ctx, ctx22, io_dir)
    if ops:
        calls = {op: calls[op] for op in ops.split(",")}
    for op, call in calls.items():
        for d in counters:
            for k in d:
                d[k] = 0
        pk_join.COUNTS["fallback"] = 0
        before = tier_counts(tracing)
        call()  # the first call: its launches and tier gates
        tiers = tier_delta(tier_counts(tracing), before)
        launches = {k: v for d in counters for k, v in d.items()}
        times = []
        for _ in range(REPS_MP4):
            ctx.barrier()
            t0 = time.perf_counter()
            out = call()
            ctx.barrier()
            times.append(time.perf_counter() - t0)
        digests = {}
        for s in ctx.local_shards:
            digests[s], sums = shard_digests(out, s)
            for key, arr in sums.items():
                np.save(os.path.join(out_dir, f"shard{s}.{op}.{key}.npy"), arr)
        result["ops"][op] = {
            "digests": {str(s): d for s, d in digests.items()}, "launches": launches,
            "fallbacks": pk_join.COUNTS["fallback"], "tiers": tiers,
            "s": float(np.median(times)), "s_all": times,
            "shard_rows": {n: [int(t.row_counts[s]) for s in ctx.local_shards]
                           for n, t in out.items()},
        }
        del out
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    ctx.barrier()
    ctx22.finalize()
    ctx.finalize()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mp4(backend: str, out_dir: str, io_dir: str, n_procs: int = WORLD, per: int = 1,
            ops: str = "", what: str = "MP4") -> list:
    """Start the ``n_procs`` ranks of ``per`` shards each; fail the run
    when one exits non-zero or the limit passes, killing the others.
    Returns their results."""
    address = f"127.0.0.1:{free_port()}"
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(n_procs):
            log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp4-worker", str(r), str(n_procs),
                 address, backend, out_dir, io_dir, str(per), ops],
                stdout=log, stderr=subprocess.STDOUT,
            ), log))
        while time.perf_counter() - t0 < MP4_LIMIT_S:
            codes = [p.poll() for p, _log in procs]
            if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    codes = [p.returncode for p, _log in procs]
    if codes != [0] * n_procs:
        tails = "\n".join(f"--- rank {r}\n" + open(os.path.join(out_dir, f"rank{r}.log")).read()[-3000:]
                          for r in range(n_procs))
        fail(f"{what}: ranks exited {codes} after {time.perf_counter() - t0:.1f} s "
             f"(limit {MP4_LIMIT_S} s):\n{tails}")
    return [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(n_procs)]


def phase_mp4(ctt, ctx4, keep: dict = None) -> dict:
    """Workload MP4: the torch.distributed backend, four processes, held
    shard for shard against the same calls at world 4 in this process
    (``ctx4``), which are timed beside them (median of REPS_MP4 calls
    after a warm-up). Returns MP4's workload line; ``keep`` takes the
    one-process digests, times and tier gates for MP2x2."""
    import torch
    from cylon_tpu_torch.ops import pk_join
    from cylon_tpu_torch.utils import tracing

    torch.cuda.empty_cache()  # the ranks share card 0 with this process
    backend = "nccl" if torch.cuda.device_count() >= WORLD else "gloo"
    print(json.dumps({"mp4_backend": backend, "processes": WORLD,
                      "rank_devices": [f"cuda:{r}" if backend == "nccl" else "cuda:0"
                                       for r in range(WORLD)]}))
    ref, single, tiers = {}, {}, {}
    ctx22 = ctt.CylonContext.init_distributed(ctt.GPUConfig(world_size=WORLD, mesh_shape="2x2"))
    io_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mp4_io_")
    io_dir = io_tmp.name
    write_mp4_inputs(ctt, ctx4, io_dir)
    for op, call in mp4_calls(ctt, ctx4, ctx22, io_dir).items():
        pk_join.COUNTS["fallback"] = 0
        before = tier_counts(tracing)
        call()
        tiers[op] = tier_delta(tier_counts(tracing), before)
        times = []
        for _ in range(REPS_MP4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ref[op] = [shard_digests(out, s) for s in range(WORLD)]
        single[op] = float(np.median(times))
        if pk_join.COUNTS["fallback"]:
            fail(f"MP4 reference {op}: the PK join fell back")
        del out
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp4_") as mp4_dir:
        t0 = time.perf_counter()
        ranks = run_mp4(backend, mp4_dir, io_dir)
        wall_s = time.perf_counter() - t0
        # each rank's file equals one process's and the input it read
        for d, (mp, one, inp) in enumerate(zip(*(mp4_io_paths(io_dir, sub)
                                                  for sub in ("out_mp", "out_1p", "in")))):
            if not open(mp, "rb").read() == open(one, "rb").read() == open(inp, "rb").read():
                fail(f"MP4 IO4_rank: rank {d}'s file differs from one process's")
        io_bytes = [os.path.getsize(p) for p in mp4_io_paths(io_dir, "in")]
        io_tmp.cleanup()
        for r, res in enumerate(ranks):
            print(json.dumps({"mp4_rank": r, "device": res["device"],
                              "digests": {op: v["digests"] for op, v in res["ops"].items()},
                              "launches": {op: v["launches"] for op, v in res["ops"].items()}}))
            for op, got in res["ops"].items():
                want_digests, want_sums = ref[op][r]
                if got["digests"] != {str(r): want_digests}:
                    fail(f"MP4 {op}: rank {r}'s digests differ from shard {r} at world 4")
                for key, want in want_sums.items():  # workload A's tolerance
                    arr = np.load(os.path.join(mp4_dir, f"shard{r}.{op}.{key}.npy"))
                    if arr.shape != want.shape or not np.allclose(
                            arr.astype(np.float64), want.astype(np.float64), rtol=1e-5, atol=1e-4):
                        fail(f"MP4 {op}: rank {r}'s {key} differs from shard {r} at world 4")
                for k in MP4_KERNELS[op]:
                    if got["launches"][k] <= 0:
                        fail(f"MP4 {op}: rank {r} launched no {k}")
                if got["fallbacks"]:
                    fail(f"MP4 {op}: rank {r} fell back to the sort join")
                # every rank takes the gates one process takes, from the
                # counts gathered from every rank
                if got["tiers"] != tiers[op]:
                    fail(f"MP4 {op}: rank {r}'s tier gates {got['tiers']} != one process's {tiers[op]}")
    if keep is not None:
        keep.update(ref=ref, single=single, tiers=tiers)
    rank0 = ranks[0]["ops"]
    return {
        "workload": "MP4", "world": WORLD, "backend": backend, "processes": WORLD,
        "rank_devices": [res["device"] for res in ranks], "wall_s": wall_s,
        "s": {op: v["s"] for op, v in rank0.items()},
        "s_all": {op: v["s_all"] for op, v in rank0.items()},
        "single_process_s": single, "single_process_devices": [str(d) for d in ctx4.devices],
        "shard_rows": {op: [res["ops"][op]["shard_rows"] for res in ranks] for op in rank0},
        "launches_rank0": {op: v["launches"] for op, v in rank0.items()},
        "tiers_rank0": {op: v["tiers"] for op, v in rank0.items()}, "tiers_single_process": tiers,
        "io4_rank_file_bytes": io_bytes,
    }


#: MP2x2's calls: MP4's A4, S4, U4, PK4 and L4, and A4 and S4 on the 2x2 mesh
MP2X2_OPS = ("A4", "S4", "U4", "PK4", "L4", "A4_2x2", "S4_2x2")


def phase_mp2x2(keep: dict, smi: str) -> dict:
    """Workload MP2x2: two gloo processes of two shards each, both on
    cuda:0 (``GPUConfig(devices=["cuda:0", "cuda:0"], coordinator_address=
    ...)``), running MP4's calls on MP4's data; rank p's shards 2p and
    2p + 1 held against the same shards of the one-process world-4 calls
    (``keep``, from :func:`phase_mp4`): digests bit for bit, float sums
    within workload A's tolerance, the same tier gates, every kernel of the
    call launched on every rank. Prints each rank's shards, launches and
    median seconds a call."""
    ref, single, tiers = keep["ref"], keep["single"], keep["tiers"]
    procs, per = 2, 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp2x2_") as d:
        t0 = time.perf_counter()
        ranks = run_mp4("gloo", d, d, n_procs=procs, per=per, ops=",".join(MP2X2_OPS),
                        what="MP2x2")
        wall_s = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            if res["shards"] != list(range(r * per, (r + 1) * per)):
                fail(f"MP2x2: rank {r} owns shards {res['shards']}")
            print(json.dumps({"mp2x2_rank": r, "device": res["device"], "shards": res["shards"],
                              "s": {op: v["s"] for op, v in res["ops"].items()},
                              "launches": {op: v["launches"] for op, v in res["ops"].items()},
                              "smi": smi}))
            for op, got in res["ops"].items():
                for sh in res["shards"]:
                    want_digests, want_sums = ref[op][sh]
                    if got["digests"][str(sh)] != want_digests:
                        fail(f"MP2x2 {op}: rank {r}'s shard {sh} differs from shard {sh} at world 4")
                    for key, want in want_sums.items():  # workload A's tolerance
                        arr = np.load(os.path.join(d, f"shard{sh}.{op}.{key}.npy"))
                        if arr.shape != want.shape or not np.allclose(
                                arr.astype(np.float64), want.astype(np.float64), rtol=1e-5,
                                atol=1e-4):
                            fail(f"MP2x2 {op}: rank {r}'s {key} of shard {sh} differs")
                for k in MP4_KERNELS[op]:
                    if got["launches"][k] <= 0:
                        fail(f"MP2x2 {op}: rank {r} launched no {k}")
                if got["fallbacks"]:
                    fail(f"MP2x2 {op}: rank {r} fell back to the sort join")
                if got["tiers"] != tiers[op]:
                    fail(f"MP2x2 {op}: rank {r}'s tier gates {got['tiers']} != one process's "
                         f"{tiers[op]}")
    return {
        "workload": "MP2x2", "world": procs * per, "backend": "gloo", "processes": procs,
        "shards_per_process": per, "rank_shards": [res["shards"] for res in ranks],
        "rank_devices": [res["device"] for res in ranks], "wall_s": wall_s, "smi": smi,
        "s": {op: [res["ops"][op]["s"] for res in ranks] for op in MP2X2_OPS},
        "s_all": {op: [res["ops"][op]["s_all"] for res in ranks] for op in MP2X2_OPS},
        "single_process_s": {op: single[op] for op in MP2X2_OPS},
        "launches": {op: [res["ops"][op]["launches"] for res in ranks] for op in MP2X2_OPS},
        "shard_rows": {op: [res["ops"][op]["shard_rows"] for res in ranks] for op in MP2X2_OPS},
    }


def phase_obs(tl, tr, reset_counts, counts, require_launches, kernels, smi) -> dict:
    """Workload OBS: A's join -> groupby (8M x 8M) and L's q3_lazy, each
    untraced and under ``obs.trace.query_trace`` with the profiler on, then
    ``explain(analyze=True)`` of q3_lazy. Holds the traced outputs bit for
    bit against the untraced ones, the ``host_sync`` counts equal and the
    card's own synchronizing calls (:func:`sync_census`) equal, the
    Chrome export written to a temporary file and loaded back
    schema-clean. Prints the span tree's node count, the device ms of each
    span and profiled stage from their CUDA events beside the call's
    device time from torch.profiler, and the traced and untraced ms."""
    import torch
    from cylon_tpu_torch.obs import export as obs_export
    from cylon_tpu_torch.obs import prof as obs_prof
    from cylon_tpu_torch.obs import trace as obs_trace
    from cylon_tpu_torch.utils import tracing

    tr_rk = tr.rename({"k": "rk"})
    q3 = tl.lazy().join(tr_rk.lazy(), left_on="k", right_on="rk").groupby("k", {"v": "sum"})

    def a_call():
        j = tl.distributed_join(tr, on="k", how="inner")
        return {"join": j, "groupby": j.distributed_groupby("k_x", {"v": "sum", "w": "sum"})}

    calls = {"A": a_call, "q3_lazy": lambda: {"q3": q3.collect()}}
    cells = {}
    for name, call in calls.items():
        call()  # warm
        torch.cuda.synchronize()
        res = {}
        outs = {}
        for mode in ("untraced", "traced"):
            syncs, ms = [], []
            for i in range(1 + REPS):
                os.environ["CYLON_TPU_TORCH_PROF"] = "1" if mode == "traced" else "0"
                obs_prof.reset()
                obs_export.reset_ring()
                reset_counts()
                before = tracing.get_count("host_sync")
                t0 = time.perf_counter()
                if mode == "traced":
                    with obs_trace.query_trace(name, force=True) as q:
                        out = call()
                else:
                    out = call()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                syncs.append(tracing.get_count("host_sync") - before)
                if i == 0:
                    outs[mode] = out
                    res[f"launches_{mode}"] = counts()
                    if mode == "traced":
                        trace = q
                elif i == 1 and mode == "untraced":
                    outs["untraced_again"] = out  # the card's float sums vary run to run
                else:
                    del out
            os.environ.pop("CYLON_TPU_TORCH_PROF", None)
            res[f"{mode}_ms"] = float(np.median(ms[1:]))
            res[f"{mode}_ms_all"] = ms
            res[f"host_sync_{mode}"] = syncs
        if res["host_sync_traced"] != res["host_sync_untraced"]:
            fail(f"OBS {name}: host_sync traced {res['host_sync_traced']} != untraced "
                 f"{res['host_sync_untraced']}")
        # the card's own synchronizing calls, traced (and profiled) and not
        for mode in ("untraced", "traced"):
            os.environ["CYLON_TPU_TORCH_PROF"] = "1" if mode == "traced" else "0"
            obs_prof.reset()

            def census_call(call=call, name=name, mode=mode):
                if mode == "untraced":
                    return call()
                with obs_trace.query_trace(name, force=True):
                    return call()

            res[f"sync_census_{mode}"] = sync_census(census_call)
        os.environ.pop("CYLON_TPU_TORCH_PROF", None)
        if res["sync_census_traced"] != res["sync_census_untraced"]:
            fail(f"OBS {name}: the card's synchronizing calls differ, traced "
                 f"{res['sync_census_traced']} against untraced {res['sync_census_untraced']}")
        require_launches(res["launches_traced"], f"OBS {name}", kernels[name])
        # bit for bit, but the float sums, which the card adds in no fixed
        # order (index_add_): within workload A's tolerance, and counted
        # against two untraced calls' own difference
        res["float_sum_bits_differ"] = {"traced": 0, "untraced_twice": 0}
        for key, want in outs["untraced"].items():
            for other, tag in ((outs["traced"][key], "traced"),
                               (outs["untraced_again"][key], "untraced_twice")):
                for s_ in range(want.world_size):
                    for c in want.column_names:
                        gc_, wc = other._shards[s_][c], want._shards[s_][c]
                        if (gc_.valid is None) != (wc.valid is None) or (
                                wc.valid is not None and not torch.equal(gc_.valid, wc.valid)):
                            fail(f"OBS {name}: {tag} {key}.{c} validity differs from untraced")
                        if torch.equal(gc_.data, wc.data):
                            continue
                        if not (c.endswith("_sum") and wc.data.dtype.is_floating_point):
                            fail(f"OBS {name}: {tag} {key}.{c} differs from untraced")
                        err = (gc_.data.double() - wc.data.double()).abs()
                        if not bool((err <= 1e-4 + 1e-5 * wc.data.double().abs()).all()):
                            fail(f"OBS {name}: {tag} {key}.{c} max abs err {float(err.max())}")
                        res["float_sum_bits_differ"][tag] += 1
        del outs
        spans = list(trace.all_spans())
        res["span_nodes"] = len(spans)
        res["trace_device_ms"] = trace.device_ms(wait=True)
        res["span_device_ms"] = {}
        for sp in spans:
            dev = sp.device_ms(wait=True)
            if dev is None:
                fail(f"OBS {name}: span {sp.name} carries no device events")
            res["span_device_ms"].setdefault(sp.name, []).append(dev)
        stages = {}
        for p in trace.attrs.get(obs_prof.PROF_ATTR) or []:
            if not p.on_device():
                fail(f"OBS {name}: a {p.kind} stage profile carries no device events")
            for st, sec in p.seconds(wait=True).items():
                stages[st] = stages.get(st, 0.0) + sec * 1e3
        res["stage_device_ms"] = stages
        def traced_call(call=call, name=name):
            with obs_trace.query_trace(name, force=True):
                return call()

        prof = profile(traced_call)
        res["profiler_kernel_ms"] = prof["kernel_ms"]
        res["profiler_wall_ms"] = prof["wall_ms"]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
            path = os.path.join(d, "trace.json")
            n_events = obs_export.write_chrome(path, [trace])
            doc = obs_export.load_chrome(path)
            problems = obs_export.validate_chrome(doc)
            if problems or len(doc["traceEvents"]) != n_events:
                fail(f"OBS {name}: the Chrome export does not load back clean: {problems[:3]}")
            res["chrome_events"] = n_events
            res["chrome_bytes"] = os.path.getsize(path)
        cells[name] = res
    # explain(analyze=True) of q3_lazy
    t0 = time.perf_counter()
    text = q3.explain(analyze=True)
    explain_ms = (time.perf_counter() - t0) * 1e3
    if "== Analyzed plan (executed) ==" not in text or "FusedJoinGroupBySum" not in text:
        fail(f"OBS: explain(analyze=True) of q3_lazy:\n{text}")
    print(text)
    return {"workload": "OBS", "world": tl.world_size, "smi": smi, "cells": cells,
            "explain_ms": explain_ms, "explain_lines": len(text.splitlines())}


def fb_digest(t, order_col) -> str:
    """A digest of a table's rows independent of their shard and order:
    every column, gathered, in the order of ``order_col`` (unique values),
    or of a list of columns, sorted by each in turn (the first most
    significant: rows equal in all of them are equal rows)."""
    import torch

    cols = {c: torch.cat([t._shards[s][c].data for s in range(t.world_size)])
            for c in t.column_names}
    if isinstance(order_col, str):
        order = torch.argsort(cols[order_col])
    else:
        order = torch.arange(t.row_count, device=cols[order_col[0]].device)
        for c in reversed(order_col):
            order = order[torch.sort(cols[c][order], stable=True).indices]
    h = hashlib.sha256()
    for c in t.column_names:
        h.update(cols[c][order].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def phase_fb(ctt, ctx8, reset_counts, counts, require_launches, kernels, smi) -> dict:
    """FB: the feedback re-coster's skew-trigger flip on the card. One
    process holds SKEW_WORLD shards on cuda:0; the left side has FB_HOT of
    its 8M rows on one key (a bucket 3.1x the mean: the static 4x trigger
    ignores it), the right side's keys are a permutation. With the
    observation store on a temporary directory and the profiler on, the
    same lazy join repeats until its decisions settle: each run's
    Decisions, the executors built, the shipped bytes and the median time
    before (the NO_AUTOTUNE oracle) and after the flip, and a digest of the
    rows equal to the oracle's."""
    import torch
    from cylon_tpu_torch.obs import prof as _prof
    from cylon_tpu_torch.obs import store as _store
    from cylon_tpu_torch.plan import feedback as _fb
    from cylon_tpu_torch.plan.lazy import gated_fingerprint
    from cylon_tpu_torch.utils import tracing as _tr

    rng = np.random.default_rng(SEED + 17)
    k = rng.integers(0, N_SKEW, N_SKEW).astype(np.int32)
    k[rng.random(N_SKEW) < FB_HOT] = 7
    left = {"k": k, "v": np.arange(N_SKEW, dtype=np.float32)}
    right = {"rk": rng.permutation(N_SKEW).astype(np.int32),
             "w": rng.normal(size=N_SKEW).astype(np.float32)}
    names = ("shuffle.exchanged_bytes", "shuffle.spill.relay_bytes", "shuffle.skew_split")

    def rows(name):
        return int(_tr.get_trace_report().get(name, {}).get("rows", 0))

    def run():
        reset_counts()
        before = {n: rows(n) for n in names}
        t0 = time.perf_counter()
        out = lf.collect()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        moved = {n: rows(n) - before[n] for n in names}
        return out, {"ms": ms, "shipped_bytes": moved["shuffle.exchanged_bytes"]
                     + moved["shuffle.spill.relay_bytes"],
                     "relay_rows": moved["shuffle.skew_split"], "launches": counts()}

    env = {"CYLON_TPU_TORCH_OBS_DIR": None, "CYLON_TPU_TORCH_AUTOTUNE_MIN_OBS": "2",
           "CYLON_TPU_TORCH_PROF": "1"}
    saved = {v: os.environ.get(v) for v in env}
    with tempfile.TemporaryDirectory(prefix="fb_obs_") as obs_dir:
        try:
            _prof.reset()
            tl, tr = ctt.Table.from_pydict(ctx8, left), ctt.Table.from_pydict(ctx8, right)
            lf = tl.lazy().join(tr.lazy(), left_on="k", right_on="rk")
            # the oracle first, with no store (so its runs journal nothing)
            # and the re-coster off: the static decisions
            with _fb.autotune_disabled():
                out, _c = run()  # warm-up
                digest_oracle = fb_digest(out, "v")
                rows_out = out.row_count
                static = [run()[1] for _ in range(REPS_FB)]
            env["CYLON_TPU_TORCH_OBS_DIR"] = obs_dir
            os.environ.update(env)
            _store.reset_stores()
            m0 = _tr.get_count("plan.cache.miss")
            runs, prev = [], None
            for i in range(FB_MAX_RUNS):
                out, cell = run()
                dec = gated_fingerprint(lf.plan, ctx8)[-1][1]
                cell["decisions_after"] = dec._asdict()
                cell["digest"] = fb_digest(out, "v")
                if cell["digest"] != digest_oracle or out.row_count != rows_out:
                    fail(f"FB run {i}: rows differ from the NO_AUTOTUNE oracle's")
                runs.append(cell)
                if dec == prev and dec.skew_trigger is not None:
                    break
                prev = dec
            if runs[-1]["decisions_after"]["skew_trigger"] != _fb.SKEW_TRIGGER_TUNED:
                fail(f"FB: the skew trigger never flipped: {[r['decisions_after'] for r in runs]}")
            executors = _tr.get_count("plan.cache.miss") - m0
            flips = sum(p.get("flips", 0) for p in _store.store().profiles.values())
            if executors != 1 + flips:
                fail(f"FB: {executors} executors built for {flips} flips")
            tuned = [run()[1] for _ in range(REPS_FB)]
            require_launches(tuned[0]["launches"], "FB tuned", kernels)
            strag = [p.get("strag_sum", 0.0) / max(p.get("strag_n", 1), 1)
                     for p in _store.store().profiles.values()]
        finally:
            for v, x in saved.items():
                if x is None:
                    os.environ.pop(v, None)
                else:
                    os.environ[v] = x
            _store.reset_stores()
    med = {m: float(np.median([c["ms"] for c in cells]))
           for m, cells in (("static", static), ("tuned", tuned))}
    ship = {m: cells[0]["shipped_bytes"] for m, cells in (("static", static), ("tuned", tuned))}
    if ship["tuned"] >= ship["static"]:
        fail(f"FB: the tuned trigger shipped no fewer bytes: {ship}")
    return {"workload": "FB", "world": SKEW_WORLD, "rows_per_side": N_SKEW, "hot_share": FB_HOT,
            "join_rows": rows_out, "budget_bytes": ctx8.shuffle_byte_budget,
            "runs": [{k_: v_ for k_, v_ in r.items() if k_ != "launches"} for r in runs],
            "executors_built": executors, "flips": flips, "straggler_ratio_mean": strag,
            "digest": digest_oracle, "shipped_bytes": ship, "median_ms": med,
            "ms_all": {"static": [c["ms"] for c in static], "tuned": [c["ms"] for c in tuned]},
            "cells": {"static": static[0], "tuned": tuned[0]}}


def phase_serve(ctt, ctx, left, right, reset_counts, counts, require_launches, kernels,
                smi) -> dict:
    """SERVE: q3_lazy over A's 8M-row sides through the serving scheduler.
    SERVE_THREADS bindings (A's keys shifted by binding, integer-valued
    float32 values, so every sum is exact in any order) run serially by
    ``collect()``, then from as many threads at once by ``collect_async``
    into the context's one scheduler; every threaded result is bit-equal
    to its serial one. The stacked batches and single executions the
    scheduler ran (a batch that fell back to singles, or a failed query,
    fails the phase), the shed and backpressure counters, the SLO state,
    the median latency and the throughput of both, and each one's kernel
    launches."""
    import threading

    import torch
    from cylon_tpu_torch import serve
    from cylon_tpu_torch.obs import slo as _slo
    from cylon_tpu_torch.utils import tracing as _tr

    rng = np.random.default_rng(SEED + 23)
    plans = []
    for i in range(SERVE_THREADS):
        tl = ctt.Table.from_pydict(ctx, {"k": (left["k"] + i * 7919) % N_A,
                                         "v": rng.integers(-50, 50, N_A).astype(np.float32)})
        tr = ctt.Table.from_pydict(ctx, {"rk": right["k"],
                                         "w": rng.integers(-50, 50, N_A).astype(np.float32)})
        plans.append(tl.lazy().join(tr.lazy(), left_on="k", right_on="rk")
                     .groupby("k", {"v": "sum"}))
    counters = ("serve.shed.admission_budget", "serve.shed.queue_depth",
                "serve.shed.unconsumed_cap", "serve.backpressure.wait", "serve.budget_overflow",
                "serve.batches", "serve.singles", "serve.batch_cache.miss",
                "serve.batch_fallback", "serve.errors")

    def executed():
        """The executions the scheduler ran so far: stacked batches, the
        queries they held, and single executions."""
        rep = _tr.get_trace_report()
        return (_tr.get_count("serve.batches"), int(rep.get("serve.batches", {}).get("rows", 0)),
                _tr.get_count("serve.singles"))

    saved = os.environ.get("CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES")
    os.environ["CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES"] = str(SERVE_INFLIGHT)
    serve.scheduler(ctx)
    try:
        def serial_round():
            reset_counts()
            lat, outs = [], []
            t0 = time.perf_counter()
            for lf in plans:
                t1 = time.perf_counter()
                outs.append(lf.collect())
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t1) * 1e3)
            return outs, lat, (time.perf_counter() - t0) * 1e3, counts()

        def threaded_round():
            reset_counts()
            lat, outs = [None] * SERVE_THREADS, [None] * SERVE_THREADS
            barrier = threading.Barrier(SERVE_THREADS)

            def client(i):
                barrier.wait()
                t1 = time.perf_counter()
                outs[i] = plans[i].collect_async().result(timeout=600)
                lat[i] = (time.perf_counter() - t1) * 1e3

            threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_THREADS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = (time.perf_counter() - t0) * 1e3
            if any(o is None for o in outs):
                fail("SERVE: a threaded query returned nothing")
            return outs, lat, wall, counts()

        want, _lat, _w, _c = serial_round()  # warm-up, and the serial results
        before = {c: _tr.get_count(c) for c in counters}
        threaded_round()  # warm-up: builds the batched executor
        cells = {"serial": [], "threads8": []}
        for _ in range(REPS_SERVE):
            for name, fn in (("serial", serial_round), ("threads8", threaded_round)):
                ex0 = executed()
                outs, lat, wall, launches = fn()
                batches, batched, singles = (b - a for a, b in zip(ex0, executed()))
                for i, (o, w) in enumerate(zip(outs, want)):
                    for c in w.column_names:
                        if not torch.equal(o.column(c).data, w.column(c).data):
                            fail(f"SERVE {name}: binding {i} column {c} differs from serial")
                if name == "threads8" and batched + singles != SERVE_THREADS:
                    fail(f"SERVE: {batched} batched and {singles} single executions "
                         f"for {SERVE_THREADS} queries")
                cells[name].append({"latency_ms": lat, "wall_ms": wall,
                                    "queries_per_s": SERVE_THREADS / (wall / 1e3),
                                    "launches": launches,
                                    "executed": {"batches": batches, "batched_queries": batched,
                                                 "singles": singles}})
        moved = {c: _tr.get_count(c) - before[c] for c in counters}
        states = _slo.monitor().evaluate()
    finally:
        if saved is None:
            os.environ.pop("CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES", None)
        else:
            os.environ["CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES"] = saved
    require_launches(cells["threads8"][0]["launches"], "SERVE threads8", kernels)
    if any(moved[c] for c in counters if c.startswith("serve.shed.")):
        fail(f"SERVE: queries shed: {moved}")
    # a stacked execution that fails falls back to singles with the same
    # results: only these counters show it
    if moved["serve.batch_fallback"] or moved["serve.errors"]:
        fail(f"SERVE: a batch fell back or a query failed: {moved}")
    if not moved["serve.batches"]:
        fail("SERVE: no stacked batch ran in the threaded rounds")
    summary = {name: {"median_latency_ms": float(np.median([x for c in cs for x in c["latency_ms"]])),
                      "median_queries_per_s": float(np.median([c["queries_per_s"] for c in cs])),
                      "executed": [c["executed"] for c in cs]}
               for name, cs in cells.items()}
    return {"workload": "SERVE", "world": ctx.world_size, "rows_per_side": N_A,
            "bindings": SERVE_THREADS, "inflight_budget": SERVE_INFLIGHT,
            "counters": moved, "slo_states": states, "summary": summary,
            "rounds": {n: [{k_: v_ for k_, v_ in c.items() if k_ != "launches"} for c in cs]
                       for n, cs in cells.items()},
            "cells": {n: cs[0] for n, cs in cells.items()}}


def make_stream():
    """stream_bench.py's data (seed 11): the appendable left side, the static
    right side (rows // 32) and the batch maker the appends draw from, in
    the bench's order of draws."""
    rng = np.random.default_rng(STREAM_SEED)

    def lbatch(n):
        return {"k": rng.integers(0, STREAM_KEYS, n).astype(np.int32),
                "v": rng.integers(-50, 50, n).astype(np.float32)}

    left = lbatch(N_STREAM)
    n_r = max(N_STREAM // 32, 256)
    right = {"rk": rng.integers(0, STREAM_KEYS, n_r).astype(np.int32),
             "w": rng.integers(-50, 50, n_r).astype(np.float32)}
    return left, right, lbatch


def q3_rows(t):
    """A q3 view result's (keys, sums) on the host, in key order."""
    d = t.to_pydict()
    order = np.argsort(d["k"], kind="stable")
    return d["k"][order], d["v_sum"][order]


def phase_stream(ctt, ctx, ctx4, left_a, right_a, reset_counts, counts, require_launches,
                 smi) -> dict:
    """STREAM: incremental views (cylon_tpu_torch/stream/) on the card.

    STREAM_q3, at worlds 1 and 4: benchmarks/stream_bench.py's view (an
    8M-row appendable left side joined to a static 250,000-row right side,
    summed by key, through the q3 pushdown) warmed as the bench warms it,
    then STREAM_ROUNDS rounds of a 1% append, each refresh split into its
    snapshot build, its plan (the delta's upload), the delta collect and
    the host merge, beside a fresh NO_IVM view's full recompute on the same
    generation: equal exactly (integer-valued float32 sums below 2^24),
    one pushdown each, no emit. STREAM_join: A's two sides, both
    appendable, a filter on the left then an inner join with no aggregate,
    appends to each side in turn: every refresh's rows equal the
    recompute's by an order-free digest, and K2 launches. Then two
    subscriptions of the world-1 q3 view resolve through the scheduler
    after an append, both equal to the refresh and the recompute, with no
    serving error and no batch fallen back."""
    import torch
    from cylon_tpu_torch import stream
    from cylon_tpu_torch.utils import tracing as _tr

    def sync_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def spread(xs):
        return {"median": float(np.median(xs)), "min": float(min(xs)), "max": float(max(xs))}

    def q3(ctx_, what):
        left, right, lbatch = make_stream()
        src = stream.AppendableTable(ctx_, left)
        tr_ = ctt.Table.from_pydict(ctx_, right)

        def build(lt):
            return lt.lazy().join(tr_.lazy(), left_on="k", right_on="rk").groupby("k", {"v": "sum"})

        snap = []
        orig_table = src.table

        def timed_table(at_gen=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig_table(at_gen)
            snap.append(sync_ms(t0))
            return out

        src.table = timed_table  # the view's snapshot builds, timed apart
        view = stream.view(build, src)
        # the bench's warm-up: the full refresh, one incremental round and
        # one NO_IVM recompute
        view.refresh()
        src.append(lbatch(STREAM_DELTA))
        view.refresh()
        with stream.ivm_disabled():
            stream.view(build, src).refresh()
        if view.stats != {"noop": 0, "full": 1, "fallback": 0, "inc": 1}:
            fail(f"{what}: the warm-up round was not incremental: {view.stats}")
        rounds = []
        for r in range(STREAM_ROUNDS):
            src.append(lbatch(STREAM_DELTA))
            inc0 = view.stats["inc"]
            reset_counts()
            p0 = _tr.get_count("join.sum_pushdown")
            snap.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mode, lf, commit = view._plan_refresh()
            plan_ms = sync_ms(t0)
            t1 = time.perf_counter()
            part = lf.collect()
            collect_ms = sync_ms(t1)
            t2 = time.perf_counter()
            got = commit(part)
            merge_ms = sync_ms(t2)
            inc_ms = sync_ms(t0)
            launches_inc, push_inc = counts(), _tr.get_count("join.sum_pushdown") - p0
            reset_counts()
            p0 = _tr.get_count("join.sum_pushdown")
            with stream.ivm_disabled():
                t3 = time.perf_counter()
                want = stream.view(build, src).refresh()
                full_ms = sync_ms(t3)
            launches_full, push_full = counts(), _tr.get_count("join.sum_pushdown") - p0
            if mode != "inc" or view.stats["inc"] != inc0 + 1 or view.stats["fallback"]:
                fail(f"{what} round {r}: mode {mode}, stats {view.stats}")
            gk, gs = q3_rows(got)
            wk, ws = q3_rows(want)
            if gk.dtype != wk.dtype or gs.dtype != ws.dtype or not (
                    np.array_equal(gk, wk) and np.array_equal(gs, ws)):
                fail(f"{what} round {r}: the refresh differs from the NO_IVM recompute")
            max_abs = float(np.abs(ws).max())
            if max_abs >= 2.0 ** 24:
                fail(f"{what} round {r}: max |sum| {max_abs} >= 2^24: float32 sums inexact")
            # the q3 pushdown on both paths: one pushdown a plan, no emit
            # (without it the full join emits about 3.9e9 rows)
            if push_inc != 1 or push_full != 1:
                fail(f"{what} round {r}: pushdowns {push_inc} incremental, {push_full} full")
            for name, c in (("incremental", launches_inc), ("full", launches_full)):
                if c["expand_rows"]:
                    fail(f"{what} round {r} {name}: the join emitted rows (K2 launched)")
            rounds.append({"inc_ms": inc_ms, "snapshot_ms": snap[0], "plan_ms": plan_ms,
                           "collect_ms": collect_ms, "merge_ms": merge_ms, "full_ms": full_ms,
                           "max_abs_sum": max_abs, "rows": src.row_count,
                           "launches_inc": launches_inc, "launches_full": launches_full})
        kernels = ["radix_lane_hist", "radix_onesweep"]
        if ctx_.world_size > 1:
            kernels += ["pack_hist", "pack_dest", "compact_move"]
        require_launches(rounds[0]["launches_inc"], f"{what} incremental", kernels)
        require_launches(rounds[0]["launches_full"], f"{what} full", kernels)
        src.table = orig_table
        summary = {m: spread([r_[m] for r_ in rounds])
                   for m in ("inc_ms", "snapshot_ms", "plan_ms", "collect_ms", "merge_ms",
                             "full_ms")}
        summary["inc_over_full"] = summary["inc_ms"]["median"] / summary["full_ms"]["median"]
        summary["snapshot_share"] = (summary["snapshot_ms"]["median"]
                                     / summary["inc_ms"]["median"])
        return {"world": ctx_.world_size, "budget_bytes": ctx_.shuffle_byte_budget,
                "rows": N_STREAM, "right_rows": len(right["rk"]),
                "delta_rows": STREAM_DELTA, "stats": dict(view.stats), "groups": len(q3_rows(got)[0]),
                "summary": summary,
                "rounds": [{k_: v_ for k_, v_ in r_.items() if not k_.startswith("launches")}
                           for r_ in rounds],
                "launches": {"inc": rounds[0]["launches_inc"],
                             "full": rounds[0]["launches_full"]}}, view, src, build, lbatch

    out = {"workload": "STREAM", "smi": smi}
    q3_w4 = q3(ctx4, "STREAM_q3 w4")[0]
    q3_w1, view1, src1, build1, lbatch1 = q3(ctx, "STREAM_q3 w1")
    out["q3"] = {"w1": q3_w1, "w4": q3_w4}

    # subscriptions of the world-1 view, resolved through the scheduler
    counters = ("serve.errors", "serve.batch_fallback", "serve.batches", "serve.singles")
    s1, s2 = stream.subscribe(view1), stream.subscribe(view1)
    src1.append(lbatch1(STREAM_DELTA))
    if not (s1.stale() and s2.stale()):
        fail("STREAM subscriptions: the append did not mark them stale")
    before = {c: _tr.get_count(c) for c in counters}
    reset_counts()
    t0 = time.perf_counter()
    f1, f2 = s1.refresh_async(), s2.refresh_async()
    r1, r2 = f1.result(timeout=600), f2.result(timeout=600)
    subs_ms = sync_ms(t0)
    launches_subs = counts()
    moved = {c: _tr.get_count(c) - before[c] for c in counters}
    refreshed = view1.refresh()
    with stream.ivm_disabled():
        full = stream.view(build1, src1).refresh()
    want = q3_rows(full)
    for name, t in (("subscription 1", r1), ("subscription 2", r2), ("view.refresh()", refreshed)):
        got = q3_rows(t)
        if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
            fail(f"STREAM subscriptions: {name} differs from the NO_IVM recompute")
    if moved["serve.errors"] or moved["serve.batch_fallback"]:
        fail(f"STREAM subscriptions: a query failed or a batch fell back: {moved}")
    if not (s1.done() and s2.done()):
        fail("STREAM subscriptions: not resolved after their refresh")
    require_launches(launches_subs, "STREAM subscriptions", ["radix_lane_hist", "radix_onesweep"])
    out["subs"] = {"ms": subs_ms, "counters": moved, "stats": dict(view1.stats)}
    del view1, src1, s1, s2, r1, r2, refreshed, full

    # STREAM_join: A's sides, both appendable; a filter, a join, no aggregate
    rng = np.random.default_rng(SEED + 29)
    lt_src = stream.AppendableTable(ctx, {"k": left_a["k"], "v": left_a["v"]})
    rt_src = stream.AppendableTable(ctx, {"rk": right_a["k"], "w": right_a["w"]})

    def build_join(lt, rt):
        return lt.lazy().filter(ctt.col("v") >= 0.0).join(rt.lazy(), left_on="k", right_on="rk")

    jview = stream.view(build_join, lt_src, rt_src)
    jview.refresh()
    join_rounds = []
    order = ["k", "v", "rk", "w"]
    for r in range(STREAM_JOIN_ROUNDS):
        if r % 2 == 0:
            lt_src.append({"k": rng.integers(0, N_A, STREAM_DELTA).astype(np.int32),
                           "v": rng.normal(size=STREAM_DELTA).astype(np.float32)})
        else:
            rt_src.append({"rk": rng.integers(0, N_A, STREAM_DELTA).astype(np.int32),
                           "w": rng.normal(size=STREAM_DELTA).astype(np.float32)})
        reset_counts()
        t0 = time.perf_counter()
        got = jview.refresh()
        inc_ms = sync_ms(t0)
        launches_inc = counts()
        reset_counts()
        with stream.ivm_disabled():
            t1 = time.perf_counter()
            want = stream.view(build_join, lt_src, rt_src).refresh()
            full_ms = sync_ms(t1)
        launches_full = counts()
        if got.row_count != want.row_count or fb_digest(got, order) != fb_digest(want, order):
            fail(f"STREAM_join round {r}: the refresh differs from the NO_IVM recompute")
        if jview.stats["inc"] != r + 1 or jview.stats["fallback"]:
            fail(f"STREAM_join round {r}: stats {jview.stats}")
        require_launches(launches_inc, f"STREAM_join round {r} incremental",
                         ["radix_lane_hist", "radix_onesweep", "expand_rows"])
        join_rounds.append({"side": "left" if r % 2 == 0 else "right", "inc_ms": inc_ms,
                            "full_ms": full_ms, "rows": got.row_count,
                            "launches_inc": launches_inc, "launches_full": launches_full})
    out["join"] = {"rows_per_side": N_A, "delta_rows": STREAM_DELTA, "stats": dict(jview.stats),
                   "inc_ms": spread([r_["inc_ms"] for r_ in join_rounds]),
                   "full_ms": spread([r_["full_ms"] for r_ in join_rounds]),
                   "rounds": [{k_: v_ for k_, v_ in r_.items() if not k_.startswith("launches")}
                              for r_ in join_rounds]}
    del jview, lt_src, rt_src, got, want
    out["cells"] = {
        "q3_w1_inc": {"launches": q3_w1["launches"]["inc"]},
        "q3_w1_full": {"launches": q3_w1["launches"]["full"]},
        "q3_w4_inc": {"launches": q3_w4["launches"]["inc"]},
        "q3_w4_full": {"launches": q3_w4["launches"]["full"]},
        "subs": {"launches": launches_subs},
        "join_inc": {"launches": join_rounds[0]["launches_inc"]},
        "join_full": {"launches": join_rounds[0]["launches_full"]},
    }
    return out


def widen(cols: dict) -> dict:
    """Host columns as the CSV codec reads them back: integers as int64,
    floats as float64 (the codec infers no narrower type)."""
    return {c: v.astype(np.int64 if v.dtype.kind in "iu" else np.float64) for c, v in cols.items()}


def tables_identical(a, b, what, sums=()) -> dict:
    """``a`` equals ``b`` shard for shard, column for column, bit for bit:
    names, row counts, validity and data; a float sum column of ``sums``
    (the card adds a group's terms in no fixed order) equal bit for bit or
    within rtol 1e-12. Returns {sum column: bit-equal in every shard}."""
    import torch

    if a.column_names != b.column_names or a.row_counts.tolist() != b.row_counts.tolist():
        fail(f"{what}: names or shard rows differ ({a.row_counts.tolist()} vs "
             f"{b.row_counts.tolist()})")
    bits = {c: True for c in sums}
    for d in a.ctx.local_shards:
        for c in a.column_names:
            x, y = a._shards[d][c], b._shards[d][c]
            if x.data.dtype != y.data.dtype or (x.valid is None) != (y.valid is None) or (
                    x.valid is not None and not torch.equal(x.valid, y.valid)):
                fail(f"{what}: shard {d} {c} type or validity differs")
            if torch.equal(x.data, y.data):
                continue
            if c not in sums or not torch.allclose(x.data, y.data, rtol=1e-12, atol=0):
                fail(f"{what}: shard {d} {c} differs")
            bits[c] = False
    return bits


def phase_capi(ctt, ctx, io_dir: str, counted) -> dict:
    """Workload CAPI: the port's C ABI (native/capi.cpp) and its client
    (native/examples/capi_client.c), built here, run as a program of its
    own on cuda:0 (no CYLON_TPU_TORCH_PLATFORM) over A-shaped CSVs of
    N_CAPI rows a side (int32 k uniform in [0, N_CAPI), float32 x and y):
    read -> distributed_join -> distributed_sort -> project -> write_csv.
    Its file must equal, byte for byte (sorted, so row for row), the same
    calls through the Python API in this process, whose launches
    ``counted(fn) -> (fn(), launches)`` reads. Returns the line."""
    import sysconfig

    import torch
    from cylon_tpu_torch import native

    t0 = time.perf_counter()
    so = native.build_capi()
    capi_build_s = time.perf_counter() - t0
    exe = os.path.join(io_dir, "capi_client")
    t0 = time.perf_counter()
    subprocess.run(["gcc", "-O2", str(native.HERE / "examples" / "capi_client.c"), "-o", exe,
                    "-ldl"], check=True, capture_output=True, timeout=120)
    client_build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 15)
    lp, rp, out, want_p = (os.path.join(io_dir, f) for f in
                           ("capi_l.csv", "capi_r.csv", "capi_out.csv", "capi_want.csv"))
    for path, name in ((lp, "x"), (rp, "y")):
        ctt.write_csv(ctt.Table.from_pydict(ctx, {
            "k": rng.integers(0, N_CAPI, N_CAPI).astype(np.int32),
            name: rng.normal(size=N_CAPI).astype(np.float32)}), path)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in sys.path if p]),
               LD_LIBRARY_PATH=os.pathsep.join(filter(None, [
                   sysconfig.get_config_var("LIBDIR") or "", os.environ.get("LD_LIBRARY_PATH", "")])))
    env.pop("CYLON_TPU_TORCH_PLATFORM", None)  # the card
    torch.cuda.empty_cache()  # the client's process shares the card
    t0 = time.perf_counter()
    res = subprocess.run([exe, so, lp, rp, out], capture_output=True, text=True, timeout=600,
                         env=env)
    client_s = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"CAPI: the client exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")

    def python_api():
        j = ctt.read_csv(ctx, lp).distributed_join(ctt.read_csv(ctx, rp), on="k", how="inner")
        return j.distributed_sort("k_x").project(["k_x", "x", "y"])

    python_api()  # warm-up
    t0 = time.perf_counter()
    want, launches = counted(python_api)
    ctt.write_csv(want, want_p)
    python_s = time.perf_counter() - t0
    if f"rows={want.row_count} cols=3" not in res.stdout:
        fail(f"CAPI: the client printed {res.stdout.strip()!r}, not rows={want.row_count} cols=3")
    if open(out, "rb").read() != open(want_p, "rb").read():
        fail("CAPI: the client's file differs from the Python API's")
    return {"workload": "CAPI", "rows_per_side": N_CAPI, "join_rows": want.row_count,
            "capi_build_s": capi_build_s, "client_build_s": client_build_s,
            "client_s": client_s, "python_api_s": python_s,
            "out_bytes": os.path.getsize(out), "client_stdout": res.stdout.strip(),
            "cells": {"python_api": {"launches": launches}}}


def main(mp4_only: bool = False) -> None:
    """Every phase; with ``mp4_only`` (``--mp4``) workload MP4 alone, the
    check of the NCCL backend where there are four cards."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import cylon_tpu_torch as ctt
        from cylon_tpu_torch import _build
        from cylon_tpu_torch import table as _tbl
        from cylon_tpu_torch.ops import cuda_codec, cuda_gather, cuda_probe, cuda_radix, pk_join
        from cylon_tpu_torch.ops import sketch as _sketch
        from cylon_tpu_torch.ops import stats as _stats
        from cylon_tpu_torch.parallel import shuffle as _sh
        from cylon_tpu_torch.utils import tracing as _tr
        from cylon_tpu_torch.ops import radix as _radix
        from cylon_tpu_torch.ops.partition import hash_partition_ids
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
    if mp4_only:
        ctx4 = ctt.CylonContext.init_distributed(ctt.GPUConfig(world_size=WORLD))
        print(json.dumps(phase_mp4(ctt, ctx4)))
        print(smi)
        return

    # record the largest input each kernel wrapper sees on the main path
    seen = {}
    orig_lane, orig_expand = cuda_radix.radix_sort_lane, cuda_gather.expand_rows

    def rec_lane(enc, perm, lo, hi):
        key = f"radix_{enc.element_size() * 8}"
        if key not in seen or enc.shape[0] > seen[key][0].shape[0]:
            seen[key] = (enc, perm, lo, hi)
        return orig_lane(enc, perm, lo, hi)

    def rec_expand(srcT, li):
        size = li.numel() * srcT.shape[0]
        if "expand" not in seen or size > seen["expand"][1].numel() * seen["expand"][0].shape[0]:
            seen["expand"] = (srcT, li)
        return orig_expand(srcT, li)

    orig_hist, orig_dest = cuda_codec.pack_hist, cuda_codec.pack_dest
    orig_move, orig_plan = cuda_codec.compact_move, _tbl._plan_state
    orig_probe = cuda_probe.probe
    plans = []  # (bucket_cap, n_rounds) of every shuffle of a run, as planned
    gates = []  # beside each: the semi and wire gates' decisions, the row bytes

    def rec_hist(words, valids, has_valid, n, P, pid=None):
        key = "hist_64" if seen.get("key64_next") else "hist"
        if pid is None and (key not in seen or words.shape[1] > seen[key][0].shape[1]):
            seen[key] = (words, valids, has_valid, n, P)
        if pid is not None and ("hist_pid" not in seen or pid.shape[0] > seen["hist_pid"][5].shape[0]):
            seen["hist_pid"] = (None, None, (), n, P, pid)  # the range shuffle's pid lane
        return orig_hist(words, valids, has_valid, n, P, pid)

    def rec_dest(lane, base, round_idx, P, bc):
        if "dest" not in seen or lane.shape[0] >= seen["dest"][0].shape[0]:
            seen["dest"] = (lane, base, round_idx, P, bc)
        return orig_dest(lane, base, round_idx, P, bc)

    def rec_move(move, recv, P, bc, n_header=0):
        # the largest buffer, the largest whose rows are not a multiple of
        # 16 bytes (B3's 4-byte store path) and the largest of each header
        # count (a two-hop round's same-group part has none, its combined
        # cross-outer part one)
        keys = ("move", "move_odd") if move.shape[1] % 4 else ("move",)
        for key in keys + (f"move_nh{n_header}",):
            if key not in seen or move.numel() >= seen[key][0].numel():
                seen[key] = (move, recv, P, bc, n_header)
        return orig_move(move, recv, P, bc, n_header)

    def rec_plan(st):
        orig_plan(st)
        plans.append((st["bucket_cap"], st["n_rounds"]))
        semi = None
        if st["counts_f"] is not None:
            semi = {"applied": bool(st["use_filter"]), "rows": int(st["counts_u"].sum()),
                    "rows_filtered": int(st["counts_f"].sum())}
        tp = st.get("topo_plan")
        gates.append({"semi_filter": semi, "wire": st["wire"] is not None,
                      "row_bytes": _wire_row_bytes(st),
                      "cap_o": None if tp is None else tp.cap_o,
                      "ring_cap": None if st.get("ring") is None else st["ring"][1]})

    def rec_probe(lk, rk, rid, nb, B):
        if "probe" not in seen or lk.numel() > seen["probe"][0].numel():
            seen["probe"] = (lk, rk, rid, nb, B)
        return orig_probe(lk, rk, rid, nb, B)

    cuda_radix.radix_sort_lane = rec_lane
    cuda_gather.expand_rows = rec_expand
    cuda_codec.pack_hist, cuda_codec.pack_dest = rec_hist, rec_dest
    cuda_codec.compact_move, _tbl._plan_state = rec_move, rec_plan
    cuda_probe.probe = rec_probe
    launch_counters = (cuda_radix.LAUNCHES, cuda_gather.LAUNCHES, cuda_codec.LAUNCHES,
                       cuda_probe.LAUNCHES)

    def reset_counts():
        for d in launch_counters:
            for k in d:
                d[k] = 0
        _radix.COUNTS["declined"] = 0
        pk_join.COUNTS["fallback"] = 0
        plans.clear()
        gates.clear()
        tier_base.clear()
        tier_base.update(tier_counts(_tr))

    tier_base = {}

    def tiers():
        """The tier counters since reset_counts(), and each shuffle's gates."""
        return {"counters": tier_delta(tier_counts(_tr), tier_base), "shuffles": list(gates)}

    def counts():
        return {k: v for d in launch_counters for k, v in d.items()}

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
    # the PK join has no left-order emit: K1 and B5, plus the codec at world 4
    pk_kernels = list(cuda_radix.LAUNCHES) + list(cuda_probe.LAUNCHES)

    env = ctt.CylonEnv(config=ctt.GPUConfig())
    ctx = env.context
    if ctx.device.type != "cuda":
        fail(f"GPUConfig() resolved to {ctx.device}")

    # ------------------------------------------------------------------
    # workload A
    # ------------------------------------------------------------------
    left, right, rng = make_a()
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
        df_o = ctt.DataFrame(orders, ctx=ctx)
        df_c = ctt.DataFrame(customers, ctx=ctx)
        jb = df_o.merge(df_c, on="cust", env=env)
        return jb, jb.groupby("segment", env=env).agg({"price": "sum"}).to_dict()

    run_b()
    seen.clear()
    reset_counts()
    t0 = time.perf_counter()
    jb, gb_host = run_b()
    b_times = [time.perf_counter() - t0]
    launches_b = counts()
    require_launches(launches_b, "workload B", local_kernels)
    declined_b = _radix.COUNTS["declined"]
    for _ in range(REPS_B - 1):
        t0 = time.perf_counter()
        _jb, _gb = run_b()
        b_times.append(time.perf_counter() - t0)
        del _jb, _gb
    b_s = float(np.median(b_times))
    # plain reference: every order meets its one customer (cust is a key)
    seg_names, seg_code = np.unique(customers["segment"], return_inverse=True)
    want = np.bincount(seg_code[orders["cust"]], weights=orders["price"],
                       minlength=len(seg_names))
    b_ref = (seg_names, want)  # workload B_IO4's reference too
    if len(jb) != N_ORDERS or list(gb_host["segment"]) != list(seg_names):
        fail("workload B: join rows or segments differ from the reference")
    # float64 sums of ~330k terms in another order: rtol 1e-9
    if not np.allclose(np.asarray(gb_host["price_sum"], np.float64), want, rtol=1e-9, atol=0):
        fail("workload B: price sums differ from the reference")
    work_b = {"workload": "B", "orders": N_ORDERS, "customers": N_CUST,
              "end_to_end_s": b_s, "end_to_end_s_all": b_times,
              "spread_s": max(b_times) - min(b_times), "launches": launches_b,
              "radix_declined": declined_b}
    captured_b = dict(seen)
    del jb

    # ------------------------------------------------------------------
    # workload A4: A's data at world 4 through the hash shuffle
    # ------------------------------------------------------------------
    env4 = ctt.CylonEnv(config=ctt.GPUConfig(world_size=WORLD))
    ctx4 = env4.context
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
        launches, plan, tier = counts(), list(plans), tiers()
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
            "shuffle_plans": plan, "tiers": tier,
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

    # ------------------------------------------------------------------
    # workloads L and L4: the lazy planner on A's tables (the right key
    # renamed rk), at world 1 and at world 4 (32 MiB budget)
    # ------------------------------------------------------------------
    from cylon_tpu_torch.utils import tracing as _tr

    kr_pos = kr[wr > 0.0]  # plan_filter keeps the joined rows with w > 0
    cr_pos = torch.bincount(kr_pos, minlength=N_A)
    keys_pos = torch.nonzero((cl > 0) & (cr_pos > 0)).squeeze(1)
    del kr_pos
    # the plain reference A's eager join -> groupby is held to, per query:
    # (group keys, {column: float64 reference})
    l_refs = {
        "q3_lazy": (keys, {"v_sum": sv[keys] * cr[keys]}),
        "plan_filter": (keys_pos, {"v_sum": sv[keys_pos] * cr_pos[keys_pos]}),
        "q3_ordered": (keys, {"v_sum": sv[keys] * cr[keys]}),
        "q3_ordered_lazy": (keys, {"v_sum": sv[keys] * cr[keys], "v_mean": sv[keys] / cl[keys]}),
    }
    # plan_filter reads every column of A's tables (w in the filter), so it
    # prunes none; q3_lazy drops w, the two-aggregate q3 w too
    fused = ["plan.rule.fused_join_groupby"]
    key_order = ["ordering.join_key_order_emit", "ordering.groupby_run_detect"]
    l_expect = {
        "q3_lazy": fused + ["plan.rule.projection_pushdown"],
        "plan_filter": fused + ["plan.rule.filter_pushdown"],
        "q3_ordered": key_order,
        "q3_ordered_lazy": key_order + ["plan.rule.order_reuse", "plan.rule.projection_pushdown"],
    }

    def lazy_queries(tl_, tr_):
        """run_bench.py's q3_lazy and q3_ordered, plan_bench.py's query,
        and the lazy two-aggregate q3: name -> (call, group key column)."""
        q = tl_.lazy().join(tr_.rename({"k": "rk"}).lazy(), left_on="k", right_on="rk")

        def ordered():
            jo = tl_.distributed_join(tr_, on="k", how="inner", emit_order="key")
            return jo.distributed_groupby("k_x", {"v": "sum"})

        return {
            "q3_lazy": (lambda: q.groupby("k", {"v": "sum"}).collect(), "k"),
            "plan_filter": (lambda: q.filter(ctt.col("w") > 0.0).groupby("k", {"v": "sum"}).collect(), "k"),
            "q3_ordered": (ordered, "k_x"),
            "q3_ordered_lazy": (lambda: q.groupby("k", {"v": ["sum", "mean"]}).collect(), "k"),
        }

    def check_l(out, key_col, name, what):
        """Group keys exactly, sums and means within A's tolerance, as sets
        (a world-4 shard holds its hash partition's groups in key order);
        each shard in ascending key order."""
        ref_keys, ref_cols = l_refs[name]
        for s_ in range(out.world_size):
            ks = out._shards[s_][key_col].data
            if ks.numel() > 1 and not bool((ks[1:] > ks[:-1]).all()):
                fail(f"{what} {name}: shard {s_} groups not in key order")
        gk = out.column(key_col).data.long()
        order = torch.argsort(gk)
        if out.row_count != ref_keys.numel() or not torch.equal(gk[order], ref_keys):
            fail(f"{what} {name}: group keys differ from the reference")
        for col, ref in ref_cols.items():
            err = (out.column(col).data.double()[order] - ref).abs()
            if not bool((err <= 1e-4 + 1e-5 * ref.abs()).all()):
                fail(f"{what} {name}: {col} max abs err {float(err.max())}")

    def measure_l(what, tl_, tr_, kernels):
        world = tl_.world_size
        res = {}
        for name, (call, key_col) in lazy_queries(tl_, tr_).items():
            call()  # warm-up: compiles the plan (a plan-cache miss)
            _tr.reset_trace()
            reset_counts()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            times = [time.perf_counter() - t0]
            launches, plan, tier = counts(), list(plans), tiers()
            require_launches(launches, f"{what} {name}", kernels)
            for _ in range(REPS_L - 1):
                t0 = time.perf_counter()
                _o = call()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                del _o
            fired = {k: v["count"] for k, v in _tr.report("plan.rule.").items()}
            fired.update({k: v["count"] for k, v in _tr.report("ordering.").items()})
            lazy = name != "q3_ordered"  # the eager q3_ordered has no plan
            expect = l_expect[name] + (["plan.rule.shuffle_elimination"] if lazy and world > 1 else [])
            for c_ in expect:
                if not fired.get(c_):
                    fail(f"{what} {name}: {c_} did not fire ({fired})")
            hits = _tr.get_count("plan.cache.hit")
            if lazy and (hits != REPS_L or _tr.get_count("plan.cache.miss")):
                fail(f"{what} {name}: {hits} plan-cache hits of {REPS_L} warm collects")
            check_l(out, key_col, name, what)
            ms = float(np.median(times)) * 1e3
            res[name] = {"ms": ms, "ms_all": [t * 1e3 for t in times],
                         "spread_ms": (max(times) - min(times)) * 1e3,
                         "input_rows_per_s": 2 * N_A / (ms / 1e3), "groups": out.row_count,
                         "launches": launches, "counters": fired, "plan_cache_hits": hits,
                         "shuffle_plans": plan, "tiers": tier}
            del out
        return {"workload": what, "world": world, "rows_per_side": N_A,
                "budget_bytes": tl_.ctx.shuffle_byte_budget, "queries": res}

    k1_kernels = list(cuda_radix.LAUNCHES)
    work_l = measure_l("L", tl, tr, k1_kernels)
    q3_l = lazy_queries(tl, tr)["q3_lazy"][0]
    print(json.dumps({"profile_l": profile(q3_l)}))
    work_l4 = measure_l("L4", tl4, tr4, k1_kernels + list(cuda_codec.LAUNCHES))
    del tl4, tr4, q3_l, cr_pos, keys_pos

    # ------------------------------------------------------------------
    # workload B4: B at world 4 (the groupby shuffles on a string key)
    # ------------------------------------------------------------------
    def run_b4():
        df_o = ctt.DataFrame(orders, ctx=ctx4)
        df_c = ctt.DataFrame(customers, ctx=ctx4)
        jb4 = df_o.merge(df_c, on="cust", env=env4)
        return jb4, jb4.groupby("segment", env=env4).agg({"price": "sum"})

    run_b4()
    seen.clear()
    seen["key64_next"] = True  # the join shuffles hash int64 keys
    reset_counts()
    t0 = time.perf_counter()
    jb4, gb4 = run_b4()
    gb4_host = gb4.to_dict()
    b4_s = time.perf_counter() - t0
    launches_b4, plans_b4, tiers_b4 = counts(), list(plans), tiers()
    require_launches(launches_b4, "workload B4", all_kernels)
    order = np.argsort(np.asarray(gb4_host["segment"], dtype=str))
    if len(jb4) != N_ORDERS or [gb4_host["segment"][i] for i in order] != list(seg_names):
        fail("workload B4: join rows or segments differ from the reference")
    if not np.allclose(np.asarray(gb4_host["price_sum"], np.float64)[order], want, rtol=1e-9, atol=0):
        fail("workload B4: price sums differ from the reference")
    work_b4 = {"workload": "B4", "world": WORLD, "orders": N_ORDERS, "customers": N_CUST,
               "end_to_end_s": b4_s, "launches": launches_b4, "shuffle_plans": plans_b4,
               "tiers": tiers_b4,
               "group_shard_rows": gb4.table.row_counts.tolist()}
    captured_b4 = on_card(seen)
    del jb4, gb4

    # ------------------------------------------------------------------
    # workloads PK and PK4: the PK-FK join (algorithm="pallas_pk", B5)
    # ------------------------------------------------------------------
    pk_left, pk_right = make_pk()
    r_key, l_key = pk_right["k"], pk_left["k"]
    # plain float64 reference of the sums by key
    kl_pk = torch.from_numpy(l_key).to(dev).long()
    cl_pk = torch.bincount(kl_pk, minlength=2 * N_A)
    sv_pk = torch.zeros(2 * N_A, dtype=torch.float64, device=dev).index_add_(
        0, kl_pk, torch.from_numpy(pk_left["v"]).to(dev).double())
    wk_pk = torch.zeros(2 * N_A, dtype=torch.float64, device=dev)
    wk_pk[torch.from_numpy(r_key).to(dev).long()] = torch.from_numpy(pk_right["w"]).to(dev).double()
    keys_pk = torch.nonzero(cl_pk > 0).squeeze(1)
    pk_sums = (("v_sum", sv_pk[keys_pk]), ("w_sum", cl_pk[keys_pk] * wk_pk[keys_pk]))
    del kl_pk, sv_pk, wk_pk

    def run_pk(tl_, tr_, algorithm):
        j = tl_.distributed_join(tr_, on="k", how="inner", algorithm=algorithm)
        torch.cuda.synchronize()
        t_join = time.perf_counter()
        g = j.distributed_groupby("k_x", {"v": "sum", "w": "sum"})
        torch.cuda.synchronize()
        return j, g, t_join

    def row_sorted(j):
        """The join's rows in (k_x, bits of v) order: its multiset, since
        w follows from k (unique right keys)."""
        kx, v = j.column("k_x").data.long(), j.column("v").data
        order = torch.argsort((kx << 32) | (v.view(torch.int32).long() & 0xFFFFFFFF))
        return [j.column(c).data[order] for c in ("k_x", "v", "k_y", "w")]

    def check_pk(j, g, j_sort, g_sort, what):
        if j.row_count != N_A or j_sort.row_count != N_A:
            fail(f"{what}: join rows {j.row_count} (sort join {j_sort.row_count}) != {N_A}")
        for c, (a, b) in zip(("k_x", "v", "k_y", "w"), zip(row_sorted(j), row_sorted(j_sort))):
            if not torch.equal(a, b):
                fail(f"{what}: join column {c} differs from the sort join's as a multiset")
        gk, gk_sort = g.column("k_x").data.long(), g_sort.column("k_x").data.long()
        order, order_sort = torch.argsort(gk), torch.argsort(gk_sort)
        if not (torch.equal(gk[order], keys_pk) and torch.equal(gk_sort[order_sort], keys_pk)):
            fail(f"{what}: group keys differ from the sort join's groupby or the reference")
        # float32 sums of 1-10 terms against float64 references, workload
        # A's tolerance: the card's segment sums add by atomics, in no fixed
        # order, so two groupbys of the same rows agree only to rounding
        for col, ref in pk_sums:
            for gg, oo in ((g, order), (g_sort, order_sort)):
                err = (gg.column(col).data.double()[oo] - ref).abs()
                if not bool((err <= 1e-4 + 1e-5 * ref.abs()).all()):
                    fail(f"{what}: {col} max abs err {float(err.max())}")

    def measure_pk(what, c):
        tl_, tr_ = ctt.Table.from_pydict(c, pk_left), ctt.Table.from_pydict(c, pk_right)
        run_pk(tl_, tr_, "pallas_pk")  # warm-up
        seen.pop("probe", None)
        reset_counts()
        t0 = time.perf_counter()
        j, g, t_join = run_pk(tl_, tr_, "pallas_pk")
        t_end = time.perf_counter()
        launches, fallbacks = counts(), pk_join.COUNTS["fallback"]
        require_launches(launches, what, pk_kernels + (list(cuda_codec.LAUNCHES) if c is ctx4 else []))
        if fallbacks != 0:
            fail(f"{what}: {fallbacks} speculation misses fell back to the sort join")
        join_t, gb_t = [t_join - t0], [t_end - t_join]
        for _ in range(REPS_E2E - 1):
            t0 = time.perf_counter()
            _j, _g, t_join = run_pk(tl_, tr_, "pallas_pk")
            join_t.append(t_join - t0)
            gb_t.append(time.perf_counter() - t_join)
            del _j, _g
        run_pk(tl_, tr_, "sort")  # warm-up of the sort join on the same data
        sort_j, sort_g = [], []
        for _ in range(REPS_E2E):
            t0 = time.perf_counter()
            j_sort, g_sort, t_join = run_pk(tl_, tr_, "sort")
            sort_j.append(t_join - t0)
            sort_g.append(time.perf_counter() - t_join)
        check_pk(j, g, j_sort, g_sort, what)
        if pk_join.COUNTS["fallback"] != 0:
            fail(f"{what}: a speculation miss in the timed runs")
        js, gs = float(np.median(join_t)), float(np.median(gb_t))
        sjs, sgs = float(np.median(sort_j)), float(np.median(sort_g))
        nb, B = seen["probe"][3], seen["probe"][4]
        work = {
            "workload": what, "world": c.world_size, "rows_per_side": N_A,
            "join_rows": j.row_count, "groups": g.row_count, "nb": nb, "B": B,
            "join_shard_rows": j.row_counts.tolist(),
            "join_s": js, "groupby_s": gs, "join_s_all": join_t, "groupby_s_all": gb_t,
            "input_rows_per_s": 2 * N_A / (js + gs),
            "sort_join_s": sjs, "sort_groupby_s": sgs, "sort_join_s_all": sort_j,
            "sort_input_rows_per_s": 2 * N_A / (sjs + sgs),
            "launches": launches, "fallbacks": fallbacks,
            "radix_declined": _radix.COUNTS["declined"],
        }
        return work, tl_, tr_

    work_pk, tl_pk, tr_pk = measure_pk("PK", ctx)
    captured_pk = dict(seen)
    print(json.dumps({"profile_pk": profile(lambda: run_pk(tl_pk, tr_pk, "pallas_pk"))}))
    del tl_pk, tr_pk
    work_pk4, tl_pk, tr_pk = measure_pk("PK4", ctx4)
    print(json.dumps({"profile_pk4": profile(lambda: run_pk(tl_pk, tr_pk, "pallas_pk"))}))
    del tl_pk, tr_pk

    # a duplicate right key: one speculation miss, then the exact sort join
    dl = {"k": l_key[:N_DUP], "v": pk_left["v"][:N_DUP]}
    dr = {"k": r_key[:N_DUP].copy(), "w": pk_right["w"][:N_DUP]}
    dr["k"][7] = dr["k"][3]
    tdl, tdr = ctt.Table.from_pydict(ctx, dl), ctt.Table.from_pydict(ctx, dr)
    reset_counts()
    j_dup = tdl.distributed_join(tdr, on="k", algorithm="pallas_pk")
    dup_fallbacks = pk_join.COUNTS["fallback"]
    j_dup_sort = tdl.distributed_join(tdr, on="k")
    if dup_fallbacks != 1:
        fail(f"duplicate-key case: {dup_fallbacks} fallbacks, expected 1")
    if j_dup.column_names != j_dup_sort.column_names or not all(
        torch.equal(j_dup.column(c).data, j_dup_sort.column(c).data) for c in j_dup.column_names
    ):
        fail("duplicate-key case: the fallback differs from the sort join")
    work_dup = {"workload": "PK_dup", "rows_per_side": N_DUP, "join_rows": j_dup.row_count,
                "fallbacks": dup_fallbacks}
    del j_dup, j_dup_sort, tdl, tdr

    # ------------------------------------------------------------------
    # workloads S, S4, U and U4: distributed_sort and the set operations on
    # benchmarks/run_bench.py's make_tables at A's scale (left is workload
    # A's left side, seed 0; left2 the same with seed 1)
    # ------------------------------------------------------------------
    left2 = make_left2()
    sort_kernels = list(cuda_radix.LAUNCHES)
    shuffle_kernels = sort_kernels + list(cuda_codec.LAUNCHES)

    def measure(fn, what, kernels, reps=REPS_OPS):
        """Warm-up, then ``reps`` timed calls; the first one's result, its
        launches and shuffle plans, and every call's seconds."""
        fn()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times = [time.perf_counter() - t0]
        launches, plan, tier = counts(), list(plans), tiers()
        require_launches(launches, what, kernels)
        if _radix.COUNTS["declined"]:
            fail(f"{what}: a sort declined the radix engine")
        for _ in range(reps - 1):
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del r
        return out, {"launches": launches, "shuffle_plans": plan, "s": float(np.median(times)),
                     "s_all": times, "tiers": tier}

    def host_cols(t, names):
        return [t.column(c).data.cpu().numpy() for c in names]

    def row_keys(k, v=None):
        """One int64 per row: k, or (k, bits of v with -0.0 as +0.0), the
        set operations' row equality."""
        k = np.asarray(k).astype(np.int64)
        if v is None:
            return k
        v = np.where(v == 0, np.float32(0), v).astype(np.float32)
        return (k << 32) | v.view(np.uint32).astype(np.int64)

    def row_keys_dev(cols):
        k = cols[0].long()
        if len(cols) == 1:
            return k
        v = torch.where(cols[1] == 0, torch.zeros_like(cols[1]), cols[1])
        return (k << 32) | (v.view(torch.int32).long() & 0xFFFFFFFF)

    # S: left.distributed_sort("k") at world 1 (run_bench.py:499-506)
    s_out, work_s = measure(lambda: tl.distributed_sort("k"), "S", sort_kernels)
    order = np.argsort(left["k"], kind="stable")
    got_k, got_v = host_cols(s_out, ["k", "v"])
    if not (np.diff(got_k) >= 0).all():
        fail("S: k is not non-decreasing")
    if not (np.array_equal(got_k, left["k"][order])
            and np.array_equal(got_v.view(np.int32), left["v"][order].view(np.int32))):
        fail("S: rows differ from numpy's stable argsort of k")
    work_s.update({"workload": "S", "world": 1, "rows": N_A, "input_rows_per_s": N_A / work_s["s"]})
    del s_out, order, got_k, got_v

    # S4: the same at world 4 through the range shuffle (B2a in pid mode)
    tl4 = ctt.Table.from_pydict(ctx4, left)
    in_keys = torch.sort(row_keys_dev([torch.from_numpy(left[c]).to(dev) for c in ("k", "v")]))[0]
    x = left["k"].astype(np.float64)  # numpy's range bins, float64
    nb = 16 * WORLD
    lo, hi = x.min(), x.max()
    bins = np.clip(((x - lo) / max(hi - lo, 1e-300) * nb).astype(np.int32), 0, nb - 1)
    hist = np.bincount(bins, minlength=nb)
    per_part = max(hist.sum() / WORLD, 1.0)
    bin_part = np.clip(((np.cumsum(hist) - hist) / per_part).astype(np.int32), 0, WORLD - 1)
    want_counts = np.bincount(bin_part[bins], minlength=WORLD)
    del x, bins

    def check_s4(out, what):
        if out.row_counts.tolist() != want_counts.tolist():
            fail(f"{what}: shard rows {out.row_counts.tolist()} != range bins {want_counts.tolist()}")
        last = None
        for sh in out._shards:
            k = sh["k"].data.to(dev)
            if k.numel() == 0:
                continue
            if not bool((k[1:] >= k[:-1]).all()) or (last is not None and int(k[0]) < last):
                fail(f"{what}: keys out of order within or across shards")
            last = int(k[-1])
        got = torch.sort(row_keys_dev([out.column(c).data.to(dev) for c in ("k", "v")]))[0]
        if not torch.equal(got, in_keys):
            fail(f"{what}: rows differ from the input as a multiset")

    s4_out, work_s4 = measure(lambda: tl4.distributed_sort("k"), "S4", shuffle_kernels)
    check_s4(s4_out, "S4")
    if work_s4["shuffle_plans"][0][1] != 1:
        fail(f"S4: plan {work_s4['shuffle_plans']} at the default budget is not one round")
    print(json.dumps({"profile_s4": profile(lambda: tl4.distributed_sort("k"))}))
    seen.clear()
    ctx4.add_config("shuffle_byte_budget", BUDGET_SMALL)
    s4k_out, work_s4k = measure(lambda: tl4.distributed_sort("k"), "S4_K4", shuffle_kernels)
    captured_s4 = on_card(seen)
    check_s4(s4k_out, "S4_K4")
    if work_s4k["shuffle_plans"][0][1] < 2:
        fail(f"S4_K4: plan {work_s4k['shuffle_plans']} at 4 MiB is not several rounds")
    ctx4.add_config("shuffle_byte_budget", "")
    for w, o, budget in ((work_s4, s4_out, None), (work_s4k, s4k_out, BUDGET_SMALL)):
        w.update({"workload": "S4" if budget is None else "S4_K4", "world": WORLD, "rows": N_A,
                  "budget_bytes": budget or ctx4.shuffle_byte_budget,
                  "shard_rows": o.row_counts.tolist(), "input_rows_per_s": N_A / w["s"]})
    del s4_out, s4k_out, in_keys

    # U: the set operations (run_bench.py:547-562) at world 1, on (k, v) and
    # on project(["k"]), then unique on k, against numpy in first-occurrence
    # order
    tl2 = ctt.Table.from_pydict(ctx, left2)
    pl, pl2 = tl.project(["k"]), tl2.project(["k"])
    keys_l, keys_r = row_keys(left["k"], left["v"]), row_keys(left2["k"], left2["v"])
    cat_k = np.concatenate([left["k"], left2["k"]])
    cat_v = np.concatenate([left["v"], left2["v"]])

    def first_rows(keys):
        return np.sort(np.unique(keys, return_index=True)[1])

    def last_rows(keys):
        return np.sort(len(keys) - 1 - np.unique(keys[::-1], return_index=True)[1])

    def set_refs(kl, kr):
        """Row indices of the plain results: union into [left ++ left2],
        subtract and intersect into left."""
        fl = first_rows(kl)
        hit = np.isin(kl[fl], kr)
        return {"union": first_rows(np.concatenate([kl, kr])), "subtract": fl[~hit],
                "intersect": fl[hit]}

    refs = {"": set_refs(keys_l, keys_r), "_k": set_refs(left["k"], left2["k"])}
    refs["_k"]["unique"] = first_rows(left["k"])
    refs["_k"]["unique_last"] = last_rows(left["k"])
    del keys_l, keys_r
    u_calls = [
        ("union", "", lambda a, b: a.union(b)), ("subtract", "", lambda a, b: a.subtract(b)),
        ("intersect", "", lambda a, b: a.intersect(b)),
        ("union", "_k", lambda a, b: a.union(b)), ("subtract", "_k", lambda a, b: a.subtract(b)),
        ("intersect", "_k", lambda a, b: a.intersect(b)),
        ("unique", "_k", lambda a, b: a.unique(["k"])),
        ("unique_last", "_k", lambda a, b: a.unique(["k"], keep="last")),
    ]
    work_u = {"workload": "U", "world": 1, "rows_per_side": N_A, "ops": {}}
    for op, sfx, call in u_calls:
        a, b = (tl, tl2) if sfx == "" or op.startswith("unique") else (pl, pl2)
        out, w = measure(lambda: call(a, b), f"U {op}{sfx}", sort_kernels)
        idx = refs[sfx][op]
        src_k, src_v = (cat_k, cat_v) if op == "union" else (left["k"], left["v"])
        names = out.column_names
        got = host_cols(out, names)
        if names != (["k", "v"] if a is tl else ["k"]) or len(got[0]) != len(idx):
            fail(f"U {op}{sfx}: {names}, {len(got[0])} rows != {len(idx)}")
        if not np.array_equal(got[0], src_k[idx]) or (
                len(got) > 1 and not np.array_equal(got[1].view(np.int32), src_v[idx].view(np.int32))):
            fail(f"U {op}{sfx}: rows differ from numpy's first-occurrence result")
        n_in = N_A if op.startswith("unique") else 2 * N_A
        w.update({"rows": len(idx), "input_rows_per_s": n_in / w["s"]})
        work_u["ops"][op + sfx] = w
        del out, got
    print(json.dumps({"profile_u": profile(lambda: tl.union(tl2))}))
    del pl, pl2

    # U4: the distributed forms at world 4: each shard's rows, as a
    # multiset, are the plain result's rows of that shard's murmur3
    # partition (of all columns; of k for distributed_unique)
    tl4b = ctt.Table.from_pydict(ctx4, left2)
    pl4, pl4b = tl4.project(["k"]), tl4b.project(["k"])
    u4_calls = [
        ("union", "", lambda a, b: a.distributed_union(b)),
        ("subtract", "", lambda a, b: a.distributed_subtract(b)),
        ("intersect", "", lambda a, b: a.distributed_intersect(b)),
        ("union", "_k", lambda a, b: a.distributed_union(b)),
        ("subtract", "_k", lambda a, b: a.distributed_subtract(b)),
        ("intersect", "_k", lambda a, b: a.distributed_intersect(b)),
        ("unique", "_k", lambda a, b: a.distributed_unique(["k"])),
        ("unique_last", "_k", lambda a, b: a.distributed_unique(["k"], keep="last")),
    ]
    work_u4 = {"workload": "U4", "world": WORLD, "rows_per_side": N_A, "ops": {}}
    for op, sfx, call in u4_calls:
        a, b = (tl4, tl4b) if sfx == "" or op.startswith("unique") else (pl4, pl4b)
        out, w = measure(lambda: call(a, b), f"U4 {op}{sfx}", shuffle_kernels)
        idx = torch.from_numpy(refs[sfx][op]).to(dev)
        src_k, src_v = (cat_k, cat_v) if op == "union" else (left["k"], left["v"])
        want = [torch.from_numpy(src_k).to(dev)[idx]]
        if a is tl4:
            want.append(torch.from_numpy(src_v).to(dev)[idx])
        part_by = want[:1] if op.startswith("unique") else want
        pid = hash_partition_ids([(c, None) for c in part_by], None, WORLD)
        want_keys = row_keys_dev(want)
        for s_, sh in enumerate(out._shards):
            got = torch.sort(row_keys_dev([sh[c].data.to(dev) for c in out.column_names]))[0]
            if not torch.equal(got, torch.sort(want_keys[pid == s_])[0]):
                fail(f"U4 {op}{sfx}: shard {s_} differs from the plain result's partition")
        n_in = N_A if op.startswith("unique") else 2 * N_A
        w.update({"rows": out.row_count, "shard_rows": out.row_counts.tolist(),
                  "input_rows_per_s": n_in / w["s"]})
        work_u4["ops"][op + sfx] = w
        del out, want, pid, want_keys
    print(json.dumps({"profile_u4": profile(lambda: tl4.distributed_union(tl4b))}))
    del tl4b, pl4, pl4b, cat_k, cat_v

    # O: the order-descriptor fast paths over sorted input (U's tables and
    # A's right side sorted by k, S4's output at world 4), each op timed
    # beside the same call under ordering.disabled(), the sort-based path
    # it bypasses; both must give the same rows in the same order
    from cylon_tpu_torch import ordering as _ordering

    def plain_path(call):
        def run():
            with _ordering.disabled():
                return call()
        return run

    def same_table(a, b, what, sums=()):
        """Shard by shard, row for row; the float ``sums`` (the card adds
        them in no fixed order) within A's tolerance."""
        if a.column_names != b.column_names or a.row_counts.tolist() != b.row_counts.tolist():
            fail(f"{what}: {a.column_names} {a.row_counts.tolist()} != "
                 f"{b.column_names} {b.row_counts.tolist()}")
        for sa, sb in zip(a._shards, b._shards):
            for c in a.column_names:
                ca, cb = sa[c], sb[c]
                if c in sums:
                    err = (ca.data.double() - cb.data.double()).abs()
                    if not bool((err <= 1e-4 + 1e-5 * cb.data.double().abs()).all()):
                        fail(f"{what}: {c} max abs err {float(err.max())}")
                elif not torch.equal(ca.data, cb.data) or (ca.valid is None) != (cb.valid is None) or (
                        ca.valid is not None and not torch.equal(ca.valid, cb.valid)):
                    fail(f"{what}: column {c} differs from the path it bypasses")

    sl, sl2 = tl.sort("k"), tl2.sort("k")
    psl, psl2 = sl.project(["k"]), sl2.project(["k"])
    tr_sorted = tr.sort("k")
    s4_sorted = tl4.distributed_sort("k")
    o_calls = [
        ("sort", "sort_elided", lambda: sl.sort("k")),
        ("sort_kv", "sort_suffix", lambda: sl.sort(["k", "v"])),
        ("unique_k", "unique_run_detect", lambda: sl.unique(["k"])),
        ("unique_last_k", "unique_run_detect", lambda: sl.unique(["k"], keep="last")),
        ("union_k", "setop_sorted_probe", lambda: psl.union(psl2)),
        ("subtract_k", "setop_sorted_probe", lambda: psl.subtract(psl2)),
        ("intersect_k", "setop_sorted_probe", lambda: psl.intersect(psl2)),
        ("groupby_sum", "groupby_run_detect", lambda: sl.groupby("k", {"v": "sum"})),
        ("join_presorted", "join_presorted_probe", lambda: tl.join(tr_sorted, on="k")),
        ("dist_sort_4", "dist_sort_elided", lambda: s4_sorted.distributed_sort("k")),
    ]
    work_o = {"workload": "O", "rows_per_side": N_A, "ops": {}}
    for op, counter, call in o_calls:
        _tr.reset_trace()
        fast, w_fast = measure(call, f"O {op}", [])
        if not _tr.get_count("ordering." + counter):
            fail(f"O {op}: ordering.{counter} did not fire")
        _tr.reset_trace()
        plain, w_plain = measure(plain_path(call), f"O {op} (ordering disabled)", [])
        if _tr.report("ordering."):
            fail(f"O {op}: an ordering fast path fired under ordering.disabled()")
        same_table(fast, plain, f"O {op}", sums=("v_sum",) if op == "groupby_sum" else ())
        work_o["ops"][op] = {
            "fast_path": "ordering." + counter, "world": fast.world_size, "rows": fast.row_count,
            "ms": w_fast["s"] * 1e3, "ms_all": [t * 1e3 for t in w_fast["s_all"]],
            "launches": w_fast["launches"],
            "disabled_ms": w_plain["s"] * 1e3, "disabled_ms_all": [t * 1e3 for t in w_plain["s_all"]],
            "disabled_launches": w_plain["launches"],
        }
        del fast, plain
    del sl, sl2, psl, psl2, tr_sorted, s4_sorted, tl4, tl2

    # ------------------------------------------------------------------
    # workloads F and F4: the DataFrame surface of the reference's op
    # benchmarks (python/examples/op_benchmark: filter, math, null
    # handling, isin, astype, sort, dedup, groupby, indexing) on A's left
    # side widened, at world 1 and at world 4; each op timed alone
    # ------------------------------------------------------------------
    fd = make_f()
    n_f = len(fd["k"])
    k_f, v_f, ok_f, w_f, g_f, s_f = (fd[c] for c in ("k", "v", "valid", "w", "g", "s"))
    T = ctt.dtypes.Type

    def frame_f(context):
        return ctt.DataFrame(ctt.Table.from_encoded(context, {
            "k": (k_f, None, ctt.dtypes.DataType(T.INT32), None),
            "v": (v_f, ok_f, ctt.dtypes.DataType(T.FLOAT), None),
            "w": (w_f, None, ctt.dtypes.DataType(T.FLOAT), None),
            "g": (g_f, None, ctt.dtypes.DataType(T.INT32), None),
            "s": (s_f, None, ctt.dtypes.DataType(T.STRING), fd["names"]),
        }))

    def f_host(t, names=("k", "v", "w", "g", "s")):
        """Whole columns on the host: {name: (data, valid | None)}."""
        return t._host_physical(list(names))

    def same_rows(got, idx, what, v_valid=True):
        """Every column of a row-subset output equal to the input's rows
        ``idx`` in order (v's mask too)."""
        want = {"k": k_f, "v": v_f, "w": w_f, "g": g_f, "s": s_f}
        for c, (d, valid) in got.items():
            x = want[c][idx]
            if d.dtype != x.dtype or len(d) != len(x) or not np.array_equal(
                    d.view(np.uint32) if d.dtype == np.float32 else d,
                    x.view(np.uint32) if x.dtype == np.float32 else x):
                fail(f"{what}: column {c} differs from numpy's rows")
        vm = got["v"][1]
        want_ok = ok_f[idx]
        if vm is None or not np.array_equal(vm, want_ok):
            fail(f"{what}: v's validity differs")

    def f_refs():
        """numpy's answers for F (row indices, group stats)."""
        refs = {"filter": np.nonzero(ok_f & (v_f > np.float32(0.5)))[0],
                "isin": np.nonzero(np.isin(k_f, fd["isin"]))[0],
                "dropna": np.nonzero(ok_f)[0],
                "sort": np.lexsort((k_f, g_f)),
                "dedup_first": first_rows(g_f), "dedup_last": last_rows(g_f)}
        order_k = np.argsort(k_f, kind="stable")
        sk = k_f[order_k]
        lab = fd["labels"]
        lo, hi = np.searchsorted(sk, lab, "left"), np.searchsorted(sk, lab, "right")
        refs["loc_list"] = np.concatenate([order_k[a:b] for a, b in zip(lo, hi)])
        a_, b_ = fd["loc_range"]
        refs["loc_slice"] = np.nonzero((k_f >= a_) & (k_f <= b_))[0]
        refs["iloc_slice"] = np.arange(*fd["iloc_range"])
        # the groupby: var/std (float64, two passes), nunique and the median
        # (the reference's interpolation) of v's valid values, nunique of s
        gv, vv = g_f[ok_f], v_f[ok_f].astype(np.float64)
        keys = np.unique(g_f)
        cnt = np.bincount(gv, minlength=keys.max() + 1)[keys]
        mean = np.bincount(gv, weights=vv, minlength=keys.max() + 1)[keys] / cnt
        dev2 = (vv - mean[np.searchsorted(keys, gv)]) ** 2
        var = np.bincount(gv, weights=dev2, minlength=keys.max() + 1)[keys] / (cnt - 1)
        o = np.lexsort((vv, gv))
        sg, sv = gv[o], vv[o]
        newpair = np.ones(len(sg), bool)
        newpair[1:] = (sg[1:] != sg[:-1]) | (sv[1:] != sv[:-1])
        nun = np.bincount(sg[newpair], minlength=keys.max() + 1)[keys]
        starts = np.searchsorted(sg, keys).astype(np.float64)
        pos = starts + 0.5 * np.maximum(cnt - 1, 0).astype(np.float64)
        lo_i, hi_i = np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)
        frac = pos - np.floor(pos)
        med = sv[lo_i] * (1 - frac) + sv[hi_i] * frac
        pairs = np.unique(g_f.astype(np.int64) * 64 + s_f)
        s_nun = np.bincount(pairs // 64, minlength=keys.max() + 1)[keys]
        refs["groupby"] = {"g": keys, "v_var": var, "v_std": np.sqrt(var), "v_nunique": nun,
                           "v_median": med, "s_nunique": s_nun}
        return refs

    refs_f = f_refs()
    AGG_F = {"v": ["var", "std", "nunique", "median"], "s": "nunique"}

    def check_groupby(out_cols, keep, what):
        """``out_cols``: {name: host data} of groups ``keep`` (a mask over
        numpy's sorted keys), in key order."""
        want = refs_f["groupby"]
        if not np.array_equal(out_cols["g"], want["g"][keep]):
            fail(f"{what}: group keys differ")
        for c in ("v_nunique", "v_median", "s_nunique"):
            if not np.array_equal(out_cols[c], want[c][keep]):
                fail(f"{what}: {c} differs from numpy")
        for c in ("v_var", "v_std"):  # the card adds in no fixed order
            if not np.allclose(out_cols[c], want[c][keep], rtol=1e-6, atol=0):
                fail(f"{what}: {c} beyond rtol 1e-6 of numpy's float64")

    def run_f(df, env, world):
        """F's ops on ``df`` (world 1, or world 4 with ``env``): {op:
        (output, measurement)}; every output gated against numpy."""
        res = {}
        t = df.table
        ops = [
            ("filter", lambda: df[df["v"] > 0.5], []),
            ("math", lambda: _assign_x(df), []),
            ("isnull", lambda: df.isnull(), []),
            ("fillna", lambda: df.fillna(0.0), []),
            ("dropna", lambda: df.dropna(), []),
            ("isin", lambda: df[df["k"].isin(fd["isin"])], []),
            ("astype", lambda: df.astype({"k": "int64", "g": "float64"}), []),
            ("sort_values", lambda: df.sort_values(["g", "k"], env=env), sort_kernels),
            ("drop_duplicates_first", lambda: df.drop_duplicates(["g"], env=env), sort_kernels),
            ("drop_duplicates_last",
             lambda: df.drop_duplicates(["g"], keep="last", env=env), sort_kernels),
            ("groupby", lambda: df.groupby("g", env=env).agg(AGG_F), sort_kernels),
            ("loc_list", lambda: idx_df.loc[list(fd["labels"])], []),
            ("loc_slice", lambda: idx_df.loc[fd["loc_range"][0]:fd["loc_range"][1]], []),
            ("iloc_slice", lambda: idx_df.iloc[fd["iloc_range"][0]:fd["iloc_range"][1]], []),
        ]
        if world > 1:
            ops = [(o, fn, shuffle_kernels if ks else ks) for o, fn, ks in ops]
        idx_df = df.set_index("k")
        tag = "F" if world == 1 else "F4"
        for op, fn, kernels in ops:
            out, w = measure(fn, f"{tag} {op}", kernels)
            w["ms"] = w["s"] * 1e3
            w["input_rows_per_s"] = n_f / w["s"]
            res[op] = (out.table if isinstance(out, ctt.DataFrame) else out, w)
        return res

    def _assign_x(df):
        d = ctt.DataFrame(df.table)
        d["x"] = d["v"] * 2.0 + d["w"]
        return d

    def gate_f(res, world):
        tag = "F" if world == 1 else "F4"
        for op in ("filter", "isin", "dropna"):
            same_rows(f_host(res[op][0]), refs_f[op], f"{tag} {op}")
        x = f_host(res["math"][0], ["x", "k"])["x"]
        want_x = v_f * np.float32(2.0) + w_f
        if x[0].dtype != np.float32 or not np.array_equal(x[1], ok_f) or not np.array_equal(
                x[0][ok_f].view(np.uint32), want_x[ok_f].view(np.uint32)):
            fail(f"{tag} math: x differs from numpy's v * 2 + w")
        nul = f_host(res["isnull"][0])
        if not np.array_equal(nul["v"][0], ~ok_f) or any(nul[c][0].any() for c in "kwgs"):
            fail(f"{tag} isnull: differs from v's mask")
        fil = f_host(res["fillna"][0])
        if fil["v"][1] is not None or not np.array_equal(
                fil["v"][0].view(np.uint32), np.where(ok_f, v_f, np.float32(0)).view(np.uint32)):
            fail(f"{tag} fillna: v differs")
        ast = f_host(res["astype"][0], ["k", "g"])
        if not (np.array_equal(ast["k"][0], k_f.astype(np.int64)) and ast["k"][0].dtype == np.int64
                and np.array_equal(ast["g"][0], g_f.astype(np.float64))):
            fail(f"{tag} astype: k or g differs")
        for op in ("loc_list", "loc_slice", "iloc_slice"):
            same_rows(f_host(res[op][0]), refs_f[op], f"{tag} {op}")
        if world == 1:
            same_rows(f_host(res["sort_values"][0]), refs_f["sort"], "F sort_values")
            same_rows(f_host(res["drop_duplicates_first"][0]), refs_f["dedup_first"], "F dedup first")
            same_rows(f_host(res["drop_duplicates_last"][0]), refs_f["dedup_last"], "F dedup last")
            gb = res["groupby"][0]
            check_groupby({c: gb._host_physical([c])[c][0] for c in gb.column_names},
                          np.ones(len(refs_f["groupby"]["g"]), bool), "F groupby")
            return
        # world 4: each shard against the plain result's partition
        srt = res["sort_values"][0]
        keys_f64 = g_f.astype(np.float64)  # numpy's range bins on g, float64
        nb = 16 * WORLD
        lo_, hi_ = keys_f64.min(), keys_f64.max()
        bins = np.clip(((keys_f64 - lo_) / max(hi_ - lo_, 1e-300) * nb).astype(np.int32), 0, nb - 1)
        hist = np.bincount(bins, minlength=nb)
        per_part = max(hist.sum() / WORLD, 1.0)
        bin_part = np.clip(((np.cumsum(hist) - hist) / per_part).astype(np.int32), 0, WORLD - 1)
        part = bin_part[bins]
        for d in range(WORLD):
            mine = refs_f["sort"][part[refs_f["sort"]] == d]  # numpy's order, shard d's rows
            got = {c: srt._host_physical_shard(c, d) for c in ("k", "v", "w", "g", "s")}
            # ties on (g, k) may arrive in another order over several rounds:
            # compare the rows in a canonical order, and the (g, k) order
            gk = got["g"][0].astype(np.int64) * N_A + got["k"][0]
            if len(gk) != len(mine) or (len(gk) and (np.diff(gk) < 0).any()):
                fail(f"F4 sort_values: shard {d} out of (g, k) order or of the range bins")
            canon = np.lexsort((got["v"][0].view(np.uint32), got["w"][0].view(np.uint32), gk))
            want_c = np.lexsort((v_f[mine].view(np.uint32), w_f[mine].view(np.uint32),
                                 g_f[mine].astype(np.int64) * N_A + k_f[mine]))
            for c, src in (("k", k_f), ("g", g_f), ("s", s_f)):
                if not np.array_equal(got[c][0][canon], src[mine][want_c]):
                    fail(f"F4 sort_values: shard {d} column {c} differs")
            if not np.array_equal(got["v"][1][canon], ok_f[mine][want_c]):
                fail(f"F4 sort_values: shard {d} v mask differs")
        pid_g = hash_partition_ids([(torch.from_numpy(g_f), None)], None, WORLD).numpy()
        for op, ref in (("drop_duplicates_first", "dedup_first"), ("drop_duplicates_last",
                                                                   "dedup_last")):
            out = res[op][0]
            for d in range(WORLD):
                mine = refs_f[ref][pid_g[refs_f[ref]] == d]
                got = {c: out._host_physical_shard(c, d) for c in ("k", "v", "w", "g", "s")}
                o = np.argsort(got["g"][0], kind="stable")  # one row per g
                same_rows({c: (x[o], None if m is None else m[o]) for c, (x, m) in got.items()},
                          mine[np.argsort(g_f[mine], kind="stable")], f"F4 {op} shard {d}")
        gb = res["groupby"][0]
        keys = refs_f["groupby"]["g"]
        key_pid = hash_partition_ids([(torch.from_numpy(keys), None)], None, WORLD).numpy()
        for d in range(WORLD):
            check_groupby({c: gb._host_physical_shard(c, d)[0] for c in gb.column_names},
                          key_pid == d, f"F4 groupby shard {d}")

    def work_line(tag, world, res):
        return {"workload": tag, "world": world, "rows": n_f,
                "ops": {op: {k_: w[k_] for k_ in ("ms", "input_rows_per_s", "launches",
                                                  "shuffle_plans", "s_all", "tiers")}
                        for op, (_o, w) in res.items()}}

    df_f = frame_f(ctx)
    res_f = run_f(df_f, None, 1)
    gate_f(res_f, 1)
    print(json.dumps({"profile_f": profile(lambda: df_f.groupby("g").agg(AGG_F))}))
    work_f = work_line("F", 1, res_f)
    del res_f, df_f
    df_f4 = frame_f(ctx4)
    res_f4 = run_f(df_f4, env4, WORLD)
    gate_f(res_f4, WORLD)
    work_f4 = work_line("F4", WORLD, res_f4)
    del res_f4, df_f4, fd, refs_f

    # ------------------------------------------------------------------
    # workload SEMI4: run_bench.py config 1b's join (semi_filter_bench's
    # make_pair at 8M rows a side) at world 4, at selectivity 0.10 and
    # 1.00, each beside the same call under sketch.disabled()
    # ------------------------------------------------------------------
    def timed(fn, what, kernels):
        """Warm-up, then REPS_T calls: the first one's output, launches,
        plans and tier gates, and every call's ms."""
        fn()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        times = [time.perf_counter() - t0]
        launches, plan, tier = counts(), list(plans), tiers()
        require_launches(launches, what, kernels)
        for _ in range(REPS_T - 1):
            t0 = time.perf_counter()
            r = fn()
            times.append(time.perf_counter() - t0)
            del r
        return out, {"ms": float(np.median(times)) * 1e3, "ms_all": [t * 1e3 for t in times],
                     "launches": launches, "shuffle_plans": plan, "tiers": tier}

    def shards_equal(a, b, what, sums=()):
        """Shard for shard, column for column: exactly, but the float sums
        ``sums`` within workload A's tolerance."""
        if a.column_names != b.column_names or a.row_counts.tolist() != b.row_counts.tolist():
            fail(f"{what}: names or shard rows differ")
        for d in range(a.world_size):
            for c in a.column_names:
                x, y = a._shards[d][c], b._shards[d][c]
                if (x.valid is None) != (y.valid is None) or (
                        x.valid is not None and not torch.equal(x.valid, y.valid)):
                    fail(f"{what}: shard {d} {c} validity differs")
                if c in sums:
                    err = (x.data.double() - y.data.double()).abs()
                    if not bool((err <= 1e-4 + 1e-5 * y.data.double().abs()).all()):
                        fail(f"{what}: shard {d} {c} max abs err {float(err.max())}")
                elif not torch.equal(x.data, y.data):
                    fail(f"{what}: shard {d} {c} differs")

    def off_if(gate, off):
        return gate.disabled() if off else contextlib.nullcontext()

    work_semi = {"workload": "SEMI4", "world": WORLD, "rows_per_side": N_SEMI,
                 "budget_bytes": ctx4.shuffle_byte_budget, "cells": {}}
    captured_semi = {}
    for sel in (0.10, 1.00):
        ls, rs = make_semi(sel)
        ts_l, ts_r = ctt.Table.from_pydict(ctx4, ls), ctt.Table.from_pydict(ctx4, rs)
        cl_s = torch.bincount(torch.from_numpy(ls["k"]).to(dev).long(), minlength=2 * N_SEMI)
        cr_s = torch.bincount(torch.from_numpy(rs["k"]).to(dev).long(), minlength=2 * N_SEMI)
        n_join_s = int((cl_s * cr_s).sum())
        del ls, rs, cl_s, cr_s
        cell, outs = {}, {}
        for mode in ("filter", "off"):
            def call(off=mode == "off"):
                with off_if(_sketch, off):
                    j = ts_l.distributed_join(ts_r, on="k", how="inner")
                torch.cuda.synchronize()
                return j

            seen.clear()
            outs[mode], m = timed(call, f"SEMI4 sel {sel} {mode}", all_kernels)
            if sel < 0.5 and mode == "filter":
                captured_semi = on_card(seen)
            if outs[mode].row_count != n_join_s:
                fail(f"SEMI4 sel {sel} {mode}: join rows {outs[mode].row_count} != {n_join_s}")
            ctr, shuffles = m["tiers"]["counters"], m["tiers"]["shuffles"]
            sketch_b = ctr.get("semi_filter.sketch_bytes", [0, 0])[1]
            m.update({
                "applied": [None if g["semi_filter"] is None else g["semi_filter"]["applied"]
                            for g in shuffles],
                "rows_pruned": ctr.get("shuffle.semi_filter.pruned_rows", [0, 0])[1],
                "sketch_bytes": sketch_b,
                # rounds x W^2 x bucket_cap x row bytes per table, + the sketches
                "shipped_bytes": sum(k * WORLD * WORLD * bc * g["row_bytes"]
                                     for (bc, k), g in zip(m["shuffle_plans"], shuffles)) + sketch_b,
            })
            cell[mode] = m
        shards_equal(outs["filter"], outs["off"], f"SEMI4 sel {sel}: filtered vs unfiltered rows")
        want_applied = [True, True] if sel < 0.5 else [False, False]
        if cell["filter"]["applied"] != want_applied or cell["off"]["applied"] != [None, None]:
            fail(f"SEMI4 sel {sel}: semi gates {cell['filter']['applied']} / "
                 f"{cell['off']['applied']}, expected {want_applied} / [None, None]")
        work_semi["cells"][f"{sel:.2f}"] = cell
        del outs, ts_l, ts_r
    if "hist_pid" not in captured_semi or not bool(
            (captured_semi["hist_pid"][5] == WORLD).any()):
        fail("SEMI4: B2a got no pid lane with pruned rows (the sentinel P)")

    # ------------------------------------------------------------------
    # workloads PACK (world 1) and PACK4 (world 4): lane_pack_bench's
    # tables at 8M rows, fused beside stats.disabled()
    # ------------------------------------------------------------------
    sort_t, pack_l, pack_r = make_pack()
    tp = ctt.Table.from_pydict(ctx, sort_t)
    a_sorted = np.sort(sort_t["a"])
    del sort_t
    work_pack = {"workload": "PACK", "world": 1, "rows": N_PACK, "cells": {}}
    pack_out, captured_pack = {}, {}
    for mode in ("fused", "plain"):
        def call(off=mode == "plain"):
            with off_if(_stats, off):
                out = tp.sort(["a", "b", "c"])
            torch.cuda.synchronize()
            return out

        seen.clear()
        pack_out[mode], m = timed(call, f"PACK {mode}", local_kernels[:2])
        if mode == "fused":
            captured_pack = on_card(seen)  # the fused uint64 sort word
        m["radix_passes"] = m["launches"]["radix_onesweep"]
        work_pack["cells"][mode] = m
    shards_equal(pack_out["fused"], pack_out["plain"], "PACK: fused vs plain sort")
    if not np.array_equal(pack_out["fused"].column("a").data.cpu().numpy(), a_sorted):
        fail("PACK: the sort's first key is not in order")
    fused_n = work_pack["cells"]["fused"]["tiers"]["counters"].get("lane_pack.sort_fused", [0])[0]
    if fused_n != 1 or work_pack["cells"]["plain"]["tiers"]["counters"]:
        fail(f"PACK: lane_pack.sort_fused {fused_n} (plain: "
             f"{work_pack['cells']['plain']['tiers']['counters']})")
    del pack_out, tp, a_sorted

    tl_p4, tr_p4 = ctt.Table.from_pydict(ctx4, pack_l), ctt.Table.from_pydict(ctx4, pack_r)
    del pack_l, pack_r
    work_pack4 = {"workload": "PACK4", "world": WORLD, "rows_per_side": N_PACK, "cells": {}}
    pack4_out = {}
    for mode in ("fused", "plain"):
        def call(off=mode == "plain"):
            with off_if(_stats, off):
                j = tl_p4.distributed_join(tr_p4, on=["k1", "k2"], how="inner")
                g = j.distributed_groupby(["k1_x", "k2_x"], {"v": "sum", "w": "sum"})
            torch.cuda.synchronize()
            return j, g

        pack4_out[mode], m = timed(call, f"PACK4 {mode}", all_kernels)
        m["wire_row_bytes"] = [g["row_bytes"] for g in m["tiers"]["shuffles"]]
        m["rounds"] = [k for _bc, k in m["shuffle_plans"]]
        work_pack4["cells"][mode] = m
    (jf, gf), (jp, gp) = pack4_out["fused"], pack4_out["plain"]
    shards_equal(jf, jp, "PACK4: fused vs plain join")
    shards_equal(gf, gp, "PACK4: fused vs plain groupby", sums=("v_sum", "w_sum"))
    ctr4 = work_pack4["cells"]["fused"]["tiers"]["counters"]
    for c_ in ("lane_pack.join_fused", "lane_pack.wire.applied"):
        if not ctr4.get(c_):
            fail(f"PACK4: {c_} did not fire ({ctr4})")
    if any(k_.startswith("lane_pack.") for k_ in work_pack4["cells"]["plain"]["tiers"]["counters"]):
        fail("PACK4: lane packing under stats.disabled()")
    del pack4_out, jf, gf, jp, gp, tl_p4, tr_p4

    # ------------------------------------------------------------------
    # workload Q4: run_bench.py config 1a, A4's join (8M rows a side,
    # world 4, 32 MiB budget) under the quantized wire (quant_tol 1e-2)
    # beside the exact wire; then tests/test_quant_wire.py's _pair at 1M
    # rows, matched by row id
    # ------------------------------------------------------------------
    from cylon_tpu_torch.engine import round_cap
    from cylon_tpu_torch.ops.join import INNER
    from cylon_tpu_torch.parallel import pipeline as _pl

    def shipped_bytes():
        return int(_tr.report("shuffle.exchanged_bytes").get(
            "shuffle.exchanged_bytes", {}).get("rows", 0))

    def host_syncs():
        return _tr.get_count("host_sync")

    def with_quant(tol, fn):
        """``fn()`` with ctx4's quant_tol set, its shipped bytes and host syncs."""
        ctx4.add_config("quant_tol", tol)
        try:
            b0, h0 = shipped_bytes(), host_syncs()
            out = fn()
            torch.cuda.synchronize()
            return out, shipped_bytes() - b0, host_syncs() - h0
        finally:
            ctx4.add_config("quant_tol", "")

    def cat_col(t, c):
        return torch.cat([t._shards[d][c].data.to(dev) for d in range(t.world_size)])

    def keys_per_shard_equal(a, b, key, what):
        if a.row_counts.tolist() != b.row_counts.tolist():
            fail(f"{what}: shard rows {a.row_counts.tolist()} != {b.row_counts.tolist()}")
        for d in range(a.world_size):
            if not torch.equal(torch.sort(a._shards[d][key].data).values,
                               torch.sort(b._shards[d][key].data).values):
                fail(f"{what}: shard {d} keys differ as multisets")

    def per_key_sums_close(a, b, key, cols, tol, what):
        """Per key, the sum of each float column within ``tol * max|x| *
        rows of that key`` of the exact call's."""
        ka, kb = cat_col(a, key).long(), cat_col(b, key).long()
        rows = torch.bincount(ka, minlength=N_A).double()
        worst = 0.0
        for c in cols:
            xa, xb = cat_col(a, c).double(), cat_col(b, c).double()
            sa = torch.zeros(N_A, dtype=torch.float64, device=dev).index_add_(0, ka, xa)
            sb = torch.zeros(N_A, dtype=torch.float64, device=dev).index_add_(0, kb, xb)
            bound = tol * float(xa.abs().max()) * rows
            err = (sa - sb).abs()
            if not bool((err <= bound).all()):
                fail(f"{what}: {c} per-key sum off by {float(err.max())}")
            worst = max(worst, float((err / bound.clamp(min=1e-30)).max()))
        return worst

    tl4, tr4 = ctt.Table.from_pydict(ctx4, left), ctt.Table.from_pydict(ctx4, right)
    work_q4 = {"workload": "Q4", "world": WORLD, "rows_per_side": N_A, "quant_tol": 1e-2,
               "budget_bytes": ctx4.shuffle_byte_budget, "cells": {}}
    q4_out = {}
    for mode, tol in (("exact", ""), ("quant", "0.01")):
        if mode == "quant":
            seen.clear()
        out, cell = timed(lambda tol=tol: with_quant(tol, lambda: tl4.distributed_join(
            tr4, on="k", how="inner")), f"Q4_{mode}", all_kernels)
        j_q, bytes_q, _h = out
        cell.update({"shipped_bytes": bytes_q, "join_rows": j_q.row_count,
                     "rounds": [k_ for _b, k_ in cell["shuffle_plans"]],
                     "bucket_cap": [b_ for b_, _k in cell["shuffle_plans"]],
                     "wire_row_bytes": [g_["row_bytes"] for g_ in cell["tiers"]["shuffles"]]})
        work_q4["cells"][mode] = cell
        q4_out[mode] = j_q
        if mode == "quant":
            captured_q4 = on_card(seen)
    if not work_q4["cells"]["quant"]["tiers"]["counters"].get("shuffle.quant.applied"):
        fail(f"Q4: the quantized wire did not apply ({work_q4['cells']['quant']['tiers']})")
    keys_per_shard_equal(q4_out["exact"], q4_out["quant"], "k_x", "Q4")
    work_q4["per_key_err_over_bound"] = per_key_sums_close(
        q4_out["exact"], q4_out["quant"], "k_x", ("v", "w"), 1e-2, "Q4")
    del q4_out
    # the 1M-row pair with row ids: every value within 1e-2 * max|x|
    rng_q = np.random.default_rng(SEED)
    n_q = 1_000_000
    q_left = {"k": rng_q.integers(0, n_q // 20, n_q).astype(np.int32),
              "v": (rng_q.normal(size=n_q) * 10).astype(np.float32),
              "rid": np.arange(n_q, dtype=np.int64)}
    q_right = {"rk": rng_q.integers(0, n_q // 20, n_q // 2).astype(np.int32),
               "w": (rng_q.normal(size=n_q // 2) * 10).astype(np.float32),
               "sid": np.arange(n_q // 2, dtype=np.int64)}
    tq_l, tq_r = ctt.Table.from_pydict(ctx4, q_left), ctt.Table.from_pydict(ctx4, q_right)
    pair = {}
    for mode, tol in (("exact", ""), ("quant", "0.01")):
        j_p, _b, _h = with_quant(tol, lambda: tq_l.distributed_join(tq_r, left_on="k", right_on="rk"))
        order = torch.argsort(cat_col(j_p, "rid") * (n_q // 2) + cat_col(j_p, "sid"))
        pair[mode] = {c: cat_col(j_p, c)[order] for c in ("k", "rid", "sid", "v", "w")}
    for c in ("k", "rid", "sid"):
        if not torch.equal(pair["exact"][c], pair["quant"][c]):
            fail(f"Q4 pair: {c} differs under the quantized wire")
    pair_err = {}
    for c in ("v", "w"):
        ref = pair["exact"][c].double()
        err = float((ref - pair["quant"][c].double()).abs().max())
        pair_err[c] = err / (1e-2 * float(ref.abs().max()))
        if pair_err[c] > 1.0:
            fail(f"Q4 pair: {c} err {err} past 1e-2 * max|x|")
    work_q4["pair_1m"] = {"join_rows": int(pair["exact"]["k"].numel()), "err_over_bound": pair_err}
    del pair, tq_l, tq_r, q_left, q_right

    # ------------------------------------------------------------------
    # workloads FUSED and FUSED4: run_bench.py's dist_inner_join_fused and
    # dist_join_groupby_q3_fused, A's tables at world 1 and A4's at world
    # 4, each beside the eager call
    # ------------------------------------------------------------------
    def rows_sorted(t):
        return t.sort(t.column_names)

    def multisets_equal(a, b, what):
        """Per shard the same rows: both sorted by every column, then equal."""
        shards_equal(rows_sorted(a), rows_sorted(b), what)

    def fused_cell(fn, what, kernels, ref=None):
        (out, _b, h), cell = timed(lambda: with_quant(getattr(fn, "tol", ""), fn), what, kernels)
        cell["host_syncs"] = h
        if ref is not None:
            multisets_equal(out, ref, what)
        return out, cell

    slice_lanes = []
    orig_bsp = _sh.build_slice_plan

    def rec_bsp(pid, sid, world, num_slices):
        def lane(enc, perm, lo, hi):
            slice_lanes.append((enc, perm, lo, hi))
            return rec_lane(enc, perm, lo, hi)

        cuda_radix.radix_sort_lane = lane
        try:
            return orig_bsp(pid, sid, world, num_slices)
        finally:
            cuda_radix.radix_sort_lane = rec_lane

    _sh.build_slice_plan = rec_bsp
    work_fused = {"workload": "FUSED", "world": 1, "rows_per_side": N_A, "cells": {}}
    j_e, work_fused["cells"]["eager"] = fused_cell(
        lambda: tl.distributed_join(tr, on="k"), "FUSED_eager", local_kernels)
    j_f, work_fused["cells"]["fused"] = fused_cell(
        lambda: tl.distributed_join(tr, on="k", mode="fused"), "FUSED", local_kernels, j_e)
    if work_fused["cells"]["fused"]["host_syncs"] != 1:
        fail(f"FUSED: {work_fused['cells']['fused']['host_syncs']} host syncs, not 1")
    del j_e, j_f

    work_fused4 = {"workload": "FUSED4", "world": WORLD, "rows_per_side": N_A,
                   "budget_bytes": ctx4.shuffle_byte_budget, "cells": {}}
    c4 = work_fused4["cells"]
    j_e4, c4["eager"] = fused_cell(lambda: tl4.distributed_join(tr4, on="k"), "FUSED4_eager",
                                   all_kernels)
    seen.clear()
    j_f4, c4["fused"] = fused_cell(lambda: tl4.distributed_join(tr4, on="k", mode="fused"),
                                   "FUSED4", all_kernels, j_e4)
    captured_f4 = on_card(seen)
    print(json.dumps({"profile_fused4": profile(
        lambda: tl4.distributed_join(tr4, on="k", mode="fused")),
        "profile_fused4_eager": profile(lambda: tl4.distributed_join(tr4, on="k"))}))
    slice_lanes.clear()
    # a slice round's send slots come from the slice plan's one K1 sort
    # (the JAX package's slice_round_dest), not from B2b
    _j, c4["fused_slices2"] = fused_cell(
        lambda: tl4.distributed_join(tr4, on="k", mode="fused", num_slices=2),
        "FUSED4_slices2", [k_ for k_ in all_kernels if k_ != "pack_dest"], j_e4)
    if not slice_lanes:
        fail("FUSED4_slices2: build_slice_plan sorted no lane through K1")
    slice_lane = max(slice_lanes, key=lambda a: a[0].shape[0])
    slice_lane = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in slice_lane)

    # A4's rows (k, float32) ship no narrower on the static wire plan (32 +
    # 8 bits fill two words; tests/test_torch_pipeline.py holds that on the
    # CPU); with the right payload float64 the right side rides q8 fields
    # and its rounds carry the scale rows
    tr4d = ctt.Table.from_pydict(ctx4, {"k": right["k"], "w": right["w"].astype(np.float64)})
    j_e4d = tl4.distributed_join(tr4d, on="k")

    def fused_quant_f64():
        return tl4.distributed_join(tr4d, on="k", mode="fused")

    fused_quant_f64.tol = "0.01"
    seen.clear()
    j_fqd, c4["fused_quant_f64"] = fused_cell(fused_quant_f64, "FUSED4_quant_f64", all_kernels)
    captured_f4q = on_card(seen)
    keys_per_shard_equal(j_e4d, j_fqd, "k_x", "FUSED4_quant_f64")
    c4["fused_quant_f64"]["per_key_err_over_bound"] = per_key_sums_close(
        j_e4d, j_fqd, "k_x", ("v", "w"), 1e-2, "FUSED4_quant_f64")
    if captured_f4q["move"][0].shape[1] <= 2:
        fail("FUSED4_quant_f64: B3 moved no q8 scale lane")
    for name in ("fused", "fused_slices2", "fused_quant_f64"):
        if c4[name]["host_syncs"] != 1:
            fail(f"FUSED4 {name}: {c4[name]['host_syncs']} host syncs, not 1")
    del _j, j_f4, j_fqd, j_e4d, tr4d
    # the q3 step at the reference benchmark's capacities, beside the eager
    # join -> groupby-sum; groups against workload A's float64 reference
    cap4 = round_cap(int(tl4.row_counts.max()))
    q3_caps = {"bucket_cap": max(64, 4 * cap4 // WORLD), "join_cap": 4 * cap4,
               "group_cap": 2 * cap4}
    step = _pl.make_join_groupby_step(ctx4, (0,), (0,), 1, INNER, **q3_caps)
    l_in = [tl4._flat_cols(s) for s in range(WORLD)]
    r_in = [tr4._flat_cols(s) for s in range(WORLD)]

    def q3_fused():
        out = step(l_in, r_in)
        total = float(out[3][0])  # the single fetch
        return out, total

    # the pushdown sums in the probe's merged sort: no join emit, no K2
    q3_kernels = list(cuda_radix.LAUNCHES) + list(cuda_codec.LAUNCHES)
    (q3_out, q3_total), c4["q3_fused"] = timed(q3_fused, "FUSED4_q3", q3_kernels)
    print(json.dumps({"profile_q3_fused": profile(q3_fused)}))
    (g_e4, _), c4["q3_eager"] = timed(
        lambda: (tl4.distributed_join(tr4, on="k").distributed_groupby("k_x", {"v": "sum"}), 0),
        "FUSED4_q3_eager", all_kernels)
    sums, ngs = q3_out[0], q3_out[1]
    got_keys, got_sums = [], []
    for d in range(WORLD):
        ng = int(ngs[d])
        if ng != g_e4.row_counts[d]:
            fail(f"FUSED4 q3: shard {d} groups {ng} != eager {g_e4.row_counts[d]}")
        got_keys.append(g_e4._shards[d]["k_x"].data.to(dev).long())
        got_sums.append(sums[d][:ng].to(dev).double())
    gk, gs = torch.cat(got_keys), torch.cat(got_sums)
    ref = (sv * cr)[gk]
    err = (gs - ref).abs()
    if not bool((err <= 1e-4 + 1e-5 * ref.abs()).all()):
        fail(f"FUSED4 q3: group sums max abs err {float(err.max())}")
    total_ref = float((sv * cr)[keys].sum())
    total_tol = 1e-4 + 1e-5 * float(gs.abs().sum())
    if abs(q3_total - total_ref) > total_tol:
        fail(f"FUSED4 q3: total {q3_total} vs {total_ref} (tol {total_tol})")
    c4["q3_fused"].update({"capacities": q3_caps, "total": q3_total, "total_ref": total_ref,
                           "groups": int(sum(int(x) for x in ngs))})
    del q3_out, g_e4, j_e4, step, l_in, r_in, tl4, tr4
    _sh.build_slice_plan = orig_bsp
    print(json.dumps({"smi": smi, **work_q4}))
    print(json.dumps({"smi": smi, **work_fused}))
    print(json.dumps({"smi": smi, **work_fused4}))

    # ------------------------------------------------------------------
    # workloads SKEW8_shuffle, SKEW8_join and SPILL4: the skew split and
    # the spill tiers (ROADMAP A7's first slice), each beside the same
    # call with the split off or at tier 0
    # ------------------------------------------------------------------
    from cylon_tpu_torch.parallel import spill as _spill

    def counter_rows(names):
        rep = _tr.report("shuffle.")
        return {k: [int(rep[k]["count"]), int(rep[k]["rows"])] if k in rep else [0, 0]
                for k in names}

    def with_counters(fn, names, got):
        """``fn()``, with the counters ``names`` it moved left in ``got``."""
        before = counter_rows(names)
        out = fn()
        torch.cuda.synchronize()
        after = counter_rows(names)
        got.clear()
        got.update({k: [after[k][0] - before[k][0], after[k][1] - before[k][1]] for k in names})
        return out

    def _in(cm, fn):
        with cm:
            return fn()

    def gate_cells(what, fn, kernels, off, modes, names):
        """``fn`` in each of ``modes``, the second under the context manager
        ``off()``: (cells with the counters ``names`` each call moved, the
        rounds, bucket caps and each shuffle's cap_o; outputs). The codec
        inputs of the first mode's call are left in ``seen``."""
        cells, outs = {}, {}
        for mode in modes:
            got = {}
            if mode == modes[0]:
                seen.clear()
            out, cell = timed(lambda cm=(contextlib.nullcontext if mode == modes[0] else off):
                              with_counters(lambda: _in(cm(), fn), names, got),
                              f"{what}_{mode}", kernels)
            cell.update({"counters": dict(got),
                         "rounds": [k_ for _b, k_ in cell["shuffle_plans"]],
                         "bucket_cap": [b_ for b_, _k in cell["shuffle_plans"]],
                         "cap_o": [g_["cap_o"] for g_ in cell["tiers"]["shuffles"]]})
            cells[mode], outs[mode] = cell, out
            if mode == modes[0]:
                captured = on_card(seen)
        seen.clear()
        seen.update(captured)
        return cells, outs

    skew_names = ("shuffle.exchanged_bytes", "shuffle.spill.relay_bytes", "shuffle.skew_split",
                  "shuffle.rounds")
    codec_kernels = list(cuda_codec.LAUNCHES)
    ctx8 = ctt.CylonContext.init_distributed(ctt.GPUConfig(world_size=SKEW_WORLD))

    def skew_cells(what, fn, kernels):
        """The split call beside the padded one; the codec inputs of the
        split call are left in ``seen``."""
        cells, outs = gate_cells(what, fn, kernels, _spill.skew_disabled, ("split", "padded"),
                                 skew_names)
        for cell in cells.values():
            got = cell["counters"]
            cell.update({"shipped_bytes": got["shuffle.exchanged_bytes"][1]
                         + got["shuffle.spill.relay_bytes"][1],
                         "relay_rows": got["shuffle.skew_split"][1]})
        if not cells["split"]["relay_rows"] or cells["padded"]["relay_rows"]:
            fail(f"{what}: the skew split did not engage (or engaged when off): {cells}")
        return cells, outs

    # SKEW8_shuffle: spill_bench.py's bench_skew at 8M rows, world 8
    t8 = ctt.Table.from_pydict(ctx8, {"k": np.zeros(N_SKEW, np.int32),
                                      "v": np.arange(N_SKEW, dtype=np.float32)})
    cells, outs = skew_cells("SKEW8_shuffle", lambda: t8.shuffle(["k"]), codec_kernels)
    captured_skew = dict(seen)
    print(json.dumps({"profile_skew8": profile(lambda: t8.shuffle(["k"]))}))
    v_ref = torch.arange(N_SKEW, dtype=torch.float32, device=dev)
    for mode, out in outs.items():
        if out.row_counts.tolist() != outs["split"].row_counts.tolist() or out.row_count != N_SKEW:
            fail(f"SKEW8_shuffle {mode}: shard rows {out.row_counts.tolist()}")
        for d in range(SKEW_WORLD):
            vs = torch.sort(outs["split"]._shards[d]["v"].data).values
            if not torch.equal(vs, torch.sort(out._shards[d]["v"].data).values):
                fail(f"SKEW8_shuffle: shard {d} rows differ between split and padded")
        if not torch.equal(torch.sort(cat_col(out, "v")).values, v_ref):
            fail(f"SKEW8_shuffle {mode}: the rows are not the input's")
    shipped = {m: c["shipped_bytes"] for m, c in cells.items()}
    if shipped["split"] > 0.6 * shipped["padded"]:
        fail(f"SKEW8_shuffle: shipped {shipped}: under 40% fewer bytes")
    work_skew = {"workload": "SKEW8_shuffle", "world": SKEW_WORLD, "rows": N_SKEW,
                 "budget_bytes": ctx8.shuffle_byte_budget, "cells": cells,
                 "bytes_reduction": 1.0 - shipped["split"] / shipped["padded"]}
    del t8, outs, v_ref
    print(json.dumps({"smi": smi, **work_skew}))

    # SKEW8_join: half the left rows on the key of A's right row 0
    rng_j = np.random.default_rng(SEED)
    k_skew = rng_j.integers(0, N_A, N_A).astype(np.int32)
    k_skew[: N_A // 2] = right["k"][0]
    tj8_l = ctt.Table.from_pydict(ctx8, {"k": k_skew, "v": rng_j.normal(size=N_A).astype(np.float32)})
    tj8_r = ctt.Table.from_pydict(ctx8, right)
    cl_j = torch.bincount(torch.from_numpy(k_skew).to(dev).long(), minlength=N_A)
    n_join_j = int((cl_j * cr).sum())
    del cl_j, k_skew
    cells, outs = skew_cells("SKEW8_join", lambda: tj8_l.distributed_join(tj8_r, on="k"),
                             all_kernels)
    for mode, out in outs.items():
        if out.row_count != n_join_j:
            fail(f"SKEW8_join {mode}: join rows {out.row_count} != {n_join_j}")
    multisets_equal(outs["split"], outs["padded"], "SKEW8_join")
    work_skew_j = {"workload": "SKEW8_join", "world": SKEW_WORLD, "rows_per_side": N_A,
                   "join_rows": n_join_j, "budget_bytes": ctx8.shuffle_byte_budget,
                   "cells": cells, "bytes_reduction": 1.0 - cells["split"]["shipped_bytes"]
                   / cells["padded"]["shipped_bytes"]}
    del tj8_l, tj8_r, outs
    print(json.dumps({"smi": smi, **work_skew_j}))

    # FB and SERVE: the feedback re-coster's skew-trigger flip at world 8,
    # and q3_lazy served to eight threads through collect_async
    work_fb = phase_fb(ctt, ctx8, reset_counts, counts, require_launches, all_kernels, smi)
    print(json.dumps({"smi": smi, **work_fb}))
    work_serve = phase_serve(ctt, ctx, left, right, reset_counts, counts, require_launches,
                             list(cuda_radix.LAUNCHES), smi)
    print(json.dumps({"smi": smi, **work_serve}))
    # STREAM: incremental views over appendable tables (stream/)
    t_stream = time.perf_counter()
    work_stream = phase_stream(ctt, ctx, ctx4, left, right, reset_counts, counts,
                               require_launches, smi)
    work_stream["phase_s"] = time.perf_counter() - t_stream

    # SPILL4: spill_bench.py's bench_tier1_join at A4_K4's scale: A4's join
    # at the 4 MiB budget, forced through tiers 1 and 2, beside tier 0
    spill_names = ("shuffle.spill.staged_rounds", "shuffle.spill.staged_bytes",
                   "shuffle.spill.shuffles", "shuffle.rounds")
    ctx4.add_config("shuffle_byte_budget", BUDGET_SMALL)
    sp_l, sp_r = ctt.Table.from_pydict(ctx4, left), ctt.Table.from_pydict(ctx4, right)
    spill_dir = tempfile.TemporaryDirectory(prefix="spill4_")
    os.environ["CYLON_TPU_TORCH_SPILL_DIR"] = spill_dir.name
    work_spill = {"workload": "SPILL4", "world": WORLD, "rows_per_side": N_A,
                  "budget_bytes": BUDGET_SMALL, "cells": {}}
    spill_out = {}
    try:
        for tier in ("0", "1", "2"):
            os.environ["CYLON_TPU_TORCH_SPILL_TIER"] = tier
            got = {}
            out, cell = timed(lambda: with_counters(
                lambda: sp_l.distributed_join(sp_r, on="k", how="inner"), spill_names, got),
                f"SPILL4_tier{tier}", all_kernels)
            gauge_b = _tr.report("shuffle.spill.peak_device_bytes")[
                "shuffle.spill.peak_device_bytes"]["last"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_b = torch.cuda.memory_allocated()
            j_peak = sp_l.distributed_join(sp_r, on="k", how="inner")
            torch.cuda.synchronize()
            peak_join = torch.cuda.max_memory_allocated() - base_b
            del j_peak
            torch.cuda.reset_peak_memory_stats()
            base_b = torch.cuda.memory_allocated()
            s_peak = sp_l.shuffle(["k"])
            torch.cuda.synchronize()
            peak_shuffle = torch.cuda.max_memory_allocated() - base_b
            del s_peak
            if tier == "1":
                print(json.dumps({"profile_spill4_tier1": profile(
                    lambda: sp_l.distributed_join(sp_r, on="k", how="inner"))}))
            cell.update({"counters": dict(got), "peak_device_bytes_gauge": gauge_b,
                         "max_memory_allocated_join": peak_join,
                         "max_memory_allocated_shuffle": peak_shuffle,
                         "rounds": [k_ for _b, k_ in cell["shuffle_plans"]]})
            if tier != "0" and got["shuffle.spill.staged_rounds"][0] != sum(cell["rounds"]):
                fail(f"SPILL4 tier {tier}: staged rounds {got} against rounds {cell['rounds']}")
            work_spill["cells"][f"tier{tier}"] = cell
            spill_out[tier] = out
    finally:
        os.environ.pop("CYLON_TPU_TORCH_SPILL_TIER", None)
        os.environ.pop("CYLON_TPU_TORCH_SPILL_DIR", None)
        ctx4.add_config("shuffle_byte_budget", "")
    print(json.dumps({"smi": smi, **work_spill}))
    if os.listdir(spill_dir.name):
        fail(f"SPILL4: tier 2 left files in its spill dir: {os.listdir(spill_dir.name)}")
    spill_dir.cleanup()
    if _spill.arena_bytes()[0]:
        fail(f"SPILL4: {_spill.arena_bytes()[0]} arena bytes left open")
    for tier in ("1", "2"):
        shards_equal(spill_out["0"], spill_out[tier], f"SPILL4 tier {tier}")
    if spill_out["0"].row_count != n_join:
        fail(f"SPILL4: join rows {spill_out['0'].row_count} != {n_join}")
    sp = work_spill["cells"]
    for key in ("max_memory_allocated_shuffle", "peak_device_bytes_gauge"):
        if not sp["tier1"][key] < sp["tier0"][key]:
            fail(f"SPILL4: tier 1's {key} {sp['tier1'][key]} is not below tier 0's {sp['tier0'][key]}")
    del spill_out, sp_l, sp_r

    # ------------------------------------------------------------------
    # workloads TOPO8_loc, TOPO8_ring and FUSED4_2x2: the two-hop topology
    # exchange (ROADMAP A6 topo), each call beside the same call under
    # topo.disabled() on the same context
    # ------------------------------------------------------------------
    from cylon_tpu_torch.parallel import topo as _topo

    topo_names = ("shuffle.coll_bytes.intra", "shuffle.coll_bytes.inter",
                  "shuffle.coll_bytes.inter_alt", "shuffle.exchanged_bytes", "shuffle.rounds",
                  "shuffle.relay.ring_rows", "shuffle.spill.relay_bytes", "shuffle.skew_split")

    def topo_cells(what, fn, kernels):
        """The two-hop call beside the flat one: (cells, outputs); the codec
        inputs of the two-hop call are left in ``seen``."""
        return gate_cells(what, fn, kernels, _topo.disabled, ("two_hop", "flat"), topo_names)

    def locality_keys(world, inner, seed):
        """tools/topo_smoke.py's locality_shards at N_A rows: 80% of each
        shard's keys hash to its own outer group (the port's murmur3
        partition ids over arange(N_A)), the rest drawn from all of it."""
        rng_t = np.random.default_rng(seed)
        cand = np.arange(N_A, dtype=np.int32)
        pid = hash_partition_ids([(torch.from_numpy(cand).to(dev), None)], None, world).cpu().numpy()
        pools = [cand[(pid // inner) == g] for g in range(world // inner)]
        n_shard = N_A // world
        own = int(n_shard * 0.8)
        keys = np.concatenate([np.concatenate([rng_t.choice(pools[p // inner], own),
                                               rng_t.choice(cand, n_shard - own)])
                               for p in range(world)]).astype(np.int32)
        return keys, rng_t.normal(size=N_A).astype(np.float32)

    work_topo = {"workload": "TOPO8_loc", "world": SKEW_WORLD, "rows_per_side": N_A,
                 "budget_bytes": ctx8.shuffle_byte_budget, "cells": {}}
    captured_topo = {}
    for mesh in ("4x2", "2x4"):
        inner = int(mesh.split("x")[1])
        ctx_m = ctt.CylonContext.init_distributed(ctt.GPUConfig(world_size=SKEW_WORLD,
                                                                mesh_shape=mesh))
        kl_t, vl_t = locality_keys(SKEW_WORLD, inner, 0)
        kr_t, wr_t = locality_keys(SKEW_WORLD, inner, 1)
        tt_l = ctt.Table.from_pydict(ctx_m, {"k": kl_t, "v": vl_t})
        tt_r = ctt.Table.from_pydict(ctx_m, {"k": kr_t, "w": wr_t})
        del kl_t, vl_t, kr_t, wr_t
        for op, fn, kernels in (
                ("shuffle", lambda: tt_l.shuffle(["k"]), codec_kernels),
                ("join", lambda: tt_l.distributed_join(tt_r, on="k"), all_kernels),
                ("q3", lambda: tt_l.distributed_join(tt_r, on="k").distributed_groupby(
                    "k_x", {"v": "sum"}), all_kernels)):
            cells, outs = topo_cells(f"TOPO8_loc_{mesh}_{op}", fn, kernels)
            if op == "q3":
                shards_equal(rows_sorted(outs["two_hop"]), rows_sorted(outs["flat"]),
                             f"TOPO8_loc {mesh} q3", sums=("v_sum",))
            else:
                multisets_equal(outs["two_hop"], outs["flat"], f"TOPO8_loc {mesh} {op}")
            c2 = cells["two_hop"]["counters"]
            if not c2["shuffle.coll_bytes.inter"][1] <= 0.75 * c2["shuffle.coll_bytes.inter_alt"][1]:
                fail(f"TOPO8_loc {mesh} {op}: inter {c2}: not at most 0.75 of the flat exchange's")
            if any(cells["flat"]["counters"][k_][0] for k_ in topo_names[:3]):
                fail(f"TOPO8_loc {mesh} {op}: the flat call bumped a per-axis counter")
            for mode in cells:
                work_topo["cells"][f"{mesh}_{op}_{mode}"] = cells[mode]
            del outs
            if op == "shuffle":
                captured_topo[mesh] = dict(seen)
        if mesh == "4x2":
            print(json.dumps({"profile_topo8_join_4x2": profile(
                lambda: tt_l.distributed_join(tt_r, on="k"))}))
        del tt_l, tt_r
    print(json.dumps({"smi": smi, **work_topo}))

    # TOPO8_ring: SKEW8_shuffle's one-hot table at both meshes, beside the
    # flat split plan (the whole tail through the host relay)
    work_ring = {"workload": "TOPO8_ring", "world": SKEW_WORLD, "rows": N_SKEW, "cells": {}}
    for mesh in ("4x2", "2x4"):
        ctx_m = ctt.CylonContext.init_distributed(ctt.GPUConfig(world_size=SKEW_WORLD,
                                                                mesh_shape=mesh))
        t_hot = ctt.Table.from_pydict(ctx_m, {"k": np.zeros(N_SKEW, np.int32),
                                              "v": np.arange(N_SKEW, dtype=np.float32)})
        cells, outs = topo_cells(f"TOPO8_ring_{mesh}", lambda: t_hot.shuffle(["k"]), codec_kernels)
        if not cells["two_hop"]["counters"]["shuffle.relay.ring_rows"][1] or \
                cells["flat"]["counters"]["shuffle.relay.ring_rows"][0]:
            fail(f"TOPO8_ring {mesh}: the ring did not engage (or engaged flat): {cells}")
        multisets_equal(outs["two_hop"], outs["flat"], f"TOPO8_ring {mesh}")
        for mode in cells:
            cells[mode]["host_relay_bytes"] = cells[mode]["counters"]["shuffle.skew_split"][1] * 8
            work_ring["cells"][f"{mesh}_{mode}"] = cells[mode]
        if mesh == "4x2":
            captured_ring = dict(seen)
        del t_hot, outs
    print(json.dumps({"smi": smi, **work_ring}))

    # FUSED4_2x2: A4's fused join on a 2x2 mesh (the structured two-hop:
    # the same received layout, so the same rows in the same order)
    ctx22 = ctt.CylonContext.init_distributed(ctt.GPUConfig(world_size=WORLD, mesh_shape="2x2"))
    f22_l, f22_r = ctt.Table.from_pydict(ctx22, left), ctt.Table.from_pydict(ctx22, right)
    cells, outs = topo_cells("FUSED4_2x2", lambda: f22_l.distributed_join(
        f22_r, on="k", how="inner", mode="fused"), all_kernels)
    shards_equal(outs["two_hop"], outs["flat"], "FUSED4_2x2")
    if outs["two_hop"].row_count != n_join:
        fail(f"FUSED4_2x2: join rows {outs['two_hop'].row_count} != {n_join}")
    work_fused22 = {"workload": "FUSED4_2x2", "world": WORLD, "mesh": "2x2",
                    "rows_per_side": N_A, "cells": cells}
    del f22_l, f22_r, outs
    print(json.dumps({"smi": smi, **work_fused22}))

    # ------------------------------------------------------------------
    # workloads OOC, OOC4, TASK4 and DAG4: the out-of-core layers (ROADMAP
    # A7's second slice)
    # ------------------------------------------------------------------
    from cylon_tpu_torch.parallel import LogicalTaskPlan
    from cylon_tpu_torch.parallel import dag as _dag
    from cylon_tpu_torch.parallel.ooc import OutOfCoreJoin

    ooc_names = ("shuffle.spill.ooc_joins", "shuffle.spill.shuffles", "shuffle.spill.staged_rounds",
                 "shuffle.spill.staged_bytes", "shuffle.rounds", "shuffle.exchanged_bytes",
                 "shuffle.skew_split")
    ooc_l, ooc_r = make_ooc()

    def ooc_chunks(cols):
        for lo in range(0, N_A, OOC_CHUNK):
            yield {c: v[lo:lo + OOC_CHUNK] for c, v in cols.items()}

    def peak_of(fn):
        """``fn()`` and the device bytes it allocated at its peak beyond
        those allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    def join_rows_sorted(k, v, w):
        """The rows (k, v, w) of a join on k as two int64 words a row, in
        one total order: a multiset compares as equal tensors."""
        a = (k.long() << 32) | (v.view(torch.int32).long() & 0xFFFFFFFF)
        b = w.view(torch.int32).long()
        o = torch.sort(b, stable=True).indices
        o = o[torch.sort(a[o], stable=True).indices]
        return a[o], b[o]

    def ooc_cell(ctx_o, what, kernels, reps):
        """run_bench.py config 5 through OutOfCoreJoin on ``ctx_o``: a
        warm-up, then ``reps`` timed calls from the host chunks, the first
        with its launches, counters and peak device bytes, beside the
        in-memory join of the same host tables (uploaded inside the call)."""
        def call():
            job = OutOfCoreJoin(ctx_o, on="k", how="inner", num_buckets=OOC_BUCKETS)
            return job, job.execute(ooc_chunks(ooc_l), ooc_chunks(ooc_r))

        def in_memory():
            return ctt.Table.from_pydict(ctx_o, ooc_l).distributed_join(
                ctt.Table.from_pydict(ctx_o, ooc_r), on="k", how="inner")

        call()[1].close()
        reset_counts()
        got = {}
        t0 = time.perf_counter()
        (job, sink), peak = peak_of(lambda: with_counters(call, ooc_names, got))
        times = [time.perf_counter() - t0]
        launches = counts()
        require_launches(launches, what, kernels)
        rows = sink.result_pydict()
        res = [torch.from_numpy(np.ascontiguousarray(rows[c])).to(dev) for c in ("k_x", "v", "w")]
        split = job.cost_split
        sink.close()
        for _ in range(reps - 1):
            t0 = time.perf_counter()
            call()[1].close()
            times.append(time.perf_counter() - t0)
        in_memory()
        t0 = time.perf_counter()
        ref, ref_peak = peak_of(in_memory)
        ref_s = time.perf_counter() - t0
        if sink.rows != ref.row_count:
            fail(f"{what}: sink.rows {sink.rows} != the in-memory join's {ref.row_count}")
        got_rows = join_rows_sorted(*res)
        want_rows = join_rows_sorted(*(cat_col(ref, c) for c in ("k_x", "v", "w")))
        if not all(torch.equal(x, y) for x, y in zip(got_rows, want_rows)):
            fail(f"{what}: the rows differ from the in-memory join's as multisets")
        if _spill.arena_bytes()[0]:
            fail(f"{what}: {_spill.arena_bytes()[0]} arena bytes left open")
        del ref, res, got_rows, want_rows
        return {"ms": float(np.median(times)) * 1e3, "ms_all": [t * 1e3 for t in times],
                "launches": launches, "counters": dict(got), "sink_rows": sink.rows,
                "cost_split": split, "max_device_cap": job.max_device_cap,
                "join_phase_device_cap": job.join_phase_device_cap,
                "max_memory_allocated": peak, "in_memory_ms": ref_s * 1e3,
                "in_memory_max_memory_allocated": ref_peak}

    work_ooc = {"workload": "OOC", "world": 1, "rows_per_side": N_A, "chunk_rows": OOC_CHUNK,
                "buckets": OOC_BUCKETS,
                "cells": {"ooc": ooc_cell(ctx, "OOC", local_kernels, REPS_OOC)}}
    print(json.dumps({"smi": smi, **work_ooc}))
    work_ooc4 = {"workload": "OOC4", "world": WORLD, "rows_per_side": N_A,
                 "chunk_rows": OOC_CHUNK, "buckets": OOC_BUCKETS,
                 "budget_bytes": ctx4.shuffle_byte_budget, "cells": {}}
    ooc_dir = tempfile.TemporaryDirectory(prefix="ooc4_")
    try:
        for tier in ("", "2"):
            os.environ["CYLON_TPU_TORCH_SPILL_TIER"] = tier
            os.environ["CYLON_TPU_TORCH_SPILL_DIR"] = ooc_dir.name
            work_ooc4["cells"][f"tier{tier or 'default'}"] = ooc_cell(
                ctx4, f"OOC4_tier{tier or 'default'}", all_kernels, REPS_OOC if not tier else 1)
    finally:
        os.environ.pop("CYLON_TPU_TORCH_SPILL_TIER", None)
        os.environ.pop("CYLON_TPU_TORCH_SPILL_DIR", None)
    if os.listdir(ooc_dir.name):
        fail(f"OOC4: tier 2 left files in its spill dir: {os.listdir(ooc_dir.name)}")
    ooc_dir.cleanup()
    print(json.dumps({"smi": smi, **work_ooc4}))
    del ooc_l, ooc_r

    # TASK4: A's left side at world 4 in T = 12 tasks (examples/
    # task_parallel.py's 3x over-decomposition), beside shuffle(["k"])
    task_t = ctt.Table.from_pydict(ctx4, left)
    task_plan = LogicalTaskPlan(3 * WORLD, WORLD)
    parts, cell_task = timed(lambda: task_t.task_partition(["k"], task_plan), "TASK4",
                             list(cuda_radix.LAUNCHES) + codec_kernels)
    _out, cell_shuffle = timed(lambda: task_t.shuffle(["k"]), "TASK4_shuffle", codec_kernels)
    del _out
    for t_id, p in parts.items():
        owner = task_plan.worker_of(t_id)
        if any(int(c) for w_, c in enumerate(p.row_counts) if w_ != owner):
            fail(f"TASK4: task {t_id}'s rows {p.row_counts.tolist()} are not on worker {owner} alone")
    got_k = torch.cat([cat_col(p, "k") for p in parts.values()])
    got_v = torch.cat([cat_col(p, "v") for p in parts.values()])
    in_k, in_v = torch.from_numpy(left["k"]).to(dev), torch.from_numpy(left["v"]).to(dev)
    if not all(torch.equal(x, y) for x, y in zip(join_rows_sorted(got_k, got_v, got_v),
                                                 join_rows_sorted(in_k, in_v, in_v))):
        fail("TASK4: the tasks' rows are not the input's")
    work_task4 = {"workload": "TASK4", "world": WORLD, "rows": N_A, "tasks": 3 * WORLD,
                  "task_rows": {t_id: p.row_counts.tolist() for t_id, p in parts.items()},
                  "cells": {"task_partition": cell_task, "shuffle": cell_shuffle}}
    del parts, task_t, got_k, got_v, in_k, in_v
    print(json.dumps({"smi": smi, **work_task4}))

    # DAG4: DisJoinOp over A's tables in 8 chunks a side beside
    # distributed_join; DisUnionOp over U's project(["k"]) sides in 8
    # chunks beside distributed_union
    def chunk_tables(cols):
        m = N_A // DAG_CHUNKS
        return [ctt.Table.from_pydict(ctx4, {c: v[i * m:(i + 1) * m] for c, v in cols.items()})
                for i in range(DAG_CHUNKS)]

    dl, dr = chunk_tables(left), chunk_tables(right)
    ul, ur = chunk_tables({"k": left["k"]}), chunk_tables({"k": make_left2()["k"]})
    d_tl, d_tr = ctt.Table.from_pydict(ctx4, left), ctt.Table.from_pydict(ctx4, right)
    u_tl = ctt.Table.from_pydict(ctx4, {"k": left["k"]})
    u_tr = ctt.Table.from_pydict(ctx4, {"k": make_left2()["k"]})
    work_dag4 = {"workload": "DAG4", "world": WORLD, "rows_per_side": N_A, "chunks": DAG_CHUNKS,
                 "cells": {}}
    for op, graph, eager in (
            ("join", lambda: _dag.DisJoinOp(on="k", how="inner").execute(dl, dr),
             lambda: d_tl.distributed_join(d_tr, on="k", how="inner")),
            ("union", lambda: _dag.DisUnionOp(columns=["k"]).execute(ul, ur),
             lambda: u_tl.distributed_union(u_tr))):
        g_out, g_cell = timed(graph, f"DAG4_{op}", all_kernels if op == "join" else
                              list(cuda_radix.LAUNCHES) + codec_kernels)
        e_out, e_cell = timed(eager, f"DAG4_{op}_eager", all_kernels if op == "join" else
                              list(cuda_radix.LAUNCHES) + codec_kernels)
        multisets_equal(g_out, e_out, f"DAG4 {op}")
        if op == "join" and g_out.row_count != n_join:
            fail(f"DAG4: join rows {g_out.row_count} != {n_join}")
        work_dag4["cells"][f"{op}_graph"], work_dag4["cells"][f"{op}_eager"] = g_cell, e_cell
        del g_out, e_out
    del dl, dr, ul, ur, d_tl, d_tr, u_tl, u_tr
    print(json.dumps({"smi": smi, **work_dag4}))

    # ------------------------------------------------------------------
    # workloads IO, IO4, B_IO4 and CAPI: files in and out (ROADMAP A8):
    # the native CSV codec writes A's and B's tables and reads them back,
    # the main path runs on what it read, and the C ABI's client drives it
    # from a program of its own
    # ------------------------------------------------------------------
    from cylon_tpu_torch import native as _native
    from cylon_tpu_torch.io import csv as _csv

    io_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_io_")
    io_dir = io_tmp.name
    t0 = time.perf_counter()
    _native.get_lib()  # g++ at first use
    native_build_s = time.perf_counter() - t0
    sums_a = ("v_sum", "w_sum")

    def io_path(name):
        return os.path.join(io_dir, name)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def write_read(t, paths, ctx_):
        """write_csv then read_csv of ``paths``: (read table, write s, read
        s, file bytes)."""
        _o, w_s = clock(lambda: ctt.write_csv(t, paths))
        got, r_s = clock(lambda: ctt.read_csv(ctx_, paths))
        nbytes = sum(os.path.getsize(p) for p in ([paths] if isinstance(paths, str) else paths))
        return got, w_s, r_s, nbytes

    def join_gb(l_t, r_t):
        j = l_t.distributed_join(r_t, on="k", how="inner")
        return j, j.distributed_groupby("k_x", {"v": "sum", "w": "sum"})

    # IO (world 1): A's tables through one file a side
    wide_l, wide_r = widen(left), widen(right)
    io_l, wl_s, rl_s, bytes_l = write_read(tl, io_path("a_l.csv"), ctx)
    io_r, wr_s, rr_s, bytes_r = write_read(tr, io_path("a_r.csv"), ctx)
    enc_l, parse_s = clock(lambda: _csv._read_one_native(io_path("a_l.csv"), ctt.CSVReadOptions()))
    _t, stage_s = clock(lambda: ctt.Table.from_encoded(ctx, enc_l))
    del enc_l, _t
    ref_l, ref_r = ctt.Table.from_pydict(ctx, wide_l), ctt.Table.from_pydict(ctx, wide_r)
    tables_identical(io_l, ref_l, "IO: the read left side")
    tables_identical(io_r, ref_r, "IO: the read right side")
    (j_io, g_io), cell_io = timed(lambda: join_gb(io_l, io_r), "IO", local_kernels)
    j_ref, g_ref = join_gb(ref_l, ref_r)
    tables_identical(j_io, j_ref, "IO join")
    bits_io = tables_identical(g_io, g_ref, "IO groupby", sums_a)
    if j_io.row_count != n_join:
        fail(f"IO: join rows {j_io.row_count} != {n_join}")
    mb = 1e6
    work_io = {"workload": "IO", "world": 1, "rows_per_side": N_A, "file_bytes": [bytes_l, bytes_r],
               "native_build_s": native_build_s,
               "write_mb_per_s": (bytes_l + bytes_r) / mb / (wl_s + wr_s),
               "read_mb_per_s": (bytes_l + bytes_r) / mb / (rl_s + rr_s),
               "write_s": [wl_s, wr_s], "read_s": [rl_s, rr_s],
               "parse_s_left": parse_s, "staging_ms_left": stage_s * 1e3,
               "sums_bit_equal": bits_io, "cells": {"join_groupby": cell_io}}
    del j_io, g_io, j_ref, g_ref, ref_l, ref_r, io_l, io_r
    print(json.dumps({"smi": smi, **work_io}))

    # IO4 (world 4): one file a shard a side, then one file a side split evenly
    io4 = {}
    for side, cols, wide in (("l", left, wide_l), ("r", right, wide_r)):
        paths = [io_path(f"a4_{side}{s}.csv") for s in range(WORLD)]
        t4 = ctt.Table.from_pydict(ctx4, cols)
        got, w_s, r_s, nbytes = write_read(t4, paths, ctx4)
        offs = np.concatenate([[0], np.cumsum(t4.row_counts)])
        ref4 = ctt.Table.from_shards(ctx4, [{c: v[offs[s]:offs[s + 1]] for c, v in wide.items()}
                                            for s in range(WORLD)])
        tables_identical(got, ref4, f"IO4: the read {side} side, shard for shard")
        even, even_s = clock(lambda: ctt.read_csv(ctx4, io_path(f"a_{side}.csv")))
        tables_identical(even, ctt.Table.from_pydict(ctx4, wide), f"IO4: one file, {side} side")
        io4[side] = (got, ref4, {"write_s": w_s, "read_s": r_s, "file_bytes": nbytes,
                                 "read_one_file_s": even_s})
        del even, t4
    (j4, g4), cell_io4 = timed(lambda: join_gb(io4["l"][0], io4["r"][0]), "IO4", all_kernels)
    j4_ref, g4_ref = join_gb(io4["l"][1], io4["r"][1])
    tables_identical(j4, j4_ref, "IO4 join")
    bits_io4 = tables_identical(g4, g4_ref, "IO4 groupby", sums_a)
    nbytes4 = sum(v[2]["file_bytes"] for v in io4.values())
    work_io4 = {"workload": "IO4", "world": WORLD, "rows_per_side": N_A,
                "sides": {k: v[2] for k, v in io4.items()},
                "write_mb_per_s": nbytes4 / mb / sum(v[2]["write_s"] for v in io4.values()),
                "read_mb_per_s": nbytes4 / mb / sum(v[2]["read_s"] for v in io4.values()),
                "sums_bit_equal": bits_io4, "cells": {"join_groupby": cell_io4}}
    del j4, g4, j4_ref, g4_ref, io4
    print(json.dumps({"smi": smi, **work_io4}))

    # B_IO4: B's orders and customers, four files a side at world 4
    b_tables = {}
    for name, cols in (("orders", orders), ("customers", customers)):
        paths = [io_path(f"b_{name}{s}.csv") for s in range(WORLD)]
        b_tables[name] = write_read(ctt.Table.from_pydict(ctx4, cols), paths, ctx4)
    if b_tables["customers"][0]._ref["segment"].dictionary.tolist() != list(seg_names):
        fail("B_IO4: the unified segment dictionary differs from B's")

    def run_b_io4():
        jb_ = ctt.DataFrame(b_tables["orders"][0]).merge(
            ctt.DataFrame(b_tables["customers"][0]), on="cust", env=env4)
        return jb_, jb_.groupby("segment", env=env4).agg({"price": "sum"}).to_dict()

    (jb_io, gb_io), cell_bio = timed(run_b_io4, "B_IO4", all_kernels)
    b_names, b_want = b_ref
    order = np.argsort(np.asarray(gb_io["segment"], dtype=str))
    if len(jb_io) != N_ORDERS or [gb_io["segment"][i] for i in order] != list(b_names):
        fail("B_IO4: join rows or segments differ from B's")
    if not np.allclose(np.asarray(gb_io["price_sum"], np.float64)[order], b_want, rtol=1e-9, atol=0):
        fail("B_IO4: price sums differ from B's (rtol 1e-9)")
    work_bio4 = {"workload": "B_IO4", "world": WORLD, "orders": N_ORDERS, "customers": N_CUST,
                 "files": {k: {"write_s": v[1], "read_s": v[2], "file_bytes": v[3]}
                           for k, v in b_tables.items()}, "cells": {"merge_groupby": cell_bio}}
    del jb_io, b_tables
    print(json.dumps({"smi": smi, **work_bio4}))

    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, counts()

    work_capi = phase_capi(ctt, ctx, io_dir, counted)
    require_launches(work_capi["cells"]["python_api"]["launches"], "CAPI", local_kernels)
    print(json.dumps({"smi": smi, **work_capi}))
    io_tmp.cleanup()


    cuda_radix.radix_sort_lane, cuda_gather.expand_rows = orig_lane, orig_expand
    cuda_codec.pack_hist, cuda_codec.pack_dest = orig_hist, orig_dest
    cuda_codec.compact_move, _tbl._plan_state = orig_move, orig_plan
    cuda_probe.probe = orig_probe

    mp4_keep = {}
    work_mp4 = phase_mp4(ctt, ctx4, mp4_keep)
    print(json.dumps(work_mp4))
    work_mp2x2 = phase_mp2x2(mp4_keep, smi)
    print(json.dumps(work_mp2x2))
    del mp4_keep
    work_obs = phase_obs(tl, tr, reset_counts, counts, require_launches,
                         {"A": local_kernels, "q3_lazy": list(cuda_radix.LAUNCHES)}, smi)
    print(json.dumps(work_obs))

    # ------------------------------------------------------------------
    # each kernel against its plain version, at the main path's shapes
    # ------------------------------------------------------------------
    def max_err(a, b):
        if a.shape != b.shape:
            fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    def hold_lane(captured):
        """K1a, one K1b pass and the whole lane sort against their plain
        versions on a lane the main path sorted: (lane keys as the kernels
        read them, errors)."""
        enc, perm, lo, hi = captured
        keys_in = enc if perm is None else enc.index_select(0, perm)
        hist = cuda_radix.lane_hist(keys_in, lo, hi)
        bits0 = min(8, hi - lo)
        k1, p1 = cuda_radix.onesweep_pass(keys_in, perm, hist[0], lo, bits0)
        sk, sp = cuda_radix.radix_sort_lane(enc, perm, lo, hi)
        torch.cuda.synchronize()
        e_h = max_err(hist, cuda_radix.lane_hist_plain(keys_in, lo, hi))
        pk1, pp1 = cuda_radix.onesweep_pass_plain(keys_in, perm, lo, bits0)
        psk, psp = cuda_radix.radix_sort_lane_plain(enc, perm, lo, hi)
        e_s = max(max_err(k1, pk1), max_err(p1, pp1), max_err(sk, psk), max_err(sp, psp),
                  max_err(sk, enc.index_select(0, sp)))
        return keys_in, e_h, e_s

    keys32, err_h, err_s = hold_lane(captured_a["radix_32"])
    lo32, hi32 = captured_a["radix_32"][2:]
    # the 64-bit lane: PACK's fused uint64 sort word (and B's 64-bit lane
    # where its join still sorts one)
    if "radix_64" not in captured_pack:
        fail("workload PACK sorted no fused uint64 word")
    for wide in (captured_pack["radix_64"], captured_b.get("radix_64")):
        if wide is not None:
            _k64, err_h64, err_s64 = hold_lane(wide)
            err_h, err_s = max(err_h, err_h64), max(err_s, err_s64)
    srcT, li = captured_a["expand"]
    xk = cuda_gather.expand_rows(srcT, li)
    torch.cuda.synchronize()
    err_x = max_err(xk, cuda_gather.expand_rows_plain(srcT, li))
    if err_h or err_s or err_x:
        fail(f"kernel mismatch: lane_hist {err_h}, onesweep {err_s}, expand {err_x}")

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
    if "move_odd" not in captured_b4:
        fail("workload B4 received no buffer whose rows are not a multiple of 16 bytes")
    move_o, recv_o, o_P, o_bc, o_nh = captured_b4["move_odd"]
    moved_o = cuda_codec.compact_move(move_o, recv_o, o_P, o_bc, o_nh)
    torch.cuda.synchronize()
    err_cm = max(err_cm, max_err(moved_o, cuda_codec.compact_move_plain(
        move_o, recv_o, o_P, o_bc, o_nh)))
    # the range shuffle of S4_K4: B2a in pid mode on its range pid lane, B2b
    # and B3 at its largest round and received buffer
    if "hist_pid" not in captured_s4:
        fail("workload S4_K4 gave B2a no pid lane")
    s_args = captured_s4["hist_pid"]
    s_lane, s_hist = cuda_codec.pack_hist(*s_args)
    torch.cuda.synchronize()
    want_h = cuda_codec.pack_hist_plain(*s_args)
    err_ph_s = max(max_err(s_lane, want_h[0]), max_err(s_hist, want_h[1]))
    sd_args = captured_s4["dest"]
    s_dest = cuda_codec.pack_dest(*sd_args)
    torch.cuda.synchronize()
    err_pd_s = max_err(s_dest, cuda_codec.pack_dest_plain(*sd_args))
    sm_args = captured_s4["move"]
    s_moved = cuda_codec.compact_move(*sm_args)
    torch.cuda.synchronize()
    err_cm_s = max_err(s_moved, cuda_codec.compact_move_plain(*sm_args))
    # SEMI4's semi-filtered side: B2a in pid mode on hash pids with the
    # sentinel P at every row the other side's sketch pruned
    q_args = captured_semi["hist_pid"]
    q_lane, q_hist = cuda_codec.pack_hist(*q_args)
    torch.cuda.synchronize()
    want_q = cuda_codec.pack_hist_plain(*q_args)
    err_ph_q = max(max_err(q_lane, want_q[0]), max_err(q_hist, want_q[1]))
    err_ph_s = max(err_ph_s, err_ph_q)
    err_ph, err_pd, err_cm = max(err_ph, err_ph_s), max(err_pd, err_pd_s), max(err_cm, err_cm_s)
    if err_ph or err_pd or err_cm:
        fail(f"kernel mismatch: pack_hist {err_ph}, pack_dest {err_pd}, compact_move {err_cm}")

    # B5 on the probe of PK's world-1 join (the largest it made)
    p_lk, p_rk, p_rid, p_nb, p_B = captured_pk["probe"]
    got_p = cuda_probe.probe(p_lk, p_rk, p_rid, p_nb, p_B)
    torch.cuda.synchronize()
    err_pk = max_err(got_p, cuda_probe.probe_plain(p_lk, p_rk, p_rid, p_nb, p_B))
    if err_pk:
        fail(f"kernel mismatch: pk_probe {err_pk}")

    # this slice's new paths, each kernel held exactly on that path's own
    # inputs: B2b on Q4's quantized rounds, B3 on Q4's received buffers with
    # their q8 scale lanes and on FUSED4_quant's concatenated rounds, K1 on
    # FUSED4_slices2's combined (slice, pid) sort, K2 on FUSED4's emit
    new_paths = {}
    topo_moves = [(f"topo8_{part}_{mesh}", cap_, key)
                  for mesh, cap_ in (("4x2", captured_topo["4x2"]), ("2x4", captured_topo["2x4"]),
                                     ("ring_4x2", captured_ring))
                  for part, key in (("self", "move_nh0"), ("hop2", "move_nh1"))]
    for tag, cap_, key in [(t_, c_, "move") for t_, c_ in (
            ("q4", captured_q4), ("fused4_quant", captured_f4q), ("skew8", captured_skew))] \
            + topo_moves:
        if key not in cap_:
            fail(f"{tag}: B3 received no buffer ({key})")
        mv = cap_[key]
        got_m = cuda_codec.compact_move(*mv)
        torch.cuda.synchronize()
        new_paths[f"compact_move_{tag}"] = {
            "shape": [mv[2], mv[3], mv[0].shape[1]], "n_header": mv[4],
            "max_abs_err": max_err(got_m, cuda_codec.compact_move_plain(*mv)),
            "ms": cuda_ms(lambda mv=mv: cuda_codec.compact_move(*mv)),
            "plain_ms": cuda_ms(lambda mv=mv: cuda_codec.compact_move_plain(*mv)),
            "bound_ms": (4 * mv[0].numel() + 4 * mv[2] * mv[3] * mv[0].shape[1]) / bw * 1e3}
    for tag, cap_ in (("q4", captured_q4), ("skew8", captured_skew)):
        qd = cap_["dest"]
        got_d = cuda_codec.pack_dest(*qd)
        torch.cuda.synchronize()
        new_paths[f"pack_dest_{tag}"] = {
            "shape": [qd[0].shape[0], qd[3], qd[4]], "round": qd[2],
            "max_abs_err": max_err(got_d, cuda_codec.pack_dest_plain(*qd)),
            "ms": cuda_ms(lambda qd=qd: cuda_codec.pack_dest(*qd)),
            "plain_ms": cuda_ms(lambda qd=qd: cuda_codec.pack_dest_plain(*qd)),
            "bound_ms": (4 * qd[0].shape[0] * 2 + 4 * qd[3] * cuda_codec.n_tiles(qd[0].shape[0]))
            / bw * 1e3}
    _ks, e_hs, e_ss = hold_lane(slice_lane)
    new_paths["radix_slice_plan"] = {
        "shape": [slice_lane[0].shape[0], slice_lane[2], slice_lane[3]],
        "max_abs_err": max(e_hs, e_ss),
        "ms": cuda_ms(lambda: cuda_radix.radix_sort_lane(*slice_lane)),
        "plain_ms": cuda_ms(lambda: cuda_radix.radix_sort_lane_plain(*slice_lane)),
        "bound_ms": 8 * slice_lane[0].shape[0] / bw * 1e3}
    f_src, f_li = captured_f4["expand"]
    got_x = cuda_gather.expand_rows(f_src, f_li)
    torch.cuda.synchronize()
    # the padded emit reads the emitting left rows (the front of the
    # source) and clamps its rows past the output to the last column: count
    # the distinct source columns it reads (li never decreases)
    f_touched = int(torch.unique_consecutive(f_li.clamp(0, f_src.shape[1] - 1)).numel())
    new_paths["expand_rows_fused4"] = {
        "shape": [f_src.shape[0], f_src.shape[1], f_li.numel()],
        "max_abs_err": max_err(got_x, cuda_gather.expand_rows_plain(f_src, f_li)),
        "ms": cuda_ms(lambda: cuda_gather.expand_rows(f_src, f_li)),
        "plain_ms": cuda_ms(lambda: cuda_gather.expand_rows_plain(f_src, f_li)),
        # the padded emit's positions past the output clamp, as in the kernel
        "library_ms": cuda_ms(lambda: torch.index_select(
            f_src, 1, f_li.clamp(0, f_src.shape[1] - 1))),
        "bound_ms": 4 * (f_src.shape[0] * f_touched + f_li.numel()
                         + f_src.shape[0] * f_li.numel()) / bw * 1e3}
    bad = {k_: v_["max_abs_err"] for k_, v_ in new_paths.items() if v_["max_abs_err"]}
    if bad:
        fail(f"kernel mismatch on this slice's paths: {bad}")

    # K1 at the main path's largest 32-bit lane (A's merged kv-sort): the
    # histogram of all its digits, and one pass that carries a perm (the
    # first pass of a lane has none; it is timed too), then the same pass
    # over random full-range keys with a random perm. Each timed pass gets
    # its own zeroed status words, allocated before the timing.
    n, esz = keys32.shape[0], keys32.element_size()
    passes32 = cuda_radix.n_passes(lo32, hi32)
    if passes32 < 2 or hi32 - lo32 < 16:
        fail(f"workload A's largest lane spans [{lo32}, {hi32}): no full second digit to time")
    hist32 = cuda_radix.lane_hist(keys32, lo32, hi32)
    if int(hist32[1].max()) == n:
        fail("workload A's timed digit is one value on every row: K1b would copy it through")
    ident = torch.arange(n, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    keys_rand = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    perm_rand = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    hist_rand = cuda_radix.lane_hist(keys_rand, 0, 32)
    if int(hist_rand[1].max()) == n:
        fail("random keys: the timed digit is one value on every row")
    status = cuda_radix.status_words(n, 3 * REPS + 3, dev).view(3 * REPS + 3, -1)
    bufs = (torch.empty_like(keys32), torch.empty_like(ident))
    calls = iter(range(3 * REPS + 3))

    def sweep(keys, perm, counts, shift):
        return lambda: cuda_radix.onesweep_pass(keys, perm, counts, shift, 8,
                                                status=status[next(calls)], out=bufs)

    ms_h = cuda_ms(lambda: cuda_radix.lane_hist(keys32, lo32, hi32))
    ms_hp = cuda_ms(lambda: cuda_radix.lane_hist_plain(keys32, lo32, hi32))
    ms_s = cuda_ms(sweep(keys32, ident, hist32[1], lo32 + 8))
    ms_s_ident = cuda_ms(sweep(keys32, None, hist32[1], lo32 + 8))
    ms_s_rand = cuda_ms(sweep(keys_rand, perm_rand, hist_rand[1], 8))
    k_r, p_r = cuda_radix.onesweep_pass(keys_rand, perm_rand, hist_rand[1], 8, 8)
    torch.cuda.synchronize()
    pk_r, pp_r = cuda_radix.onesweep_pass_plain(keys_rand, perm_rand, 8, 8)
    err_s = max(err_s, max_err(k_r, pk_r), max_err(p_r, pp_r))
    if err_s:
        fail(f"kernel mismatch: onesweep on random keys {err_s}")
    del keys_rand, perm_rand, k_r, p_r, pk_r, pp_r
    ms_sp = cuda_ms(lambda: cuda_radix.onesweep_pass_plain(keys32, ident, lo32 + 8, 8))
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
    ms_cm_o = cuda_ms(lambda: cuda_codec.compact_move(move_o, recv_o, o_P, o_bc, o_nh))
    ms_cmp_o = cuda_ms(lambda: cuda_codec.compact_move_plain(move_o, recv_o, o_P, o_bc, o_nh))
    lm_o = move_o.shape[1]
    bytes_ph = 4 * cap_h * (words.shape[0] + (0 if valids is None else valids.shape[0]) + 1) \
        + 4 * P * nt_h
    bytes_pd = 4 * cap_d * 2 + 4 * d_P * nt_d
    bytes_cm = 4 * move.numel() + 4 * m_P * m_bc * lm
    bytes_cm_o = 4 * move_o.numel() + 4 * o_P * o_bc * lm_o
    cap_s, P_s = s_args[5].shape[0], s_args[4]
    ms_ph_s = cuda_ms(lambda: cuda_codec.pack_hist(*s_args))
    ms_php_s = cuda_ms(lambda: cuda_codec.pack_hist_plain(*s_args))
    cap_q = q_args[5].shape[0]
    ms_ph_q = cuda_ms(lambda: cuda_codec.pack_hist(*q_args))
    ms_php_q = cuda_ms(lambda: cuda_codec.pack_hist_plain(*q_args))
    bytes_ph_q = 4 * cap_q * 2 + 4 * P_s * cuda_codec.n_tiles(cap_q)
    ms_pd_s = cuda_ms(lambda: cuda_codec.pack_dest(*sd_args))
    ms_pdp_s = cuda_ms(lambda: cuda_codec.pack_dest_plain(*sd_args))
    ms_cm_s = cuda_ms(lambda: cuda_codec.compact_move(*sm_args))
    ms_cmp_s = cuda_ms(lambda: cuda_codec.compact_move_plain(*sm_args))
    # pid mode reads the pid lane and writes the lane and the histogram
    bytes_ph_s = 4 * cap_s * 2 + 4 * P_s * cuda_codec.n_tiles(cap_s)
    sd_cap, sd_P, sd_bc = sd_args[0].shape[0], sd_args[3], sd_args[4]
    bytes_pd_s = 4 * sd_cap * 2 + 4 * sd_P * cuda_codec.n_tiles(sd_cap)
    sm_move, sm_P, sm_bc = sm_args[0], sm_args[2], sm_args[3]
    bytes_cm_s = 4 * sm_move.numel() + 4 * sm_P * sm_bc * sm_move.shape[1]
    touched = int(li.max()) + 1 if n_out else 0
    bytes_h = esz * n + 4 * 256 * passes32  # keys in, counts out
    bytes_s = 2 * (esz + 4) * n  # keys and perm in, keys and perm out
    bytes_x = 4 * L * touched + 4 * n_out + 4 * L * n_out
    ms_p = cuda_ms(lambda: cuda_probe.probe(p_lk, p_rk, p_rid, p_nb, p_B))
    ms_pp = cuda_ms(lambda: cuda_probe.probe_plain(p_lk, p_rk, p_rid, p_nb, p_B), reps=3)
    # B5's bound: its bytes (left key, right key, right id in, result out);
    # its shared-memory hash table answers each left slot in about one probe
    bytes_p = 16 * p_nb * p_B
    bound_p_bytes = bytes_p / bw * 1e3
    # a whole stable argsort of workload A's right keys: one lane sort
    # (a histogram, 4 one-sweep passes) vs torch.sort
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
        # the function: read the keys, write the perm
        "bound_ms": (4 * N_A + 4 * N_A) / bw * 1e3,
        # this design: the histogram's read, a first pass without a perm in
        # (key in, key and perm out), 3 passes of key and perm in and out
        "design_bound_ms": (4 + 12 + 3 * 16) * N_A / bw * 1e3,
    }
    src_radix = "cylon_tpu_torch/csrc/radix_pass.cu"
    src_codec = "cylon_tpu_torch/csrc/shuffle_codec.cu"
    kernels = [
        {"name": "radix_lane_hist", "route": "cuda", "source": src_radix,
         "replaces": "cylon_tpu/ops/pallas_radix.py:86",
         "launches": launches_a["radix_lane_hist"], "max_abs_err": err_h,
         "ms": ms_h, "plain_ms": ms_hp, "bound_ms": bytes_h / bw * 1e3,
         "bound_by": "bytes", "library_ms": None, "shape": [n, esz * 8, passes32]},
        {"name": "radix_onesweep", "route": "cuda", "source": src_radix,
         "replaces": "cylon_tpu/ops/pallas_radix.py:93",
         "launches": launches_a["radix_onesweep"], "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": ms_sp, "bound_ms": bytes_s / bw * 1e3,
         "bound_by": "bytes", "library_ms": None, "shape": [n, esz * 8],
         "ms_identity_perm": ms_s_ident, "bound_ms_identity_perm": (2 * esz + 4) * n / bw * 1e3,
         "ms_random_keys": ms_s_rand},
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
         "shape": [cap_h, len(hv), P], "launches_a4_k4": work_a4k["launches"]["pack_hist"],
         "s4_pid_mode": {"shape": [cap_s, P_s], "max_abs_err": err_ph_s, "ms": ms_ph_s,
                         "plain_ms": ms_php_s, "bound_ms": bytes_ph_s / bw * 1e3,
                         "launches_s4": work_s4["launches"]["pack_hist"],
                         "launches_s4_k4": work_s4k["launches"]["pack_hist"]},
         "semi4_pid_mode": {"shape": [cap_q, P_s], "max_abs_err": err_ph_q, "ms": ms_ph_q,
                            "plain_ms": ms_php_q, "bound_ms": bytes_ph_q / bw * 1e3,
                            "pruned_rows": int((q_args[5] == P_s).sum())}},
        {"name": "shuffle_pack_dest", "route": "cuda", "source": src_codec,
         "replaces": "cylon_tpu/ops/pallas_codec.py:344",
         "launches": work_a4["launches"]["pack_dest"], "max_abs_err": err_pd,
         "ms": ms_pd, "plain_ms": ms_pdp, "bound_ms": bytes_pd / bw * 1e3,
         "bound_by": "bytes", "library_ms": None,
         "shape": [cap_d, d_P, d_bc], "launches_a4_k4": work_a4k["launches"]["pack_dest"],
         "s4_k4": {"shape": [sd_cap, sd_P, sd_bc], "max_abs_err": err_pd_s, "ms": ms_pd_s,
                   "plain_ms": ms_pdp_s, "bound_ms": bytes_pd_s / bw * 1e3,
                   "launches": work_s4k["launches"]["pack_dest"]}},
        {"name": "shuffle_compact_move", "route": "cuda", "source": src_codec,
         "replaces": "cylon_tpu/ops/pallas_codec.py:508",
         "launches": work_a4["launches"]["compact_move"], "max_abs_err": err_cm,
         "ms": ms_cm, "plain_ms": ms_cmp, "bound_ms": bytes_cm / bw * 1e3,
         "bound_by": "bytes", "library_ms": None, "argsort_gather_ms": ms_chain,
         "shape": [m_P, m_bc, lm], "launches_a4_k4": work_a4k["launches"]["compact_move"],
         # B4's largest received buffer whose LM is not a multiple of 4
         "shape_lm_odd": [o_P, o_bc, lm_o], "ms_lm_odd": ms_cm_o, "plain_ms_lm_odd": ms_cmp_o,
         "bound_ms_lm_odd": bytes_cm_o / bw * 1e3,
         "s4_k4": {"shape": [sm_P, sm_bc, sm_move.shape[1]], "max_abs_err": err_cm_s,
                   "ms": ms_cm_s, "plain_ms": ms_cmp_s, "bound_ms": bytes_cm_s / bw * 1e3,
                   "launches": work_s4k["launches"]["compact_move"]}},
        {"name": "pk_probe", "route": "cuda", "source": "cylon_tpu_torch/csrc/pk_probe.cu",
         "replaces": "cylon_tpu/ops/pallas_join.py:82",
         "launches": work_pk["launches"]["pk_probe"], "max_abs_err": err_pk,
         "ms": ms_p, "plain_ms": ms_pp, "bound_ms": bound_p_bytes, "bound_by": "bytes",
         "library_ms": None, "shape": [p_nb, p_B], "bytes": bytes_p,
         "launches_pk4": work_pk4["launches"]["pk_probe"]},
    ]
    by_name = {k["name"]: k for k in kernels}
    by_name["shuffle_pack_dest"]["q4"] = new_paths["pack_dest_q4"]
    by_name["shuffle_pack_dest"]["skew8"] = new_paths["pack_dest_skew8"]
    by_name["shuffle_compact_move"]["skew8"] = new_paths["compact_move_skew8"]
    by_name["shuffle_compact_move"]["q4"] = new_paths["compact_move_q4"]
    by_name["shuffle_compact_move"]["fused4_quant"] = new_paths["compact_move_fused4_quant"]
    by_name["radix_onesweep"]["slice_plan"] = new_paths["radix_slice_plan"]
    by_name["expand_rows"]["fused4"] = new_paths["expand_rows_fused4"]
    for tag, _c, _k in topo_moves:  # B3 on both parts of a two-hop round
        by_name["shuffle_compact_move"][tag] = new_paths[f"compact_move_{tag}"]
    # ptxas's registers and spills of every kernel (the builds' -Xptxas -v)
    usage = {n: _build.resource_usage(n) for n in _build.SOURCES}
    kernel_fn = {"radix_lane_hist": ("radix_pass", "lane_hist_kernel"),
                 "radix_onesweep": ("radix_pass", "onesweep_kernel"),
                 "expand_rows": ("expand_rows", "expand_kernel"),
                 "shuffle_pack_hist": ("shuffle_codec", "pack_hist_kernel"),
                 "shuffle_pack_dest": ("shuffle_codec", "pack_dest_kernel"),
                 "shuffle_compact_move": ("shuffle_codec", "compact_kernel"),
                 "pk_probe": ("pk_probe", "probe_kernel")}
    for k in kernels:
        # launches of this slice's main path: each L / L4 query's first timed call
        ck = k["name"].replace("shuffle_", "")  # its launch counter's key
        k["launches_l"] = {q: v["launches"][ck] for q, v in work_l["queries"].items()}
        k["launches_l4"] = {q: v["launches"][ck] for q, v in work_l4["queries"].items()}
        # this slice's workloads: each variant's first timed call
        for tag, w in (("semi4", work_semi), ("pack", work_pack), ("pack4", work_pack4),
                       ("q4", work_q4), ("fused", work_fused), ("fused4", work_fused4),
                       ("skew8", work_skew), ("skew8_join", work_skew_j), ("spill4", work_spill),
                       ("topo8_loc", work_topo), ("topo8_ring", work_ring),
                       ("fused4_2x2", work_fused22), ("ooc", work_ooc), ("ooc4", work_ooc4),
                       ("task4", work_task4), ("dag4", work_dag4), ("io", work_io),
                       ("io4", work_io4), ("b_io4", work_bio4), ("capi", work_capi),
                       ("fb", work_fb), ("serve", work_serve), ("stream", work_stream)):
            cells = w["cells"].items()
            if tag == "semi4":
                cells = [(f"{sel}_{mode}", m) for sel, c in w["cells"].items() for mode, m in c.items()]
            k[f"launches_{tag}"] = {name: m["launches"].get(ck, 0) for name, m in cells}
        # MP2x2's ranks (two shards each) and OBS's traced calls
        k["launches_mp2x2"] = {op: [ln[ck] for ln in work_mp2x2["launches"][op]]
                               for op in MP2X2_OPS}
        k["launches_obs"] = {name: c["launches_traced"].get(ck, 0)
                             for name, c in work_obs["cells"].items()}
        src, fn = kernel_fn[k["name"]]
        k["ptxas"] = {m: u for m, u in usage[src].items() if fn in m}
        if not k["ptxas"]:
            fail(f"no ptxas report for {k['name']} ({fn} in {src}.cu)")
    print(json.dumps({"argsort": argsort, "peak_bw_bytes_per_s": bw}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(work_a))
    print(json.dumps(work_b))
    print(json.dumps(work_a4))
    print(json.dumps(work_a4k))
    print(json.dumps(work_b4))
    print(json.dumps(work_pk))
    print(json.dumps(work_pk4))
    print(json.dumps(work_dup))
    for w in (work_s, work_s4, work_s4k, work_u, work_u4, work_o, work_f, work_f4, work_l, work_l4,
              work_semi, work_pack, work_pack4):
        print(json.dumps(w))
    print(json.dumps({k_: v_ for k_, v_ in work_stream.items() if k_ != "cells"}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp4-worker"]:
        rank_, world_, address_, backend_, out_dir_, io_dir_, per_, ops_ = sys.argv[2:10]
        mp4_worker(int(rank_), int(world_), address_, backend_, out_dir_, io_dir_, int(per_), ops_)
    else:
        main(mp4_only=sys.argv[1:] == ["--mp4"])
