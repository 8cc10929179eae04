"""One rank of the port's multi-process tests, the cases every rank runs,
and the launcher and comparisons of the tests that start the ranks.

    python tests/_torch_mp_worker.py RANK WORLD INIT_URL OUT_DIR DEVICE BACKEND [CASE ...]

joins a ``torch.distributed`` group through ``GPUConfig(coordinator_address=
INIT_URL, num_processes=WORLD, process_id=RANK)``, runs the cases (default:
all) on its one shard and pickles what each output holds on that shard to
``OUT_DIR/rankRANK.pkl``. A WORLD of ``PxL`` starts P processes of L shards
each (``GPUConfig(devices=[DEVICE] * L, ...)``), a world of P L shards. The same case functions run in the test process
on ``LocalCommunicator`` (every shard in one process) and, for the cases in
``SHARED``, on the JAX package, so the tests hold rank d's shard against
shard d of both. This module imports only torch, numpy and cylon_tpu_torch.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

import cylon_tpu_torch as ctt  # noqa: E402
from cylon_tpu_torch.column import Column  # noqa: E402
from cylon_tpu_torch.ops import pk_join  # noqa: E402
from cylon_tpu_torch.parallel import spill as _spill  # noqa: E402

SEED = 7
AGG_COMBINE = {"v": "sum", "a": "min", "w": "max"}          # pre-combined per shard
AGG_FULL = {"v": ["sum", "mean"], "a": ["count", "max"], "w": "sum"}  # shuffled raw
WORDS = np.array([f"w{i:03d}" for i in range(60)], dtype=object)
#: the port's kill switches of its two default-on shuffle tiers: the tests
#: run the ranks with them set, as they hold the JAX side with its own set
PORT_NO_TIERS = ("CYLON_TPU_TORCH_NO_SEMI_FILTER", "CYLON_TPU_TORCH_NO_LANE_PACK")


def port_encode(cols):
    return OrderedDict((k, Column.encode_host(np.asarray(v))) for k, v in cols.items())


@contextlib.contextmanager
def budget(ctx, n):
    """A per-round shuffle byte budget for the calls inside."""
    ctx.add_config("shuffle_byte_budget", str(n))
    try:
        yield
    finally:
        ctx.add_config("shuffle_byte_budget", "")


def _sides(rng, n_l, n_r, keyspace):
    left = {
        "k": rng.integers(0, keyspace, n_l).astype(np.int32),
        "v": rng.normal(size=n_l).astype(np.float32),
        "a": rng.integers(-50, 50, n_l).astype(np.int32),
    }
    right = {"k": rng.integers(0, keyspace, n_r).astype(np.int32), "w": rng.normal(size=n_r)}
    return left, right


# ----------------------------------------------------------------------
# cases run by the port on both communicators and by the JAX package:
# fn(Table, ctx, encode) -> {name: Table or scalar}
# ----------------------------------------------------------------------

def case_join_groupby(T, ctx, enc):
    """distributed_join -> distributed_groupby at a byte budget small enough
    for several rounds."""
    left, right = _sides(np.random.default_rng(SEED), 700, 600, 300)
    tl, tr = T.from_encoded(ctx, enc(left)), T.from_encoded(ctx, enc(right))
    with budget(ctx, ctx.world_size * 32 * 16):
        j = tl.distributed_join(tr, on="k", how="inner")
        return {"join": j, "combine": j.distributed_groupby("k_x", AGG_COMBINE),
                "full": j.distributed_groupby("k_x", AGG_FULL)}


def case_skew(T, ctx, enc):
    """A skewed key (70% of the left rows) and a right side with an empty
    last shard; a left join."""
    rng = np.random.default_rng(SEED + 1)
    left, right = _sides(rng, 600, ctx.world_size - 1, 40)
    left["k"][rng.random(600) < 0.7] = 7
    right["k"][:] = 7
    tl, tr = T.from_encoded(ctx, enc(left)), T.from_encoded(ctx, enc(right))
    j = tl.distributed_join(tr, on="k", how="left")
    return {"join": j, "full": j.distributed_groupby("k_x", AGG_FULL)}


def case_sort(T, ctx, enc):
    """distributed_sort on a float64 key with nulls, ascending, and on
    (float32 key with nulls descending, int key)."""
    rng = np.random.default_rng(SEED + 2)
    n = 500
    f = rng.normal(size=n)
    f[rng.random(n) < 0.1] = np.nan  # nulls
    g = rng.choice([-1.5, 0.0, 2.5, np.nan], n).astype(np.float32)
    t = T.from_encoded(ctx, enc({"f": f, "g": g, "k": rng.integers(0, 9, n).astype(np.int32)}))
    with budget(ctx, ctx.world_size * 64 * 16):
        return {"asc": t.distributed_sort("f"),
                "desc": t.distributed_sort(["g", "k"], [False, True])}


def case_setops(T, ctx, enc):
    """The distributed set operations on tables whose string columns have
    different dictionaries, and distributed_unique keeping the last and
    (keep=False) the first."""
    rng = np.random.default_rng(SEED + 3)

    def side(n, words):
        return {"k": rng.integers(0, 12, n).astype(np.int32),
                "f": rng.choice([0.5, -0.0, 0.0, 1.5], n), "s": rng.choice(words, n)}

    a = T.from_encoded(ctx, enc(side(300, WORDS[:40])))
    b = T.from_encoded(ctx, enc(side(200, WORDS[20:])))
    return {"union": a.distributed_union(b), "subtract": a.distributed_subtract(b),
            "intersect": a.distributed_intersect(b),
            "unique_last": a.distributed_unique(["k"], keep="last"),
            "unique_false": a.distributed_unique(["k", "s"], keep=False)}


def case_aggregates(T, ctx, enc):
    """Whole-table sum/count/min/max/mean/minmax: integers, float64 with
    nulls, float32, and min/max of a string column."""
    rng = np.random.default_rng(SEED + 4)
    n = 400
    f = rng.normal(size=n) * 1e3
    f[rng.random(n) < 0.2] = np.nan
    t = T.from_encoded(ctx, enc({
        "i": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "l": rng.integers(-2**40, 2**40, n).astype(np.int64),
        "f": f, "h": rng.normal(size=n).astype(np.float32), "s": rng.choice(WORDS, n),
    }))
    out = {}
    for c in ("i", "l", "f", "h"):
        out.update({f"{op}_{c}": getattr(t, op)(c) for op in ("sum", "count", "min", "max", "mean")})
        out[f"minmax_{c}"] = t.minmax(c)
    out.update({"count_s": t.count("s"), "min_s": t.min("s"), "max_s": t.max("s"),
                "minmax_s": t.minmax("s")})
    return out


SHARED = OrderedDict([
    ("join_groupby", case_join_groupby), ("skew", case_skew), ("sort", case_sort),
    ("setops", case_setops), ("aggregates", case_aggregates),
])


# ----------------------------------------------------------------------
# cases of the port alone: fn(env) -> {name: Table, host value or scalar}
# ----------------------------------------------------------------------

def case_pk(env):
    """The PK join (kernel B5's path) -> groupby with unique right keys,
    then a duplicate right key, which must fall back to the sort join on
    every rank, once."""
    ctx = env.context
    rng = np.random.default_rng(SEED + 5)
    r_key = rng.permutation(np.arange(2000, dtype=np.int32))[:600]
    left = {"k": rng.choice(r_key, 800), "v": rng.normal(size=800).astype(np.float32)}
    right = {"k": r_key, "w": rng.normal(size=600).astype(np.float32)}
    T = ctt.Table
    tl, tr = T.from_pydict(ctx, left), T.from_pydict(ctx, right)
    before = pk_join.COUNTS["fallback"]
    j = tl.distributed_join(tr, on="k", algorithm="pallas_pk")
    g = j.distributed_groupby("k_x", {"v": "sum", "w": "sum"})
    clean = pk_join.COUNTS["fallback"] - before
    dup = dict(right, k=r_key.copy())
    dup["k"][11] = dup["k"][5]
    td = T.from_pydict(ctx, dup)
    jd = tl.distributed_join(td, on="k", algorithm="pallas_pk")
    fallbacks = pk_join.COUNTS["fallback"] - before - clean
    return {"join": j, "groupby": g, "dup": jd, "dup_sort": tl.distributed_join(td, on="k"),
            "fallbacks_clean": clean, "fallbacks_dup": fallbacks}


def case_ingest(env):
    """Table.from_encoded_shards: each rank encodes only its own block
    (remote entries None, global counts); one shard gives a validity mask
    and the others none; one shard is empty; the string dictionary is
    unified beforehand. Then host reads, filter, take and a groupby."""
    ctx = env.context
    w = ctx.world_size
    rng = np.random.default_rng(SEED + 6)
    counts = np.array([5 + 7 * s for s in range(w)], np.int64)
    counts[-1] = 0
    n = int(counts.sum())
    offs = np.concatenate([[0], np.cumsum(counts)])
    x = rng.normal(size=n)
    x[:counts[0]:3] = np.nan  # nulls in shard 0 only
    codes, _valid, str_t, dictionary = Column.encode_host(rng.choice(WORDS[:9], n))
    k = rng.integers(0, 20, n).astype(np.int32)

    def block(s):
        lo, hi = int(offs[s]), int(offs[s + 1])
        cols = port_encode({"k": k[lo:hi], "x": x[lo:hi]})
        cols["s"] = (codes[lo:hi], None, str_t, dictionary)
        return cols

    shards = [block(s) if s in ctx.local_shards else None for s in range(w)]
    t = ctt.Table.from_encoded_shards(ctx, shards, counts)
    keep = np.arange(n) % 2 == 0
    return {"table": t, "filter": t.filter(keep), "take": t.take([0, -1, n // 2, 3]),
            "groupby": t.distributed_groupby("s", {"x": "sum", "k": "max"}),
            "host": t.to_pydict(), "column_x": t.column("x").data.cpu().numpy()}


def case_env(env):
    ctx = env.context
    return {"rank": env.rank, "ctx_rank": ctx.rank, "world": env.world_size,
            "local_shards": list(ctx.local_shards), "neighbours": ctx.get_neighbours(),
            "is_distributed": env.is_distributed}


def case_frame(env):
    """The flow of examples/join_groupby.py: DataFrame.merge -> groupby ->
    to_pandas, whole on every rank."""
    rng = np.random.default_rng(SEED + 7)
    orders = {"cust": rng.integers(0, 60, 500), "price": rng.gamma(2.0, 50.0, 500)}
    customers = {"cust": np.arange(60), "segment": rng.choice(["consumer", "corporate", "home"], 60)}
    df_o = ctt.DataFrame(orders, ctx=env.context)
    df_c = ctt.DataFrame(customers, ctx=env.context)
    joined = df_o.merge(df_c, on="cust", env=env)
    by_seg = joined.groupby("segment", env=env).agg({"price": "sum"})
    return {"joined": joined.to_pandas(), "by_segment": by_seg.to_pandas()}


def case_surface(env):
    """The DataFrame and Table surface's steps that gather from every rank:
    the raw-row distributed_groupby of var/std/nunique/median, the
    pipeline groupby, dropna of columns (null counts), astype to strings
    and applymap (host round trips), loc by a list of labels and iloc by
    positions (global), concat(axis=1) through distributed_join, equals
    unordered, compute.nunique."""
    rng = np.random.default_rng(SEED + 9)
    n = 300
    v = rng.normal(size=n)
    v[rng.random(n) < 0.2] = np.nan
    s = rng.choice(WORDS[:8], n).astype(object)
    s[rng.random(n) < 0.1] = None
    t = ctt.Table.from_encoded(env.context, port_encode({
        "k": rng.integers(0, 25, n).astype(np.int32), "v": v, "s": s,
        "f": rng.normal(size=n).astype(np.float32)}))
    ti = t.set_index("k")
    other = t.project(["k", "f"]).add_suffix("_b").set_index("k_b")
    return {
        "groupby": t.distributed_groupby("k", {"v": ["var", "std", "nunique", "median"],
                                               "s": "nunique"}),
        "pipeline": t.distributed_pipeline_groupby("k", {"f": ["sum", "median"]}),
        "fillna_s": t.project(["s"]).fillna("zz"), "fillna_v": t.project(["v"]).fillna(0.5),
        "dropna_cols": t.dropna(axis=0),
        "dropna_rows": t.dropna(axis=1), "astype_str": t.astype({"k": str}),
        "isin": t.isin([3, 4.0, "w001"]), "where": t.where(t.project(["f"]) > 0, 0),
        "applymap": t.project(["k", "s"]).applymap(lambda x: x),
        "select_rows": t.select_rows(lambda r: r["k"] % 3 == 0),
        "loc_list": ti.loc[[3, 99, 7, 3]], "loc_slice": ti.loc[5:9],
        "iloc_list": t.iloc[[7, 2, 250]], "iloc_slice": t.iloc[40:260],
        "concat1": ctt.Table.concat([ti, other], axis=1, join="outer", distributed=True),
        "equals": t.equals(t, ordered=False), "nunique": ctt.compute.nunique(t.project(["s"])),
    }


def case_overflow(env):
    """A join whose output passes ``ops.join.MAX_ROWS`` rows on shard 0
    alone: a hot key that hashes to shard 0 on both sides, a few rows of a
    key that hashes to shard 1. Run with the limit lowered (``main``), it
    must raise on every rank."""
    from cylon_tpu_torch.ops.partition import hash_partition_ids

    cand = torch.arange(64, dtype=torch.int32)
    pid = hash_partition_ids([(cand, None)], None, env.world_size)
    hot, cold = int(cand[pid == 0][0]), int(cand[pid == 1][0])
    keys = np.array([hot] * 60 + [cold] * 3, np.int32)
    t = ctt.Table.from_encoded(env.context, port_encode({"k": keys, "v": np.arange(63.0)}))
    return {"join": t.distributed_join(t, on="k")}


@contextlib.contextmanager
def tiers_on():
    """The port's semi filter and lane packing at their defaults (on) for
    the calls inside, whatever the process's environment says."""
    saved = {k: os.environ.pop(k) for k in PORT_NO_TIERS if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def case_semi(env):
    """A semi-filtered distributed_join, the tiers at their defaults: the
    right keys are 10% of the left ones, so the pair's key sketches (one
    all_gather of both sides' words) prune the rest before the exchange."""
    from cylon_tpu_torch.utils import tracing

    rng = np.random.default_rng(SEED + 11)
    n = 1600
    lk = rng.permutation(n).astype(np.int32)
    rk = np.concatenate([rng.choice(lk, n // 10, replace=False), np.arange(n, 2 * n - n // 10)])
    a = ctt.Table.from_encoded(env.context, port_encode(
        {"k": lk, "v": rng.normal(size=n).astype(np.float32)}))
    b = ctt.Table.from_encoded(env.context, port_encode(
        {"k": rng.permutation(rk).astype(np.int32), "w": rng.normal(size=n)}))
    with tiers_on():
        before = tracing.get_count("shuffle.semi_filter.applied")
        j = a.distributed_join(b, on="k")
        applied = tracing.get_count("shuffle.semi_filter.applied") - before
    return {"join": j, "applied": applied}


def case_lazy(env):
    """The lazy q3 (join -> groupby-sum, the fused join-sum), the same
    query with a filter after the join (pushed below it), and the
    two-aggregate form (order_reuse: the key-order join emit). Every rank
    optimizes the same plan from host-side facts alone, so every rank
    takes the same shuffles."""
    rng = np.random.default_rng(SEED + 10)
    left = {"k": rng.integers(0, 200, 500).astype(np.int32), "v": rng.normal(size=500).astype(np.float32)}
    right = {"rk": rng.permutation(200).astype(np.int32), "w": rng.normal(size=200).astype(np.float32)}
    a = ctt.Table.from_encoded(env.context, port_encode(left)).lazy()
    b = ctt.Table.from_encoded(env.context, port_encode(right)).lazy()
    j = a.join(b, left_on="k", right_on="rk")
    return {"q3": j.groupby("k", {"v": "sum"}).collect(),
            "filtered": j.filter(ctt.col("w") > 0.0).groupby("k", {"v": "sum"}).collect(),
            "multi": j.groupby("k", {"v": ["sum", "mean"]}).collect()}


def case_fused(env):
    """distributed_join(mode="fused"): the inner join in one attempt (one
    host read, counted), and the outer join in two hash slices. Inside the
    step every rank issues the same all_to_alls and overflow all_reduces,
    with no host count exchange."""
    from cylon_tpu_torch.utils import tracing

    left, right = _sides(np.random.default_rng(SEED + 12), 600, 500, 300)
    a = ctt.Table.from_encoded(env.context, port_encode(left))
    b = ctt.Table.from_encoded(env.context, port_encode(right))
    before = tracing.get_count("host_sync")
    j = a.distributed_join(b, on="k", mode="fused")
    syncs = tracing.get_count("host_sync") - before
    o = a.distributed_join(b, on="k", how="outer", mode="fused", num_slices=2)
    return {"inner": j, "outer_sliced": o, "host_syncs": syncs}


def case_out_of_core(env):
    """task_partition with T = 3W (each task's rows on its owner only) and
    the out-of-core join in 4 buckets of 3000 x 1500 rows in chunks of
    500: the ingest's caller-owned sinks take each rank's shards, every
    rank plans the same buckets (one host gather) and stages its own shard
    of each pair (``Table.from_shards``); the join's rows, a shard each,
    come back as one table."""
    from cylon_tpu_torch.parallel import LogicalTaskPlan
    from cylon_tpu_torch.parallel.ooc import OutOfCoreJoin

    ctx = env.context
    world = ctx.world_size
    rng = np.random.default_rng(SEED + 15)
    t = ctt.Table.from_encoded(ctx, port_encode(
        {"k": rng.integers(0, 300, 900), "v": rng.normal(size=900),
         "s": WORDS[rng.integers(0, 60, 900)]}))
    out = {f"task{i}": p for i, p in t.task_partition(["k"], LogicalTaskPlan(3 * world, world)).items()}
    cols = {"k": rng.integers(0, 4000, 4500).astype(np.int32), "v": rng.normal(size=4500)}

    def chunks(lo, hi):
        for a in range(lo, hi, 500):
            yield {c: v[a:a + 500] for c, v in cols.items()}

    job = OutOfCoreJoin(ctx, on="k", num_buckets=4)
    sink = job.execute(chunks(0, 3000), chunks(3000, 4500))
    out["ooc"] = ctt.Table.from_shards(ctx, [
        sink.result_pydict(shard=s) if s in ctx.local_shards else None for s in range(world)])
    out["ooc_rows"] = sink.rows
    sink.close()
    return out


def case_skew8(env):
    """A one-hot shuffle and a skewed join at world 8, where the skew split
    engages: each rank's hot-bucket tail crosses the host relay, one host
    all_to_all over gloo, and lands on its owner rank; the join again
    under tier 1, each rank's rounds and relayed rows into its arena."""
    from cylon_tpu_torch.utils import tracing

    n = 4096
    t = ctt.Table.from_encoded(env.context, port_encode(
        {"k": np.zeros(n, np.int32), "v": np.arange(n, dtype=np.float32)}))
    rng = np.random.default_rng(SEED + 13)
    k = np.where(rng.random(n) < 0.5, 3, rng.integers(0, 500, n)).astype(np.int32)
    a = ctt.Table.from_encoded(env.context, port_encode({"k": k, "v": rng.normal(size=n)}))
    b = ctt.Table.from_encoded(env.context, port_encode(
        {"k": rng.integers(0, 500, 300).astype(np.int32), "w": rng.normal(size=300)}))
    before = tracing.get_count("shuffle.skew_split")
    out = {"shuffle": t.shuffle(["k"]), "join": a.distributed_join(b, on="k")}
    os.environ["CYLON_TPU_TORCH_SPILL_TIER"] = "1"  # each rank stages its shard in host arenas
    try:
        out["join_tier1"] = a.distributed_join(b, on="k")
    finally:
        del os.environ["CYLON_TPU_TORCH_SPILL_TIER"]
    out["relays"] = tracing.get_count("shuffle.skew_split") - before
    return out


def rank_config(url, procs, rank, device, backend, per, **kw):
    """A rank's GPUConfig: one shard on ``device``, or ``per`` shards on it."""
    where = dict(devices=[device] * per) if per > 1 else dict(device=device)
    return ctt.GPUConfig(coordinator_address=url, num_processes=procs, process_id=rank,
                         backend=backend, **where, **kw)


def mesh_context(env, mesh):
    """A context over ``env``'s shards declared with a 2-D ``mesh``: under
    torch.distributed on the same process group (the groups' chunks
    routed through the whole group), else in this process."""
    ctx = env.context
    if RANK_ARGS:
        url, device, backend, per = RANK_ARGS
        return ctt.CylonContext.init_distributed(rank_config(
            url, ctx.world_size // per, ctx.rank, device, backend, per, mesh_shape=mesh))
    return ctt.CylonContext.init_distributed(ctt.GPUConfig(
        device=ctx.device, world_size=ctx.world_size, mesh_shape=mesh))


def case_topo8(env):
    """The two-hop exchange at 4x2 over eight shards: a shuffle of keys of
    which 80% hash to the shard's own outer group, a one-hot shuffle whose
    same-group relay tail rides the ring of ``ppermute`` steps, and a
    join; the grouped all_to_alls ride the whole process group."""
    from cylon_tpu_torch.ops.partition import hash_partition_ids
    from cylon_tpu_torch.utils import tracing

    ctx = mesh_context(env, "4x2")
    rng = np.random.default_rng(SEED + 14)
    cand = np.arange(20000, dtype=np.int32)
    pid = hash_partition_ids([(torch.from_numpy(cand), None)], None, 8).numpy()
    pools = [cand[(pid // 2) == g] for g in range(4)]
    k = np.concatenate([np.concatenate([rng.choice(pools[p // 2], 400), rng.choice(cand, 100)])
                        for p in range(8)]).astype(np.int32)
    t = ctt.Table.from_encoded(ctx, port_encode({"k": k, "v": rng.normal(size=k.size)}))
    hot = ctt.Table.from_encoded(ctx, port_encode(
        {"k": np.zeros(4096, np.int32), "v": np.arange(4096, dtype=np.float32)}))
    b = ctt.Table.from_encoded(ctx, port_encode(
        {"k": rng.choice(cand, 300).astype(np.int32), "w": rng.normal(size=300)}))
    names = ("shuffle.coll_bytes.inter", "shuffle.coll_bytes.inter_alt", "shuffle.relay.ring_rows")

    def rows(n):
        return int(tracing.report(n).get(n, {}).get("rows", 0))

    before = {n: rows(n) for n in names}
    out = {"locality": t.shuffle(["k"]), "ring": hot.shuffle(["k"]),
           "join": t.distributed_join(b, on="k")}
    out.update({n: rows(n) - before[n] for n in names})
    ctx.finalize()
    return out


#: the counter of the bytes that cross between outer groups
INTER_BYTES = "shuffle.coll_bytes.inter"


def mesh2x2_calls(T, ctx, enc, report):
    """A shuffle and a join on a context declared 2x2, through the
    two-hop exchange, and the cross-outer bytes they ship (``report`` the
    package's ``tracing.report``); run by the port and by the JAX
    package."""
    left, right = _sides(np.random.default_rng(SEED + 16), 800, 500, 300)
    a, b = T.from_encoded(ctx, enc(left)), T.from_encoded(ctx, enc(right))
    before = int(report(INTER_BYTES).get(INTER_BYTES, {}).get("rows", 0))
    out = {"shuffle": a.shuffle(["k"]), "join": a.distributed_join(b, on="k")}
    out[INTER_BYTES] = int(report(INTER_BYTES).get(INTER_BYTES, {}).get("rows", 0)) - before
    return out


def case_mesh2x2(env):
    """:func:`mesh2x2_calls` over four shards. With two shards a process
    an inner group is one process (its hop a local transpose) and both
    outer groups span the two processes (one exchange carries both)."""
    from cylon_tpu_torch.utils import tracing

    ctx = mesh_context(env, "2x2")
    out = mesh2x2_calls(ctt.Table, ctx, port_encode, tracing.report)
    ctx.finalize()
    return out


#: the directory of case_io's files: the rank processes' OUT_DIR, or one
#: the test process sets for its own run
IO_DIR = None


def _io_input(path, s):
    """Shard s's input file: int64 keys, float64 with empty fields (nulls),
    a string column whose dictionary differs from file to file, and m,
    int64 in the even files and float64 in the odd ones."""
    rng = np.random.default_rng(SEED + 30 + s)
    n = 40 + 9 * s
    words = WORDS[5 * s: 5 * s + 12]
    lines = ["k,x,s,m"]
    for r in range(n):
        x = "" if r % 5 == 2 else repr(float(rng.normal()))
        m = int(rng.integers(0, 9)) + (0.5 if s % 2 else 0)
        lines.append(f"{int(rng.integers(0, 25))},{x},{rng.choice(words)},{m}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")


def case_io(env):
    """Per-rank file I/O: each rank writes its own shard's input file, then
    read_csv of world_size paths in which every other shard's path names a
    file that does not exist (a rank reads only its own), write_csv of one
    path a shard (each rank its own file) and of one path (the rank of
    shard 0 writes it after a gather), and a groupby on the unified string
    column; under torch.distributed also write_parquet and read_parquet one
    file a shard (one process skips them: parquet I/O beside jaxlib has
    made later XLA compiles of the test process segfault). Returns the
    tables and the bytes of the files this process wrote."""
    ctx = env.context
    w, local = ctx.world_size, ctx.local_shards
    d = Path(IO_DIR)
    for s in local:
        _io_input(d / "in" / f"part{s}.csv", s)

    def mine(sub, ext):
        return [str(d / (sub if s in local else "absent") / f"part{s}.{ext}") for s in range(w)]

    t = ctt.read_csv(ctx, mine("in", "csv"))
    (d / "out").mkdir(exist_ok=True)
    ctt.write_csv(t, [str(d / "out" / f"part{s}.csv") for s in range(w)])
    ctt.write_csv(t, str(d / "out" / "whole.csv"))
    written = {s: (d / "out" / f"part{s}.csv").read_bytes() for s in local}
    if 0 in local:
        written["whole"] = (d / "out" / "whole.csv").read_bytes()
    out = {"csv": t, "groupby": t.distributed_groupby("s", {"x": "sum", "m": "max"}),
           "written": written}
    if len(local) < w:
        ctt.write_parquet(t, [str(d / "out" / f"part{s}.parquet") for s in range(w)])
        out["parquet"] = ctt.read_parquet(ctx, mine("out", "parquet"))
    return out


def case_feedback_plan(ctx):
    """The lazy join -> groupby-sum of ``case_feedback`` (a join shuffle
    pair whose semi filter the re-coster's semi mode decides)."""
    rng = np.random.default_rng(SEED + 20)
    left = {"k": rng.integers(0, 400, 3000).astype(np.int32),
            "v": rng.normal(size=3000).astype(np.float32)}
    right = {"rk": rng.integers(0, 400, 1500).astype(np.int32),
             "w": rng.normal(size=1500).astype(np.float32)}
    a = ctt.Table.from_encoded(ctx, port_encode(left)).lazy()
    b = ctt.Table.from_encoded(ctx, port_encode(right)).lazy()
    return a.join(b, left_on="k", right_on="rk").groupby("k", {"v": "sum"})


def case_feedback(env):
    """Each rank journals to a store of its own; rank 0's holds two
    observations of high selectivity (its semi decision is "off": no
    sketch), rank 1's none (its own is "explore": build the sketch, a
    collective). The ranks agree on rank 0's decisions
    (``feedback.agree``), so both skip the sketch and the collect
    completes."""
    from cylon_tpu_torch.obs import store as obs_store
    from cylon_tpu_torch.plan import feedback as fb
    from cylon_tpu_torch.plan.lazy import gated_fingerprint

    ctx = env.context
    os.environ["CYLON_TPU_TORCH_OBS_DIR"] = os.path.join(IO_DIR, f"obs{env.rank}")
    os.environ["CYLON_TPU_TORCH_AUTOTUNE_MIN_OBS"] = "2"
    obs_store.reset_stores()
    lf = case_feedback_plan(ctx)
    base = gated_fingerprint(lf.plan)[:-1]
    if env.rank == 0:
        for _ in range(2):
            obs_store.store().record({"k": "exec", "fp": fb.base_key(base), "world": 2,
                                      "row_bytes": 8, "hot": 0, "sel": [0.97, 0.97],
                                      "sketch_built": 2})
    own = fb.decisions_for(base).semi_mode
    component = gated_fingerprint(lf.plan, ctx)[-1]
    return {"own": own, "component": component, "result": lf.collect()}


def stream_calls(ctx):
    """Incremental views over appendable tables (stream/): a groupby view
    over one source and a join -> groupby view over two, refreshed after
    appends to each side. Every rank appends the same batches, of which a
    snapshot stages each rank's own shards."""
    rng = np.random.default_rng(SEED + 30)

    def batch(n, key="k", val="v"):
        k = rng.choice(WORDS[:20], n).astype(object)
        k[rng.random(n) < 0.1] = None
        return {key: k, val: rng.integers(-40, 40, n).astype(np.float32)}

    left = ctt.AppendableTable(ctx, batch(300))
    right = ctt.AppendableTable(ctx, batch(60, "rk", "w"))
    agg = ctt.stream.view(lambda t: t.lazy().groupby("k", {"v": ["sum", "count", "max"]}), left)
    join = ctt.stream.view(
        lambda a, b: a.lazy().join(b.lazy(), left_on="k", right_on="rk").groupby(
            "k", {"v": "sum", "w": "min"}), left, right)
    out = {"agg0": agg.refresh(), "join0": join.refresh()}
    left.append(batch(70))
    right.append(batch(20, "rk", "w"))
    out["agg1"], out["join1"] = agg.refresh(), join.refresh()
    left.append(batch(9))
    out["agg2"], out["join2"] = agg.refresh(), join.refresh()
    out["stats"] = (dict(agg.stats), dict(join.stats))
    return out


def case_stream(env):
    return stream_calls(env.context)


PORT = OrderedDict([("pk", case_pk), ("ingest", case_ingest), ("env", case_env),
                    ("frame", case_frame), ("surface", case_surface), ("lazy", case_lazy),
                    ("semi", case_semi), ("fused", case_fused), ("out_of_core", case_out_of_core)])
CASES = list(SHARED) + list(PORT)
#: cases run only where a test names them (their own world)
EXTRA = OrderedDict([("skew8", case_skew8), ("topo8", case_topo8), ("io", case_io),
                     ("mesh2x2", case_mesh2x2), ("feedback", case_feedback),
                     ("stream", case_stream)])
#: (init URL, device, backend, shards a process) of a rank process, for
#: contexts a case makes
RANK_ARGS = ()


# ----------------------------------------------------------------------
# running and recording
# ----------------------------------------------------------------------

def shard_record(t, s):
    """What shard s of a port table holds: per column the physical data,
    the validity mask and the decoded values."""
    return OrderedDict(
        (c, (*t._host_physical_shard(c, s), t._shards[s][c].decode_host(*t._host_physical_shard(c, s))))
        for c in t.column_names
    )


def record(value, shards):
    if isinstance(value, ctt.Table):
        return {"table": True, "names": value.column_names, "counts": value.row_counts,
                "shards": {s: shard_record(value, s) for s in shards}}
    if hasattr(value, "to_dict") and hasattr(value, "columns"):  # a pandas frame
        return {c: value[c].to_numpy() for c in value.columns}
    return value


def run_cases(env, names=CASES):
    """{case: {output: record}} on this process's shards, with each case's
    shuffle plans: the (bucket_cap, rounds) of every schedule the planner
    makes (``spill.plan_schedule``; the skew split's cold-bucket plan is
    one ``plan_rounds`` call more inside it)."""
    ctx = env.context
    out = OrderedDict()
    orig = _spill.plan_schedule
    for name in names:
        plans = []

        def rec(*args, **kw):
            sched = orig(*args, **kw)
            plans.append((sched.bucket_cap, sched.n_rounds))
            return sched

        _spill.plan_schedule = rec
        try:
            if name in SHARED:
                got = SHARED[name](ctt.Table, ctx, port_encode)
            else:
                got = (PORT.get(name) or EXTRA[name])(env)
        finally:
            _spill.plan_schedule = orig
        out[name] = {k: record(v, ctx.local_shards) for k, v in got.items()}
        out[name]["__plans__"] = plans
    return out


# ----------------------------------------------------------------------
# the launcher and the comparisons (used by the tests, not by the ranks)
# ----------------------------------------------------------------------

#: seconds the other ranks get to exit by themselves after one failed
GRACE_S = 5.0


def run_ranks(tmp: Path, world, cases=(), device="cpu", backend="gloo", limit=120.0,
              wait_all=False):
    """Start ``world`` ranks of this script (``"PxL"``: P ranks of L shards
    each); wait until all exit 0, one exits otherwise (``wait_all``: until
    all exit), or ``limit`` seconds pass; then give the others
    ``GRACE_S`` to exit and kill what still runs. Returns (exit codes,
    logs, seconds)."""
    url = "file://" + str(tmp / "rendezvous")
    n_procs = int(str(world).split("x")[0])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="1")
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for r in range(n_procs):
            logs.append(open(tmp / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r), str(world), url, str(tmp),
                 device, backend, *cases],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env, cwd=os.path.dirname(HERE),
            ))
        while time.monotonic() - t0 < limit:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or (
                    not wait_all and any(c not in (None, 0) for c in codes)):
                break
            time.sleep(0.05)
        # a rank that failed may still be leaving (its process groups torn
        # down at exit, which is what ended the others' collectives): a
        # short grace lets it exit with its own code before the kill
        grace = time.monotonic() + GRACE_S
        while time.monotonic() < min(grace, t0 + limit) and any(p.poll() is None for p in procs):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    return codes, [(tmp / f"rank{r}.log").read_text() for r in range(n_procs)], time.monotonic() - t0


def shared_result(tmp_path_factory, key: str, compute):
    """``compute()``'s result, made once per test session and shared by
    every pytest-xdist worker through a pickle under the session's base
    temporary directory, behind an exclusive ``flock`` (the other workers
    wait for it and load it instead of computing it again). Without xdist
    the directory is this session's own."""
    import fcntl

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the session's directory, above the workers'
    d = base / "torch_shared"
    d.mkdir(exist_ok=True)
    path = d / f"{key}.pkl"
    with open(d / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return pickle.loads(path.read_bytes())
        value = compute()
        tmp = d / f"{key}.pkl.tmp"
        tmp.write_bytes(pickle.dumps(value))
        tmp.replace(path)
        return value


def load_ranks(tmp: Path, world: int):
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def same_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype == object:
        assert a.tolist() == b.tolist(), what
    else:
        assert a.tobytes() == b.tobytes(), what


def float_close(got, want, dtype, what):
    """float32: rtol 1e-5 and atol 1e-4; float64: rtol 1e-12."""
    if np.dtype(dtype) == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=what)


def scalars_equal(got, want, what, dtype=None):
    """A scalar result (or a tuple of them): sums and means within
    :func:`float_close`, everything else exact and of the same type."""
    if isinstance(got, tuple):
        assert isinstance(want, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            scalars_equal(g, w, what, dtype)
    elif isinstance(got, float) and what.rsplit(".", 1)[-1].split("_")[0] in ("sum", "mean"):
        float_close(got, want, dtype or np.float64, what)
    else:
        assert got == want and type(got) is type(want), (what, got, want)


AGG_DTYPES = {"i": np.int32, "l": np.int64, "f": np.float64, "h": np.float32, "s": object}


def agg_dtype(key):
    """The column type of a case_aggregates result (``<op>_<column>``)."""
    return AGG_DTYPES[key.rsplit("_", 1)[1]]


def record_equal(got, want, what, shard, sums_close=False):
    """One output's record against another's on shard ``shard``: tables bit
    for bit (``sums_close``: but float ``*_sum``/``*_mean`` columns within
    :func:`float_close`), host columns bit for bit, scalars by
    :func:`scalars_equal`."""
    if isinstance(want, dict) and want.get("table"):
        assert got["names"] == want["names"], what
        np.testing.assert_array_equal(got["counts"], want["counts"], err_msg=what)
        g, w = got["shards"][shard], want["shards"][shard]
        for c in want["names"]:
            assert (g[c][1] is None) == (w[c][1] is None), f"{what}.{c} mask"
            if w[c][1] is not None:
                same_bits(g[c][1], w[c][1], f"{what}.{c} valid")
            if sums_close and c.endswith(("_sum", "_mean")) and w[c][0].dtype.kind == "f":
                assert g[c][0].dtype == w[c][0].dtype, what
                float_close(g[c][0], w[c][0], w[c][0].dtype, f"{what}.{c}")
            else:
                same_bits(g[c][0], w[c][0], f"{what}.{c} data")
    elif isinstance(want, dict):  # host columns: every rank the whole table
        assert list(got) == list(want), what
        for c in want:
            if sums_close and np.asarray(want[c]).dtype.kind == "f":
                float_close(got[c], want[c], np.asarray(want[c]).dtype, f"{what}.{c}")
            else:
                same_bits(got[c], want[c], f"{what}.{c}")
    elif isinstance(want, np.ndarray):
        same_bits(got, want, what)
    else:
        scalars_equal(got, want, what, agg_dtype(what) if what[-2:-1] == "_" else None)


def main(argv):
    global RANK_ARGS, IO_DIR
    rank, world, url, out_dir, device, backend = argv[:6]
    names = argv[6:] or CASES
    torch.set_num_threads(1)
    procs, per = (int(x) for x in (world.split("x") if "x" in world else (world, 1)))
    RANK_ARGS = (url, device, backend, per)
    IO_DIR = out_dir
    env = ctt.CylonEnv(config=rank_config(url, procs, int(rank), device, backend, per))
    if "fail" in names:  # a rank that dies before its first collective
        if env.rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        names = [n for n in names if n != "fail"]
    if names == ["overflow"]:  # a test-only limit, in this process alone
        from cylon_tpu_torch.ops import join as _join

        _join.MAX_ROWS = 1000
        case_overflow(env)
        return
    results = run_cases(env, names)
    if device != "cpu":  # the kernels this rank launched on its card
        from cylon_tpu_torch.ops import cuda_codec, cuda_gather, cuda_probe, cuda_radix
        results["__launches__"] = {k: v for d in (cuda_radix.LAUNCHES, cuda_gather.LAUNCHES,
                                                  cuda_codec.LAUNCHES, cuda_probe.LAUNCHES)
                                   for k, v in d.items()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    env.context.barrier()
    env.context.finalize()


if __name__ == "__main__":
    main(sys.argv[1:])
