"""The port's out-of-core layers against the JAX package's, on the CPU:
``hash_partition_ids(hash_shift=...)``, ``Table.from_shards``, the task
shuffle (``parallel/task.py``, ``Table.task_partition``), the streaming op
graphs (``parallel/dag.py``), the caller-owned shuffle sink and the
out-of-core join (``parallel/ooc.py``), fed the same numpy inputs from a
seed, both packages at their defaults with the JAX side's unported tiers
off (``CYLON_TPU_NO_TOPO``, ``NO_AUTOTUNE``), as tests/test_torch_spill.py
runs them.

Every comparison is exact and in order: the sub-bucket lane bit for bit;
each task's table shard for shard; the graphs' results shard for shard;
the out-of-core join's ``sink.rows`` and ``result_pydict()`` in the JAX
sink's order (the ingest's rounds and the bucket joins route rows alike
in both packages, so no route-order divergence of ROADMAP C3 applies),
with equal ``shuffle.spill.{ooc_joins,shuffles,staged_rounds,staged_bytes}``
and ``shuffle.rounds``. ``max_device_cap`` counts the port's exact-length
rows (ROADMAP C3) and is held to the JAX test's own bound
(tests/test_ooc.py: below half of the in-memory join's 3n/W rows), not to
the JAX value. The JAX side of each case runs once per module.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.ops import partition as jpart
from cylon_tpu.parallel import LogicalTaskPlan as JPlan
from cylon_tpu.parallel import dag as jdag
from cylon_tpu.parallel.ooc import OutOfCoreJoin as JOoc
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch import fault as tfault
from cylon_tpu_torch.fault.errors import SpillIOError
from cylon_tpu_torch.ops import partition as tpart
from cylon_tpu_torch.parallel import LogicalTaskPlan as TPlan
from cylon_tpu_torch.parallel import dag as tdag
from cylon_tpu_torch.parallel import spill as tsp
from cylon_tpu_torch.parallel.ooc import HostSink
from cylon_tpu_torch.parallel.ooc import OutOfCoreJoin as TOoc
from cylon_tpu_torch.table import _ShuffleSpec, _shuffle_many
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _contexts, _encode, _shards_equal
from test_torch_skew import DEFAULTS, UNPORTED

torch.set_num_threads(1)

OOC_COUNTERS = ("shuffle.spill.ooc_joins", "shuffle.spill.shuffles",
                "shuffle.spill.staged_rounds", "shuffle.spill.staged_bytes", "shuffle.rounds")
WORDS = np.array([f"key{i:04d}" for i in range(700)])


def _reset_env(mp):
    for k in UNPORTED:
        mp.setenv(k, "1")
    for k in DEFAULTS + ("CYLON_TPU_FAULTS", "CYLON_TPU_TORCH_FAULTS", "CYLON_TPU_SPILL_DIR",
                         "CYLON_TPU_TORCH_SPILL_DIR", "CYLON_TPU_SPILL_HOST_BUDGET",
                         "CYLON_TPU_TORCH_SPILL_HOST_BUDGET", "CYLON_TPU_SPILL_RETRIES",
                         "CYLON_TPU_TORCH_SPILL_RETRIES"):
        mp.delenv(k, raising=False)
    tfault.reset()


@pytest.fixture
def defaults(monkeypatch):
    _reset_env(monkeypatch)
    jtr.reset_trace()
    ttr.reset_trace()
    yield monkeypatch
    monkeypatch.delenv("CYLON_TPU_TORCH_FAULTS", raising=False)
    tfault.reset()


def counters(rep, names=OOC_COUNTERS):
    got = rep("shuffle.")
    return {k: (int(got[k]["count"]), int(got[k].get("rows", 0))) for k in names if k in got}


def _chunks(cols, m):
    n = len(next(iter(cols.values())))
    for lo in range(0, n, m):
        yield {c: v[lo:lo + m] for c, v in cols.items()}


# ----------------------------------------------------------------------
# the sub-bucket lane and per-shard construction
# ----------------------------------------------------------------------

def _keys(kind, rng, n=3000):
    if kind == "int32":
        return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    if kind == "int64":
        return rng.integers(-(1 << 62), 1 << 62, n)
    if kind == "float":
        x = rng.normal(size=n) * 1e6
        x[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
        return x
    return WORDS[rng.integers(0, len(WORDS), n)]


@pytest.mark.parametrize("kind", ["int32", "int64", "float", "string"])
def test_hash_shift_lane_equals_reference(kind):
    """The out-of-core sub-bucket lane (murmur3 bits 16 and up) and the
    plain partition lane equal the JAX package's bit for bit, through the
    mask (K a power of two) and the modulo (K = 12) paths; dictionary keys
    hash by value."""
    jctx, tctx = _contexts(1)
    enc = _encode({"k": _keys(kind, np.random.default_rng(len(kind)))})
    jk = ct.Table.from_encoded(jctx, enc)._key_hash_cols(["k"])
    tk = ctt.Table.from_encoded(tctx, enc)._key_hash_cols(["k"])[0]
    n = len(enc["k"][0])
    combos = ((8, 16), (12, 16), (12, 0))
    wants = jax.jit(lambda kc: [jpart.hash_partition_ids(kc, n, k, hash_shift=shift)
                                for k, shift in combos])(jk)
    for (k, shift), want in zip(combos, wants):
        got = tpart.hash_partition_ids(tk, None, k, hash_shift=shift).numpy()
        np.testing.assert_array_equal(got, np.asarray(want)[:n], err_msg=f"K={k} shift={shift}")
    # bits 16 and up differ from the low bits the shuffle routes on
    low = tpart.hash_partition_ids(tk, None, 8).numpy()
    assert (low != tpart.hash_partition_ids(tk, None, 8, hash_shift=16).numpy()).any()


def test_from_shards_equals_reference():
    """Per-shard construction at world 4: each shard encodes alone (its own
    string dictionary, an empty shard, an int column that is float on one
    shard), then types promote and dictionaries unify, as in the JAX
    package."""
    jctx, tctx = _contexts(4)
    rng = np.random.default_rng(5)
    shards = []
    for s, n in enumerate((5, 0, 7, 3)):
        shards.append({"s": WORDS[rng.integers(10 * s, 10 * s + 20, n)],
                       "i": rng.integers(0, 9, n) if s != 2 else rng.normal(size=n),
                       "f": rng.normal(size=n).astype(np.float32)})
    _shards_equal(ct.Table.from_shards(jctx, shards), ctt.Table.from_shards(tctx, shards))
    with pytest.raises(ValueError, match="need 4 shards"):
        ctt.Table.from_shards(tctx, shards[:3])


# ----------------------------------------------------------------------
# the task shuffle
# ----------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (0, 4), ({}, 4), ({1: 0, 2: 0}, 4), ({0: 4}, 4), ({0: -1, 1: 0}, 4),
])
def test_task_plan_validation_matches_reference(args):
    with pytest.raises(ValueError) as want:
        JPlan(*args)
    with pytest.raises(ValueError, match=str(want.value).replace("[", r"\[").replace(")", r"\)")):
        TPlan(*args)


def test_task_plan_equals_reference():
    for args in ((10, 8), ({0: 3, 1: 0, 2: 3}, 4), (7, 3)):
        j, t = JPlan(*args), TPlan(*args)
        np.testing.assert_array_equal(t.worker_for_task, j.worker_for_task)
        assert t.worker_for_task.dtype == j.worker_for_task.dtype
        assert (t.n_tasks, t.world, repr(t)) == (j.n_tasks, j.world, repr(j))
        for w in range(args[1]):
            np.testing.assert_array_equal(t.tasks_of(w), j.tasks_of(w))
        assert [t.worker_of(i) for i in range(t.n_tasks)] == [j.worker_of(i)
                                                             for i in range(j.n_tasks)]


def test_task_partition_equals_reference(defaults):
    """World 4, T = 12 (3x over-decomposition): each task's table equals the
    JAX package's shard for shard and in order, its rows only on its
    owner's shard, without the task column; the split reads its [P, T]
    counts in one host sync; a plan of another world raises."""
    jctx, tctx = _contexts(4)
    rng = np.random.default_rng(9)
    n = 1200
    enc = _encode({"k": rng.integers(0, 300, n), "v": rng.normal(size=n),
                   "s": WORDS[rng.integers(0, 40, n)]})
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    jparts = jt.task_partition(["k"], JPlan(12, 4))
    plan = TPlan(12, 4)
    syncs0 = ttr.get_count("host_sync")
    tparts = tt.task_partition(["k"], plan)
    task_syncs = ttr.get_count("host_sync") - syncs0
    ttr.reset_trace()
    tt._shuffle_impl(["k"])  # the shuffle's own host syncs
    assert task_syncs == ttr.get_count("host_sync") + 1
    assert sorted(tparts) == list(range(12))
    for t_id, tp in tparts.items():
        assert tp.column_names == ["k", "v", "s"]
        _shards_equal(jparts[t_id], tp)
        owner = plan.worker_of(t_id)
        assert all(c == 0 for w, c in enumerate(tp.row_counts) if w != owner)
    assert sum(p.row_count for p in tparts.values()) == n
    with pytest.raises(ValueError, match="plan built for world=2"):
        tt.task_partition(["k"], TPlan(4, 2))


# ----------------------------------------------------------------------
# the streaming op graphs
# ----------------------------------------------------------------------

def _frame_chunks(pkg, ctx, df, n_chunks):
    size = (len(df) + n_chunks - 1) // n_chunks
    return [pkg.Table.from_pandas(ctx, df.iloc[i * size:(i + 1) * size].reset_index(drop=True))
            for i in range(n_chunks) if len(df.iloc[i * size:(i + 1) * size])]


def _graph_both(world, make, *frames_and_chunks):
    """``make(dag_module).execute(...)`` in both packages on the same frames
    cut into the same chunks: (JAX result, port result)."""
    jctx, tctx = _contexts(world)
    out = []
    for pkg, mod, ctx in ((ct, jdag, jctx), (ctt, tdag, tctx)):
        streams = [_frame_chunks(pkg, ctx, df, m) for df, m in frames_and_chunks]
        out.append(make(mod).execute(*streams))
    return out


def test_dis_join_graph_equals_reference(defaults):
    """DisJoinOp at world 4 (partition -> shuffle -> join under
    JoinExecution) on a string key whose dictionaries are chunk-local and
    an int32 key against an int64 one: shard for shard, in order."""
    rng = np.random.default_rng(21)
    left = pd.DataFrame({"s": WORDS[rng.integers(0, 30, 140)],
                         "k": rng.integers(0, 5, 140).astype(np.int32), "x": rng.normal(size=140)})
    right = pd.DataFrame({"s": WORDS[rng.integers(0, 30, 100)], "k": rng.integers(0, 5, 100),
                          "y": rng.normal(size=100)})
    j, t = _graph_both(4, lambda m: m.DisJoinOp(on=["s", "k"], how="inner"), (left, 3),
                       (right, 2))
    _shards_equal(j, t)
    assert t.row_count == len(left.merge(right, on=["s", "k"]))


@pytest.mark.parametrize("world", [1, pytest.param(4, marks=pytest.mark.slow)])
def test_dis_union_graph_equals_reference(defaults, world):
    rng = np.random.default_rng(22)
    a = pd.DataFrame({"k": rng.integers(0, 20, 80), "v": rng.integers(0, 3, 80)})
    b = pd.DataFrame({"k": rng.integers(0, 20, 60), "v": rng.integers(0, 3, 60)})
    j, t = _graph_both(world, lambda m: m.DisUnionOp(columns=["k", "v"]), (a, 2), (b, 3))
    _shards_equal(j, t)
    assert t.row_count == len(pd.concat([a, b]).drop_duplicates())


def test_executions_agree():
    """Sequential, RoundRobin, Priority and Join executions of one graph
    shape give the same table as the eager join (world 1)."""
    tctx = _contexts(1)[1]
    rng = np.random.default_rng(23)
    left = pd.DataFrame({"k": rng.integers(0, 40, 200), "x": rng.normal(size=200)})
    right = pd.DataFrame({"k": rng.integers(0, 40, 150), "y": rng.normal(size=150)})
    eager = ctt.Table.from_pandas(tctx, left).join(ctt.Table.from_pandas(tctx, right), on="k")

    def build():
        lp, rp = tdag.PartitionOp("pl"), tdag.PartitionOp("pr")
        join, root = tdag.JoinOp("join", on="k", how="inner"), tdag.RootOp()
        lp.add_child(join, edge=0)
        rp.add_child(join, edge=1)
        join.add_child(root)
        return lp, rp, join, root

    for make_exec in (
        lambda lp, rp, join, root: tdag.SequentialExecution(lp, rp),
        lambda lp, rp, join, root: tdag.RoundRobinExecution(lp, rp),
        lambda lp, rp, join, root: tdag.PriorityExecution(lp, rp, priorities={"pl": 2}),
        lambda lp, rp, join, root: tdag.JoinExecution(lp, rp, join, root),
    ):
        lp, rp, join, root = build()
        g = tdag._StreamingGraph([lp, rp], root, make_exec(lp, rp, join, root))
        out = g.execute(_frame_chunks(ctt, tctx, left, 3), _frame_chunks(ctt, tctx, right, 2))
        assert out.equals(eager), type(g.execution).__name__


def test_graph_errors_and_edges_match_reference():
    """Stall detection, insert after FIN, an empty stream and a zero-row
    chunk behave as in the JAX package (tests/test_dag.py)."""
    jctx, tctx = _contexts(1)
    left = pd.DataFrame({"k": np.arange(6), "x": np.arange(6.0)})
    for pkg, mod, ctx in ((ct, jdag, jctx), (ctt, tdag, tctx)):
        src, root = mod.MapOp("id", lambda t: t), mod.RootOp()
        src.add_child(root)
        src.insert(pkg.Table.from_pydict(ctx, {"v": np.arange(4)}))
        with pytest.raises(RuntimeError, match=r"stalled; pending: \['id', 'root'\]"):
            mod.RoundRobinExecution(src).run()
        src = mod.MapOp("id", lambda t: t)
        src.finish()
        with pytest.raises(RuntimeError, match="id: insert after FIN on edge 0"):
            src.insert(pkg.Table.from_pydict(ctx, {"v": np.arange(2)}))
        with pytest.raises(ValueError, match="input stream 1 is empty"):
            mod.DisJoinOp(on="k").execute([pkg.Table.from_pandas(ctx, left)], [])
        with pytest.raises(RuntimeError, match="root has no output"):
            mod.RootOp().result()
        with pytest.raises(ValueError, match="on= or left_on="):
            mod.DisJoinOp(left_on=["k"])
    empty = ctt.Table.from_pandas(tctx, pd.DataFrame({"k": np.arange(0), "y": np.arange(0.0)}))
    out = tdag.DisJoinOp(on="k", how="left").execute([ctt.Table.from_pandas(tctx, left)], [empty])
    assert out.row_count == 6 and out.column_names == ["k_x", "x", "k_y", "y"]


# ----------------------------------------------------------------------
# the caller-owned sink and the out-of-core join
# ----------------------------------------------------------------------

def test_caller_sink_shuffle(defaults):
    """A shuffle spec with a caller-owned sink at world 4 (the out-of-core
    ingest, which test_ooc_join_equals_reference holds against the JAX
    package): no device result, every shard's rows delivered decoded,
    round by round, in the order of the shuffle's own result (the
    package's HostSink as the caller's sink, read a shard at a time), at
    least tier 1 under a tier knob of 0 and tier 2 under a knob of 2, and
    ``device_rows_peak`` recorded on the sink."""
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(31)
    enc = _encode({"k": rng.integers(0, 500, 2000).astype(np.int32),
                   "s": WORDS[rng.integers(0, 50, 2000)], "v": rng.normal(size=2000)})
    tt = ctt.Table.from_encoded(tctx, enc)
    defaults.setenv("CYLON_TPU_TORCH_SPILL_TIER", "0")
    want = tt._shuffle_impl(["k"], 4 * 64 * 16)
    for knob, want_tier in (("0", tsp.TIER_HOST), ("2", tsp.TIER_DISK)):
        defaults.setenv("CYLON_TPU_TORCH_SPILL_TIER", knob)
        ttr.reset_trace()
        sink = HostSink()
        spec = _ShuffleSpec(tt, ("k",), 4 * 64 * 16, sink=sink)
        assert _shuffle_many([spec]) == [None]
        assert ttr.report("shuffle.spill.tier")["shuffle.spill.tier"]["last"] == want_tier
        assert ttr.get_count("shuffle.spill.staged_rounds") == ttr.report(
            "shuffle.rounds")["shuffle.rounds"]["rows"] > 1
        assert sink.device_rows_peak > 0
        for s in range(4):
            got = sink.result_pydict(shard=s)
            for c in tt.column_names:
                exp = want._shards[s][c].decode_host(*want._host_physical_shard(c, s))
                assert got[c].tolist() == exp.tolist(), (s, c)
        sink.close()
        assert tsp.arena_bytes()[0] == 0


def _ooc_sides(keys, n, seed):
    rng = np.random.default_rng(seed)
    if keys == "string":  # about two matches a left row, as the int keys
        names = np.array([f"key{i:05d}" for i in range(2 * n)])
        lk, rk = names[rng.integers(0, 2 * n, n)], names[rng.integers(0, 2 * n, n // 2)]
    else:
        lk, rk = (rng.integers(0, 2 * n, m).astype(np.int32) for m in (n, n // 2))
    left = {"k": lk, "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rk, "w": rng.normal(size=n // 2).astype(np.float32)}
    return left, right


#: case -> (world, key kind, rows of the left side, buckets, chunk rows)
OOC_CASES = {"string_w4": (4, "string", 6144, 4, 512), "int_w1": (1, "int32", 2400, 4, 800)}


@pytest.fixture(scope="module")
def ooc_reference():
    """case -> the JAX package's (sink rows, result frame, counters), each
    run once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            world, keys, n, k, m = OOC_CASES[case]
            left, right = _ooc_sides(keys, n, world + k)
            with pytest.MonkeyPatch.context() as mp:
                _reset_env(mp)
                jtr.reset_trace()
                job = JOoc(_contexts(world)[0], on="k", how="inner", num_buckets=k)
                sink = job.execute(_chunks(left, m), _chunks(right, m))
                cache[case] = (sink.rows, pd.DataFrame(sink.result_pydict()), counters(jtr.report))
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(OOC_CASES))
def test_ooc_join_equals_reference(defaults, ooc_reference, case):
    """The out-of-core join at worlds 4 and 1 (a string key at world 4, as
    tests/test_spill_tiers.py runs one; 4 buckets, chunks of 512 and 800
    rows): ``sink.rows`` and the result rows
    in the JAX sink's order, the spill counters, the device bound; every
    arena closed after."""
    world, keys, n, k, m = OOC_CASES[case]
    rows, frame, want = ooc_reference(case)
    left, right = _ooc_sides(keys, n, world + k)
    ttr.reset_trace()
    job = TOoc(_contexts(world)[1], on="k", how="inner", num_buckets=k)
    sink = job.execute(_chunks(left, m), _chunks(right, m))
    assert sink.rows == rows == len(pd.DataFrame(left).merge(pd.DataFrame(right), on="k"))
    got = pd.DataFrame(sink.result_pydict())
    pd.testing.assert_frame_equal(got, frame)
    assert counters(ttr.report) == want
    assert want["shuffle.spill.ooc_joins"] == (1, 0)
    if world > 1:
        # every ingest chunk's shuffle spilled into the sinks
        assert want["shuffle.spill.shuffles"][0] == -(-n // m) + -(-(n // 2) // m)
    assert job.max_device_cap < (3 * n // world) // 2, (job.max_device_cap, n)
    assert 0 < job.join_phase_device_cap <= job.max_device_cap
    assert set(job.cost_split) == {"spill_fetch_s", "stage_upload_s", "join_s", "drain_fetch_s",
                                   "drain_thread_s"}
    sink.close()
    assert tsp.arena_bytes()[0] == 0


def test_ooc_join_faults_type_and_close_arenas(defaults, tmp_path):
    """Tier 2 with ``arena.alloc`` armed: the join leaves as SpillIOError
    with every arena (ingest and result) closed and no file left; the same
    join runs clean right after (tests/test_chaos.py's case). Only
    ``how="inner"`` is supported, as in the JAX package."""
    tctx = _contexts(4)[1]
    left, right = _ooc_sides("int32", 4000, 7)
    want = TOoc(tctx, on="k", num_buckets=4).execute(_chunks(left, 1000), _chunks(right, 1000))
    want_rows = pd.DataFrame(want.result_pydict())
    want.close()
    defaults.setenv("CYLON_TPU_TORCH_SPILL_DIR", str(tmp_path))
    defaults.setenv("CYLON_TPU_TORCH_SPILL_RETRIES", "0")
    defaults.setenv("CYLON_TPU_TORCH_SPILL_TIER", "2")
    defaults.setenv("CYLON_TPU_TORCH_FAULTS", "arena.alloc:p=1")
    tfault.reset()
    job = TOoc(tctx, on="k", num_buckets=4)
    with pytest.raises(SpillIOError):
        job.execute(_chunks(left, 1000), _chunks(right, 1000))
    assert tsp.arena_bytes()[0] == 0 and tsp.arena_bytes()[2] == 0
    assert not job.lp.arenas and not job.rp.arenas and job.sink._arena is None
    assert not os.listdir(tmp_path)
    defaults.delenv("CYLON_TPU_TORCH_FAULTS")
    tfault.reset()
    sink = TOoc(tctx, on="k", num_buckets=4).execute(_chunks(left, 1000), _chunks(right, 1000))
    pd.testing.assert_frame_equal(pd.DataFrame(sink.result_pydict()), want_rows)
    sink.close()
    assert not os.listdir(tmp_path)
    for pkg_join in (JOoc, TOoc):
        with pytest.raises(NotImplementedError, match="how='inner' only"):
            pkg_join(tctx, on="k", how="left")


# ----------------------------------------------------------------------
# heavier sweeps
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("variant", ["world8", "tier2", "skewed"])
def test_ooc_join_sweep_equals_reference(defaults, tmp_path, variant):
    """World 8; forced tier 2 at world 4 (the arenas on disk, the bucket
    joins' shuffles spilled too); a skewed ingest at world 8, whose hot
    key's relayed rows reach the caller-owned sink through the host relay:
    equal to the JAX package's in order, with equal counters."""
    world = 4 if variant == "tier2" else 8
    left, right = _ooc_sides("int32", 8000, 40 + world)
    if variant == "skewed":
        left["k"][: 4000] = right["k"][0]
    if variant == "tier2":
        for pre in ("CYLON_TPU_", "CYLON_TPU_TORCH_"):
            defaults.setenv(pre + "SPILL_TIER", "2")
            defaults.setenv(pre + "SPILL_DIR", str(tmp_path))
    jctx, tctx = _contexts(world)
    names = OOC_COUNTERS + ("shuffle.skew_split",)
    got = []
    for cls, ctx, tr in ((JOoc, jctx, jtr), (TOoc, tctx, ttr)):
        tr.reset_trace()
        sink = cls(ctx, on="k", how="inner", num_buckets=8).execute(
            _chunks(left, 2000), _chunks(right, 2000))
        got.append((sink.rows, pd.DataFrame(sink.result_pydict()), counters(tr.report, names)))
        sink.close()
    assert got[0][0] == got[1][0]
    pd.testing.assert_frame_equal(got[1][1], got[0][1])
    assert got[1][2] == got[0][2]
    if variant == "skewed":
        assert got[1][2]["shuffle.skew_split"][1] > 0
    assert tsp.arena_bytes()[0] == 0
