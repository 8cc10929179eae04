"""The port's ``torch.distributed`` backend: one OS process per shard (the
reference's ``mpirun -np N``), gloo on the CPU.

Each world W in 2, 3 and 4 starts W processes of ``tests/_torch_mp_worker.py``
(rendezvous through a file under the test's temporary directory, so that
parallel test workers never share a port). Every rank runs the same cases
on its own shard: join -> groupby at several rounds, a skewed key with an
empty shard, ``distributed_sort`` on float keys with nulls, the set
operations and ``distributed_unique``, the PK join with a duplicate right
key that falls back on every rank, per-rank ingest
(``Table.from_encoded_shards``), the whole-table aggregates, the context's
rank, the DataFrame flow, the DataFrame and Table surface's steps that
gather from every rank (``case_surface``), and a semi-filtered join whose
key sketches ride one all_gather (``case_semi``). The ranks run with the
port's semi filter and lane packing off, as the JAX side runs with its
own off (tests/test_torch_shuffle_slice.py), but ``case_semi``, which
turns them on for its join. The test process runs the same case functions
on ``LocalCommunicator`` at the same world (every shard in one process),
and the shared ones on the JAX package's 4-device CPU mesh at W = 4 (the
configuration of tests/test_torch_shuffle_slice.py), and holds rank d's
shard against shard d of both: bit-exact and in row order for the port,
exact for the JAX package but for float sums and means. Float sums and
means are held within rtol 1e-12 (float64) and rtol 1e-5 with atol 1e-4
(float32): they add in another order across packages and across the
backends' reductions; everything else is exact.

Every run has a wall-clock limit; a rank that exits non-zero ends the run
at once, and the remaining ranks are killed.
"""
import pickle

import numpy as np
import pandas as pd
import pytest
import torch
import torch.distributed as dist

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu_torch.context import LocalCommunicator

import _torch_mp_worker as W
from test_torch_shuffle_slice import _contexts, ref_env  # noqa: F401

torch.set_num_threads(1)

WORLDS = (2, 3, 4)
# the JAX side compiles its programs anew at each world (about 30 s a
# world here), so it runs at world 4 only; at worlds 2 and 3 the ranks are
# held against LocalCommunicator, which tests/test_torch_shuffle_slice.py,
# test_torch_sort.py and test_torch_setops.py hold against the JAX package
JAX_WORLDS = (4,)
LIMIT_S = 120  # per run of W processes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> (per rank its results, LocalCommunicator's results), each
    world run once per module."""
    cache = {}

    def get(world):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"mp{world}")
            with pytest.MonkeyPatch.context() as mp:
                for k in W.PORT_NO_TIERS:
                    mp.setenv(k, "1")
                codes, logs, _s = W.run_ranks(tmp, world, limit=LIMIT_S)
                if codes != [0] * world:
                    cache[world] = RuntimeError(f"ranks exited {codes}:\n" + "\n".join(
                        f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
                else:
                    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
                             for r in range(world)]
                    local = W.run_cases(ctt.CylonEnv(
                        config=ctt.GPUConfig(device="cpu", world_size=world)))
                    cache[world] = (ranks, local)
        if isinstance(cache[world], Exception):
            raise cache[world]
        return cache[world]

    return get


@pytest.mark.parametrize("case", W.CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_shard_equals_local_communicator_shard(runs, world, case):
    ranks, local = runs(world)
    for r, res in enumerate(ranks):
        got, want = res[case], local[case]
        assert got["__plans__"] == want["__plans__"], (r, case)
        if case == "env":
            assert got == {"rank": r, "ctx_rank": r, "world": world, "local_shards": [r],
                           "neighbours": [i for i in range(world) if i != r],
                           "is_distributed": True, "__plans__": []}
            continue
        assert sorted(got) == sorted(want)
        for key in want:
            if key != "__plans__":
                W.record_equal(got[key], want[key], key, r)


@pytest.mark.parametrize("world", WORLDS)
def test_rounds_and_pk_fallback_are_taken_on_every_rank(runs, world):
    """The round plan and the PK join's speculation come from collectives:
    every rank plans the same rounds (several for the join), and one
    duplicate right key, which one shard sees, reruns the sort join on
    every rank."""
    ranks, _local = runs(world)
    for res in ranks:
        plans = res["join_groupby"]["__plans__"]
        assert len(plans) == 4 and all(k > 1 for _bc, k in plans[:2]), plans
        assert plans == ranks[0]["join_groupby"]["__plans__"]
        assert res["pk"]["fallbacks_clean"] == 0 and res["pk"]["fallbacks_dup"] == 1
        for c in res["pk"]["dup"]["names"]:
            dup, srt = res["pk"]["dup"]["shards"], res["pk"]["dup_sort"]["shards"]
            assert list(dup) == list(srt)
            for s in dup:
                W.same_bits(dup[s][c][0], srt[s][c][0], c)


def test_semi_filter_prunes_on_every_rank(runs):
    """Two gloo processes: the semi gate applies the filter to both sides
    on every rank (the gate reads counts gathered from every rank), and
    each rank's join shard equals LocalCommunicator's (the case test
    above compares them bit for bit)."""
    ranks, local = runs(2)
    assert [res["semi"]["applied"] for res in ranks] == [2, 2] == [local["semi"]["applied"]] * 2


def _jax_shard(t, s):
    return pd.DataFrame({
        c: t._columns[c].decode_host(*t._host_physical_shard(c, s)) for c in t.column_names
    })


@pytest.mark.parametrize("case", list(W.SHARED))
@pytest.mark.parametrize("world", JAX_WORLDS)
def test_rank_shard_equals_jax_mesh_shard(runs, ref_env, world, case):
    ranks, _local = runs(world)
    jctx, _tctx = _contexts(world)
    enc = lambda cols: {k: ct.Column.encode_host(np.asarray(v)) for k, v in cols.items()}  # noqa: E731
    want = W.SHARED[case](ct.Table, jctx, enc)
    for r, res in enumerate(ranks):
        for key, w in want.items():
            got = res[case][key]
            if not isinstance(w, ct.Table):
                dtype = W.agg_dtype(key)
                w = tuple(x.item() if hasattr(x, "item") else x for x in w) if isinstance(w, tuple) \
                    else (w.item() if hasattr(w, "item") else w)
                if dtype == object:
                    w = tuple(str(x) for x in w) if isinstance(w, tuple) else str(w)
                    got = tuple(str(x) for x in got) if isinstance(got, tuple) else str(got)
                W.scalars_equal(got, w, key, dtype)
                continue
            assert got["names"] == w.column_names, key
            np.testing.assert_array_equal(got["counts"], w.row_counts, err_msg=key)
            want_df = _jax_shard(w, r)
            for c in w.column_names:
                g, x = got["shards"][r][c][2], want_df[c].to_numpy()
                if c.endswith(("_sum", "_mean")) and x.dtype.kind == "f":
                    assert np.asarray(g).dtype == x.dtype, (key, c)
                    W.float_close(g, x, x.dtype, f"{key}.{c}")
                else:
                    pd.testing.assert_series_equal(pd.Series(g, name=c), pd.Series(x, name=c),
                                                   check_exact=True, obj=f"{key}.{c}")


def test_world8_skew_relay_rank_equals_local_shard(tmp_path, monkeypatch):
    """Eight gloo ranks, a one-hot shuffle and a skewed join (again under
    tier 1): the skew split engages on every rank, the relayed tails cross
    one host all_to_all, and rank d's shard equals shard d of one process
    bit for bit, in row order. Then a context at 4x2 on the same process
    group: a locality shuffle, a one-hot shuffle whose same-group tail
    rides the ring (``batch_isend_irecv``) and a join, over the inner and
    outer process groups, again rank d's shard shard d of one process."""
    for k in W.PORT_NO_TIERS:
        monkeypatch.setenv(k, "1")
    codes, logs, _s = W.run_ranks(tmp_path, 8, cases=["skew8", "topo8"], limit=LIMIT_S)
    assert codes == [0] * 8, "\n".join(log[-2000:] for log in logs)
    ranks = W.load_ranks(tmp_path, 8)
    local = W.run_cases(ctt.CylonEnv(config=ctt.GPUConfig(device="cpu", world_size=8)),
                        ["skew8", "topo8"])
    assert local["skew8"]["relays"] == 3
    topo = local["topo8"]
    assert topo["shuffle.relay.ring_rows"] > 0
    assert topo["shuffle.coll_bytes.inter"] < topo["shuffle.coll_bytes.inter_alt"]
    for r, res in enumerate(ranks):
        got = res["skew8"]
        assert got["__plans__"] == local["skew8"]["__plans__"] and got["relays"] == 3, r
        for key in ("shuffle", "join", "join_tier1"):
            W.record_equal(got[key], local["skew8"][key], key, r)
        W.record_equal(got["join_tier1"], local["skew8"]["join"], "tier 1 against tier 0", r)
        got = res["topo8"]
        assert got["__plans__"] == topo["__plans__"], r
        for key in ("locality", "ring", "join", "shuffle.relay.ring_rows",
                    "shuffle.coll_bytes.inter", "shuffle.coll_bytes.inter_alt"):
            W.record_equal(got[key], topo[key], f"topo8 {key}", r)


def test_a_failing_rank_fails_the_run_without_a_hang(tmp_path):
    """Rank 1 dies before the first collective: the run ends as soon as it
    exits, well inside the limit, and rank 0, blocked in that collective,
    is killed."""
    codes, logs, seconds = W.run_ranks(tmp_path, 2, cases=["fail", "join_groupby"], limit=60)
    assert codes[1] == 1 and "rank 1 fails on purpose" in logs[1], logs[1][-2000:]
    assert codes[0] != 0 and seconds < 60, (codes, seconds)


def test_a_join_that_overflows_on_one_rank_raises_on_every_rank(tmp_path):
    """The join's output passes the (lowered) row limit on shard 0 only;
    every rank reads every shard's count first, so both raise the same
    ValueError and exit, well inside the limit, instead of rank 1 waiting
    in its next collective."""
    codes, logs, seconds = W.run_ranks(tmp_path, 2, cases=["overflow"], limit=60, wait_all=True)
    for r in range(2):
        assert codes[r] == 1, (r, codes, logs[r][-2000:])
        assert "join output of 3600 rows on one shard exceeds 1000 rows" in logs[r], logs[r][-2000:]
    assert seconds < 60, seconds


# ----------------------------------------------------------------------
# DistCommunicator in this process, on a world-1 gloo group, against
# LocalCommunicator
# ----------------------------------------------------------------------

@pytest.fixture
def dist_ctx(tmp_path):
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(
        device="cpu", coordinator_address=f"file://{tmp_path}/rendezvous",
        num_processes=1, process_id=0,
    ))
    yield ctx
    ctx.finalize()
    assert not dist.is_initialized()


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64, torch.bool])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_dist_all_reduce_matches_local(dist_ctx, op, dtype):
    x = torch.from_numpy(np.random.default_rng(3).integers(-5, 5, (4, 3))).to(dtype)
    got = dist_ctx.comm.all_reduce([x], op)
    want = LocalCommunicator([torch.device("cpu")]).all_reduce([x], op)
    assert len(got) == 1 and got[0].dtype == want[0].dtype
    assert torch.equal(got[0], want[0])


def test_dist_all_gather_matches_local(dist_ctx):
    x = torch.from_numpy(np.random.default_rng(4).integers(-9, 9, (2, 5)).astype(np.int32))
    got = dist_ctx.comm.all_gather([x])
    want = LocalCommunicator([torch.device("cpu")]).all_gather([x])
    assert len(got) == 1 and got[0].shape == (1, 2, 5) and torch.equal(got[0], want[0])


def test_dist_all_to_all_and_counts_match_local(dist_ctx):
    comm, local = dist_ctx.comm, LocalCommunicator([torch.device("cpu")])
    buf = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    assert torch.equal(comm.all_to_all([buf])[0], local.all_to_all([buf])[0])
    for counts in ([[5]], [[1, 2, 3]], np.zeros((1, 2, 3), np.int64)):
        np.testing.assert_array_equal(comm.all_gather_counts(counts), local.all_gather_counts(counts))
    assert comm.gather_host({"a": 1}) == local.gather_host({"a": 1}) == [{"a": 1}]
    assert (dist_ctx.rank, dist_ctx.local_shards, dist_ctx.get_neighbours()) == (0, [0], [])
    dist_ctx.barrier()
    with pytest.raises(ValueError, match="one shard"):
        comm.all_to_all([buf, buf])
    # the skew relay's host regroup: one host all_to_all over gloo
    rows = np.arange(21, dtype=np.int32).reshape(7, 3)
    for relay in (np.array([[7]]), np.array([[0]])):
        mats = {0: rows[: int(relay.sum())]}
        got, want = comm.relay_exchange(mats, relay), local.relay_exchange(mats, relay)
        assert list(got) == list(want) == [0]
        W.same_bits(got[0], want[0], "relay_exchange")


@pytest.mark.parametrize("kw,err,match", [
    (dict(devices=["cpu"]), ValueError, "owns one shard"),
    (dict(device="cpu", world_size=2), ValueError, "owns one shard"),
    (dict(device="cpu", backend="nccl"), ValueError, "needs a CUDA device"),
    (dict(device="cpu", backend="mpi"), ValueError, "backend must be"),
    (dict(device="cpu", process_id=2), ValueError, "not a rank"),
    (dict(device="cpu", num_processes=None), ValueError, "needs num_processes"),
])
def test_config_errors(kw, err, match):
    args = dict(coordinator_address="127.0.0.1:29500", num_processes=2, process_id=0)
    with pytest.raises(err, match=match):
        ctt.GPUConfig(**{**args, **kw})


def test_config_never_switches_backend_or_device(monkeypatch):
    """NCCL missing raises; no card and no device raises; gloo on a card
    stays gloo; env:// takes the launcher's rank and world."""
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        ctt.GPUConfig(device="cuda:0", coordinator_address="h:1", num_processes=2, process_id=0)
    cfg = ctt.GPUConfig(device="cuda:1", coordinator_address="h:1", num_processes=2,
                        process_id=1, backend="gloo")
    assert cfg.backend == "gloo" and cfg.devices == [None, torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.GPUConfig(coordinator_address="h:1", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="need a coordinator_address"):
        ctt.GPUConfig(device="cpu", num_processes=2)
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    cfg = ctt.GPUConfig(device="cpu", coordinator_address="env://")
    assert (cfg.world_size, cfg.process_id, cfg.backend, cfg.device) == (3, 2, "gloo", torch.device("cpu"))


# ----------------------------------------------------------------------
# unique(keep=...): anything but "last" keeps the first, as in cylon_tpu
# ----------------------------------------------------------------------

@pytest.mark.parametrize("keep", ["none", False])
@pytest.mark.parametrize("world", [1, 4])
def test_unique_keep_other_than_last_keeps_first(ref_env, world, keep):
    rng = np.random.default_rng(11)
    cols = {"k": rng.integers(0, 15, 300).astype(np.int32), "v": rng.normal(size=300),
            "s": rng.choice(W.WORDS[:5], 300)}
    jctx, tctx = _contexts(world)
    jt = ct.Table.from_encoded(jctx, {k: ct.Column.encode_host(v) for k, v in cols.items()})
    tt = ctt.Table.from_encoded(tctx, W.port_encode(cols))
    for keys in (["k"], ["k", "s"]):
        want = jt.distributed_unique(keys, keep=keep)
        got = tt.distributed_unique(keys, keep=keep)
        first = tt.distributed_unique(keys, keep="first")
        np.testing.assert_array_equal(got.row_counts, want.row_counts)
        for s in range(world):
            pd.testing.assert_frame_equal(
                pd.DataFrame({c: got._shards[s][c].decode_host(*got._host_physical_shard(c, s))
                              for c in got.column_names}),
                _jax_shard(want, s), check_exact=True,
            )
            for c in got.column_names:
                assert torch.equal(got._shards[s][c].data, first._shards[s][c].data)
