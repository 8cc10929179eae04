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

A layout of 2 processes of 2 shards each (``GPUConfig(devices=[...])``,
the JAX package's own tests/test_multiprocess.py: 2 processes x 2 CPU
devices, a mesh of 4) runs the join, the sort, the aggregates and a 2x2
mesh's shuffle and join; each rank's two shards are held against the same
shards of the four one-shard ranks, of one process of 4 and of the JAX
package's world-4 results.

Every run has a wall-clock limit; a rank that exits non-zero ends the run
at once, and the remaining ranks are killed.
"""
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pytest
import torch
import torch.distributed as dist

import jax

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch.context import LocalCommunicator

import _torch_mp_worker as W
from test_torch_shuffle_slice import NO_TIERS, _contexts, ref_env  # noqa: F401

torch.set_num_threads(1)

WORLDS = (2, 3, 4)
# the JAX side compiles its programs anew at each world (about 30 s a
# world here), so it runs at world 4 only; at worlds 2 and 3 the ranks are
# held against LocalCommunicator, which tests/test_torch_shuffle_slice.py,
# test_torch_sort.py and test_torch_setops.py hold against the JAX package
JAX_WORLDS = (4,)
LIMIT_S = 120  # per run of W processes


#: the layout of several shards a process: 2 processes of 2 shards, and
#: the cases it runs (one each of the join, the sort, the aggregates and a
#: 2x2 mesh)
TWO_BY_TWO = "2x2"
TWO_BY_TWO_CASES = ("join_groupby", "sort", "aggregates", "mesh2x2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world (or ``TWO_BY_TWO``) -> (per rank its results,
    LocalCommunicator's results at the same world), each run once per
    test session and shared by the xdist workers (``W.shared_result``)."""

    def compute(world):
        procs, per = (2, 2) if world == TWO_BY_TWO else (world, 1)
        cases = TWO_BY_TWO_CASES if world == TWO_BY_TWO else ()
        tmp = tmp_path_factory.mktemp(f"mp{world}")
        with pytest.MonkeyPatch.context() as mp:
            for k in W.PORT_NO_TIERS:
                mp.setenv(k, "1")
            # the one-process run while the ranks run (the launcher's thread
            # only waits on the rank processes)
            with ThreadPoolExecutor(1) as ex:
                ranks_run = ex.submit(W.run_ranks, tmp, world, cases=cases, limit=LIMIT_S)
                local = W.run_cases(ctt.CylonEnv(
                    config=ctt.GPUConfig(device="cpu", world_size=procs * per)),
                    cases or W.CASES)
                codes, logs, _s = ranks_run.result()
            if codes != [0] * procs:
                return RuntimeError(f"ranks exited {codes}:\n" + "\n".join(
                    f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
            ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(procs)]
            return ranks, local

    def get(world):
        got = W.shared_result(tmp_path_factory, f"runs_{world}", lambda: compute(world))
        if isinstance(got, Exception):
            raise got
        return got

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


def _jax_record(value):
    """A JAX package output as plain values: a table's names, counts and
    shard frames, or a scalar (tuple) as it is."""
    if not isinstance(value, ct.Table):
        return value
    return {"jax_table": True, "names": value.column_names, "counts": value.row_counts,
            "frames": {s: _jax_shard(value, s) for s in range(len(value.row_counts))}}


@pytest.fixture(scope="module")
def jax_want(tmp_path_factory):
    """(world, case) -> the JAX package's outputs of a shared case as
    plain values, each computed once per test session and shared by the
    xdist workers (the world-4 rank tests and the 2x2 layout hold against
    the same ones)."""

    def compute(world, case):
        enc = lambda cols: {k: ct.Column.encode_host(np.asarray(v))  # noqa: E731
                            for k, v in cols.items()}
        with pytest.MonkeyPatch.context() as mp:  # ref_env, for the module
            if case == "mesh2x2":  # the two-hop exchange on, as the ranks run it
                for k in NO_TIERS:
                    if k != "CYLON_TPU_NO_TOPO":
                        mp.setenv(k, "1")
                mp.setenv("CYLON_TPU_NO_AUTOTUNE", "1")
                mp.delenv("CYLON_TPU_MESH", raising=False)
                jctx = ct.CylonContext.init_distributed(
                    ct.TPUConfig(devices=jax.devices()[:4], mesh_shape="2x2"))
                out = W.mesh2x2_calls(ct.Table, jctx, enc, jtr.report)
            else:
                for k in NO_TIERS:
                    mp.setenv(k, "1")
                out = W.SHARED[case](ct.Table, _contexts(world)[0], enc)
            return {k: _jax_record(v) for k, v in out.items()}

    return lambda world, case: W.shared_result(
        tmp_path_factory, f"jax_{world}_{case}", lambda: compute(world, case))


def _hold_against_jax(got_case, want, shard, what):
    """One rank's record of a shared case against the JAX package's
    outputs on ``shard``: scalars by ``W.scalars_equal``, tables shard for
    shard (float sums and means within ``W.float_close``)."""
    for key, w in want.items():
        got = got_case[key]
        if not (isinstance(w, dict) and w.get("jax_table")):
            dtype = W.agg_dtype(key)
            w = tuple(x.item() if hasattr(x, "item") else x for x in w) if isinstance(w, tuple) \
                else (w.item() if hasattr(w, "item") else w)
            if dtype == object:
                w = tuple(str(x) for x in w) if isinstance(w, tuple) else str(w)
                got = tuple(str(x) for x in got) if isinstance(got, tuple) else str(got)
            W.scalars_equal(got, w, key, dtype)
            continue
        assert got["names"] == w["names"], (what, key)
        np.testing.assert_array_equal(got["counts"], w["counts"], err_msg=f"{what} {key}")
        want_df = w["frames"][shard]
        for c in w["names"]:
            g, x = got["shards"][shard][c][2], want_df[c].to_numpy()
            if c.endswith(("_sum", "_mean")) and x.dtype.kind == "f":
                assert np.asarray(g).dtype == x.dtype, (what, key, c)
                W.float_close(g, x, x.dtype, f"{what} {key}.{c}")
            else:
                pd.testing.assert_series_equal(pd.Series(g, name=c), pd.Series(x, name=c),
                                               check_exact=True, obj=f"{what} {key}.{c}")


@pytest.mark.parametrize("case", list(W.SHARED))
@pytest.mark.parametrize("world", JAX_WORLDS)
def test_rank_shard_equals_jax_mesh_shard(runs, jax_want, world, case):
    ranks, _local = runs(world)
    want = jax_want(world, case)
    for r, res in enumerate(ranks):
        _hold_against_jax(res[case], want, r, f"rank {r}")


@pytest.mark.parametrize("case", TWO_BY_TWO_CASES)
def test_two_shards_a_process_equal_world4_shards(runs, jax_want, case):
    """Two gloo processes of two shards each (``GPUConfig(devices=[cpu,
    cpu], coordinator_address=...)``): rank p owns shards 2p and 2p + 1,
    and each of them equals the same shard of the four one-shard ranks
    and of one process of 4 bit for bit, with the same round plans, and
    the JAX package's world-4 result. The 2x2 mesh's shuffle and join
    (an inner group inside one process, both outer groups across the two)
    equal one process's 2x2 mesh and the JAX package's 2x2 mesh shard for
    shard, and ship the JAX package's cross-outer bytes."""
    ranks, local = runs(TWO_BY_TWO)
    ranks4, local4 = runs(4) if case != "mesh2x2" else (None, local)
    jax_case = jax_want(4, case)
    for p, res in enumerate(ranks):
        assert res[case]["__plans__"] == local4[case]["__plans__"], (p, case)
        for key, want in local4[case].items():
            if key == "__plans__":
                continue
            for s in (2 * p, 2 * p + 1):
                if isinstance(want, dict) and want.get("table"):
                    assert sorted(res[case][key]["shards"]) == [2 * p, 2 * p + 1], (p, key)
                W.record_equal(res[case][key], want, f"{key} of one process", s)
                if ranks4 is not None:
                    W.record_equal(res[case][key], ranks4[s][case][key], f"{key} of rank {s}", s)
        if case == "mesh2x2":
            got, want = res[case][W.INTER_BYTES], jax_case[W.INTER_BYTES]
            assert got == want > 0, (p, got, want)
        tables = {k: v for k, v in jax_case.items() if k != W.INTER_BYTES}
        for s in (2 * p, 2 * p + 1):
            _hold_against_jax(res[case], tables, s, f"rank {p} shard {s}")


def test_world8_skew_relay_rank_equals_local_shard(tmp_path, monkeypatch):
    """Eight gloo ranks, a one-hot shuffle and a skewed join (again under
    tier 1): the skew split engages on every rank, the relayed tails cross
    one host all_to_all, and rank d's shard equals shard d of one process
    bit for bit, in row order. Then a context at 4x2 on the same process
    group: a locality shuffle, a one-hot shuffle whose same-group tail
    rides the ring (``ppermute``) and a join, their grouped exchanges
    routed through the whole process group, again rank d's shard shard d
    of one process."""
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


@pytest.mark.parametrize("world", [2, 4])
def test_io_ranks_read_and_write_only_their_own_files(tmp_path, world, monkeypatch):
    """gloo ranks each read only their own shard's CSV file (every other
    path names a file that does not exist on that rank) and write only
    their own: rank d's tables equal shard d of one process, whose
    unification saw every file, and the files it wrote equal one
    process's byte for byte (the one-path file is written by rank 0); each
    rank's parquet file, read back alone, equals its shard."""
    codes, logs, _s = W.run_ranks(tmp_path, world, cases=["io"], limit=LIMIT_S)
    assert codes == [0] * world, "\n".join(log[-2000:] for log in logs)
    ranks = W.load_ranks(tmp_path, world)
    monkeypatch.setattr(W, "IO_DIR", str(tmp_path / "local"))
    local = W.run_cases(ctt.CylonEnv(config=ctt.GPUConfig(device="cpu", world_size=world)),
                        ["io"])["io"]
    assert local["csv"]["shards"][1]["m"][0].dtype == np.float64  # int64 and float64 files
    assert "parquet" not in local
    for r, res in enumerate(ranks):
        got = res["io"]
        for key in ("csv", "groupby"):
            W.record_equal(got[key], local[key], key, r)
        W.record_equal(got["parquet"], local["csv"], "parquet read of the rank's own file", r)
        assert sorted(got["written"], key=str) == sorted([r] + (["whole"] if r == 0 else []), key=str)
        for key, data in got["written"].items():
            assert data == local["written"][key], (r, key)


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
    (dict(devices=["cpu"], world_size=1), ValueError, "owns one shard"),
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
