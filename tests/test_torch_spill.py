"""The port's spill tiers (parallel/spill.py: the host and disk arenas, the
one-deep round staging of table._shuffle_many, the tier choice, the I/O
degradation ladder, stale-dir reaping) against the JAX package's, on the
CPU, both packages at their defaults but for the forced tier, with the JAX
side's unported tiers off (``CYLON_TPU_NO_TOPO``, ``NO_AUTOTUNE``).

Forced tiers 1 and 2 at world 4 (a shuffle of several rounds) and tier 1
at world 8 (a skewed join, its relayed rows into the arenas) equal the
JAX package's forced tier
shard for shard, with equal
``shuffle.spill.staged_rounds`` and ``staged_bytes``; the tier follows the
device spill budget when it is not forced; ``HostArena`` grows, promotes a
column and self-promotes to disk as the JAX arena does on the same appends;
the plan fingerprint carries the spill gate; tier 1's peak accounting is
below tier 0's; every column kind the host codec decodes crosses the
relay and the arenas bit for bit; an injected write fault heals inside
the retries and an
injected read fault with no rung left raises ``SpillIOError`` with the
arena bytes back at their baseline.
"""
import os
import subprocess
import time

import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.parallel import spill as jsp
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch import fault as tfault
from cylon_tpu_torch.fault.errors import SpillIOError
from cylon_tpu_torch.parallel import spill as tsp
from cylon_tpu_torch.plan import lazy as tlazy
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _contexts, _encode, _shards_equal
from test_torch_skew import DEFAULTS, UNPORTED, _skewed_sides, _tables, skew_counters

torch.set_num_threads(1)

STAGE_COUNTERS = ("shuffle.spill.shuffles", "shuffle.spill.staged_rounds",
                  "shuffle.spill.staged_bytes", "shuffle.rounds", "shuffle.exchanged_bytes")


@pytest.fixture
def defaults(monkeypatch):
    for k in UNPORTED:
        monkeypatch.setenv(k, "1")
    for k in DEFAULTS + ("CYLON_TPU_FAULTS", "CYLON_TPU_TORCH_FAULTS", "CYLON_TPU_SPILL_DIR",
                         "CYLON_TPU_TORCH_SPILL_DIR", "CYLON_TPU_SPILL_HOST_BUDGET",
                         "CYLON_TPU_TORCH_SPILL_HOST_BUDGET"):
        monkeypatch.delenv(k, raising=False)
    tfault.reset()
    jtr.reset_trace()
    ttr.reset_trace()
    yield monkeypatch
    monkeypatch.delenv("CYLON_TPU_TORCH_FAULTS", raising=False)
    tfault.reset()


def _both_env(monkeypatch, name, value):
    monkeypatch.setenv("CYLON_TPU_" + name, str(value))
    monkeypatch.setenv("CYLON_TPU_TORCH_" + name, str(value))


def stage_counters(rep):
    got = rep("shuffle.")
    return {k: (int(got[k]["count"]), int(got[k].get("rows", 0))) for k in STAGE_COUNTERS if k in got}


def _pair(world, seed, n=3000, keyspace=400, port_only=False):
    """(JAX tables, port tables) of a join's two sides; ``port_only``: the
    port's alone."""
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, keyspace, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.integers(0, keyspace, n // 2).astype(np.int32),
             "w": rng.normal(size=n // 2).astype(np.float32)}
    jctx, tctx = _contexts(world)
    le, re_ = _encode(left), _encode(right)
    port = ctt.Table.from_encoded(tctx, le), ctt.Table.from_encoded(tctx, re_)
    if port_only:
        return port
    return (ct.Table.from_encoded(jctx, le), ct.Table.from_encoded(jctx, re_)), port


@pytest.mark.parametrize("world,tier", [(4, 1), (4, 2), (8, 1)])
def test_forced_tier_matches_reference(defaults, tmp_path, world, tier):
    """Forced through tier 1 or 2 and equal to the JAX package's forced tier
    shard for shard, with the same staged rounds and bytes; tier 2's
    arenas leave no file. World 4: a hash shuffle at a budget of several
    rounds. World 8: test_torch_skew's skewed join, whose relayed tail
    lands in the arenas after the staged round."""
    _both_env(defaults, "SPILL_TIER", tier)
    _both_env(defaults, "SPILL_DIR", tmp_path)
    if world == 4:
        _both_env(defaults, "SHUFFLE_BUDGET", world * 32 * 8)
        (jl, _jr), (tl, _tr) = _pair(world, 17 + world)
        _shards_equal(jl.shuffle(["k"]), tl.shuffle(["k"]))
    else:
        left, right = _skewed_sides(np.random.default_rng(4))
        (jl, tl), (jr, tr) = _tables(world, left), _tables(world, right)
        _shards_equal(jl.distributed_join(jr, on="k"), tl.distributed_join(tr, on="k"))
    got, want = stage_counters(ttr.report), stage_counters(jtr.report)
    assert got == want
    # every round of every spilled shuffle staged
    assert got["shuffle.spill.staged_rounds"][0] == got["shuffle.rounds"][1], got
    assert got["shuffle.spill.shuffles"][0] == got["shuffle.rounds"][0]
    if world == 4:  # several rounds a shuffle
        assert got["shuffle.rounds"][1] > got["shuffle.rounds"][0]
    else:
        assert skew_counters(ttr.report) == skew_counters(jtr.report)
        assert ttr.get_count("shuffle.skew_split") == 1
    assert ttr.report("shuffle.spill.tier")["shuffle.spill.tier"]["max_s"] == tier
    assert not os.listdir(tmp_path)  # every arena closed its directory
    assert tsp.arena_bytes()[0] == 0


def test_tier_follows_the_device_budget(defaults):
    """Unforced, a tiny device spill budget spills the same shuffle, whose
    result is the tier-0 one; the choice is the JAX package's at every
    budget and forced tier."""
    tl, _tr = _pair(4, 5, n=2000, port_only=True)
    base = tl.shuffle(["k"])
    assert "shuffle.spill.shuffles" not in ttr.report("shuffle.spill.")
    _both_env(defaults, "SPILL_DEVICE_BUDGET", 64)
    got = tl.shuffle(["k"])
    assert ttr.get_count("shuffle.spill.shuffles") == 1
    np.testing.assert_array_equal(got.row_counts, base.row_counts)
    for s in range(4):
        for c in base.column_names:
            assert torch.equal(got._shards[s][c].data, base._shards[s][c].data)
    for forced in ("", "0", "1", "2"):
        _both_env(defaults, "SPILL_TIER", forced)
        for staged in (0, 64, 65, 1 << 40):
            assert tsp.choose_tier(staged) == jsp.choose_tier(staged)
    _both_env(defaults, "SPILL_TIER", "")
    assert tsp.choose_tier(65) == tsp.TIER_HOST
    defaults.setenv("CYLON_TPU_TORCH_SPILL_TIER", "3")
    with pytest.raises(ValueError):
        tsp.choose_tier(0)


def _arena_ops(mod, schema, backing, directory):
    a = mod.HostArena(schema, backing, directory=directory)
    a.reserve(10)
    rng = np.random.default_rng(1)
    for n in (6, 9, 30):
        a.append_batch([(rng.integers(-99, 99, n).astype(np.int32), rng.random(n) > 0.3),
                        (rng.normal(size=n), None)])
    cols_before = [(d.copy(), None if v is None else v.copy()) for d, v in a.columns()]
    a.promote(0, np.float64)
    return a, cols_before


@pytest.mark.parametrize("backing", ["host", "disk", "host_budget"])
def test_host_arena_matches_reference(defaults, tmp_path, backing):
    """reserve, append, promote and the host-budget promotion to disk: the
    same buffers, rows, bytes and backing as the JAX arena."""
    schema = [("a", np.dtype(np.int32), True), ("b", np.dtype(np.float64), False)]
    if backing == "host_budget":
        _both_env(defaults, "SPILL_HOST_BUDGET", 1)
    tier = tsp.TIER_DISK if backing == "disk" else tsp.TIER_HOST
    live0 = tsp.arena_bytes()[0]
    arenas = []
    for mod, sub in ((tsp, "port"), (jsp, "jax")):
        (tmp_path / sub).mkdir()
        arenas.append(_arena_ops(mod, schema, tier, str(tmp_path / sub)))
    (ta, t_before), (ja, j_before) = arenas
    for (td, tv), (jd, jv) in zip(t_before + ta.columns(), j_before + ja.columns()):
        np.testing.assert_array_equal(td, jd)
        assert td.dtype == jd.dtype
        assert (tv is None) == (jv is None) and (tv is None or (tv == jv).all())
    assert (ta.rows, ta.nbytes, ta.schema) == (ja.rows, ja.nbytes, ja.schema)
    assert ta.touches_disk() == ja.touches_disk() == (backing != "host")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert tsp.arena_bytes()[0] == live0 + ta.nbytes
    if backing == "host_budget":
        assert ttr.get_count("shuffle.spill.tier2_promotions") == jtr.get_count(
            "shuffle.spill.tier2_promotions") > 0
    ta.close()
    ja.close()
    assert tsp.arena_bytes()[0] == live0


def test_fingerprint_changes_with_the_spill_gate(defaults):
    tl, tr = _pair(4, 3, n=200, port_only=True)
    plan = tl.lazy().join(tr.lazy(), on="k")._plan
    fps = {tlazy.gated_fingerprint(plan)}
    defaults.setenv("CYLON_TPU_TORCH_SPILL_TIER", "1")
    fps.add(tlazy.gated_fingerprint(plan))
    with tsp.skew_disabled():
        fps.add(tlazy.gated_fingerprint(plan))
    assert len(fps) == 3
    assert tsp.gate_state() == ("1", True)


def test_tier1_peak_accounting_below_tier0(defaults):
    """The analytic peak device bytes of a several-round join: tier 1 holds
    at most two round outputs on the device, tier 0 all of them."""
    _both_env(defaults, "SHUFFLE_BUDGET", 4 * 16 * 8)
    tl, tr = _pair(4, 9, n=4000, port_only=True)
    peaks = []
    for tier in ("0", "1"):
        defaults.setenv("CYLON_TPU_TORCH_SPILL_TIER", tier)
        ttr.reset_trace()
        tl.distributed_join(tr, on="k")
        rep = ttr.report("shuffle.")
        assert rep["shuffle.rounds"]["rows"] > 2 * rep["shuffle.rounds"]["count"]
        peaks.append(rep["shuffle.spill.peak_device_bytes"]["max_s"])
    assert peaks[1] < peaks[0], peaks


def _arm(monkeypatch, spec):
    monkeypatch.setenv("CYLON_TPU_TORCH_FAULTS", spec)
    tfault.reset()


def test_spill_write_retry_heals(defaults, tmp_path):
    """A transient ENOSPC heals inside the retries with the arena rolled back
    to the batch boundary (no double append)."""
    defaults.setenv("CYLON_TPU_TORCH_SPILL_DIR", str(tmp_path))
    defaults.setenv("CYLON_TPU_TORCH_SPILL_RETRIES", "2")
    _arm(defaults, "spill.write:p=1:n=2")
    sink = tsp.ShardArenaSink(2, [("a", np.dtype(np.int32), False)], tsp.TIER_DISK)
    data = np.arange(64, dtype=np.int32)
    sink.accept([[(data, None)], [(data * 2, None)]], np.array([64, 64]))
    assert ttr.get_count("shuffle.spill.io_retries") == 2 and tfault.fired("spill.write") == 2
    np.testing.assert_array_equal(sink.arenas[0].columns()[0][0], data)
    np.testing.assert_array_equal(sink.arenas[1].columns()[0][0], data * 2)
    assert list(sink.counts()) == [64, 64]
    sink.close()
    with pytest.raises(tfault.FaultSpecError):
        tfault.parse_spec("spill.read:kind=die")
    assert tfault.parse_spec("serve.worker:n=1")["serve.worker"].kind == "die"  # A9c's seam
    assert tfault.parse_spec("stream.append:n=1")["stream.append"].kind == "ENOSPC"  # A9d's seam
    with pytest.raises(tfault.FaultSpecError):
        tfault.parse_spec("stream.append:kind=die")  # an errno-only seam


def test_spill_read_failure_types_and_closes_arenas(defaults, tmp_path):
    """A forced tier-2 shuffle whose read-back fails with no rung left (no
    retries, no host room to degrade into) raises SpillIOError; the
    arenas are closed, and the same shuffle runs cleanly after."""
    tl, _tr = _pair(4, 13, n=1500, port_only=True)
    oracle = tl.shuffle(["k"])
    live0 = tsp.arena_bytes()[0]
    defaults.setenv("CYLON_TPU_TORCH_SPILL_TIER", "2")
    defaults.setenv("CYLON_TPU_TORCH_SPILL_DIR", str(tmp_path))
    defaults.setenv("CYLON_TPU_TORCH_SPILL_RETRIES", "0")
    defaults.setenv("CYLON_TPU_TORCH_SPILL_HOST_BUDGET", "1")
    _arm(defaults, "spill.read:p=1")
    with pytest.raises(SpillIOError) as ei:
        tl.shuffle(["k"])
    assert ei.value.scope == "query" and ei.value.retryable
    assert tfault.fired("spill.read") == 1
    assert tsp.arena_bytes()[0] == live0 and tsp.arena_bytes()[2] == 0
    assert not os.listdir(tmp_path)
    defaults.delenv("CYLON_TPU_TORCH_FAULTS")
    tfault.reset()
    again = tl.shuffle(["k"])
    np.testing.assert_array_equal(again.row_counts, oracle.row_counts)
    for s in range(4):
        for c in oracle.column_names:
            torch.testing.assert_close(again._shards[s][c].data, oracle._shards[s][c].data,
                                       rtol=0, atol=0)


def test_stale_spill_dirs_are_reaped(tmp_path):
    """Dead-pid dirs of this host past the age guard go; live, fresh,
    foreign-host and unparseable ones stay."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    pfx, host = tsp.SPILL_DIR_PREFIX, tsp._host_tag()
    orphan = tmp_path / f"{pfx}{host}-{proc.pid}_abc"
    fresh = tmp_path / f"{pfx}{host}-{proc.pid}_fresh"
    mine = tmp_path / f"{pfx}{host}-{os.getpid()}_live"
    foreign = tmp_path / f"{pfx}otherhost-{proc.pid}_x"
    legacy = tmp_path / f"{pfx}notapid"
    for d in (orphan, fresh, mine, foreign, legacy):
        d.mkdir()
        (d / "col1.bin").write_bytes(b"x" * 128)
    old = time.time() - 3600
    os.utime(orphan, (old, old))
    os.utime(foreign, (old, old))
    assert tsp.reap_stale_spill(str(tmp_path), min_age_s=60) == 1
    assert not orphan.exists()
    assert fresh.exists() and mine.exists() and legacy.exists() and foreign.exists()
    assert tsp.reap_stale_spill(str(tmp_path / "missing")) == 0
    assert tsp._host_tag() == jsp._host_tag()


@pytest.mark.parametrize("tier", ["", "1", "2"])
def test_every_dtype_through_relay_and_arenas_matches_reference(defaults, tmp_path, tier):
    """A skewed shuffle at world 8 of every column kind the host codec
    decodes (nullable int64, a string column with nulls, bool, float16,
    uint64, float64 with NaN): the relayed rows, and under tiers 1 and 2
    the staged rounds, equal the JAX package's bit for bit."""
    _both_env(defaults, "SPILL_TIER", tier)
    _both_env(defaults, "SPILL_DIR", tmp_path)
    rng = np.random.default_rng(1)
    n = 4096
    i64 = rng.integers(-2**40, 2**40, n).astype(object)
    i64[rng.random(n) < 0.2] = None
    s = rng.choice(["a", "bb", "ccc"], n).astype(object)
    s[rng.random(n) < 0.1] = None
    cols = {"k": np.where(rng.random(n) < 0.6, 5, rng.integers(0, 100, n)).astype(np.int64),
            "x": i64, "s": s, "b": rng.random(n) < 0.5,
            "h": rng.normal(size=n).astype(np.float16),
            "u": rng.integers(0, 2**63, n).astype(np.uint64),
            "f": np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n))}
    jt, tt = _tables(8, cols)
    _shards_equal(jt.shuffle(["k"]), tt.shuffle(["k"]))
    assert skew_counters(ttr.report) == skew_counters(jtr.report)
    assert ttr.get_count("shuffle.skew_split") == 1
    assert stage_counters(ttr.report) == stage_counters(jtr.report)
