"""The port's skew split (parallel/spill.plan_schedule, the host relay of
table._shuffle_many, shuffle.relay_send_slots) against the JAX package's,
on the CPU, with the skew split on in both packages (their default), the
semi filter and lane packing at their defaults and the JAX side's unported
tiers off (``CYLON_TPU_NO_TOPO``, ``NO_AUTOTUNE``).

``plan_schedule`` equals the JAX function on count matrices made from a
seed at worlds 4 and 8, and gives ``plan_rounds``' plan on a matrix with
no skew. The one-hot and Zipf shuffles, a skewed ``distributed_join`` (also
with the semi filter applied, and with a float64 payload at
``quant_tol=1e-2``, whose relay ships q8 codes) and a ``distributed_sort``
over a block of duplicates equal the JAX package's shard for shard, in
exact order (the rounds, then each destination's relayed rows in source
order), with equal ``shuffle.skew_split``, ``shuffle.spill.relay_bytes``,
``shuffle.exchanged_bytes`` and ``shuffle.rounds`` counters.
"""
import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.parallel import shuffle as jsh
from cylon_tpu.parallel import spill as jsp
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch.parallel import shuffle as tsh
from cylon_tpu_torch.parallel import spill as tsp
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _contexts, _encode, _shards_equal

torch.set_num_threads(1)

#: the JAX package's tiers the port has not ported, off on its side
UNPORTED = ("CYLON_TPU_NO_TOPO", "CYLON_TPU_NO_AUTOTUNE")
#: left at their defaults in both packages
DEFAULTS = ("CYLON_TPU_NO_SKEW_SPLIT", "CYLON_TPU_TORCH_NO_SKEW_SPLIT", "CYLON_TPU_NO_SEMI_FILTER",
            "CYLON_TPU_TORCH_NO_SEMI_FILTER", "CYLON_TPU_NO_LANE_PACK",
            "CYLON_TPU_TORCH_NO_LANE_PACK", "CYLON_TPU_NO_QUANT", "CYLON_TPU_TORCH_NO_QUANT",
            "CYLON_TPU_QUANT_TOL", "CYLON_TPU_TORCH_QUANT_TOL", "CYLON_TPU_SPILL_TIER",
            "CYLON_TPU_TORCH_SPILL_TIER", "CYLON_TPU_SPILL_DEVICE_BUDGET",
            "CYLON_TPU_TORCH_SPILL_DEVICE_BUDGET")
#: the schedule's counters, held equal
SKEW_COUNTERS = ("shuffle.skew_split", "shuffle.spill.relay_bytes", "shuffle.exchanged_bytes",
                 "shuffle.rounds")


@pytest.fixture
def defaults(monkeypatch):
    for k in UNPORTED:
        monkeypatch.setenv(k, "1")
    for k in DEFAULTS:
        monkeypatch.delenv(k, raising=False)
    jtr.reset_trace()
    ttr.reset_trace()


def skew_counters(rep):
    got = rep("shuffle.")
    return {k: (int(got[k]["count"]), int(got[k].get("rows", 0))) for k in SKEW_COUNTERS if k in got}


def counters_equal(split=True):
    got, want = skew_counters(ttr.report), skew_counters(jtr.report)
    assert got == want
    assert ("shuffle.skew_split" in got) == split, got
    return got


def _tables(world, cols):
    jctx, tctx = _contexts(world)
    enc = _encode(cols)
    return ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)


# ----------------------------------------------------------------------
# the schedule
# ----------------------------------------------------------------------

def _count_matrix(kind, world, rng):
    if kind == "one_hot":
        m = np.zeros((world, world), np.int64)
        m[:, rng.integers(world)] = rng.integers(200, 400, world)
    elif kind == "two_hot":
        m = rng.integers(0, 30, (world, world))
        m[:, rng.choice(world, 2, replace=False)] += rng.integers(300, 900, (world, 1))
    elif kind == "zipf":
        keys = rng.zipf(1.3, 4000) % 131
        m = np.stack([np.bincount(keys[s::world] % world, minlength=world) for s in range(world)])
    elif kind == "uniform":
        m = rng.integers(40, 60, (world, world))
    else:  # mild: under the 4x trigger
        m = np.full((world, world), 64)
        m[0, 0] = 96
    return m.astype(np.int64)


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("kind", ["one_hot", "two_hot", "zipf", "uniform", "mild"])
def test_plan_schedule_matches_reference(world, kind):
    rng = np.random.default_rng(world * 10 + len(kind))
    m = _count_matrix(kind, world, rng)
    for row_bytes, budget in ((8, 1 << 40), (12, world * 64 * 12), (8, world * 16 * 8)):
        got = tsp.plan_schedule(m, row_bytes, world, budget)
        want = jsp.plan_schedule(m, row_bytes, world, budget)
        assert (got.bucket_cap, got.n_rounds) == (want.bucket_cap, want.n_rounds)
        assert got.adaptive == want.adaptive
        if got.adaptive:
            np.testing.assert_array_equal(got.relay, want.relay)
            assert got.relay_cap() == want.relay_cap()
            # the quota and the relay cover every bucket exactly
            np.testing.assert_array_equal(np.minimum(m, got.quota) + got.relay, m)
        if kind in ("uniform", "mild"):
            assert not got.adaptive
            assert (got.bucket_cap, got.n_rounds) == tsh.plan_rounds(m, row_bytes, world, budget)
        if kind == "one_hot":
            assert got.adaptive  # the split engages at W = 8 and W = 4 alike here


def test_plan_schedule_gate_and_trigger(monkeypatch):
    m = np.zeros((8, 8), np.int64)
    m[:, 3] = 256
    monkeypatch.delenv("CYLON_TPU_TORCH_NO_SKEW_SPLIT", raising=False)
    assert tsp.plan_schedule(m, 8, 8, 1 << 40).adaptive
    with tsp.skew_disabled():
        assert tsp.plan_schedule(m, 8, 8, 1 << 40) == (*tsh.plan_rounds(m, 8, 8, 1 << 40), None)
    # the feedback re-coster's tuned trigger (A9b): the JAX package's plan
    from cylon_tpu.parallel import spill as jsp

    mild = np.full((8, 8), 32, np.int64)
    mild[:, 3] = 96  # 2.8x the mean: only a tuned trigger below 4 engages
    for mat, trigger in ((m, 2), (mild, 2), (mild, None), (mild, 3)):
        got, want = (mod.plan_schedule(mat, 8, 8, 1 << 12, trigger=trigger) for mod in (tsp, jsp))
        assert (got.bucket_cap, got.n_rounds, got.adaptive) == \
            (want.bucket_cap, want.n_rounds, want.adaptive)
        if got.adaptive:
            np.testing.assert_array_equal(got.relay, want.relay)
    assert tsp.plan_schedule(mild, 8, 8, 1 << 12, trigger=2).adaptive
    assert not tsp.plan_schedule(mild, 8, 8, 1 << 12).adaptive


def test_relay_send_slots_match_reference():
    """The relay slots over B2a's pid lane and B2b's tile bases equal the
    JAX function's over a stable sort (dead rows at P, several tiles)."""
    import jax
    import jax.numpy as jnp
    from cylon_tpu_torch.ops import cuda_codec as tcc

    rng = np.random.default_rng(3)
    n, P = 9000, 8
    pid = np.where(rng.random(n) < 0.5, 5, rng.integers(0, P + 1, n)).astype(np.int32)
    lane, hist = tcc.pack_hist(None, None, (), n, P, pid=torch.from_numpy(pid))
    cnt = hist.sum(1).numpy()
    for quota in (0, 7, 600):
        relay = np.maximum(cnt - quota, 0)
        rc = int(relay.sum())
        got = tsh.relay_send_slots(lane, tcc.scan_tiles(hist), relay, quota, rc)
        want = jax.jit(jsh.relay_send_slots, static_argnums=(2, 4))(
            jnp.asarray(pid), jnp.asarray(cnt.astype(np.int32)), P, quota, rc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# whole operations at world 8
# ----------------------------------------------------------------------

def test_one_hot_shuffle_matches_reference(defaults):
    """Every row carries one key: the rounds shrink to the cold buckets and
    the hot tail crosses the relay, shipping over 40% fewer bytes."""
    n = 4096
    jt, tt = _tables(8, {"k": np.zeros(n, np.int32), "v": np.arange(n, dtype=np.float32)})
    _shards_equal(jt.shuffle(["k"]), tt.shuffle(["k"]))
    c = counters_equal()
    shipped = c["shuffle.exchanged_bytes"][1] + c["shuffle.spill.relay_bytes"][1]
    ttr.reset_trace()
    with tsp.skew_disabled():
        padded = tt.shuffle(["k"])
    assert "shuffle.skew_split" not in ttr.report("shuffle.")
    assert shipped <= 0.6 * ttr.report("shuffle.")["shuffle.exchanged_bytes"]["rows"]
    np.testing.assert_array_equal(padded.row_counts, tt.shuffle(["k"]).row_counts)


def test_zipf_shuffle_matches_reference(defaults):
    """Zipf keys (a = 1.6): the hottest bucket is 5x the mean."""
    rng = np.random.default_rng(23)
    n = 4096
    keys = (rng.zipf(1.6, n) % 131).astype(np.int32)
    jt, tt = _tables(8, {"k": keys, "v": rng.normal(size=n).astype(np.float32)})
    _shards_equal(jt.shuffle(["k"]), tt.shuffle(["k"]))
    counters_equal()


def _skewed_sides(rng, n=4000, hot=0.5, keyspace=500, payload=np.float32):
    """A left side with ``hot`` of its rows on key 3 (the rest uniform) and
    a ``payload`` column, and a 300-row right side: the shapes of every
    skewed join here, so the JAX side compiles its programs once a
    schema."""
    k = np.where(rng.random(n) < hot, 3, rng.integers(0, keyspace, n)).astype(np.int32)
    left = {"k": k, "v": rng.normal(size=n).astype(payload)}
    right = {"k": rng.integers(0, keyspace, 300).astype(np.int32),
             "w": rng.normal(size=300).astype(np.float32)}
    right["k"][0] = 3
    return left, right


def test_skewed_join_matches_reference(defaults):
    jl, tl = _tables(8, _skewed_sides(np.random.default_rng(4))[0])
    jr, tr = _tables(8, _skewed_sides(np.random.default_rng(4))[1])
    _shards_equal(jl.distributed_join(jr, on="k"), tl.distributed_join(tr, on="k"))
    counters_equal()


def test_skewed_join_with_semi_filter_matches_reference(defaults, monkeypatch):
    """The right side holds a sliver of the left's keys and the hot key:
    the semi filter prunes the left's partnerless rows (a 4096-bit sketch
    keeps it worth building at this size), the hot key's tail relays."""
    monkeypatch.setenv("CYLON_TPU_SKETCH_BITS", "4096")
    monkeypatch.setenv("CYLON_TPU_TORCH_SKETCH_BITS", "4096")
    left, right = _skewed_sides(np.random.default_rng(6), hot=0.2, keyspace=50_000)
    jl, tl = _tables(8, left)
    jr, tr = _tables(8, right)
    _shards_equal(jl.distributed_join(jr, on="k"), tl.distributed_join(tr, on="k"))
    counters_equal()
    assert ttr.get_count("shuffle.semi_filter.applied") >= 1


@pytest.mark.parametrize("tier", ["", "1"])
def test_skewed_join_quantized_relay_matches_reference(defaults, monkeypatch, tier):
    """A float64 payload at quant_tol=1e-2: the relay ships q8 codes under
    one block scale a source, decoded on the host; forced through tier 1,
    the staged rounds keep q8 codes in the arenas under one scale a round
    and shard, and the relayed rows are encoded again into them. Bit for
    bit the JAX package's."""
    for pkg in ("CYLON_TPU_", "CYLON_TPU_TORCH_"):
        monkeypatch.setenv(pkg + "QUANT_TOL", "0.01")
        monkeypatch.setenv(pkg + "SPILL_TIER", tier)
    left, right = _skewed_sides(np.random.default_rng(8), payload=np.float64)
    jl, tl = _tables(8, left)
    jr, tr = _tables(8, right)
    _shards_equal(jl.distributed_join(jr, on="k"), tl.distributed_join(tr, on="k"))
    counters_equal()
    names = ["shuffle.quant.relay_bytes_saved"]
    if tier:
        names += ["shuffle.quant.spill_bytes_saved", "shuffle.quant.spill_reencoded",
                  "shuffle.spill.staged_rounds"]
    for name in names:
        got = [(int(rep(name)[name]["count"]), int(rep(name)[name]["rows"])) for rep in (ttr.report, jtr.report)]
        assert got[0] == got[1] and got[0][0] > 0, name


def test_sort_with_duplicate_block_matches_reference(defaults):
    """distributed_sort's range shuffle over a 60% block of one key."""
    rng = np.random.default_rng(5)
    n = 3000
    k = np.where(rng.random(n) < 0.6, 42, rng.integers(0, 1000, n)).astype(np.int32)
    jt, tt = _tables(8, {"k": k, "v": np.arange(n, dtype=np.int32)})
    got = tt.distributed_sort("k")
    _shards_equal(jt.distributed_sort("k"), got)
    counters_equal()
    np.testing.assert_array_equal(got.to_pandas()["k"].to_numpy(), np.sort(k))
