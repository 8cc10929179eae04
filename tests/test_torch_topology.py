"""The port's two-hop topology exchange (parallel/topo.py, the grouped
all_to_alls and the ring of both communicators, table._plan_state's
two-hop plan) against the JAX package's, on the CPU, on 2-D meshes.

Both packages declare the same mesh (``GPUConfig(mesh_shape=...)`` and
``TPUConfig(devices=..., mesh_shape=...)`` on the conftest's eight CPU
devices) and run every tier at its default, the skew split included,
with the JAX side's feedback autopilot off (``CYLON_TPU_NO_AUTOTUNE``:
its hop mode is A9's). The host half equals the JAX functions on seeded
matrices. Shuffles, joins, a string and null groupby, ``distributed_sort``
and the set ops at ``4x2``, ``2x4`` (world 8) and ``2x2`` (world 4) equal
the JAX package shard for shard, in row order, with the counters
``shuffle.coll_bytes.{intra,inter,inter_alt}``, ``shuffle.relay.ring_rows``,
``shuffle.exchanged_bytes``, ``shuffle.rounds``, ``shuffle.spill.relay_bytes``
and ``shuffle.skew_split`` equal; and they equal the port's own flat path
(``topo.disabled()``) as row multisets a shard. The fused join at ``2x2``
equals the JAX fused two-hop shard for shard and the port's flat fused
join as row multisets.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.parallel import topo as jtopo
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch.engine import round_cap
from cylon_tpu_torch.parallel import topo as ttopo
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _encode, _shard_frame, _shards_equal

torch.set_num_threads(1)

#: every knob both packages leave at its default here
DEFAULTS = ("CYLON_TPU_NO_TOPO", "CYLON_TPU_TORCH_NO_TOPO", "CYLON_TPU_MESH",
            "CYLON_TPU_TORCH_MESH", "CYLON_TPU_OUTER_BUDGET", "CYLON_TPU_TORCH_OUTER_BUDGET",
            "CYLON_TPU_NO_SKEW_SPLIT", "CYLON_TPU_TORCH_NO_SKEW_SPLIT", "CYLON_TPU_NO_SEMI_FILTER",
            "CYLON_TPU_TORCH_NO_SEMI_FILTER", "CYLON_TPU_NO_LANE_PACK",
            "CYLON_TPU_TORCH_NO_LANE_PACK", "CYLON_TPU_NO_QUANT", "CYLON_TPU_TORCH_NO_QUANT",
            "CYLON_TPU_QUANT_TOL", "CYLON_TPU_TORCH_QUANT_TOL", "CYLON_TPU_SPILL_TIER",
            "CYLON_TPU_TORCH_SPILL_TIER", "CYLON_TPU_SPILL_DEVICE_BUDGET",
            "CYLON_TPU_TORCH_SPILL_DEVICE_BUDGET")
#: the counters held equal
COUNTERS = ("shuffle.coll_bytes.intra", "shuffle.coll_bytes.inter", "shuffle.coll_bytes.inter_alt",
            "shuffle.relay.ring_rows", "shuffle.exchanged_bytes", "shuffle.rounds",
            "shuffle.spill.relay_bytes", "shuffle.skew_split")
AXIS = ("shuffle.coll_bytes.intra", "shuffle.coll_bytes.inter", "shuffle.coll_bytes.inter_alt")
MESHES = [("4x2", 8), ("2x4", 8), ("2x2", 4)]

_CTX = {}


def _contexts(mesh, world):
    """(JAX, port) contexts declared with ``mesh``, made once a mesh."""
    if mesh not in _CTX:
        _CTX[mesh] = (
            ct.CylonContext.init_distributed(
                ct.TPUConfig(devices=jax.devices()[:world], mesh_shape=mesh)),
            ctt.CylonContext.init_distributed(
                ctt.GPUConfig(device="cpu", world_size=world, mesh_shape=mesh)),
        )
    return _CTX[mesh]


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_NO_AUTOTUNE", "1")
    for k in DEFAULTS:
        monkeypatch.delenv(k, raising=False)
    jtr.reset_trace()
    ttr.reset_trace()


def counters(rep):
    got = rep("shuffle.")
    return {k: (int(got[k]["count"]), int(got[k].get("rows", 0))) for k in COUNTERS if k in got}


def counters_equal():
    got, want = counters(ttr.report), counters(jtr.report)
    assert got == want
    return got


def _tables(mesh, world, cols):
    jctx, tctx = _contexts(mesh, world)
    enc = _encode(cols)
    return ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)


def multisets_equal(a, b):
    """Per shard the same rows, in any order."""
    np.testing.assert_array_equal(a.row_counts, b.row_counts)
    for s in range(len(a.row_counts)):
        fa, fb = _shard_frame(a, s, True), _shard_frame(b, s, True)
        cols = list(fa.columns)
        fa = fa.sort_values(cols, na_position="last").reset_index(drop=True)
        fb = fb.sort_values(cols, na_position="last").reset_index(drop=True)
        pd.testing.assert_frame_equal(fa, fb)


def flat(fn):
    """``fn()`` on the port's flat path, with the counters it moves left
    out of the ones under test."""
    saved = ttr.report("shuffle.")
    with ttopo.disabled():
        out = fn()
    ttr.reset_trace()
    for k, v in saved.items():
        if "rows" in v:
            ttr.bump(k, rows=int(v["rows"]))
    return out


# ----------------------------------------------------------------------
# the host half
# ----------------------------------------------------------------------

def test_parse_mesh_and_groups_match_reference():
    for spec, world in (("", 8), ("4x2", 8), (" 2X4 ", 8), ("8x1", 8), ("2x2", 4)):
        assert ttopo.parse_mesh(spec, world) == jtopo.parse_mesh(spec, world)
    for spec, world, msg in (("4", 8, "expected 'OxI'"), ("ax2", 8, "non-integer"),
                             ("4x2", 16, "!= world size"), ("0x8", 8, ">= 1")):
        with pytest.raises(ValueError, match=msg):
            ttopo.parse_mesh(spec, world)
        with pytest.raises(ValueError, match=msg):
            jtopo.parse_mesh(spec, world)
    for o, i in ((4, 2), (2, 4), (2, 2), (3, 3)):
        t, j = ttopo.Topology(o, i), jtopo.Topology(o, i)
        assert ttopo.inner_groups(t) == jtopo.inner_groups(j)
        assert ttopo.outer_groups(t) == jtopo.outer_groups(j)
        assert ttopo.ring_perm(t) == jtopo.ring_perm(j)
    with pytest.raises(ValueError, match="!= world size"):
        ctt.GPUConfig(device="cpu", world_size=4, mesh_shape="4x2")


@pytest.mark.parametrize("o,i", [(4, 2), (2, 4), (2, 2)])
def test_plans_and_ledger_match_reference(o, i):
    rng = np.random.default_rng(o * 10 + i)
    world = o * i
    t, j = ttopo.Topology(o, i), jtopo.Topology(o, i)
    for cap in (8, 64):
        m = rng.integers(0, 2 * cap, (world, world)).astype(np.int64)
        k = int(-(-m.max() // cap))
        np.testing.assert_array_equal(ttopo.hop2_window_counts(m, t, cap, k),
                                      jtopo.hop2_window_counts(m, j, cap, k))
        tp = ttopo.plan_two_hop(m, t, cap, k, 1)
        assert tuple(tp) == tuple(jtopo.plan_two_hop(m, j, cap, k, 1))
        assert tp.cap_o <= i * round_cap(cap)
        for cap_o in (None, tp.cap_o):
            for topo_t, topo_j in ((t, j), (None, None)):
                assert ttopo.axis_coll_bytes(topo_t, world, cap, k, 12, 1, cap_o=cap_o) == \
                    jtopo.axis_coll_bytes(topo_j, world, cap, k, 12, 1, cap_o=cap_o)
        for r in range(k):
            n_self, n_cross = ttopo.round_split(m, t, cap, r)
            w = np.clip(m - r * cap, 0, cap)
            np.testing.assert_array_equal(n_self + n_cross, w.sum(axis=0))
            # a shard's cross-outer rows are what the hop-2 aggregates send it
            agg = ttopo.hop2_window_counts(m, t, cap, k)[r].reshape(o, i, o)
            np.testing.assert_array_equal(n_cross, agg.sum(axis=0).T.reshape(-1))
    relay = np.where(rng.random((world, world)) < 0.3, rng.integers(1, 50, (world, world)), 0)
    for mat in (relay, np.zeros((world, world), np.int64), np.eye(world, dtype=np.int64) * 5):
        got, want = ttopo.split_relay(mat, t), jtopo.split_relay(mat, j)
        for g, w_ in zip(got, want):
            assert (g is None) == (w_ is None)
            if g is not None:
                np.testing.assert_array_equal(g, w_)
                assert ttopo.ring_cap(g) == jtopo.ring_cap(w_)
                assert ttopo.ring_bytes(t, ttopo.ring_cap(g), 12) == \
                    jtopo.ring_bytes(j, jtopo.ring_cap(w_), 12)


def test_local_collectives_route_like_groups():
    """The one-process grouped all_to_all and ppermute: chunk b of member
    a's output is chunk a of member b's input; the ring moves each buffer
    to its next group-mate; the structured two-hop gives the flat
    all_to_all's output."""
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=8))
    comm = ctx.comm
    topo = ttopo.Topology(4, 2)
    bufs = [torch.arange(8 * 3, dtype=torch.int32).view(8, 3) + 100 * s for s in range(8)]
    flat_out = comm.all_to_all(bufs)
    for got, want in zip(ttopo.exchange_buffer_structured(comm, bufs, topo), flat_out):
        assert torch.equal(got, want)
    g = comm.all_to_all_grouped([b[:4] for b in bufs], ttopo.outer_groups(topo))
    assert torch.equal(g[3][1], bufs[3][1])  # shard 3 is member 1 of (1, 3, 5, 7)
    assert torch.equal(g[3][2], bufs[5][1])
    ring = comm.ppermute(bufs, ttopo.ring_perm(topo))
    assert all(torch.equal(ring[d], bufs[d ^ 1]) for d in range(8))
    assert torch.equal(comm.ppermute(bufs, ((0, 1),))[2], torch.zeros_like(bufs[2]))


def test_two_part_compact_equals_reference_receive():
    """One two-hop round of seeded buffers at 4x2: each shard's received
    parts equal the JAX package's ``two_hop_received`` (rows, mask,
    total), and B3 on the two parts (its plain version here), the
    same-group rows then the combined chunks, gives the rows of that
    triple's mask-and-argsort compaction, in order."""
    import jax.numpy as jnp

    from cylon_tpu_torch.ops import cuda_codec
    from cylon_tpu_torch.parallel import shuffle as tsh

    topo, world, bc, lanes = ttopo.Topology(4, 2), 8, 16, 3
    rng = np.random.default_rng(2)
    m = rng.integers(0, bc + 1, (world, world))
    tp = ttopo.plan_two_hop(m, topo, bc, 1, 1)
    bufs = []
    for s in range(world):
        buf = torch.from_numpy(rng.integers(-1000, 1000, (world * (bc + 1), lanes)).astype(np.int32))
        buf.view(world, bc + 1, lanes)[:, 0, 0] = torch.from_numpy(m[s].astype(np.int32))
        bufs.append(buf)
    comm = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=world)).comm
    n_self, n_cross = ttopo.round_split(m, topo, bc, 0)
    for d, (g2, self_rows, self_cnt) in enumerate(
            ttopo.two_hop_exchange(comm, bufs, range(world), topo, bc, tp.cap_o, 1)):
        rows, mask, total = ttopo.two_hop_received(g2, self_rows, self_cnt, topo, bc, tp.cap_o, 1)
        j_rows, j_mask, j_total = jtopo.two_hop_received(
            jnp.asarray(g2.numpy()), jnp.asarray(self_rows.numpy()),
            jnp.asarray(self_cnt.numpy()), jtopo.Topology(4, 2), bc, tp.cap_o, 1)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        assert int(total) == int(j_total) == n_self[d] + n_cross[d]
        parts = torch.cat([
            cuda_codec.compact_move(self_rows, self_cnt, topo.inner, bc)[:n_self[d]],
            cuda_codec.compact_move(g2, tsh.header_counts(g2, topo.outer), topo.outer, tp.cap_o,
                                    n_header=1)[:n_cross[d]]])
        assert torch.equal(parts, rows[torch.argsort(~mask, stable=True)][:int(total)])


# ----------------------------------------------------------------------
# whole operations against the JAX package
# ----------------------------------------------------------------------

def _uniform(rng, n=4096, keys=300):
    return {"k": rng.integers(0, keys, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)}


def _nullable(rng, n=2000):
    """A dictionary string column with nulls, an int32 key and a float32
    payload with nulls."""
    words = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta", None], dtype=object)
    v = rng.normal(size=n).astype(np.float32).astype(object)
    v[rng.random(n) < 0.1] = None
    return {"s": words[rng.integers(0, len(words), n)], "k": rng.integers(0, 60, n).astype(np.int32),
            "v": v}


#: each operation: (its input columns, the call on (table, other table))
OPS = {
    "shuffle": (_uniform, lambda t, u: t.shuffle(["k"])),
    "join": (_uniform, lambda t, u: t.distributed_join(u, on="k")),
    # a string key with nulls, and null payloads
    "groupby": (_nullable, lambda t, u: t.distributed_groupby("s", {"v": "sum", "k": "max"})),
    # the range shuffle: B2a in pid mode
    "sort": (_nullable, lambda t, u: t.distributed_sort("k")),
    "union": (_nullable, lambda t, u: t.distributed_union(u)),
    "intersect": (_nullable, lambda t, u: t.distributed_intersect(u)),
    "unique": (_nullable, lambda t, u: t.distributed_unique(["k"])),
}
#: the cases of every run; the rest of the sweep is under -m slow (the
#: JAX package compiles its programs anew for every mesh and operation)
TIER1 = {("4x2", "shuffle"), ("4x2", "join"), ("2x4", "groupby"), ("2x4", "sort"),
         ("2x2", "union"), ("2x2", "unique")}


@pytest.mark.parametrize("mesh,world,op", [
    pytest.param(m, w, op, marks=() if (m, op) in TIER1 else pytest.mark.slow)
    for m, w in MESHES for op in OPS])
def test_op_matches_reference(env, mesh, world, op):
    """Shard for shard, in row order, and with equal counters, the JAX
    package's result on the same mesh; as row multisets a shard, the port's
    own flat path's (the flat route may deliver equal keys in another
    order, which a stable local sort keeps)."""
    make, call = OPS[op]
    rng = np.random.default_rng(world + len(mesh) + len(op))
    cols = make(rng)
    jt, tt = _tables(mesh, world, cols)
    other = {c: x[::3] for c, x in cols.items()}
    if op == "join":
        other = {"k": rng.integers(0, 300, 800).astype(np.int32),
                 "w": rng.normal(size=800).astype(np.float32)}
    ju, tu = _tables(mesh, world, other)
    got = call(tt, tu)
    _shards_equal(call(jt, ju), got, agg=op == "groupby")
    c = counters_equal()
    assert c["shuffle.coll_bytes.intra"][1] > 0 and c["shuffle.coll_bytes.inter"][1] > 0, c
    multisets_equal(got, flat(lambda: call(tt, tu)))
    if op == "sort":
        np.testing.assert_array_equal(got.to_pandas()["k"].to_numpy(), np.sort(cols["k"]))


def _locality_shards(rng, world, inner, n_shard, own=0.8):
    """Per-shard keys, ``own`` of each shard's keys hashing to its own
    outer group by the port's murmur3 partition ids (tools/topo_smoke.py's
    shape)."""
    from cylon_tpu_torch.ops.partition import hash_partition_ids

    cand = np.arange(20000, dtype=np.int32)
    pid = hash_partition_ids([(torch.from_numpy(cand), None)], None, world).numpy()
    pools = [cand[(pid // inner) == g] for g in range(world // inner)]
    keys = [np.concatenate([rng.choice(pools[p // inner], int(n_shard * own)),
                            rng.choice(cand, n_shard - int(n_shard * own))]) for p in range(world)]
    return np.concatenate(keys).astype(np.int32)


def test_locality_saving_and_outer_budget(env, monkeypatch):
    """80% own-group keys at 4x2: the two-hop cross-outer bytes are at most
    0.75 of the flat exchange's (inter_alt), as the JAX tool gates; a
    2048-byte outer budget plans more rounds and moves the same rows. Both
    equal the JAX package."""
    rng = np.random.default_rng(23)
    k = _locality_shards(rng, 8, 2, 512)
    jt, tt = _tables("4x2", 8, {"k": k, "v": rng.normal(size=k.size).astype(np.float32)})
    got = tt.shuffle(["k"])
    _shards_equal(jt.shuffle(["k"]), got)
    c = counters_equal()
    assert c["shuffle.coll_bytes.inter"][1] <= 0.75 * c["shuffle.coll_bytes.inter_alt"][1], c
    k0 = c["shuffle.rounds"][1]
    for var in ("CYLON_TPU_OUTER_BUDGET", "CYLON_TPU_TORCH_OUTER_BUDGET"):
        monkeypatch.setenv(var, "2048")
    jtr.reset_trace()
    ttr.reset_trace()
    tight = tt.shuffle(["k"])
    _shards_equal(jt.shuffle(["k"]), tight)
    assert counters_equal()["shuffle.rounds"][1] > k0
    multisets_equal(tight, got)


@pytest.mark.parametrize("mesh,world", [("4x2", 8), pytest.param("2x4", 8, marks=pytest.mark.slow)])
def test_ring_relay_matches_reference(env, mesh, world):
    """A one-hot key at world 8: the skew split relays the hot bucket's
    tail; its same-group part rides the device ring (``ring_rows`` > 0),
    the cross-outer part the host relay, in the JAX order: the rounds, the
    host relay, the ring."""
    n = 4096
    jt, tt = _tables(mesh, world, {"k": np.zeros(n, np.int32), "v": np.arange(n, dtype=np.float32)})
    got = tt.shuffle(["k"])
    _shards_equal(jt.shuffle(["k"]), got)
    c = counters_equal()
    assert c["shuffle.relay.ring_rows"][1] > 0 and c["shuffle.skew_split"][1] > 0
    multisets_equal(got, flat(lambda: tt.shuffle(["k"])))


@pytest.mark.slow
def test_spilled_two_hop_matches_reference(env, monkeypatch):
    """Forced through tier 1 at 4x2, at several rounds: each round's two
    parts are staged to the host arenas; a one-hot shuffle keeps its
    whole tail on the host relay (the ring runs at tier 0 only). Shard
    for shard and counter for counter the JAX package's."""
    for var in ("CYLON_TPU_SPILL_TIER", "CYLON_TPU_TORCH_SPILL_TIER"):
        monkeypatch.setenv(var, "1")
    rng = np.random.default_rng(3)
    for cols in (_uniform(rng), {"k": np.zeros(4096, np.int32),
                                 "v": np.arange(4096, dtype=np.float32)}):
        jtr.reset_trace()
        ttr.reset_trace()
        jt, tt = _tables("4x2", 8, cols)
        _shards_equal(jt.shuffle(["k"], byte_budget=8 * 64 * 8),
                      tt.shuffle(["k"], byte_budget=8 * 64 * 8))
        assert "shuffle.relay.ring_rows" not in counters_equal()


def test_flat_context_and_kill_switch_are_counter_clean(env):
    """A context with no topology bumps no per-axis counter and plans as
    before; the kill switch on a 2-D context keeps the flat path's
    rounds and bytes; a degenerate shape is flat."""
    rng = np.random.default_rng(3)
    cols = _uniform(rng)
    flat_ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=8))
    deg = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=8,
                                                          mesh_shape="8x1"))
    assert ttopo.effective(flat_ctx) is None and ttopo.effective(deg) is None
    for ctx in (flat_ctx, deg):
        ttr.reset_trace()
        ctt.Table.from_pydict(ctx, cols).shuffle(["k"])
        rep = ttr.report("shuffle.")
        assert not any(k in rep for k in AXIS + ("shuffle.relay.ring_rows",)), rep
        base = {k: rep[k]["rows"] for k in ("shuffle.rounds", "shuffle.exchanged_bytes")}
    _jctx, tctx = _contexts("4x2", 8)
    assert ttopo.effective(tctx) == ttopo.Topology(4, 2)
    ttr.reset_trace()
    with ttopo.disabled():
        assert ttopo.effective(tctx) is None
        ctt.Table.from_pydict(tctx, cols).shuffle(["k"])
    rep = ttr.report("shuffle.")
    assert not any(k in rep for k in AXIS)
    assert {k: rep[k]["rows"] for k in base} == base


def test_gate_state_joins_the_fingerprint(env, monkeypatch):
    from cylon_tpu_torch.plan.lazy import gated_fingerprint

    _jctx, tctx = _contexts("4x2", 8)
    t = ctt.Table.from_pydict(tctx, _uniform(np.random.default_rng(1), 200, 50))
    lf = t.lazy().filter(ctt.col("v") > 0.0)
    fp_on = gated_fingerprint(lf.plan)
    assert ttopo.gate_state() == (True, "")
    with ttopo.disabled():
        assert gated_fingerprint(lf.plan) != fp_on
    monkeypatch.setenv("CYLON_TPU_TORCH_MESH", "4x2")
    assert ttopo.gate_state() == (True, "4x2") and gated_fingerprint(lf.plan) != fp_on
    # read at init: a context made now takes the env's shape
    assert ctt.CylonContext.init_distributed(
        ctt.GPUConfig(device="cpu", world_size=8)).topology == ttopo.Topology(4, 2)
    assert ctt.CylonContext.init_distributed(
        ctt.GPUConfig(device="cpu", world_size=8, mesh_shape="2x4")).topology == (2, 4)


def test_fused_join_matches_reference(env):
    """mode="fused" at 2x2: every round's exchange is the structured
    two-hop, shard for shard the JAX fused join, as row multisets the
    port's flat fused join; the fused axis bytes equal the JAX
    package's."""
    rng = np.random.default_rng(9)
    jl, tl = _tables("2x2", 4, _uniform(rng, 600, 300))
    jr, tr = _tables("2x2", 4, {"k": rng.integers(0, 300, 500).astype(np.int32),
                                 "w": rng.normal(size=500), "b": rng.random(500) > 0.5})
    got = tl.distributed_join(tr, on="k", mode="fused")
    _shards_equal(jl.distributed_join(jr, on="k", mode="fused"), got)
    c = counters_equal()
    assert c["shuffle.coll_bytes.intra"][1] > 0
    multisets_equal(got, flat(lambda: tl.distributed_join(tr, on="k", mode="fused")))


def test_quantized_wire_keeps_the_flat_path(env, monkeypatch):
    """A q8 field keeps the flat exchange: its per-chunk scales ride the
    header rows, which the hop-2 repack does not carry. The port's rows
    equal the JAX package's flat exchange (whose two-hop path raises on
    such a plan, ROADMAP.md C2); the per-axis ledger splits the flat
    exchange and no inter_alt is counted."""
    for var in ("CYLON_TPU_QUANT_TOL", "CYLON_TPU_TORCH_QUANT_TOL"):
        monkeypatch.setenv(var, "0.01")
    rng = np.random.default_rng(1)
    cols = {"k": rng.integers(-2**31, 2**31 - 1, 4000).astype(np.int32),
            "w": rng.normal(size=4000)}
    jt, tt = _tables("2x2", 4, cols)
    got = tt.shuffle(["k"])
    monkeypatch.setenv("CYLON_TPU_NO_TOPO", "1")
    _shards_equal(jt.shuffle(["k"]), got)
    rep = ttr.report("shuffle.")
    assert rep["shuffle.quant.applied"]["count"] == 1
    assert "shuffle.coll_bytes.inter_alt" not in rep
    # the flat split: one group-mate chunk (intra) to two cross-group ones
    intra, inter = rep["shuffle.coll_bytes.intra"]["rows"], rep["shuffle.coll_bytes.inter"]["rows"]
    assert intra > 0 and 2 * intra == inter
