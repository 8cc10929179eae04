"""The port's knob registry (utils/envgate.py) and lane packing (ops/stats.py,
the sort-word and canonical-lane fusion of ops/sort.py, the wire codec of
ops/gather.py) against the JAX package's, on the CPU, both packages at
their defaults for lane packing, the semi filter and the skew split; the
JAX side keeps ``CYLON_TPU_NO_QUANT``, ``NO_TOPO`` and ``NO_AUTOTUNE`` at 1
(tests/test_torch_semi_filter.py).

Bit layouts round-trip and equal the JAX package's words; ``FusePlan`` and
``WirePlan`` equal its plans on the same schemas and stats; sort, groupby,
the multi-key join, ``distributed_sort`` and the wire-narrowed shuffle
equal its results shard by shard, exactly (floats too: a sort and a
shuffle move values, they add none), with the ``lane_pack.*`` counters;
each kill switch gives the tiers-off result.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.ops import gather as jg
from cylon_tpu.ops import sort as jso
from cylon_tpu.ops import stats as jst
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch import config as tcfg
from cylon_tpu_torch import table as ttbl
from cylon_tpu_torch import ordering as tord
from cylon_tpu_torch.ops import gather as tg
from cylon_tpu_torch.ops import sketch as tsk
from cylon_tpu_torch.ops import sort as tso
from cylon_tpu_torch.ops import stats as tst
from cylon_tpu_torch.utils import envgate
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_semi_filter import _both, counters_equal, defaults  # noqa: F401
from test_torch_shuffle_slice import _contexts, _encode, _shards_equal

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# the knob registry (A5)
# ----------------------------------------------------------------------

def test_registry_holds_the_ports_knobs_and_only_those():
    assert set(envgate.REGISTRY) == {
        "CYLON_TPU_TORCH_NO_ORDERING", "CYLON_TPU_TORCH_NO_SEMI_FILTER",
        "CYLON_TPU_TORCH_NO_LANE_PACK", "CYLON_TPU_TORCH_SHUFFLE_BUDGET",
        "CYLON_TPU_TORCH_SKETCH_BITS", "CYLON_TPU_TORCH_NO_QUANT", "CYLON_TPU_TORCH_QUANT_TOL",
        "CYLON_TPU_TORCH_NO_SKEW_SPLIT", "CYLON_TPU_TORCH_SPILL_TIER",
        "CYLON_TPU_TORCH_SPILL_DEVICE_BUDGET", "CYLON_TPU_TORCH_SPILL_HOST_BUDGET",
        "CYLON_TPU_TORCH_SPILL_DIR", "CYLON_TPU_TORCH_SPILL_RETRIES", "CYLON_TPU_TORCH_FAULTS",
        "CYLON_TPU_TORCH_NO_TOPO", "CYLON_TPU_TORCH_MESH", "CYLON_TPU_TORCH_OUTER_BUDGET",
        "CYLON_TPU_TORCH_NO_NATIVE", "CYLON_TPU_TORCH_PLATFORM",
        "CYLON_TPU_TORCH_TRACE", "CYLON_TPU_TORCH_PROF", "CYLON_TPU_TORCH_TRACE_RING",
        "CYLON_TPU_TORCH_TRACE_EXPORT", "CYLON_TPU_TORCH_OBS_DIR", "CYLON_TPU_TORCH_METRICS_PORT",
        "CYLON_TPU_TORCH_LEAK_GRACE_S", "CYLON_TPU_TORCH_SLO_WINDOW_S",
        "CYLON_TPU_TORCH_NO_AUTOTUNE", "CYLON_TPU_TORCH_AUTOTUNE_MIN_OBS",
        "CYLON_TPU_TORCH_AUTOTUNE_MARGIN", "CYLON_TPU_TORCH_SERVE_P99_TARGET_MS",
        "CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES", "CYLON_TPU_TORCH_SERVE_QUEUE_DEPTH",
        "CYLON_TPU_TORCH_SERVE_BATCH_MAX", "CYLON_TPU_TORCH_SERVE_DEADLINE_MS",
        "CYLON_TPU_TORCH_STREAM_CHUNK_ROWS", "CYLON_TPU_TORCH_STREAM_STATE_BUDGET",
        "CYLON_TPU_TORCH_NO_IVM",
    }
    kinds = {k: v.kind for k, v in envgate.REGISTRY.items()}
    assert kinds["CYLON_TPU_TORCH_SHUFFLE_BUDGET"] == kinds["CYLON_TPU_TORCH_SKETCH_BITS"] == "tuning"
    assert kinds["CYLON_TPU_TORCH_QUANT_TOL"] == "dispatch"
    # the spill, topology, native, observability, feedback, serving and
    # streaming knobs take their JAX counterparts' kinds and defaults
    from cylon_tpu.plan import feedback as _jfb  # noqa: F401 - registers NO_AUTOTUNE
    from cylon_tpu.utils import envgate as jenv
    from cylon_tpu_torch.plan import feedback as _tfb  # noqa: F401

    for name in ("SPILL_TIER", "SPILL_DEVICE_BUDGET", "SPILL_HOST_BUDGET", "SPILL_DIR",
                 "SPILL_RETRIES", "FAULTS", "NO_SKEW_SPLIT", "NO_TOPO", "MESH", "OUTER_BUDGET",
                 "NO_NATIVE", "PLATFORM", "TRACE", "PROF", "TRACE_RING", "TRACE_EXPORT",
                 "METRICS_PORT", "LEAK_GRACE_S", "OBS_DIR", "SLO_WINDOW_S", "NO_AUTOTUNE",
                 "AUTOTUNE_MIN_OBS", "AUTOTUNE_MARGIN", "SERVE_P99_TARGET_MS",
                 "SERVE_INFLIGHT_BYTES", "SERVE_QUEUE_DEPTH", "SERVE_BATCH_MAX",
                 "SERVE_DEADLINE_MS", "STREAM_CHUNK_ROWS", "STREAM_STATE_BUDGET", "NO_IVM"):
        mine, ref = envgate.REGISTRY["CYLON_TPU_TORCH_" + name], jenv.REGISTRY["CYLON_TPU_" + name]
        assert (mine.kind, mine.default) == (ref.kind, ref.default), name
    assert all(v.note or v.keyed_via for v in envgate.REGISTRY.values())
    with pytest.raises(ValueError):
        envgate.EnvKnob("CYLON_TPU_NO_RADIX")  # not the port's prefix
    with pytest.raises(ValueError):
        envgate.EnvKnob("CYLON_TPU_TORCH_X", kind="impl")


@pytest.mark.parametrize("gate,var", [
    (tord, "CYLON_TPU_TORCH_NO_ORDERING"), (tsk, "CYLON_TPU_TORCH_NO_SEMI_FILTER"),
    (tst, "CYLON_TPU_TORCH_NO_LANE_PACK"),
])
def test_kill_switches_read_their_variable_and_nest(monkeypatch, gate, var):
    monkeypatch.delenv(var, raising=False)
    assert gate.enabled()
    with gate.disabled():
        assert os.environ[var] == "1" and not gate.enabled()
        with gate.disabled():
            assert not gate.enabled()
        assert not gate.enabled()
    assert gate.enabled() and var not in os.environ
    monkeypatch.setenv(var, "1")
    assert not gate.enabled()


def test_tuning_knobs_resolve_config_then_env_then_default(monkeypatch):
    monkeypatch.delenv("CYLON_TPU_TORCH_SHUFFLE_BUDGET", raising=False)
    monkeypatch.delenv("CYLON_TPU_TORCH_SKETCH_BITS", raising=False)
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))
    assert ctx.shuffle_byte_budget == tcfg.DEFAULT_SHUFFLE_BYTE_BUDGET == 32 << 20
    assert ctx.sketch_bits == tcfg.DEFAULT_SKETCH_BITS == 1 << 21
    monkeypatch.setenv("CYLON_TPU_TORCH_SHUFFLE_BUDGET", "4096")
    monkeypatch.setenv("CYLON_TPU_TORCH_SKETCH_BITS", "8192")
    assert (ctx.shuffle_byte_budget, ctx.sketch_bits) == (4096, 8192)
    ctx.add_config("shuffle_byte_budget", 1024)
    ctx.add_config("sketch_bits", 2048)
    assert (ctx.shuffle_byte_budget, ctx.sketch_bits) == (1024, 2048)
    assert tcfg.SEMI_FILTER_MIN_PAYOFF == 2


# ----------------------------------------------------------------------
# bit layouts and plans
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bits_list,allow64", [
    ([2, 1, 12, 16, 20], True),    # one uint64 word
    ([2, 1, 12, 16, 20], False),   # the 16-bit field straddles two uint32 words
    ([20, 20, 30], False),         # two straddling fields
    ([33, 40, 1], True),           # a 64-bit word and a straddle into the next
    ([0, 0], False),               # zero widths: one zero word
])
def test_layout_round_trips_and_equals_reference(bits_list, allow64):
    rng = np.random.default_rng(1)
    layout = tst.layout_words(bits_list, allow64)
    assert layout == jst.layout_words(bits_list, allow64)
    vals = [rng.integers(0, 1 << b, 257, dtype=np.uint64) if b else np.zeros(257, np.uint64)
            for b in bits_list]
    words = tst.assemble_words([torch.from_numpy(v.view(np.int64)) for v in vals], layout)
    back = tst.extract_fields(words, layout, bits_list)
    for v, b in zip(vals, back):
        np.testing.assert_array_equal(b.numpy().view(np.uint64), v)
    jw = jst.assemble_words(
        [jnp.asarray(v if b > 32 else v.astype(np.uint32)) for v, b in zip(vals, bits_list)], layout)
    for j, t in zip(jw, words):
        np.testing.assert_array_equal(t.numpy().view(np.uint32 if t.dtype == torch.int32 else np.uint64),
                                      np.asarray(j))


SPECS = [
    ([("i32", 12, False, True), ("i32", 16, True, True), ("i32", 20, False, False)], 2, 0),
    ([("i32", 12, False, True), ("i32", 16, False, True)], 2, 14),
    ([("f32", 32, False, False)], 2, 0),                   # descending float: none
    ([("i64", 44, False, True), ("u32", 16, True, True)], 1, 0),
    ([("i32", 32, False, True)], 1, 0),                    # no fewer words: none
    ([("bool", 1, True, True), ("i64", 64, False, True)], 1, 0),
]


@pytest.mark.parametrize("specs,pad,prefix", SPECS)
def test_fuse_plan_equals_reference(specs, pad, prefix):
    for allow64 in (True, False):
        got = tso.plan_lane_fusion(specs, pad_bits=pad, prefix_bits=prefix, allow64=allow64)
        want = jso.plan_lane_fusion(specs, pad_bits=pad, prefix_bits=prefix, allow64=allow64)
        assert (got is None) == (want is None) and (got is None or tuple(got) == tuple(want))


def _wide_cols(rng, n):
    """Every lane-codec case: narrow ints, a full int64, a bool, float16, a
    float32, a float64, a dictionary code, nullable ints."""
    valid = rng.random(n) > 0.1
    return {
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "i32": rng.integers(1000, 1000 + 3000, n).astype(np.int32),
        "i64": rng.integers(-(2**50), 2**50, n).astype(np.int64),
        "u16": rng.integers(0, 60000, n).astype(np.uint16),
        "b": rng.random(n) > 0.5,
        "h": rng.normal(size=n).astype(np.float16),
        "f": rng.normal(size=n).astype(np.float32),
        "d": rng.normal(size=n),
        "s": rng.choice(np.array(["a", "bb", "ccc"], dtype=object), n),
        "ni": np.where(valid, rng.integers(0, 500, n), None).astype(object),
    }


def test_wire_plan_stats_and_bases_equal_reference(defaults):
    rng = np.random.default_rng(4)
    cols = _wide_cols(rng, 400)
    jctx, tctx = _contexts(1)
    enc = _encode(cols)
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    names = list(cols)
    js, ts = jt.ensure_stats(names), tt.ensure_stats(names)
    assert ts == js and tt.column_stats == jt.column_stats
    jplan = jg.lane_plan(jt._flat_cols())
    tplan = tg.wire_lane_plan(tt._flat_cols(0))
    assert [tuple(p) for p in tplan] == [tuple(p) for p in jplan]
    stats_list = [None if ts[n] is None else (ts[n].cls, tst.field_bits(ts[n])) for n in names]
    by_col = {i: ts[n] for i, n in enumerate(names) if ts[n] is not None}
    for sl in (stats_list, [None] * len(names)):
        got, want = tg.wire_plan(tplan, sl), jg.wire_plan(jplan, sl)
        assert tuple(got.fields) == tuple(want.fields)
        assert (got.n_words, got.n_plain) == (want.n_words, want.n_plain)
        assert tg.wire_row_bytes(got) == jg.wire_row_bytes(want)
        np.testing.assert_array_equal(tg.wire_bases(got, by_col), jg.wire_bases(want, by_col))
        assert not tg.wire_has_quant(got)
        # the codec round-trips every column, nulls' masked values too
        words, pt = tg.wire_pack_cols(tt._flat_cols(0), got, tg.wire_bases(got, by_col))
        back = tg.wire_unpack_cols(words, got, tg.wire_bases(got, by_col), pt.__getitem__,
                                   lambda lane: None if lane is None else lane.to(torch.bool))
        for (d0, v0), (d1, v1) in zip(tt._flat_cols(0), back):
            assert torch.equal(d0.view(torch.int8) if d0.dtype == torch.float16 else d0,
                               d1.view(torch.int8) if d1.dtype == torch.float16 else d1)
            assert (v0 is None) == (v1 is None) and (v0 is None or torch.equal(v0, v1))


# ----------------------------------------------------------------------
# whole operations
# ----------------------------------------------------------------------

def _sort_cols(rng, n, nulls=True):
    """lane_pack_bench.make_sort_table's shape: 12/16/20-bit keys and a
    float32 payload; here b nullable."""
    b = rng.integers(0, 60000, n).astype(np.int64)
    return {
        "a": rng.integers(0, 4000, n).astype(np.int32),
        "b": np.where(rng.random(n) > 0.1, b, None).astype(object) if nulls else b.astype(np.int32),
        "c": rng.integers(0, 1000000, n).astype(np.int32),
        "v": rng.normal(size=n).astype(np.float32),
    }


def test_sort_and_groupby_fuse_like_reference(defaults):
    rng = np.random.default_rng(8)
    enc = _encode(_sort_cols(rng, 1500))
    jctx, tctx = _contexts(1)
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    spec = (["a", "b", "c"], [True, True, False])
    _shards_equal(jt.sort(*spec), tt.sort(*spec))
    _shards_equal(jt.groupby(["a", "b"], {"v": "sum", "c": "max"}),
                  tt.groupby(["a", "b"], {"v": "sum", "c": "max"}), agg=True)
    got = counters_equal()
    assert got["lane_pack.sort_fused"][0] == 1 and got["lane_pack.groupby_fused"][0] == 1, got
    assert got["lane_pack.stats_kernel"][0] == 1, got  # measured once, kept on the table
    ttr.reset_trace()
    with tst.disabled():
        plain = tt.sort(*spec)
        assert not ttr.report("lane_pack.")
    _shards_equal(jt.sort(*spec), plain)


def test_multi_key_join_and_distributed_sort_fuse_like_reference(defaults):
    rng = np.random.default_rng(9)

    def side(v, n):
        return {"k1": rng.integers(0, 4000, n).astype(np.int32),
                "k2": rng.integers(0, 60, n).astype(np.int32),
                v: rng.normal(size=n).astype(np.float32)}

    left, right = side("v", 900), side("w", 700)
    (jl, jr), (tl, tr) = _both(1, left, right)
    _shards_equal(jl.join(jr, on=["k1", "k2"]), tl.join(tr, on=["k1", "k2"]))
    got = counters_equal()
    assert got["lane_pack.join_fused"][0] == 1, got
    enc = _encode(_sort_cols(rng, 1600, nulls=False))
    jctx, tctx = _contexts(4)
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    _shards_equal(jt.distributed_sort(["a", "b"], [False, True]),
                  tt.distributed_sort(["a", "b"], [False, True]))
    got = counters_equal()
    assert got["lane_pack.sort_fused"][0] == 1 and got["lane_pack.wire.applied"][0] == 1, got


def test_join_then_groupby_plans_like_reference(defaults, monkeypatch):
    """The world-4 pipeline users run most: ``distributed_join`` then
    ``distributed_groupby``. The join's outputs carry the JAX package's
    all-true masks, so the groupby's shuffle plans the same wire rows: the
    same results shard by shard, the same tier counters, and the same
    rounds and exchanged bytes (rounds x W^2 x bucket_cap x wire row bytes)
    as the JAX package's ``shuffle.rounds``/``shuffle.exchanged_bytes``."""
    rng = np.random.default_rng(5)
    left = {"k": rng.integers(0, 3000, 1600).astype(np.int32),
            "v": rng.normal(size=1600).astype(np.float32),
            "g": rng.integers(0, 40, 1600).astype(np.int32)}
    right = {"k": rng.integers(0, 3000, 1200).astype(np.int32),
             "w": rng.normal(size=1200).astype(np.float32)}
    (jl, jr), (tl, tr) = _both(4, left, right)
    plans = []
    plan_state = ttbl._plan_state

    def record(st):
        plan_state(st)
        rb = st["row_bytes"] if st["wire"] is None else tg.wire_row_bytes(st["wire"])
        plans.append((st["n_rounds"], st["n_rounds"] * st["world"] ** 2 * st["bucket_cap"] * rb))

    monkeypatch.setattr(ttbl, "_plan_state", record)
    jj, tj = jl.distributed_join(jr, on="k"), tl.distributed_join(tr, on="k")
    _shards_equal(jj, tj)
    agg = {"v": "sum", "w": "max"}
    _shards_equal(jj.distributed_groupby(["g"], agg), tj.distributed_groupby(["g"], agg), agg=True)
    got = counters_equal()
    assert got["shuffle.semi_filter.applied"][0] >= 1 and got["lane_pack.wire.applied"][0] >= 2, got
    want = {k: int(v.get("rows", 0)) for k, v in jtr.report("shuffle.").items()}
    assert len(plans) == 3  # the join's two sides, the groupby's one table
    assert sum(k for k, _b in plans) == want["shuffle.rounds"]
    assert sum(b for _k, b in plans) == want["shuffle.exchanged_bytes"]


def _wire_table(rng, n):
    """Four plain lanes (16 bytes a row) that narrow to three words (12)."""
    return {"f": rng.normal(size=n).astype(np.float32), "g": rng.normal(size=n).astype(np.float32),
            "a": rng.integers(0, 1 << 16, n).astype(np.int32),
            "k": rng.integers(0, 1 << 16, n).astype(np.int32)}


@pytest.mark.parametrize("budget,applied", [(None, True), (800, False)])
def test_wire_gate_applies_and_skips_on_matching_shapes(defaults, budget, applied):
    """At the default budget the narrowed rows ship fewer bytes. At 800
    bytes the plain rows take bucket_cap 8 in 3 rounds and the narrowed
    ones 16 in 2: 24 x 16 = 32 x 12 bytes, not fewer, so the gate skips."""
    rng = np.random.default_rng(12)
    enc = _encode(_wire_table(rng, 280))
    jctx, tctx = _contexts(4)
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    _shards_equal(jt.shuffle(["k"], byte_budget=budget), tt.shuffle(["k"], byte_budget=budget))
    got = counters_equal()
    took = "lane_pack.wire.applied" if applied else "lane_pack.wire.gate_skipped"
    assert got[took][0] == 1, got
    if applied:
        assert got["lane_pack.wire.bytes_saved"][1] > 0


def test_masked_outputs_plan_like_reference(defaults):
    """ROADMAP.md C1: ``filter``, groupby keys, ``unique`` and the set ops
    give every column (the groupby its keys) the JAX package's all-true
    validity mask, so the shuffles after them plan alike. At world 4:
    ``filter`` -> ``shuffle(["k"], byte_budget=2048)`` (K > 1 rounds: the
    rows of a shard in the same order), and ``distributed_unique`` ->
    ``distributed_groupby``; the same shards, the same tier counters, and
    the same ``shuffle.rounds`` and ``shuffle.exchanged_bytes``."""
    rng = np.random.default_rng(4)
    n = 3000
    cols = {"k": rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, n, dtype=np.int32),
            "v": rng.normal(size=n).astype(np.float32),
            "g": rng.integers(0, 60, n).astype(np.int32)}
    enc = _encode(cols)
    jctx, tctx = _contexts(4)
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    keep = cols["v"] > 0
    flows = [
        lambda t: t.filter(keep).shuffle(["k"], byte_budget=2048),
        lambda t: t.distributed_unique(["g"]).distributed_groupby(["g"], {"v": "sum"}),
    ]
    for i, flow in enumerate(flows):
        jtr.reset_trace()
        ttr.reset_trace()
        want, got = flow(jt), flow(tt)
        _shards_equal(want, got, agg=i == 1)
        counters_equal()
        shipped = {}
        for name, rep in (("port", ttr.report), ("jax", jtr.report)):
            r = rep("shuffle.")
            shipped[name] = {k: int(r[k].get("rows", 0))
                             for k in ("shuffle.rounds", "shuffle.exchanged_bytes")}
        assert shipped["port"] == shipped["jax"], shipped
        if i == 0:
            assert shipped["port"]["shuffle.rounds"] > 1
