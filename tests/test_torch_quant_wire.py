"""The port's quantized wire tier (ops/quant.py, the 'q' fields of
ops/gather.py, the header scales of parallel/shuffle.py, the eager
shuffles' quant spec) against the JAX package's, on the CPU.

The codec's codes and decodes equal the JAX functions bit for bit as the
JAX package runs them, inside a compiled shuffle: XLA turns the decode's
``/ 126`` into a product with the float32 reciprocal, so the port computes
that form. Op by op, outside ``jax.jit``, the JAX decode divides; the two
forms differ by at most one float32 rounding, far inside one q8 step
(``scale / 126``), which the test holds.

At worlds 1 and 4 both packages run with ``CYLON_TPU_QUANT_TOL=1e-2`` and
``CYLON_TPU_TORCH_QUANT_TOL=1e-2``, lane packing at the default, the semi
filter off, the skew split on in both packages, and the JAX side's
unported tiers off (``NO_TOPO``, ``NO_AUTOTUNE``): the quantized ``distributed_join``,
``distributed_groupby`` sum and ``distributed_sort`` equal the JAX
package's shard for shard and bit for bit, with the same
``shuffle.quant.*`` counters, and sit inside the reference's differential
bounds against the exact wire (tests/test_quant_wire.py).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.ops import gather as jg
from cylon_tpu.ops import quant as jq
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch.ops import gather as tg
from cylon_tpu_torch.ops import quant as tq
from cylon_tpu_torch.parallel import shuffle as tsh
from cylon_tpu_torch.plan import lazy as tlazy
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _contexts, _encode, _shard_frame, _shards_equal

torch.set_num_threads(1)

TOL = 1e-2
#: the JAX side's unported tiers, and both packages' semi filter, off
#: (the filter prunes no row of these key ranges; off, the JAX side
#: compiles no sketch programs)
OFF = ("CYLON_TPU_NO_TOPO", "CYLON_TPU_NO_AUTOTUNE",
       "CYLON_TPU_NO_SEMI_FILTER", "CYLON_TPU_TORCH_NO_SEMI_FILTER")
CLEAR = ("CYLON_TPU_NO_QUANT", "CYLON_TPU_TORCH_NO_QUANT", "CYLON_TPU_NO_LANE_PACK",
         "CYLON_TPU_TORCH_NO_LANE_PACK", "CYLON_TPU_QUANT_TOL", "CYLON_TPU_TORCH_QUANT_TOL")


@pytest.fixture
def quant_env(monkeypatch):
    """Lane packing at its default in both packages, tolerance unset."""
    for k in OFF:
        monkeypatch.setenv(k, "1")
    for k in CLEAR:
        monkeypatch.delenv(k, raising=False)
    jtr.reset_trace()
    ttr.reset_trace()
    return monkeypatch


def _tol(mp, tol=TOL):
    mp.setenv("CYLON_TPU_QUANT_TOL", str(tol))
    mp.setenv("CYLON_TPU_TORCH_QUANT_TOL", str(tol))


# ----------------------------------------------------------------------
# the codec
# ----------------------------------------------------------------------

def _values(rng, n, dt):
    x = (rng.normal(size=n) * rng.choice([1e-3, 1.0, 1e3], n)).astype(dt)
    x[:8] = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5]).astype(dt)
    return x


@pytest.mark.parametrize("dt", [np.float32, np.float64, np.float16])
def test_codecs_equal_reference_bit_for_bit(dt):
    rng = np.random.default_rng(2)
    x = _values(rng, 3000, dt)
    bm = np.float32(np.abs(x[np.isfinite(x)]).max())
    # per-row scales: the block's, a zero block's safe 1.0, another block's
    scale = np.where(np.arange(3000) % 3 == 0, np.float32(1.0), bm).astype(np.float32)
    scale[1::3] = np.float32(3.75)
    tx, ts = torch.from_numpy(x), torch.from_numpy(scale)
    jcode = np.asarray(jax.jit(jq.encode_q8)(jnp.asarray(x), jnp.asarray(scale)))
    tcode = tq.encode_q8(tx, ts).numpy()
    np.testing.assert_array_equal(tcode, jcode.astype(np.int64))
    assert set(np.unique(tcode[:3])) == {tq.Q8_NAN, tq.Q8_POS_INF, tq.Q8_NEG_INF}
    jdec = np.asarray(jax.jit(lambda c, s: jq.decode_q8(c, s, dt))(jnp.asarray(jcode), jnp.asarray(scale)))
    tdec = tq.decode_q8(torch.from_numpy(tcode), ts, tx.dtype).numpy()
    np.testing.assert_array_equal(tdec.view(np.uint8), jdec.view(np.uint8))
    # the op-by-op JAX decode divides by 126: within one q8 step
    eager = np.asarray(jq.decode_q8(jnp.asarray(jcode), jnp.asarray(scale), dt)).astype(np.float64)
    fin = np.isfinite(eager)
    assert (np.isnan(eager) == np.isnan(tdec)).all()
    assert (np.abs(eager[fin] - tdec.astype(np.float64)[fin]) <= scale[fin] / 126).all()
    np.testing.assert_array_equal(tq.safe_scale(torch.tensor([0.0, 2.5])).numpy(),
                                  np.asarray(jq.safe_scale(jnp.asarray([0.0, 2.5]))))
    mine = tq.block_maxabs(tx).numpy()
    assert mine == np.asarray(jq.block_maxabs(jnp.asarray(x)))
    if dt == np.float16:
        return
    for codec in ("qb16", "qf32") if dt == np.float64 else ("qb16",):
        jc = np.asarray(jq.encode_field(codec, jnp.asarray(x), None)).astype(np.int64)
        tc = tq.encode_field(codec, tx, None).numpy()
        np.testing.assert_array_equal(tc, jc)
        jd = np.asarray(jq.decode_field(codec, jnp.asarray(jc.astype(np.uint32)), None, dt))
        td = tq.decode_field(codec, torch.from_numpy(tc), None, tx.dtype).numpy()
        np.testing.assert_array_equal(td.view(np.uint8), jd.view(np.uint8))


def test_codec_choice_and_spec_equal_reference():
    dtypes = [np.float16, np.float32, np.float64, np.int32, np.int64, np.bool_, np.uint16]
    tols = [0.0, tq.QF32_TOL, tq.QB16_TOL / 2, tq.QB16_TOL, tq.Q8_TOL / 2, tq.Q8_TOL, 0.5]
    assert (tq.Q8_TOL, tq.QB16_TOL, tq.QF32_TOL) == (jq.Q8_TOL, jq.QB16_TOL, jq.QF32_TOL)
    assert tq.CODEC_BITS == jq.CODEC_BITS
    for tol in tols:
        for dt in dtypes:
            assert tq.codec_for(dt, tol) == jq.codec_for(dt, tol), (dt, tol)
        tdt = [torch.float16, torch.float32, torch.float64, torch.int32, torch.int64,
               torch.bool, torch.bfloat16]
        want = jq.quant_spec([np.float16, np.float32, np.float64, np.int32, np.int64, np.bool_,
                              jnp.bfloat16], (1,), tol)
        assert tq.quant_spec(tdt, (1,), tol) == want


def test_q_wire_plan_equals_reference(quant_env):
    """Field for field, with and without stats, a quantized float64
    leaving the passthrough, the q8 columns and the header rows."""
    rng = np.random.default_rng(6)
    n = 64
    cols = {"k": rng.integers(0, 1000, n).astype(np.int32), "f": rng.normal(size=n).astype(np.float32),
            "d": rng.normal(size=n), "h": rng.normal(size=n).astype(np.float16),
            "nv": np.where(rng.random(n) > 0.2, rng.normal(size=n), None).astype(object)}
    jctx, tctx = _contexts(1)
    enc = _encode(cols)
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    jplan, tplan = jg.lane_plan(jt._flat_cols()), tg.wire_lane_plan(tt._flat_cols(0))
    names = list(cols)
    stats = tt.ensure_stats(names)
    from cylon_tpu_torch.ops import stats as tst

    sl = [None if stats[c] is None else (stats[c].cls, tst.field_bits(stats[c])) for c in names]
    for tol in (tq.Q8_TOL, tq.QB16_TOL, tq.QF32_TOL):
        spec = tq.quant_spec([d.dtype for d, _v in tt._flat_cols(0)], (0,), tol)
        for stats_list in (sl, [None] * len(names)):
            got, want = tg.wire_plan(tplan, stats_list, quant=spec), jg.wire_plan(jplan, stats_list, quant=spec)
            assert tuple(got.fields) == tuple(want.fields)
            assert (got.n_words, got.n_plain) == (want.n_words, want.n_plain)
            assert tg.wire_row_bytes(got) == jg.wire_row_bytes(want)
            assert tg.wire_q8_cols(got) == jg.wire_q8_cols(want)
            assert tg.wire_has_quant(got) and jg.wire_has_quant(want)
            assert tsh.wire_header_rows(got) == __import__(
                "cylon_tpu.parallel.shuffle", fromlist=["x"]).wire_header_rows(want)
        sw_t, sw_j = tg.static_wire_plan(tt._flat_cols(0), quant=spec), jg.static_wire_plan(
            jt._flat_cols(), quant=spec)
        assert tuple(sw_t.fields) == tuple(sw_j.fields)


# ----------------------------------------------------------------------
# whole operations at worlds 1 and 4
# ----------------------------------------------------------------------

def _quant_counters(rep):
    return {k: (int(v["count"]), int(v.get("rows", 0))) for k, v in rep("shuffle.quant.").items()}


def _pair(rng, n):
    """tests/test_quant_wire.py's join pair with row ids, and a float64
    payload a side (one schema for both: the JAX side compiles its
    shuffle programs once)."""
    left = {"k": rng.integers(0, max(n // 20, 2), n).astype(np.int32),
            "v": (rng.normal(size=n) * 10).astype(np.float32),
            "rid": np.arange(n, dtype=np.int64), "e": rng.normal(size=n)}
    right = {"rk": rng.integers(0, max(n // 20, 2), n // 2).astype(np.int32),
             "w": (rng.normal(size=n // 2) * 10).astype(np.float32),
             "sid": np.arange(n // 2, dtype=np.int64), "d": rng.normal(size=n // 2)}
    return left, right


def _frame(t):
    return pd.concat([_shard_frame(t, s, isinstance(t, ctt.Table)) for s in range(len(t.row_counts))],
                     ignore_index=True)


#: world 1 ships no byte, so no field quantizes there: that case runs
#: under ``-m slow``, the test-time budget's room going to world 4
@pytest.mark.parametrize("world", [pytest.param(1, marks=pytest.mark.slow), 4])
def test_quantized_ops_equal_reference(quant_env, world):
    rng = np.random.default_rng(30 + world)
    left, right = _pair(rng, 900)
    jctx, tctx = _contexts(world)
    le, re_ = _encode(left), _encode(right)
    jl, jr = ct.Table.from_encoded(jctx, le), ct.Table.from_encoded(jctx, re_)
    tl, tr = ctt.Table.from_encoded(tctx, le), ctt.Table.from_encoded(tctx, re_)
    ops = {
        "join": lambda a, b: a.distributed_join(b, left_on=["k"], right_on=["rk"]),
        "groupby": lambda a, b: a.distributed_groupby(["k"], {"v": "sum"}),
        "sort": lambda a, b: a.distributed_sort(["k", "rid"]),
    }
    exact = {name: f(tl, tr) for name, f in ops.items()}
    _tol(quant_env)
    jtr.reset_trace()
    ttr.reset_trace()
    for name, f in ops.items():
        got = f(tl, tr)
        _shards_equal(f(jl, jr), got, agg=False)
        # the reference's differential bounds against the exact wire
        ex, gt = _frame(exact[name]), _frame(got)
        if name == "join":
            ex, gt = (x.sort_values(["rid", "sid"]).reset_index(drop=True) for x in (ex, gt))
            for c in ("k", "rid", "sid"):
                np.testing.assert_array_equal(ex[c].to_numpy(), gt[c].to_numpy())
            for c in ("v", "w", "d", "e"):
                bound = TOL * np.abs(ex[c].to_numpy()).max()
                assert np.abs(ex[c].to_numpy() - gt[c].to_numpy()).max() <= bound
        elif name == "groupby":
            ex, gt = (x.sort_values("k").reset_index(drop=True) for x in (ex, gt))
            np.testing.assert_array_equal(ex["k"].to_numpy(), gt["k"].to_numpy())
            budget = TOL * np.abs(left["v"]).sum()
            assert np.abs(ex["v_sum"].to_numpy() - gt["v_sum"].to_numpy()).max() <= budget
        else:
            for c in ("k", "rid"):
                np.testing.assert_array_equal(ex[c].to_numpy(), gt[c].to_numpy())
            bound = TOL * np.abs(left["v"]).max()
            assert np.abs(ex["v"].to_numpy() - gt["v"].to_numpy()).max() <= bound
    got = _quant_counters(ttr.report)
    assert got == _quant_counters(jtr.report)
    if world > 1:
        assert got["shuffle.quant.applied"][0] >= 3, got


def test_knob_off_exact_config_wins_and_fingerprint(quant_env):
    """The tolerance unset (or the kill switch on, or the context's
    explicit 0) gives the exact wire byte for byte; the context's config
    wins over the env; the lazy fingerprint carries ``gate_state``."""
    rng = np.random.default_rng(40)
    left, _right = _pair(rng, 600)
    tctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=4))
    t = ctt.Table.from_pydict(tctx, left)

    def run():
        out = t.shuffle(["k"])
        return [[(d.clone(), None if v is None else v.clone()) for d, v in out._flat_cols(s)]
                for s in range(4)]

    def same(a, b):
        return all(torch.equal(x[0].view(torch.uint8) if x[0].dtype.is_floating_point else x[0],
                               y[0].view(torch.uint8) if y[0].dtype.is_floating_point else y[0])
                   for sa, sb in zip(a, b) for x, y in zip(sa, sb))

    off = run()
    assert tctx.quant_tol == 0.0 and not ttr.report("shuffle.quant.")
    fp_off = tlazy.gated_fingerprint(t.lazy()._plan)
    _tol(quant_env)
    assert tctx.quant_tol == TOL
    assert tlazy.gated_fingerprint(t.lazy()._plan) != fp_off
    lossy = run()
    assert not same(off, lossy) and ttr.get_count("shuffle.quant.applied") == 1
    with tq.disabled():
        assert tctx.quant_tol == 0.0 and same(off, run())
        assert tlazy.gated_fingerprint(t.lazy()._plan) != fp_off  # the switch is keyed
    tctx.add_config("quant_tol", "0")
    assert tctx.quant_tol == 0.0 and same(off, run())
    tctx.add_config("quant_tol", "")
    assert tctx.quant_tol == 0.0
    quant_env.delenv("CYLON_TPU_TORCH_QUANT_TOL")
    tctx.add_config("quant_tol", str(TOL))
    assert tctx.quant_tol == TOL and same(lossy, run())
