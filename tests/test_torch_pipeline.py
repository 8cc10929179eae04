"""The port's fused mode (parallel/pipeline.py, ``Table._fused_join``,
``DataFrame.merge(mode="fused")``) against the JAX package's, on the CPU.

Both packages run their tiers at the defaults with the JAX side's
unported ones off (``NO_TOPO``, ``NO_SKEW_SPLIT``, ``NO_AUTOTUNE``), on
tables loaded from one host encoding, where the port's ``round_cap(max
shard rows)`` equals the JAX package's ``shard_cap``: both pick the same
``bucket_cap`` and ``join_cap``. The fused joins are compared shard by
shard in order (both emit INNER / LEFT in left-row order over the same
shuffled rows, RIGHT / OUTER with the unmatched rights behind), with the
live counts and the attempts (``host_sync``: one a attempt); the eager
join gives the same rows as a multiset per shard. The q3 step's group
sums are held at float32 sum tolerance (atol 1e-4 + rtol 1e-5), its
group and join counts exactly.

The quantized fused path runs at world 4 with ``CYLON_TPU_QUANT_TOL``
and ``CYLON_TPU_TORCH_QUANT_TOL`` at 1e-2: the right side's float64
payload rides a q8 field of the static wire plan, its per-chunk scales in
the header rows of every round, so the fused join (one slice or two)
equals the JAX package's shard for shard and bit for bit, and the q3
step's bfloat16-rounded partial totals give the JAX step's total.

The collectives of one fused join are counted at the port's
communicator: ``2 * (1 + respill) + 2``, the port's copy of
``cylon_tpu/analysis/contracts.fused_join_collectives``.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.ops.join import INNER as J_INNER
from cylon_tpu.parallel import pipeline as jpl
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch.engine import round_cap
from cylon_tpu_torch.ops import gather as tg
from cylon_tpu_torch.ops import quant as tq
from cylon_tpu_torch.ops.join import INNER
from cylon_tpu_torch.parallel import pipeline as tpl
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _contexts, _encode, _shard_frame, _shards_equal

torch.set_num_threads(1)

UNPORTED = ("CYLON_TPU_NO_TOPO", "CYLON_TPU_NO_SKEW_SPLIT", "CYLON_TPU_NO_AUTOTUNE")
TOL = 1e-2


@pytest.fixture
def fused_env(monkeypatch):
    for k in UNPORTED:
        monkeypatch.setenv(k, "1")
    for k in ("CYLON_TPU_QUANT_TOL", "CYLON_TPU_TORCH_QUANT_TOL", "CYLON_TPU_NO_QUANT"):
        monkeypatch.delenv(k, raising=False)
    jtr.reset_trace()
    ttr.reset_trace()


def fused_join_collectives(respill: int) -> int:
    """Each side's shuffle is (1 + respill) header-fused all_to_alls, plus
    the two overflow all_reduces."""
    return 2 * (1 + respill) + 2


def _sides(rng, n_l, n_r, keys):
    left = {"k": rng.integers(0, keys, n_l).astype(np.int32),
            "v": rng.normal(size=n_l).astype(np.float32)}
    right = {"k": rng.integers(0, keys, n_r).astype(np.int32),
             "w": rng.normal(size=n_r), "b": rng.random(n_r) > 0.5}
    return left, right


def _tables(world, left, right):
    jctx, tctx = _contexts(world)
    le, re_ = _encode(left), _encode(right)
    return ((ct.Table.from_encoded(jctx, le), ct.Table.from_encoded(jctx, re_)),
            (ctt.Table.from_encoded(tctx, le), ctt.Table.from_encoded(tctx, re_)))


def _attempts(call, tracing):
    tracing.reset_trace()
    out = call()
    return out, tracing.get_count("host_sync")


def _counter(rep, name):
    e = rep.get(name, {})
    return int(e.get("count", 0)), int(e.get("rows", 0))


def _multiset_equal(a, b):
    for s in range(len(a.row_counts)):
        fa, fb = _shard_frame(a, s, True), _shard_frame(b, s, True)
        cols = list(fa.columns)
        fa = fa.sort_values(cols, na_position="last").reset_index(drop=True)
        fb = fb.sort_values(cols, na_position="last").reset_index(drop=True)
        pd.testing.assert_frame_equal(fa, fb)


@pytest.mark.parametrize("world", [1, pytest.param(2, marks=pytest.mark.slow), 4])
@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_fused_join_equals_reference(fused_env, world, how):
    rng = np.random.default_rng(world * 10 + len(how))
    left, right = _sides(rng, 500, 400, 300)
    (jl, jr), (tl, tr) = _tables(world, left, right)
    kw = dict(on="k", how=how, mode="fused")
    want, j_att = _attempts(lambda: jl.distributed_join(jr, **kw), jtr)
    got, t_att = _attempts(lambda: tl.distributed_join(tr, **kw), ttr)
    _shards_equal(want, got)
    assert t_att == j_att == 1
    _multiset_equal(got, tl.distributed_join(tr, on="k", how=how))


@pytest.mark.parametrize("case", [pytest.param("slices", marks=pytest.mark.slow), "shuffle_retry",
                                  pytest.param("join_retry", marks=pytest.mark.slow)])
def test_fused_slices_and_retries_equal_reference(fused_env, case):
    """world 4: two hash slices; a hot key that overflows the buckets at
    ``respill=0`` once (the retry doubles ``bucket_cap``); duplicate keys
    that overflow ``join_cap`` once (the retry adds the exact shortfall).
    Two slices on the exact wire run under ``-m slow``: on the quantized
    wire they are held against the JAX package in every run
    (``test_quantized_fused_join_equals_reference[2]``)."""
    rng = np.random.default_rng(7)
    left, right = _sides(rng, 600, 500, 400)
    kw = dict(on="k", mode="fused")
    if case == "slices":
        kw["num_slices"] = 2
    elif case == "shuffle_retry":
        left["k"][::3] = 7  # a bucket of about 75 rows a shard past bucket_cap 64
        kw.update(respill=0, capacity_factor=1.0)
    else:
        left["k"][::3] = 5
        right["k"][::3] = 5  # 200 x 167 rows of one key
    (jl, jr), (tl, tr) = _tables(4, left, right)
    want, j_att = _attempts(lambda: jl.distributed_join(jr, **kw), jtr)
    got, t_att = _attempts(lambda: tl.distributed_join(tr, **kw), ttr)
    _shards_equal(want, got)
    assert t_att == j_att == (1 if case == "slices" else 2)
    _multiset_equal(got, tl.distributed_join(tr, on="k"))


def _q3_both(jt, tt, how, quant_tol=0.0):
    """The q3 step of both packages at world 4 with the reference
    benchmark's capacities (bucket_cap = max(64, 4 cap / W), join_cap =
    4 cap, group_cap = 2 cap), each side's wire spec at ``quant_tol``:
    group counts and join counts held equal, the group sums and the
    replicated total at float32 sum tolerance. Returns the port's (sums,
    group counts, totals)."""
    (jl, jr), (tl, tr) = jt, tt
    cap = jl.shard_cap
    assert cap == round_cap(int(tl.row_counts.max()))
    jctx, tctx = _contexts(4)
    caps = dict(bucket_cap=max(64, 4 * cap // 4), join_cap=4 * cap, group_cap=2 * cap)
    specs = [tq.quant_spec([d.dtype for d, _v in t._flat_cols(0)], (0,), quant_tol) for t in (tl, tr)]
    quant = dict(quant_l=specs[0], quant_r=specs[1], quant_tol=quant_tol)
    jstep = jpl.make_join_groupby_step(jctx.mesh, jctx.axis_name, (0,), (0,), 1,
                                       J_INNER if how == INNER else how, **caps, **quant)
    js, jng, jnj, jtot = (np.asarray(x) for x in jstep(
        (jl._flat_cols(), jl.counts_dev, jr._flat_cols(), jr.counts_dev), ()))
    tstep = tpl.make_join_groupby_step(tctx, (0,), (0,), 1, how, **caps, **quant)
    ts, tng, tnj, ttot = tstep([tl._flat_cols(s) for s in range(4)],
                               [tr._flat_cols(s) for s in range(4)])
    np.testing.assert_array_equal([int(x) for x in tng], jng)
    np.testing.assert_array_equal([int(x) for x in tnj], jnj)
    js = js.reshape(4, -1)
    for s in range(4):
        ng = int(jng[s])
        np.testing.assert_allclose(ts[s][:ng].numpy(), js[s, :ng], rtol=1e-5, atol=1e-4)
    for t in ttot:
        np.testing.assert_allclose(float(t), float(jtot[0]), rtol=1e-5, atol=1e-4)
    return ts, tng, ttot


def test_join_groupby_step_equals_reference(fused_env):
    """The q3 step at world 4: the INNER float-sum pushdown, and the
    generic path of a LEFT join."""
    rng = np.random.default_rng(11)
    left, right = _sides(rng, 800, 600, 200)
    jt, tt = _tables(4, left, right)
    for how in (INNER, 1):
        _q3_both(jt, tt, how)


@pytest.mark.parametrize("num_slices", [1, 2])
def test_quantized_fused_join_equals_reference(fused_env, monkeypatch, num_slices):
    """World 4 at a 1e-2 tolerance in both packages: the right side's
    float64 payload takes a q8 field of the static plan (the left's
    float32 does not: k's 32 bits and a q8 code still fill two words, as
    on both sides of chip_smoke.py's A4, which runs the quantized fused
    join with a float64 right payload for that reason), so
    each round's chunks carry a scale lane in their header rows and B3
    compacts them over the concatenated rounds. Shard for shard against
    the JAX fused join, with the attempts and the exchanged bytes; against
    the port's exact fused join, the same rows in the same order with
    ``w`` lossy and within the reference's bound, 1e-2 max|w|."""
    rng = np.random.default_rng(17)
    left, right = _sides(rng, 600, 500, 400)
    (jl, jr), (tl, tr) = _tables(4, left, right)
    for t, lossy in ((tl, False), (tr, True)):
        spec = tq.quant_spec([d.dtype for d, _v in t._flat_cols(0)], (0,), TOL)
        assert tg.wire_has_quant(tg.static_wire_plan(t._flat_cols(0), quant=spec)) == lossy
    kw = dict(on="k", mode="fused", num_slices=num_slices)
    exact = tl.distributed_join(tr, **kw)
    for k in ("CYLON_TPU_QUANT_TOL", "CYLON_TPU_TORCH_QUANT_TOL"):
        monkeypatch.setenv(k, str(TOL))
    want, j_att = _attempts(lambda: jl.distributed_join(jr, **kw), jtr)
    j_bytes = _counter(jtr.report("shuffle."), "shuffle.exchanged_bytes")
    got, t_att = _attempts(lambda: tl.distributed_join(tr, **kw), ttr)
    _shards_equal(want, got)
    assert t_att == j_att == 1
    assert _counter(ttr.report("shuffle."), "shuffle.exchanged_bytes") == j_bytes
    assert not ttr.report("shuffle.quant.") and not jtr.report("shuffle.quant.")
    bound = TOL * np.abs(right["w"]).max()
    moved = 0
    for s in range(4):
        ex, gt = _shard_frame(exact, s, True), _shard_frame(got, s, True)
        pd.testing.assert_frame_equal(ex.drop(columns="w"), gt.drop(columns="w"))
        err = np.abs(ex["w"].to_numpy() - gt["w"].to_numpy())
        assert err.max() <= bound
        moved += int((err > 0).sum())
    assert moved > 0


def test_quantized_join_groupby_step_equals_reference(fused_env):
    """The q3 step at world 4 with both wire specs and the total at a
    1e-2 tolerance (at least QB16_TOL): each shard's partial total is
    rounded to bfloat16 before the exact all_reduce, in both packages. The
    quantized total is held against the JAX step's, and against the
    exact total within one bfloat16 rounding (2^-9) of each partial."""
    rng = np.random.default_rng(11)
    left, right = _sides(rng, 800, 600, 200)
    jt, tt = _tables(4, left, right)
    ts, _ng, ttot = _q3_both(jt, tt, INNER, quant_tol=TOL)
    exact = sum(float(s.double().sum()) for s in ts)
    budget = sum(abs(float(s.sum())) for s in ts) * 2.0**-9 + 1e-4
    assert float(ttot[0]) != exact
    assert abs(float(ttot[0]) - exact) <= budget


def test_merge_fused_errors_and_collectives(fused_env, monkeypatch):
    """``DataFrame.merge(mode="fused")`` against the JAX package's; the
    ValueErrors of the fused mode; one host sync and ``2 (1 + respill) +
    2`` collectives per fused join, at respill 0, 1 and 2."""
    rng = np.random.default_rng(13)
    left, right = _sides(rng, 400, 300, 250)
    jenv = ct.CylonEnv(config=ct.TPUConfig(devices=jax.devices()[:4]))
    tenv = ctt.CylonEnv(config=ctt.GPUConfig(device="cpu", world_size=4))
    jl1, tl1 = ct.CylonContext.init(), ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))
    jdf, tdf = (
        pkg.DataFrame(pd.DataFrame(left), ctx=c).merge(
            pkg.DataFrame(pd.DataFrame(right), ctx=c), on="k", env=env, mode="fused")
        for pkg, c, env in ((ct, jl1, jenv), (ctt, tl1, tenv))
    )
    assert tdf.columns == jdf.columns
    _shards_equal(jdf.table, tdf.table)
    (_jl, _jr), (tl, tr) = _tables(4, left, right)
    with pytest.raises(ValueError, match="algorithm"):
        tl.distributed_join(tr, on="k", mode="fused", algorithm="pallas_pk")
    with pytest.raises(ValueError, match="emit_order"):
        tl.distributed_join(tr, on="k", mode="fused", emit_order="key")
    with pytest.raises(ValueError, match="unknown join mode"):
        tl.distributed_join(tr, on="k", mode="lazy")
    comm = tl.ctx.comm
    calls = []
    for name in ("all_to_all", "all_reduce"):
        orig = getattr(comm, name)
        monkeypatch.setattr(comm, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n), _o(*a, **k))[1])
    for respill in (0, 1, 2):
        calls.clear()
        ttr.reset_trace()
        tl.distributed_join(tr, on="k", mode="fused", respill=respill)
        assert len(calls) == fused_join_collectives(respill), calls
        assert calls.count("all_reduce") == 2 and ttr.get_count("host_sync") == 1
