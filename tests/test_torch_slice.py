"""The port's main path against the JAX package, on the CPU:
``Table.from_encoded`` -> ``distributed_join`` -> ``distributed_groupby`` ->
``to_pandas`` in cylon_tpu_torch and in cylon_tpu, fed one host encoding
made with numpy from a fixed seed.

The JAX side runs the configuration whose kernels the port translates:
``CYLON_TPU_SORT_IMPL=radix_pallas`` (every sort pass through the Pallas
radix kernels, interpret mode here) and ``CYLON_TPU_EMIT_IMPL=windowed``
(the left emit through the Pallas windowed expand), with
``CYLON_TPU_NO_LANE_PACK=1``, and the port with
``CYLON_TPU_TORCH_NO_LANE_PACK=1``: sort-word fusion off on both sides
(tests/test_torch_lane_pack.py holds it on). Sides have >= 512 rows so the Pallas radix pass engages, and the
join outputs stay inside the JAX package's speculative capacity.

Tolerances: the join output is compared exactly, in emitted row order (the
left-order emit defines it). Group keys, integer aggregates, counts, mins
and maxes are exact. Float sums and means are taken in another order by
the two packages' segment reductions, so they are compared at rtol=1e-6
for float64 results and rtol=1e-5 for float32 results.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax

import cylon_tpu as ct
import cylon_tpu_torch as ctt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jctx():
    return ct.CylonContext.init_distributed(ct.TPUConfig(devices=jax.devices()[:1]))


@pytest.fixture(scope="module")
def tctx():
    return ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))


@pytest.fixture
def pallas_env(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_SORT_IMPL", "radix_pallas")
    monkeypatch.setenv("CYLON_TPU_EMIT_IMPL", "windowed")
    monkeypatch.setenv("CYLON_TPU_NO_LANE_PACK", "1")
    monkeypatch.setenv("CYLON_TPU_TORCH_NO_LANE_PACK", "1")


def _encode(cols):
    return {k: ct.Column.encode_host(np.asarray(v)) for k, v in cols.items()}


def _frames_equal_exact(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def _frames_equal_agg(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c], want[c]
        assert g.dtype == w.dtype, c
        if w.dtype.kind == "f" and c.endswith(("_sum", "_mean")):
            rtol = 1e-5 if w.dtype == np.float32 else 1e-6
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=rtol, atol=0, err_msg=c)
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True)


def _run_both(jctx, tctx, left, right, join_kw, by, agg):
    l_enc, r_enc = _encode(left), _encode(right)
    jl, jr = ct.Table.from_encoded(jctx, l_enc), ct.Table.from_encoded(jctx, r_enc)
    tl, tr = ctt.Table.from_encoded(tctx, l_enc), ctt.Table.from_encoded(tctx, r_enc)
    jj = jl.distributed_join(jr, **join_kw)
    tj = tl.distributed_join(tr, **join_kw)
    _frames_equal_exact(tj.to_pandas(), jj.to_pandas())
    if by is not None:
        jg = jj.distributed_groupby(by, agg).to_pandas()
        tg = tj.distributed_groupby(by, agg).to_pandas()
        _frames_equal_agg(tg, jg)
    return tj


def _sides(rng, n_l, n_r, keyspace, key_dtype=np.int32):
    left = {
        "k": rng.integers(0, keyspace, n_l).astype(key_dtype),
        "v": rng.normal(size=n_l).astype(np.float32),
        "a": rng.integers(-50, 50, n_l).astype(np.int32),
    }
    right = {
        "k": rng.integers(0, keyspace, n_r).astype(key_dtype),
        "w": rng.normal(size=n_r).astype(np.float64),
    }
    return left, right


AGG = {"v": ["sum", "mean"], "a": ["sum", "min", "max", "count"]}


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_types_int32_key(jctx, tctx, rng, pallas_env, how):
    left, right = _sides(rng, 600, 640, 1200)
    t = _run_both(jctx, tctx, left, right, {"on": "k", "how": how}, "k_x",
                  {**AGG, "w": ["sum", "max"]})
    assert t.row_count > 0


@pytest.mark.parametrize("key_dtype", [np.int64, np.float32, np.uint32])
def test_join_key_dtypes(jctx, tctx, rng, pallas_env, key_dtype):
    left, right = _sides(rng, 700, 600, 1400, key_dtype)
    _run_both(jctx, tctx, left, right, {"on": "k", "how": "inner"}, "k_x", AGG)
