"""The port's kernel modules against the JAX package's Pallas kernels, on
the CPU: the plain radix pass (cylon_tpu_torch.ops.cuda_radix) against
``radix_pass_pallas`` in interpret mode and the XLA ``radix_pass``, and the
plain windowed expand (cylon_tpu_torch.ops.cuda_gather) against
``expand_rows`` in interpret mode. Every comparison is exact: both compute
a permutation or a copy of int32 bits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import radix as jrx
from cylon_tpu.ops.pallas_gather import expand_rows as j_expand_rows
from cylon_tpu.ops.pallas_radix import radix_pass_pallas
from cylon_tpu_torch.ops import cuda_gather, cuda_radix
from cylon_tpu_torch.ops import radix as trx
from cylon_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)


def _lane_u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _port_pass(enc_u, perm, shift, bits):
    enc = torch.from_numpy(enc_u.view(np.int32 if enc_u.itemsize == 4 else np.int64).copy())
    out = cuda_radix.radix_pass(enc, torch.from_numpy(perm), shift, bits)
    plain = cuda_radix.radix_pass_plain(enc, torch.from_numpy(perm), shift, bits)
    assert torch.equal(out, plain)
    return out.numpy()


@pytest.mark.parametrize("shift,bits", [(0, 8), (8, 8), (16, 8), (24, 8), (24, 3), (5, 8)])
def test_radix_pass_matches_pallas(rng, shift, bits):
    n = 1024  # tile-divisible: the Pallas pass engages (interpret mode)
    enc = _lane_u32(rng, n)
    perm = rng.permutation(n).astype(np.int32)
    want = np.asarray(
        radix_pass_pallas(jnp.asarray(enc), jnp.asarray(perm), shift, bits, interpret=True)
    )
    np.testing.assert_array_equal(_port_pass(enc, perm, shift, bits), want)


@pytest.mark.parametrize("n", [1, 700, 5000, 8193])
def test_radix_pass_ragged_matches_xla(rng, n):
    """Lengths that are not a multiple of any tile, several port tiles."""
    enc = rng.integers(0, 40, n).astype(np.uint32) << np.uint32(8)  # many ties
    perm = rng.permutation(n).astype(np.int32)
    want = np.asarray(jrx.radix_pass(jnp.asarray(enc), jnp.asarray(perm), 8, 8))
    np.testing.assert_array_equal(_port_pass(enc, perm, 8, 8), want)


@pytest.mark.parametrize("shift,bits", [(0, 8), (32, 8), (56, 8), (60, 4)])
def test_radix_pass_u64_matches_xla(rng, shift, bits):
    """uint64 lanes: the Pallas tier declines them, the port's K1 takes them."""
    n = 3000
    enc = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64) * np.uint64(2)
    perm = rng.permutation(n).astype(np.int32)
    want = np.asarray(jrx.radix_pass(jnp.asarray(enc), jnp.asarray(perm), shift, bits))
    np.testing.assert_array_equal(_port_pass(enc, perm, shift, bits), want)


def test_radix_hist_layout(rng):
    """K1a's plain version: bucket-major [256, n_tiles] counts per tile."""
    n = 2 * cuda_radix.TILE + 17
    enc = torch.from_numpy(rng.integers(0, 256, n).astype(np.int32))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    hist = cuda_radix.radix_hist(enc, perm, 0, 8).reshape(256, -1)
    d = enc[perm.long()].numpy()
    for t in range(hist.shape[1]):
        tile = d[t * cuda_radix.TILE:(t + 1) * cuda_radix.TILE]
        np.testing.assert_array_equal(hist[:, t].numpy(), np.bincount(tile, minlength=256))


def test_lexsort_perm_matches_jax(rng, monkeypatch):
    """A three-lane stack (u32 key, biased small lane, bounded lane) sorts
    to the same unique stable permutation in both engines."""
    monkeypatch.setenv("CYLON_TPU_SORT_IMPL", "radix_pallas")
    n = 1024
    a = rng.integers(0, 5, n).astype(np.int32)
    b = rng.integers(-1, 2, n).astype(np.int8)
    c = _lane_u32(rng, n) >> np.uint32(20)
    want = np.asarray(jrx.lexsort_perm(
        [jnp.asarray(c), jnp.asarray(b), jnp.asarray(a)], n,
        [None, jrx.bias_hint(1, 2), jrx.bound_hint(4)],
    ))
    got = trx.lexsort_perm(
        [torch.from_numpy(c.view(np.int32)), torch.from_numpy(b), torch.from_numpy(a)], n,
        [None, trx.bias_hint(1, 2), trx.bound_hint(4)],
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.lexsort([c, b, a]))


def test_float_lane_declines(rng):
    n = 50
    before = trx.COUNTS["declined"]
    lane = torch.from_numpy(rng.normal(size=n))
    assert trx.lexsort_perm([lane], n) is None
    assert trx.COUNTS["declined"] == before + 1
    perm = tsort.lexsort_indices([lane], n)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(lane.numpy(), kind="stable"))


@pytest.mark.parametrize("m,hot,T", [(700, 0, 512), (700, 3, 512), (3, 0, 512), (9000, 2, 2048)])
def test_expand_matches_pallas(rng, m, hot, T):
    """The shapes of tests/test_pallas_gather.py: counts >= 1, some hot."""
    cnt = rng.integers(1, 4, m)
    if hot:
        cnt[rng.integers(0, m, hot)] = 700
    li = np.repeat(np.arange(m), cnt).astype(np.int32)
    L = 5
    src = rng.integers(-(2**31), 2**31, (L, m), dtype=np.int64).astype(np.int32)
    want = np.asarray(
        j_expand_rows(jnp.asarray(src), jnp.asarray(li), T=T, impl="take", interpret=True)
    )
    got = cuda_gather.expand_rows(torch.from_numpy(src), torch.from_numpy(li))
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_plain_is_clamped_take(rng):
    src = torch.from_numpy(rng.integers(-100, 100, (3, 40)).astype(np.int32))
    li = torch.tensor([-5, 0, 0, 1, 39, 44], dtype=torch.int32)
    got = cuda_gather.expand_rows(src, li)
    np.testing.assert_array_equal(got.numpy(), src.numpy()[:, np.clip(li.numpy(), 0, 39)])


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor on a device with no kernel raises; nothing falls back."""
    enc = torch.zeros(4, dtype=torch.int32, device="meta")
    perm = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_radix.radix_hist(enc, perm, 0, 8)
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_gather.expand_rows(enc.reshape(1, 4), perm)


@pytest.mark.parametrize("nulls_last", [True, False])
def test_lexsort_rows_payload_matches_jax(rng, nulls_last):
    """Mixed directions, a NaN-carrying float key and a nullable int64 key."""
    from cylon_tpu.ops.sort import lexsort_rows_payload as j_lexsort

    n = 600
    a = rng.integers(0, 4, n).astype(np.int32)
    f = rng.normal(size=n).astype(np.float32)
    f[rng.random(n) < 0.05] = np.nan
    b = rng.integers(-3, 3, n).astype(np.int64)
    bv = rng.random(n) > 0.2
    pay = np.arange(n, dtype=np.int32) * 3
    j_cols = [(jnp.asarray(a), None), (jnp.asarray(f), None), (jnp.asarray(b), jnp.asarray(bv))]
    want, (want_pay,) = j_lexsort(j_cols, n, n, [jnp.asarray(pay)], [True, False, True], nulls_last)
    t_cols = [(torch.from_numpy(a), None), (torch.from_numpy(f), None),
              (torch.from_numpy(b), torch.from_numpy(bv))]
    got, (got_pay,) = tsort.lexsort_rows_payload(
        t_cols, n, [torch.from_numpy(pay)], [True, False, True], nulls_last
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_pay.numpy(), np.asarray(want_pay))
