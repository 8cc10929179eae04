"""The port's kernel modules against the JAX package's Pallas kernels, on
the CPU: the plain lane sort and its one-digit pass
(cylon_tpu_torch.ops.cuda_radix) against chains of ``radix_pass_pallas`` in
interpret mode and of the XLA ``radix_pass``, and the
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


def _signed(enc_u):
    return torch.from_numpy(enc_u.view(np.int32 if enc_u.itemsize == 4 else np.int64).copy())


def _port_pass(enc_u, perm, shift, bits):
    enc = _signed(enc_u)
    out = cuda_radix.radix_pass(enc, torch.from_numpy(perm), shift, bits)
    d = cuda_radix.digits(enc[torch.from_numpy(perm).long()], shift, bits)
    assert torch.equal(out, torch.from_numpy(perm)[torch.sort(d, stable=True).indices])
    return out.numpy()


def _pass_chain(pass_fn, enc_u, perm, lo, hi):
    """The JAX package's pass, once per 8-bit digit of [lo, hi)."""
    p = jnp.asarray(perm)
    for shift in range(lo, hi, 8):
        p = pass_fn(jnp.asarray(enc_u), p, shift, min(8, hi - shift))
    return np.asarray(p)


def _port_lane_sort(enc_u, perm, lo, hi):
    """The lane sort's (keys, perm); the keys must be the lane read
    through the perm."""
    enc = _signed(enc_u)
    keys, p = cuda_radix.radix_sort_lane(enc, None if perm is None else torch.from_numpy(perm), lo, hi)
    assert p.dtype == torch.int32
    assert torch.equal(keys, enc[p.long()])
    return p.numpy()


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


@pytest.mark.parametrize("wide,lo,hi", [(False, 0, 32), (False, 3, 29), (True, 0, 64), (True, 7, 61)])
def test_lane_hist_layout(rng, wide, lo, hi):
    """K1a's plain version: [passes, 256] counts of every pass's digit,
    the last digit narrower where the span ends short of a byte."""
    n = 2 * cuda_radix.TILE + 17
    dt = np.uint64 if wide else np.uint32
    enc_u = rng.integers(0, np.iinfo(dt).max, n, dtype=np.uint64).astype(dt)
    hist = cuda_radix.lane_hist(_signed(enc_u), lo, hi)
    assert hist.shape == (cuda_radix.n_passes(lo, hi), 256) and hist.dtype == torch.int32
    for p, shift in enumerate(range(lo, hi, 8)):
        bits = min(8, hi - shift)
        d = (enc_u.astype(np.uint64) >> np.uint64(shift)) & np.uint64((1 << bits) - 1)
        np.testing.assert_array_equal(hist[p].numpy(), np.bincount(d.astype(np.int64), minlength=256))


@pytest.mark.parametrize("lo,hi", [(0, 32), (4, 27)])
def test_lane_sort_matches_pallas_chain(rng, lo, hi):
    """The lane sort against a chain of radix_pass_pallas (interpret mode),
    one per digit, at a tile-divisible n with a random carried perm."""
    n = 1024
    enc = _lane_u32(rng, n)
    enc[: n // 4] = enc[n // 2: n // 2 + n // 4]  # ties across the span
    perm = rng.permutation(n).astype(np.int32)
    want = _pass_chain(lambda e, p, s, b: radix_pass_pallas(e, p, s, b, interpret=True),
                       enc, perm, lo, hi)
    np.testing.assert_array_equal(_port_lane_sort(enc, perm, lo, hi), want)


@pytest.mark.parametrize("n", [1, 700, 5000, 8193])
@pytest.mark.parametrize("wide,lo,hi", [(False, 0, 32), (False, 2, 21), (True, 0, 61), (True, 5, 64)])
def test_lane_sort_ragged_matches_xla(rng, n, wide, lo, hi):
    """Ragged lengths, 32- and 64-bit lanes, narrow last digits: the lane
    sort against the XLA radix_pass chain, with a random and an identity
    perm."""
    if wide:
        enc = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64) * np.uint64(2)
        enc[rng.random(n) < 0.3] = np.uint64(2**63 + 5)
    else:
        enc = rng.integers(0, 40, n).astype(np.uint32) * np.uint32(0x01010101)  # many ties
    perm = rng.permutation(n).astype(np.int32)
    want = _pass_chain(jrx.radix_pass, enc, perm, lo, hi)
    np.testing.assert_array_equal(_port_lane_sort(enc, perm, lo, hi), want)
    ident = _pass_chain(jrx.radix_pass, enc, np.arange(n, dtype=np.int32), lo, hi)
    np.testing.assert_array_equal(_port_lane_sort(enc, None, lo, hi), ident)


def test_lane_sort_all_equal_keeps_perm(rng):
    """Stability: one digit value on every row leaves the perm as it was."""
    n = 3 * cuda_radix.TILE + 5
    enc = torch.full((n,), -7, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    keys, p = cuda_radix.radix_sort_lane(enc, perm, 0, 32)
    assert torch.equal(p, perm) and torch.equal(keys, enc)
    keys, p = cuda_radix.radix_sort_lane(enc, None, 0, 32)
    assert torch.equal(p, torch.arange(n, dtype=torch.int32))


def test_onesweep_pass_plain_is_one_digit_sort(rng):
    """K1b's plain version: keys and perm reordered by a stable sort of one
    digit; the identity perm comes back as the argsort."""
    n = 777
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    counts = cuda_radix.lane_hist(keys, 8, 16)[0]
    k1, p1 = cuda_radix.onesweep_pass(keys, perm, counts, 8, 8)
    order = np.argsort((keys.numpy().view(np.uint32) >> 8) & 255, kind="stable")
    np.testing.assert_array_equal(k1.numpy(), keys.numpy()[order])
    np.testing.assert_array_equal(p1.numpy(), perm.numpy()[order])
    _, p2 = cuda_radix.onesweep_pass(keys, None, counts, 8, 8)
    np.testing.assert_array_equal(p2.numpy(), order)


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


@pytest.mark.parametrize("case", ["u32", "ids", "bias", "wide"])
def test_kv_sort_matches_jax(rng, monkeypatch, case):
    """kv_sort's sorted keys and payload against the JAX package's kv_sort
    (forced Pallas radix tier), for a full u32 lane, a bounded id lane, a
    biased small lane and a 64-bit lane (the port's K1 takes it, the
    Pallas tier declines it to the XLA pass)."""
    monkeypatch.setenv("CYLON_TPU_SORT_IMPL", "radix_pallas")
    n = 2048 if case != "wide" else 1500
    pay = np.arange(n, dtype=np.int32) * 7 - 3
    if case == "u32":
        ku = _lane_u32(rng, n) >> np.uint32(rng.integers(0, 20))
        jk, tk, jh, th = jnp.asarray(ku), torch.from_numpy(ku.view(np.int32)), None, None
    elif case == "ids":
        k = rng.integers(0, 300, n).astype(np.int32)
        jk, tk, jh, th = jnp.asarray(k), torch.from_numpy(k), jrx.bound_hint(299), trx.bound_hint(299)
    elif case == "bias":
        k = rng.integers(-3, 3, n).astype(np.int32)
        jk, tk, jh, th = jnp.asarray(k), torch.from_numpy(k), jrx.bias_hint(3, 3), trx.bias_hint(3, 3)
    else:
        ku = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64) * np.uint64(3)
        ku[::5] = ku[1]
        jk, tk, jh, th = jnp.asarray(ku), torch.from_numpy(ku.view(np.int64)), None, None
    js, jp = jrx.kv_sort(jk, jnp.asarray(pay), jh)
    ts, tp = trx.kv_sort(tk, torch.from_numpy(pay), th)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).view(ts.numpy().dtype))


@pytest.mark.parametrize("case", ["i32", "i64", "span_i32", "u32", "bias", "i16", "bool", "span_i64"])
def test_sort_lane_returns_keys_of_its_own_lane(rng, monkeypatch, case):
    """The one-lane entry: its perm is the JAX package's argsort_perm; it
    returns the lane sorted exactly where the digit lane is the lane
    itself (int32/int64 patterns), and None where the digit lane is a
    transform of it (reinterpreted, biased, widened, narrowed)."""
    monkeypatch.setenv("CYLON_TPU_SORT_IMPL", "radix_pallas")
    n = 1536
    own = case in ("i32", "i64", "span_i32")
    hints = {"span_i32": (jrx.bound_hint(999), trx.bound_hint(999)),
             "span_i64": (jrx.bound_hint(999), trx.bound_hint(999)),
             "bias": (jrx.bias_hint(5, 4), trx.bias_hint(5, 4))}
    jh, th = hints.get(case, (None, None))
    if case in ("i32", "u32"):
        ku = _lane_u32(rng, n)
        ku[::4] = ku[3]
        jk, tk = jnp.asarray(ku), torch.from_numpy(ku.view(np.int32) if case == "i32" else ku)
    elif case == "i64":
        ku = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64) * np.uint64(5)
        jk, tk = jnp.asarray(ku), torch.from_numpy(ku.view(np.int64))
    else:
        dt = {"span_i32": np.int32, "span_i64": np.int64, "bias": np.int32, "i16": np.int16,
              "bool": np.bool_}[case]
        lo_v, hi_v = {"bias": (-5, 6), "i16": (-300, 300), "bool": (0, 2)}.get(case, (0, 1000))
        k = rng.integers(lo_v, hi_v, n).astype(dt)
        jk, tk = jnp.asarray(k), torch.from_numpy(k)
    want = np.asarray(jrx.argsort_perm(jk, jh))
    skeys, perm = trx.sort_lane(tk, th)
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(trx.argsort_perm(tk, th).numpy(), want)
    if own:
        assert skeys.dtype == tk.dtype
        np.testing.assert_array_equal(skeys.numpy(), tk.numpy()[want])
    else:
        assert skeys is None


def test_lexsort_perm_wide_ragged_matches_jax(rng, monkeypatch):
    """A 64-bit lane under a u32 lane at a ragged n: one lane sort each,
    the second gathered through the first's perm."""
    monkeypatch.setenv("CYLON_TPU_SORT_IMPL", "radix_pallas")
    n = 3001
    a = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64) >> np.uint64(3)
    a[::3] = a[0]
    c = _lane_u32(rng, n) >> np.uint32(28)
    want = np.asarray(jrx.lexsort_perm([jnp.asarray(c), jnp.asarray(a)], n))
    got = trx.lexsort_perm([torch.from_numpy(c.view(np.int32)), torch.from_numpy(a.view(np.int64))], n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.lexsort([c, a]))


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
        cuda_radix.lane_hist(enc, 0, 32)
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_radix.onesweep_pass(enc, perm, torch.zeros(256, dtype=torch.int32), 0, 8)
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_radix.radix_sort_lane(enc, perm, 0, 32)
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
