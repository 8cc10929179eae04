"""The port's shuffle modules against the JAX package, on the CPU: the row
hash (cylon_tpu_torch.ops.hash) against cylon_tpu.ops.hash, hash
partitioning, the round planner, the header-fused send buffer, and the
plain versions of kernels B2 and B3 (cylon_tpu_torch.ops.cuda_codec)
against ``fused_pack_dest`` / ``fused_compact_move`` in interpret mode and
against the XLA chains they replace. Every comparison is exact: hashes,
partition ids, send slots and moved rows are integers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import hash as jhash
from cylon_tpu.ops import pallas_codec as jpc
from cylon_tpu.ops import partition as jpart
from cylon_tpu.parallel import shuffle as jsh
from cylon_tpu_torch.ops import cuda_codec
from cylon_tpu_torch.ops import hash as thash
from cylon_tpu_torch.ops import partition as tpart
from cylon_tpu_torch.parallel import shuffle as tsh

torch.set_num_threads(1)


def _values(rng, dt, n):
    if dt == np.bool_:
        return rng.integers(0, 2, n).astype(bool)
    if np.issubdtype(dt, np.floating):
        x = (rng.normal(size=n) * 1e3).astype(dt)
        # subnormal (or, as float32, subnormal-producing) values: XLA
        # flushes them, and so does the port
        x[:10] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1 / 3, 2.0**-20, 1e-40, -1e-40, 1e-45]
        if dt == np.float64:  # values that do not round-trip through f32
            x[10:17] = [0.1, 1e300, -1e-30, 1 + 2.0**-40, np.pi, 3e-39, -1e-310]
        return x
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _u32(h):
    return np.asarray(h).astype(np.int64)


DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
          np.uint64, np.float32, np.float64, np.bool_]


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
def test_murmur3_column_matches_reference(rng, dt):
    x = _values(rng, dt, 600)
    want = _u32(jhash.murmur3_column(jnp.asarray(x)))
    np.testing.assert_array_equal(thash.murmur3_column(torch.from_numpy(x)).numpy(), want)


def test_hash_columns_with_nulls_matches_reference(rng):
    n = 700
    cols = [_values(rng, np.int64, n), _values(rng, np.float64, n), _values(rng, np.int16, n)]
    valids = [rng.random(n) > 0.2, None, rng.random(n) > 0.5]
    want = _u32(jhash.hash_columns(
        [(jnp.asarray(c), None if v is None else jnp.asarray(v)) for c, v in zip(cols, valids)]
    ))
    got = thash.hash_columns(
        [(torch.from_numpy(c), None if v is None else torch.from_numpy(v))
         for c, v in zip(cols, valids)]
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_dictionary_host_matches_reference():
    d = np.array(["", "a", "ab", "abc", "abcd", "abcde", "héllo wörld", "日本語", "x" * 37],
                 dtype=object)
    np.testing.assert_array_equal(thash.hash_dictionary_host(d), jhash.hash_dictionary_host(d))


@pytest.mark.parametrize("P", [1, 3, 4, 8])
def test_hash_partition_ids_matches_reference(rng, P):
    cap, n = 512, 450
    k = _values(rng, np.int32, cap)
    v = rng.random(cap) > 0.1
    x = _values(rng, np.float32, cap)
    want = jpart.hash_partition_ids(
        [(jnp.asarray(k), jnp.asarray(v)), (jnp.asarray(x), None)], jnp.int32(n), P
    )
    got = tpart.hash_partition_ids(
        [(torch.from_numpy(k), torch.from_numpy(v)), (torch.from_numpy(x), None)], n, P
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "counts,budget",
    [
        (np.full((4, 4), 1000), 32 << 20),           # one round
        (np.full((4, 4), 1000), 4096),                # budget-bound rounds
        (np.diag([5000, 10, 10, 10]), 32 << 20),      # skew: the 4x-mean cap
        (np.zeros((2, 2), np.int64), 1 << 20),        # nothing to send
        (np.array([[1 << 20, 3], [5, 7]]), 1024),     # past max_rounds: cap over budget
        (np.arange(9).reshape(3, 3) * 77, 2000),      # a non-power-of-two world
    ],
)
def test_plan_rounds_matches_reference(counts, budget):
    for row_bytes in (4, 12, 20):
        want = jsh.plan_rounds(counts, row_bytes, counts.shape[0], budget)
        assert tsh.plan_rounds(counts, row_bytes, counts.shape[0], budget) == want


def test_exchange_row_bytes_matches_reference(rng):
    n = 32
    arrays = [_values(rng, dt, n) for dt in (np.int32, np.int64, np.float64, np.float32, np.bool_)]
    valids = [None, rng.random(n) > 0.5, rng.random(n) > 0.5, None, None]
    want = jsh.exchange_row_bytes(
        [(jnp.asarray(a), None if v is None else jnp.asarray(v)) for a, v in zip(arrays, valids)]
    )
    got = tsh.exchange_row_bytes(
        [(torch.from_numpy(a), None if v is None else torch.from_numpy(v))
         for a, v in zip(arrays, valids)]
    )
    assert got == want == 4 + 12 + 12 + 4 + 4


def _pack_inputs(rng, cap, wide):
    """Key columns (nullable int32/int64, float64) in both packages, and the
    port's hash words of them."""
    k = _values(rng, np.int64 if wide else np.int32, cap)
    v = rng.random(cap) > 0.1
    x = (rng.normal(size=cap) * 40).astype(np.float64)
    jcols = [(jnp.asarray(k), jnp.asarray(v)), (jnp.asarray(x), None)]
    words, valids, hv = cuda_codec.key_words(
        [(torch.from_numpy(k), torch.from_numpy(v)), (torch.from_numpy(x), None)]
    )
    return jcols, words, valids, hv


def _xla_chain(pid, P, bc, r):
    cnt = jsh.bucket_counts(pid, P)
    dest, _ = jsh.build_send_slots_round(pid, cnt, P, bc, r)
    return np.array(dest), np.array(cnt)


@pytest.mark.parametrize("P", [1, 4, 8])
def test_pack_hash_mode_matches_pallas(rng, P):
    """B2's plain version (B2a + scan + B2b) against the Pallas kernel and
    the XLA chain, several rounds, rows past n."""
    cap, n = 1024, 900
    jcols, words, valids, hv = _pack_inputs(rng, cap, wide=P == 4)
    jw, jv, jhv = jpc.hash_operands(jcols)
    np.testing.assert_array_equal(words.numpy(), np.stack([np.asarray(w) for w in jw]).view(np.int32))
    pid = jpart.hash_partition_ids(jcols, jnp.int32(n), P)
    bc = max(8, (n // P) // 2)
    for r in range(3):
        dest_k, cnt_k = jpc.fused_pack_dest(jw, jv, jhv, jnp.int32(n), r, P, bc, interpret=True)
        dest_x, cnt_x = _xla_chain(pid, P, bc, r)
        dest, cnt = cuda_codec.fused_pack_dest(words, valids, hv, n, r, P, bc)
        dest_p, cnt_p = cuda_codec.fused_pack_dest_plain(words, valids, hv, n, r, P, bc)
        for d, c in ((dest, cnt), (dest_p, cnt_p)):
            np.testing.assert_array_equal(d.numpy(), np.asarray(dest_k), err_msg=f"round {r}")
            np.testing.assert_array_equal(c.numpy(), np.asarray(cnt_k))
        np.testing.assert_array_equal(dest.numpy(), dest_x)
        np.testing.assert_array_equal(cnt.numpy(), cnt_x)


@pytest.mark.parametrize("P", [4, 8])
def test_pack_pid_mode_matches_pallas(rng, P):
    """pid-input mode: the dead sentinel P among live rows and garbage past
    n, which the kernel's own row < n test must drop."""
    cap, n = 1024, 800
    pid = rng.integers(0, P + 1, cap).astype(np.int32)
    pid[n:] = rng.integers(0, P, cap - n)
    bc = (n // P) // 2
    for r in range(2):
        dest_k, cnt_k = jpc.fused_pack_dest(
            [], [], (), jnp.int32(n), r, P, bc, pid=jnp.asarray(pid), interpret=True
        )
        dest, cnt = cuda_codec.fused_pack_dest(None, None, (), n, r, P, bc, pid=torch.from_numpy(pid))
        np.testing.assert_array_equal(dest.numpy(), np.asarray(dest_k), err_msg=f"round {r}")
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_k))


def test_pack_non_power_of_two_world_matches_xla_chain(rng):
    """P = 3: the Pallas kernel declines it; B2 serves it with h % P."""
    cap, n, P = 1024, 1000, 3
    jcols, words, valids, hv = _pack_inputs(rng, cap, wide=True)
    pid = jpart.hash_partition_ids(jcols, jnp.int32(n), P)
    bc = 128
    for r in range(3):
        dest_x, cnt_x = _xla_chain(pid, P, bc, r)
        dest, cnt = cuda_codec.fused_pack_dest(words, valids, hv, n, r, P, bc)
        np.testing.assert_array_equal(dest.numpy(), dest_x, err_msg=f"round {r}")
        np.testing.assert_array_equal(cnt.numpy(), cnt_x)


@pytest.mark.parametrize(
    "counts",
    [
        "random",
        np.zeros(8, np.int32),                      # nothing received
        np.full(8, 16, np.int32),                   # every slot live
        np.array([16, 0, 3, 0, 16, 1, 0, 7], np.int32),  # zero-row chunks
    ],
    ids=["random", "zero", "full", "zero_chunks"],
)
def test_compact_matches_pallas(rng, counts):
    """B3's plain version against the Pallas kernel, dead rows included."""
    P, bc, lm = 8, 16, 3
    if isinstance(counts, str):
        counts = rng.integers(0, bc + 1, P).astype(np.int32)
    move = rng.integers(-(2**31), 2**31 - 1, (P * bc, lm)).astype(np.int32)
    want, total = jpc.fused_compact_move(jnp.asarray(move), jnp.asarray(counts), P, bc,
                                         interpret=True)
    got = cuda_codec.compact_move(torch.from_numpy(move), torch.from_numpy(counts), P, bc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(total) == int(counts.sum())


def test_send_buffer_round_trip_matches_reference(rng):
    """The header-fused send buffer, the header split and the compact of the
    received rows, from one round's send slots, against the reference's
    pack_lane_buffer / split_header / fused_compact_move."""
    P, cap, n, bc = 4, 512, 500, 64
    pid = rng.integers(0, P, cap).astype(np.int32)
    pid[n:] = P
    lanes = rng.integers(-1000, 1000, (cap, 3)).astype(np.int32)
    for r in range(3):
        dest, cnt = _xla_chain(jnp.asarray(pid), P, bc, r)
        rc = np.clip(cnt - r * bc, 0, bc).astype(np.int32)
        want = np.asarray(jsh.pack_lane_buffer(
            [jnp.asarray(lanes[:, j]) for j in range(3)], jnp.asarray(dest), jnp.asarray(rc), P, bc
        ))
        got = tsh.pack_lane_buffer(
            torch.from_numpy(lanes), torch.from_numpy(dest), torch.from_numpy(rc), P, bc
        )
        np.testing.assert_array_equal(got.numpy(), want)
        data_j, recv_j = jsh.split_header(jnp.asarray(want), P)
        data_t, recv_t = tsh.split_header(got, P)
        np.testing.assert_array_equal(data_t.numpy(), np.asarray(data_j))
        np.testing.assert_array_equal(recv_t.numpy(), np.asarray(recv_j))
        moved_j, _ = jpc.fused_compact_move(data_j, recv_j, P, bc, interpret=True)
        # the port reads the counts where they arrived, skipping the headers
        moved_t = cuda_codec.compact_move(got, got.view(P, bc + 1, 3)[:, 0, 0], P, bc, n_header=1)
        np.testing.assert_array_equal(moved_t.numpy(), np.asarray(moved_j))
