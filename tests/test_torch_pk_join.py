"""The port's PK-FK join (``algorithm="pallas_pk"``) against the JAX
package, on the CPU.

The probe and ``pk_inner_join`` are held against ``_pallas_probe`` /
``pk_inner_join`` of cylon_tpu/ops/pallas_join.py, run as
tests/test_pallas_join.py runs them (``interpret=True``); ``Table.join``
and ``distributed_join`` against cylon_tpu's on the 8 virtual CPU devices
of tests/conftest.py. Inputs are made with numpy from a fixed seed.

Everything here is exact: the probe and the join move integers. At world 1
the output is compared in emitted row order, which both packages define as
left rows by hash bucket, then by row. After a shuffle the bucket count
follows each shard's capacity, which the two packages size differently
(the reference pads each round of the shuffle), so at worlds 2 and 4 each
shard is compared as a multiset of rows. The world > 1 side runs with the
reference's shuffle tiers off, as in tests/test_torch_shuffle_slice.py.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.join_config import JoinConfig as JJoinConfig
from cylon_tpu.ops import pallas_join as jpk
from cylon_tpu_torch.join_config import JoinConfig
from cylon_tpu_torch.ops import cuda_probe, pk_join
from test_torch_shuffle_slice import NO_TIERS, _shard_frame

torch.set_num_threads(1)

I32_MIN = np.iinfo(np.int32).min

_CTX = {}


def _contexts(world):
    if world not in _CTX:
        _CTX[world] = (
            ct.CylonContext.init_distributed(ct.TPUConfig(devices=jax.devices()[:world])),
            ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=world)),
        )
    return _CTX[world]


@pytest.fixture
def ref_env(monkeypatch):
    for k in NO_TIERS:
        monkeypatch.setenv(k, "1")


def _bucketed(rng, nb, B):
    """Probe inputs in bucket layout: small keys (duplicates within a
    bucket), a quarter of the slots empty (id -1), and INT32_MIN both as a
    live key and as the key of empty right slots."""
    lk = rng.integers(-6, 6, nb * B).astype(np.int32)
    rk = rng.integers(-6, 6, nb * B).astype(np.int32)
    rid = rng.permutation(nb * B).astype(np.int32)
    rid[rng.random(nb * B) < 0.25] = -1
    lk[::5] = I32_MIN
    rk[rid < 0] = I32_MIN
    rk[1::7] = I32_MIN  # live right rows with the pad key too
    return lk, rk, rid


@pytest.mark.parametrize("nb,B", [(4, 8), (12, 4), (2, 64)])
def test_probe_plain_matches_pallas_probe(rng, nb, B):
    lk, rk, rid = _bucketed(rng, nb, B)
    want = np.asarray(jpk._pallas_probe(
        jnp.asarray(lk), jnp.asarray(rk), jnp.asarray(rid), nb=nb, B=B, interpret=True))
    got = cuda_probe.probe(torch.from_numpy(lk), torch.from_numpy(rk), torch.from_numpy(rid), nb, B)
    np.testing.assert_array_equal(got.numpy(), want)


def _probe_case(rng, case, nb, B):
    """Probe inputs the shared-memory hash table of kernel B5 has to get
    right: every slot of every bucket live with distinct keys, all right
    keys of a bucket equal (the largest id wins), and INT32_MIN as a live
    key on both sides next to empty slots that carry it as their pad key."""
    n = nb * B
    rid = rng.permutation(n).astype(np.int32)
    if case == "full_distinct":
        rk = rng.permutation(np.arange(-n, n, dtype=np.int32))[:n]
        lk = np.where(rng.random(n) < 0.7, rng.permutation(rk), rk - 1).astype(np.int32)
    elif case == "all_equal":
        rk = np.repeat(rng.integers(-(2**31), 2**31, nb).astype(np.int32), B)
        rid[rng.random(n) < 0.2] = -1
        lk = np.where(rng.random(n) < 0.5, rk, rk ^ 1).astype(np.int32)
    else:  # "int32_min_live"
        rk = rng.integers(-50, 50, n).astype(np.int32)
        rid[rng.random(n) < 0.3] = -1
        rk[rid < 0] = I32_MIN
        rk[::3] = I32_MIN  # live rows with the pad key
        lk = np.where(rng.random(n) < 0.5, I32_MIN, rng.integers(-50, 50, n)).astype(np.int32)
    return lk, rk, rid


@pytest.mark.parametrize("case", ["full_distinct", "all_equal", "int32_min_live"])
@pytest.mark.parametrize("nb,B", [(4, 64), (2, 256)])
def test_probe_plain_matches_pallas_probe_table_cases(rng, case, nb, B):
    lk, rk, rid = _probe_case(rng, case, nb, B)
    want = np.asarray(jpk._pallas_probe(
        jnp.asarray(lk), jnp.asarray(rk), jnp.asarray(rid), nb=nb, B=B, interpret=True))
    got = cuda_probe.probe(torch.from_numpy(lk), torch.from_numpy(rk), torch.from_numpy(rid), nb, B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any()


def _pk_both(lk, rk, nb, B):
    want = jpk.pk_inner_join(jnp.asarray(lk), jnp.asarray(rk), jnp.int32(len(lk)),
                             jnp.int32(len(rk)), nb=nb, B=B, interpret=True)
    got = pk_join.pk_inner_join(torch.from_numpy(lk), torch.from_numpy(rk), nb=nb, B=B)
    (jl, jr, jt, jb), (tl, tr, tt, tb) = [np.asarray(x) for x in want], [x.numpy() for x in got]
    return (jl, jr, int(jt), int(jb)), (tl, tr, int(tt), int(tb))


@pytest.mark.parametrize(
    "case,B,nb,dt",
    [
        ("hits_and_misses", 64, 0, np.int32),
        ("duplicate_right_keys", 64, 0, np.int16),
        ("bucket_overflow", 4, 2, np.int32),
        ("auto_nb_of_4", 256, 0, np.uint32),  # nb = 4: not a multiple of 8
        ("explicit_nb_12", 64, 12, np.int32),  # rounds up to 16, as the reference
    ],
)
def test_pk_inner_join_matches_reference(rng, case, B, nb, dt):
    n = 32 if case == "bucket_overflow" else 300
    rk = rng.permutation(3000)[:n].astype(np.int64)
    if dt == np.uint32:
        rk += 2**31  # keys above 2^31
    lk = rng.choice(rk, n)
    lk[::6] = 4000 + np.arange(len(lk[::6]))  # misses
    if case == "duplicate_right_keys":
        rk[5:9] = rk[0]
    lk, rk = lk.astype(dt), rk.astype(dt)
    (jl, jr, jt, jb), (tl, tr, tt, tb) = _pk_both(lk, rk, nb, B)
    assert (tt, tb) == (jt, jb)
    assert (tb != 0) == (case in ("duplicate_right_keys", "bucket_overflow"))
    np.testing.assert_array_equal(tl[:tt], jl[:jt])
    np.testing.assert_array_equal(tr[:tt], jr[:jt])
    assert (tl[tt:] == -1).all() and (tr[tt:] == -1).all()


def test_pk_inner_join_empty_sides():
    """The port has exact-length shards, so a side may hold no rows."""
    keys = torch.arange(10, dtype=torch.int32)
    for lk, rk in ((keys[:0], keys), (keys, keys[:0])):
        l_idx, r_idx, total, bad = pk_join.pk_inner_join(lk, rk, B=8)
        assert int(total) == 0 and int(bad) == 0 and l_idx.shape == (lk.shape[0],)


def _key_sides(rng, kind, n=300):
    rk = rng.permutation(max(5000, 2 * n))[:n]
    lk = rng.choice(rk, n)
    lk[::6] = 90000 + np.arange(len(lk[::6]))
    if kind == "int16":
        rk, lk = rk.astype(np.int16), (lk % 30000).astype(np.int16)
    elif kind == "uint32":
        rk, lk = (rk + 2**31).astype(np.uint32), (lk + 2**31).astype(np.uint32)
    elif kind == "string":
        rk, lk = np.array([f"s{k}" for k in rk], object), np.array([f"s{k}" for k in lk], object)
    else:
        rk, lk = rk.astype(np.int32), lk.astype(np.int32)
    left = {"k": lk, "v": rng.normal(size=n).astype(np.float32), "a": rng.integers(0, 9, n)}
    right = {"k": rk, "w": rng.normal(size=n)}
    return left, right


def _tables(world, left, right):
    jctx, tctx = _contexts(world)
    enc = [{k: ct.Column.encode_host(np.asarray(v)) for k, v in side.items()} for side in (left, right)]
    return (
        (ct.Table.from_encoded(jctx, enc[0]), ct.Table.from_encoded(jctx, enc[1])),
        (ctt.Table.from_encoded(tctx, enc[0]), ctt.Table.from_encoded(tctx, enc[1])),
    )


@pytest.mark.parametrize("kind", ["int32", "int16", "uint32", "string"])
def test_table_join_pallas_pk_matches_reference_in_order(rng, kind):
    (jl, jr), (tl, tr) = _tables(1, *_key_sides(rng, kind))
    before = pk_join.COUNTS["fallback"]
    got = tl.join(tr, on="k", algorithm="pallas_pk").to_pandas()
    want = jl.join(jr, on="k", algorithm="pallas_pk").to_pandas()
    assert pk_join.COUNTS["fallback"] == before
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    # the bucket order, not the sort join's left order
    assert not got["v"].equals(tl.join(tr, on="k").to_pandas()["v"])


@pytest.mark.parametrize("world,n", [(2, 300), (4, 4000)])
def test_distributed_join_pallas_pk_matches_reference_per_shard(rng, ref_env, world, n):
    """At world 4 a shard holds about 1000 rows in 8 buckets of 256: bucket
    ids from the hash bits the shuffle routed by would fill 2 of them and
    overflow, so no speculation miss shows that the port takes the bits
    above them."""
    (jl, jr), (tl, tr) = _tables(world, *_key_sides(rng, "int32", n=n))
    before = pk_join.COUNTS["fallback"]
    got = tl.distributed_join(tr, on="k", how="inner", algorithm="pallas_pk")
    want = jl.distributed_join(jr, on="k", how="inner", algorithm="pallas_pk")
    assert pk_join.COUNTS["fallback"] == before
    assert got.column_names == want.column_names
    np.testing.assert_array_equal(got.row_counts, want.row_counts)
    for s in range(world):
        g, w = _shard_frame(got, s, True), _shard_frame(want, s, False)
        cols = list(w.columns)
        pd.testing.assert_frame_equal(
            g.sort_values(cols).reset_index(drop=True),
            w.sort_values(cols).reset_index(drop=True), check_exact=True,
        )


def test_duplicate_keys_fall_back_to_the_sort_join(rng):
    left = {"k": rng.integers(0, 40, 160).astype(np.int32), "v": rng.normal(size=160)}
    right = {"k": rng.integers(0, 40, 120).astype(np.int32), "w": rng.normal(size=120)}
    (jl, jr), (tl, tr) = _tables(1, left, right)
    before = pk_join.COUNTS["fallback"]
    got = tl.join(tr, on="k", algorithm="pallas_pk").to_pandas()
    assert pk_join.COUNTS["fallback"] == before + 1
    want = jl.join(jr, on="k", algorithm="pallas_pk").to_pandas()
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    pd.testing.assert_frame_equal(got, tl.join(tr, on="k").to_pandas(), check_exact=True)


_INVALID = {
    "how_left": ({"k": np.arange(8, dtype=np.int32)}, dict(on="k", how="left")),
    "emit_order_key": ({"k": np.arange(8, dtype=np.int32)}, dict(on="k", emit_order="key")),
    "two_keys": ({"k": np.arange(8, dtype=np.int32), "j": np.arange(8, dtype=np.int32)},
                 dict(on=["k", "j"])),
    "null_key": ({"k": np.array([1, None, 3, 4], dtype=object)}, dict(on="k")),
    "float_key": ({"k": np.arange(8, dtype=np.float32)}, dict(on="k")),
    "int64_key": ({"k": np.arange(8, dtype=np.int64)}, dict(on="k")),
    "int32_x_uint32_key": (None, dict(on="k")),  # promotes to int64
}


@pytest.mark.parametrize("case", list(_INVALID))
def test_invalid_arguments_raise_the_reference_errors(case):
    data, kw = _INVALID[case]
    jctx, tctx = _contexts(1)
    errors = []
    for pkg, ctx in ((ct, jctx), (ctt, tctx)):
        if data is None:
            a = pkg.Table.from_pydict(ctx, {"k": np.arange(8, dtype=np.int32)})
            b = pkg.Table.from_pydict(ctx, {"k": np.arange(8, dtype=np.uint32)})
        else:
            a = b = pkg.Table.from_pydict(ctx, data)
        with pytest.raises(ValueError) as e:
            a.join(b, algorithm="pallas_pk", **kw)
        errors.append(str(e.value))
    assert errors[1] == errors[0]
    assert "pallas_pk" in errors[1]


def test_join_config_selects_pallas_pk(rng):
    left, right = _key_sides(rng, "int32", n=200)
    (jl, jr), (tl, tr) = _tables(1, left, right)
    cfg = JoinConfig.inner_join(on="k", algorithm="pallas_pk")
    assert cfg.kwargs() == JJoinConfig.inner_join(on="k", algorithm="pallas_pk").kwargs()
    got = tl.join(tr, config=cfg).to_pandas()
    want = jl.join(jr, config=JJoinConfig.inner_join(on="k", algorithm="pallas_pk")).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    with pytest.raises(ValueError, match="not both"):
        tl.join(tr, on="k", config=cfg)
    with pytest.raises(ValueError, match="unknown join algorithm"):
        JoinConfig.inner_join(on="k", algorithm="bogus")
    with pytest.raises(ValueError, match="unknown join type"):
        JoinConfig("sideways", on="k")


class _CudaLike:
    """Stands for a CUDA tensor on a machine without one: what the wrapper
    reads before it launches."""

    dtype = torch.int32
    device = torch.device("cuda", 0)

    def __init__(self, n):
        self.shape = (n,)

    def dim(self):
        return 1

    def is_contiguous(self):
        return True


def test_probe_never_takes_the_plain_version_off_the_cpu(monkeypatch):
    """A CUDA tensor goes to the kernel's library (here: a stub that
    stops), never to probe_plain; any other device raises."""

    class Launched(Exception):
        pass

    def stop(*_a, **_k):
        raise Launched

    monkeypatch.setattr(cuda_probe, "probe_plain", lambda *a: pytest.fail("plain version taken"))
    monkeypatch.setattr(cuda_probe._build, "library", stop)
    x = _CudaLike(4 * 8)
    with pytest.raises(Launched):
        cuda_probe.probe(x, x, x, 4, 8)
    meta = torch.zeros(32, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_probe.probe(meta, meta, meta, 4, 8)
