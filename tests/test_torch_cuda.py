"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
built with nvcc on first use); without one they skip. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu_torch as ctt
from cylon_tpu_torch.ops import cuda_codec, cuda_gather, cuda_probe, cuda_radix, pk_join, radix
from cylon_tpu_torch.ops.sort import orderable_key

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


def _lane(n, wide, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    dt = torch.int64 if wide else torch.int32
    info = torch.iinfo(dt)
    enc = torch.randint(info.min, info.max, (n,), dtype=dt, generator=g)
    enc[: n // 3] = enc[n // 3: 2 * (n // 3)]  # ties
    return enc.to(dev), torch.randperm(n, generator=g).to(torch.int32).to(dev)


T = cuda_radix.TILE


@pytest.mark.parametrize("n", [0, 1, T - 1, T, T + 1, 70_001, 2**24 + 3])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("identity", [False, True])
def test_radix_kernels_match_plain(dev, n, wide, identity):
    """K1a, single K1b passes and whole lane sorts (keys and perm) against
    their plain versions: full spans, a span with a narrow last digit, a
    one-digit span, with a random or an identity perm."""
    enc, perm = _lane(n, wide, n + wide, dev)
    if identity:
        perm = None
    width = 8 * enc.element_size()
    for lo, hi in [(0, width), (5, width - 2), (width - 3, width)]:
        keys = enc if perm is None else enc.index_select(0, perm)
        hist = cuda_radix.lane_hist(keys, lo, hi)
        assert torch.equal(hist, cuda_radix.lane_hist_plain(keys, lo, hi).to(dev))
        got_k, got_p = cuda_radix.radix_sort_lane(enc, perm, lo, hi)
        torch.cuda.synchronize()
        want_k, want_p = cuda_radix.radix_sort_lane_plain(enc, perm, lo, hi)
        assert torch.equal(got_k, want_k) and torch.equal(got_p, want_p), (lo, hi)
        assert torch.equal(got_k, enc.index_select(0, got_p))
        bits = min(8, hi - lo)
        k1, p1 = cuda_radix.onesweep_pass(keys, perm, hist[0], lo, bits)
        pk, pp = cuda_radix.onesweep_pass_plain(keys, perm, lo, bits)
        torch.cuda.synchronize()
        assert torch.equal(k1, pk) and torch.equal(p1, pp), (lo, hi)


@pytest.mark.parametrize("n", [T + 1, 70_001, 2**22 + 7])
@pytest.mark.parametrize("wide", [False, True])
def test_radix_all_equal_keys_keep_perm(dev, n, wide):
    """Stability under total skew: every row on one digit in every pass,
    so the carried perm comes back unchanged, and the identity too."""
    enc = torch.full((n,), -12345, dtype=torch.int64 if wide else torch.int32, device=dev)
    perm = torch.randperm(n, device=dev).to(torch.int32)
    keys, p = cuda_radix.radix_sort_lane(enc, perm, 0, 8 * enc.element_size())
    torch.cuda.synchronize()
    assert torch.equal(p, perm) and torch.equal(keys, enc)
    _, p = cuda_radix.radix_sort_lane(enc, None, 0, 8 * enc.element_size())
    assert torch.equal(p, torch.arange(n, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("wide", [False, True])
def test_radix_short_circuit_passes_match_plain(dev, wide):
    """Keys below 1000: every pass above the second has one digit on all
    rows, and K1b copies those through; the lane sort still equals its
    plain version and torch.sort's stable order."""
    g = torch.Generator(device="cpu").manual_seed(11)
    enc = torch.randint(0, 1000, (300_007,), generator=g).to(torch.int64 if wide else torch.int32).to(dev)
    perm = torch.randperm(enc.shape[0], generator=g).to(torch.int32).to(dev)
    for p in (None, perm):
        got_k, got_p = cuda_radix.radix_sort_lane(enc, p, 0, 8 * enc.element_size())
        torch.cuda.synchronize()
        want_k, want_p = cuda_radix.radix_sort_lane_plain(enc, p, 0, 8 * enc.element_size())
        assert torch.equal(got_k, want_k) and torch.equal(got_p, want_p)
    assert torch.equal(radix.argsort_perm(enc).long(), torch.sort(enc, stable=True).indices)


@pytest.mark.parametrize("dt", [torch.int32, torch.int64, torch.float32])
def test_radix_argsort_equals_torch_sort(dev, dt):
    """The whole argsort through K1 (orderable lanes, 4 or 8 passes) equals
    torch.sort(stable=True)'s indices, as in chip_smoke.py at 8M rows."""
    n = 3_000_017
    g = torch.Generator(device="cpu").manual_seed(7)
    if dt.is_floating_point:
        x = torch.randn(n, generator=g).to(dt)
    else:
        x = torch.randint(-(2**30), 2**30, (n,), generator=g).to(dt) * 3
    x[::11] = x[5]
    x = x.to(dev)
    before = cuda_radix.LAUNCHES["radix_onesweep"]
    got = radix.argsort_perm(orderable_key(x))
    assert cuda_radix.LAUNCHES["radix_onesweep"] - before == x.element_size()  # 8-bit passes
    assert torch.equal(got.long(), torch.sort(x, stable=True).indices)


@pytest.mark.parametrize("L", [1, 6, 19])
def test_expand_kernel_matches_plain(dev, L):
    g = torch.Generator(device="cpu").manual_seed(L)
    cnt = torch.randint(1, 4, (5000,), generator=g)
    cnt[17] = 3000  # a hot row spans several blocks
    li = torch.repeat_interleave(torch.arange(5000), cnt).to(torch.int32)
    src = torch.randint(-(2**31), 2**31 - 1, (L, 5000), dtype=torch.int32, generator=g)
    src, li = src.to(dev), li.to(dev)
    got = cuda_gather.expand_rows(src, li)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_gather.expand_rows_plain(src, li))
    wild = torch.randint(-10, 5010, (3333,), dtype=torch.int32, generator=g).to(dev)
    assert torch.equal(cuda_gather.expand_rows(src, wild), cuda_gather.expand_rows_plain(src, wild))


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_main_path_on_card_matches_cpu(dev, how):
    rng = np.random.default_rng(3)
    n = 20_000
    left = {"k": rng.integers(0, n, n).astype(np.int32), "v": rng.normal(size=n).astype(np.float32),
            "s": rng.choice(["a", "b", "c"], n)}
    right = {"k": rng.integers(0, n, n).astype(np.int32), "w": rng.normal(size=n)}
    k2 = rng.integers(0, 50, n).astype(object)
    k2[rng.random(n) < 0.01] = None  # a nullable int64 second key
    left["k2"], right["k2"] = k2, rng.integers(0, 50, n)
    outs = []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device))
        tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
        j1 = tl.distributed_join(tr, on="k", how=how)
        j2 = tl.distributed_join(tr, on=["k", "k2"], how=how)
        by = "k_x" if how != "right" else "k_y"
        g = j1.distributed_groupby(by, {"v": ["sum", "min"], "w": "mean"})
        outs.append((j1.to_pydict(), j2.to_pydict(), g.to_pydict()))
    (ja, jb, gg), (jc, jd, gc) = outs
    for x, y in ((ja, jc), (jb, jd)):
        assert list(x) == list(y)
        for c in x:
            np.testing.assert_array_equal(x[c], y[c])
    by = "k_x" if how != "right" else "k_y"
    np.testing.assert_array_equal(gg[by], gc[by])
    np.testing.assert_array_equal(gg["v_min"], gc["v_min"])
    # float sums: atomics on the card add in another order than the CPU
    np.testing.assert_allclose(gg["v_sum"], gc["v_sum"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gg["w_mean"], gc["w_mean"], rtol=1e-9, atol=1e-12)


def _key_cols(rng, n, wide, device):
    """A nullable int32 / int64 key and a float64 key, on ``device``."""
    dt = np.int64 if wide else np.int32
    info = np.iinfo(dt)
    k = torch.from_numpy(rng.integers(info.min, info.max, n, dtype=dt))
    valid = torch.from_numpy(rng.random(n) > 0.05)
    x = torch.from_numpy(rng.normal(size=n) * 1e3)
    x[:4] = torch.tensor([0.0, -0.0, float("nan"), float("inf")], dtype=torch.float64)[:n]
    return [(k.to(device), valid.to(device)), (x.to(device), None)]


@pytest.mark.parametrize("P", [1, 3, 4, 8, 32, 33, 1024])
@pytest.mark.parametrize("cap", [1, 4095, 4096, 4097, 70_001])
@pytest.mark.parametrize("mode", ["hash32", "hash64", "one_bucket"])
def test_pack_kernels_match_plain(dev, P, cap, mode):
    """B2a and B2b against their plain versions, with rows past n: hash mode
    (32- or 64-bit key words, nulls, a float64 key) and then pid-input mode
    with out-of-range pids, or every live row in one bucket (the warp match
    and the running counts at their most skewed). B2b over the first rounds,
    the last and rounds beyond it; B2b's register path (P <= 32) and its
    shared-memory path (P > 32), ragged last tiles."""
    rng = np.random.default_rng(P + cap + len(mode))
    n = cap - max(1, cap // 50)
    bc = max(1, (n // P) // 3)

    def rounds(hist):
        last = max(0, (int(hist.sum(1).max()) - 1) // bc)
        return sorted({0, 1, last, last + 1, last + 3})

    def check_dest(lane, hist, lane_p):
        for r in rounds(hist):
            dest = cuda_codec.pack_dest(lane, cuda_codec.scan_tiles(hist), r, P, bc)
            torch.cuda.synchronize()
            assert torch.equal(dest.cpu(), cuda_codec.pack_dest_plain(lane_p, None, r, P, bc)), r

    if mode == "one_bucket":
        pid = torch.full((cap,), P - 1, dtype=torch.int32, device=dev)
    else:
        words, valids, hv = cuda_codec.key_words(_key_cols(rng, cap, mode == "hash64", dev))
        lane, hist = cuda_codec.pack_hist(words, valids, hv, n, P)
        lane_p, hist_p = cuda_codec.pack_hist_plain(words.cpu(), valids.cpu(), hv, n, P)
        torch.cuda.synchronize()
        assert torch.equal(lane.cpu(), lane_p) and torch.equal(hist.cpu(), hist_p)
        check_dest(lane, hist, lane_p)
        for r in rounds(hist)[:2]:
            d2, c2 = cuda_codec.fused_pack_dest(words, valids, hv, n, r, P, bc)
            d3, c3 = cuda_codec.fused_pack_dest_plain(words.cpu(), valids.cpu(), hv, n, r, P, bc)
            assert torch.equal(d2.cpu(), d3) and torch.equal(c2.cpu(), c3)
        pid = torch.from_numpy(rng.integers(-1, P + 2, cap).astype(np.int32)).to(dev)
    lane, hist = cuda_codec.pack_hist(None, None, (), n, P, pid=pid)
    lane_p, hist_p = cuda_codec.pack_hist_plain(None, None, (), n, P, pid=pid.cpu())
    assert torch.equal(lane.cpu(), lane_p) and torch.equal(hist.cpu(), hist_p)
    check_dest(lane, hist, lane_p)


@pytest.mark.parametrize("P,bc", [(8, 16), (4, 5000), (3, 4097), (1, 64), (4, 65536)])
@pytest.mark.parametrize("lm", [1, 2, 3, 4, 7, 8])
def test_compact_kernel_matches_plain(dev, P, bc, lm):
    """B3 against its plain version: with and without a header row per
    chunk (the counts read where they arrive), from a buffer that starts on
    a 16-byte line or one row past it, with counts random, 0, bc, negative,
    above bc and mixed."""
    rng = np.random.default_rng(bc + lm)
    for n_header in (0, 1):
        rows = P * (bc + n_header)
        for offset in (0, 1):
            big = torch.from_numpy(
                rng.integers(-(2**31), 2**31 - 1, (rows + offset, lm)).astype(np.int32)).to(dev)
            move = big[offset:]
            for counts in (rng.integers(0, bc + 1, P), np.zeros(P), np.full(P, bc),
                           rng.integers(-3, bc + 4, P), np.full(P, -5), np.full(P, bc + 7),
                           np.resize([0, bc, -2, bc + 3], P)):
                rc = torch.from_numpy(np.asarray(counts, np.int32)).to(dev)
                if n_header:  # the counts read where they arrive: lane 0 of the headers
                    move.view(P, bc + 1, lm)[:, 0, 0] = rc
                    rc = move.view(P, bc + 1, lm)[:, 0, 0]
                got = cuda_codec.compact_move(move, rc, P, bc, n_header)
                torch.cuda.synchronize()
                want = cuda_codec.compact_move_plain(move.cpu(), rc.cpu(), P, bc, n_header)
                assert torch.equal(got.cpu(), want), (counts, n_header, offset)


@pytest.mark.parametrize("placement", ["one_card", "round_robin"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_world4_main_path_on_card_matches_cpu(dev, how, placement):
    """The world-4 shuffle -> join -> groupby on the card against the same
    path on the CPU, shard by shard: all four shards on one card, or spread
    round-robin over the visible cards (the same as one card when there is
    only one). The small budget makes the right side's shuffle take
    several rounds."""
    rng = np.random.default_rng(4)
    n = 30_000
    left = {"k": rng.integers(0, n, n).astype(np.int32), "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n), "w": rng.normal(size=n),
             "s": rng.choice(["a", "b", "c"], n)}
    outs = []
    for device in (dev if placement == "one_card" else None, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=4))
        ctx.add_config("shuffle_byte_budget", 4 * 1024 * 16)
        tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
        j = tl.distributed_join(tr, on="k", how=how)
        by = "k_x" if how != "right" else "k_y"
        g = j.distributed_groupby(by, {"v": "sum", "w": "max"})
        s = j.distributed_groupby("s", {"w": "min"})
        outs.append([(t.row_counts, [{c: t._host_physical_shard(c, i) for c in t.column_names}
                                     for i in range(4)]) for t in (j, g, s)])
    for (counts_a, shards_a), (counts_b, shards_b) in zip(*outs):
        np.testing.assert_array_equal(counts_a, counts_b)
        for sa, sb in zip(shards_a, shards_b):
            for c in sa:
                (da, va), (db, vb) = sa[c], sb[c]
                if c == "v_sum":  # float32 sums: atomics add in another order
                    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(da, db)
                assert (va is None) == (vb is None)
                if va is not None:
                    np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("B", [4, 64, 256, 8192])
def test_probe_kernel_matches_plain(dev, B):
    """B5 against probe_plain: empty buckets and empty slots, duplicate
    right keys in a bucket (the largest id wins), INT32_MIN as a live key
    and as the empty slots' key, and uint32 keys above 2^31."""
    rng = np.random.default_rng(B)
    nb = max(4, 2**16 // B)
    lk = rng.integers(-20, 20, nb * B).astype(np.int32)
    rk = rng.integers(-20, 20, nb * B).astype(np.int32)
    rid = rng.permutation(nb * B).astype(np.int32)
    rid[rng.random(nb * B) < 0.3] = -1
    empty = rng.choice(nb, nb // 4, replace=False)
    for b in empty:  # whole buckets without rows
        rid[b * B:(b + 1) * B] = -1
    lk[::9] = np.iinfo(np.int32).min
    rk[rid < 0] = np.iinfo(np.int32).min
    big = torch.from_numpy((rng.integers(0, 40, nb * B) + 2**31 - 20).astype(np.uint32))
    lk[1::5] = pk_join.probe_lane(big).numpy()[1::5]
    rk[2::5] = pk_join.probe_lane(big).numpy()[2::5]
    args = [torch.from_numpy(x) for x in (lk, rk, rid)]
    got = cuda_probe.probe(*[x.to(dev) for x in args], nb, B)
    torch.cuda.synchronize()
    want = cuda_probe.probe_plain(*args, nb, B)
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).any() and (want == -1).any()


def _colliding_keys(count, B, rng):
    """Distinct int32 keys whose home slot in B5's table (the top log2 T
    bits of key * 0x9E3779B1) is one and the same."""
    log_t = max(1, (2 * B - 1).bit_length())
    inv = pow(0x9E3779B1, -1, 2**32)
    start = int(rng.integers(0, 2**32 - count)) >> (32 - log_t) << (32 - log_t)
    keys = [(inv * (start + j)) % 2**32 for j in range(count)]
    assert len({(k * 0x9E3779B1) % 2**32 >> (32 - log_t) for k in keys}) == 1
    return np.array(keys, dtype=np.uint64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("case", ["full_distinct", "colliding", "all_equal"])
@pytest.mark.parametrize("B", [64, 256, 8192])
def test_probe_kernel_table_cases(dev, case, B):
    """B5's hash table on the inputs that stress it: every slot of every
    bucket live with distinct keys, keys that all land on one home slot
    (the probe walks the whole cluster), and one key repeated over a whole
    bucket (the largest id wins)."""
    rng = np.random.default_rng(B + len(case))
    nb = max(4, 2**15 // B)
    n = nb * B
    rid = rng.permutation(n).astype(np.int32)
    if case == "full_distinct":
        rk = rng.permutation(np.arange(-n, n, dtype=np.int32))[:n]
    elif case == "colliding":
        rk = np.concatenate([rng.permutation(_colliding_keys(B, B, rng)) for _ in range(nb)])
        rid[rng.random(n) < 0.1] = -1
    else:
        rk = np.repeat(rng.integers(-(2**31), 2**31, nb).astype(np.int32), B)
        rid[rng.random(n) < 0.2] = -1
    hit = rng.random(n) < 0.6
    lk = np.where(hit, rk[np.arange(n) // B * B + rng.integers(0, B, n)], rk ^ 0x5A5A).astype(np.int32)
    args = [torch.from_numpy(x) for x in (lk, rk, rid)]
    got = cuda_probe.probe(*[x.to(dev) for x in args], nb, B)
    torch.cuda.synchronize()
    want = cuda_probe.probe_plain(*args, nb, B)
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).any()


def test_probe_kernel_refuses_a_table_past_shared_memory(dev):
    z = torch.zeros(8193, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="227 KB"):
        cuda_probe.probe(z, z, z, 1, 8193)


@pytest.mark.parametrize("world", [1, 4])
def test_pallas_pk_join_on_card_matches_cpu(dev, world):
    """The PK join on the card equals the same join on the CPU (the same
    buckets, so the same rows in the same order), and a duplicate key
    falls back on both."""
    rng = np.random.default_rng(5)
    n = 50_000
    rk = rng.permutation(2 * n)[:n].astype(np.int32)
    left = {"k": rng.choice(rk, n), "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rk, "w": rng.normal(size=n)}
    dup = dict(right, k=np.where(np.arange(n) == 7, rk[3], rk))
    outs = []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=world))
        tl = ctt.Table.from_pydict(ctx, left)
        res = []
        for r in (right, dup):
            before = pk_join.COUNTS["fallback"]
            j = tl.distributed_join(ctt.Table.from_pydict(ctx, r), on="k", algorithm="pallas_pk")
            res.append((pk_join.COUNTS["fallback"] - before, j.row_counts, j.to_pydict()))
        outs.append(res)
    for (fa, ca, ja), (fb, cb, jb) in zip(*outs):
        assert fa == fb
        np.testing.assert_array_equal(ca, cb)
        for c in ja:
            np.testing.assert_array_equal(ja[c], jb[c])
    assert [r[0] for r in outs[0]] == [0, 1]


def _shard_dump(t):
    return t.row_counts, [{c: t._host_physical_shard(c, i) for c in t.column_names}
                          for i in range(t.world_size)]


def _dumps_equal(a, b):
    (ca, sa), (cb, sb) = a, b
    np.testing.assert_array_equal(ca, cb)
    for xa, xb in zip(sa, sb):
        assert list(xa) == list(xb)
        for c in xa:
            (da, va), (db, vb) = xa[c], xb[c]
            np.testing.assert_array_equal(da, db)
            assert (va is None) == (vb is None)
            if va is not None:
                np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("world", [1, 4])
def test_sort_and_setops_on_card_match_cpu(dev, world):
    """distributed_sort (the range shuffle at world 4, several rounds),
    every set op and distributed_unique on the card against the same calls
    on the CPU, shard by shard. 70,001 rows a side: more than one K1 tile
    and one B2 tile per shard."""
    from cylon_tpu_torch.ops import cuda_codec

    rng = np.random.default_rng(6)
    n = 70_001
    f = rng.normal(size=n).astype(np.float32)
    f[rng.random(n) < 0.01] = np.nan
    left = {"k": rng.integers(0, 5000, n).astype(np.int32), "f": f,
            "s": rng.choice(["a", "b", "c", "d"], n)}
    right = {"k": rng.integers(2500, 7500, n).astype(np.int32), "f": f[::-1].copy(),
             "s": rng.choice(["c", "d", "e"], n)}
    outs = []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=world))
        ctx.add_config("shuffle_byte_budget", world * 4096 * 16)
        tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
        pk, pr = tl.project(["k", "s"]), tr.project(["k", "s"])
        before = cuda_codec.LAUNCHES["pack_hist"]
        res = [tl.distributed_sort(["k", "f"], [False, True]), tl.distributed_sort("f")]
        launched = cuda_codec.LAUNCHES["pack_hist"] - before
        for op in ("union", "subtract", "intersect"):
            res.append(getattr(tl, "distributed_" + op)(tr))
            res.append(getattr(pk, "distributed_" + op)(pr))
        res += [tl.distributed_unique(["k"]), pk.distributed_unique(["s", "k"], "last")]
        outs.append([_shard_dump(t) for t in res])
        if device is dev and world > 1:
            assert launched == 2 * world  # B2a in pid mode, one launch a shard
    for a, b in zip(*outs):
        _dumps_equal(a, b)


@pytest.mark.parametrize("cap", [1, 4097, 70_001])
def test_pack_hist_pid_mode_on_range_pids(dev, cap):
    """B2a in pid-input mode on the range partition lane of a float key
    with NaN and nulls, against its plain version."""
    from cylon_tpu_torch.ops import partition

    rng = np.random.default_rng(cap)
    P = 4
    x = torch.from_numpy(rng.normal(size=cap)).to(dev)
    x[:: 97] = float("nan")
    valid = torch.from_numpy(rng.random(cap) > 0.02).to(dev)
    cuts = [0, cap // 3, cap // 3, cap // 2, cap]
    keys = [(x[a:b], valid[a:b]) for a, b in zip(cuts, cuts[1:])]
    comm = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=dev, world_size=P)).comm
    pids = partition.range_partition_ids(keys, P, comm)
    want = partition.range_partition_ids([(k.cpu(), v.cpu()) for k, v in keys], P,
                                         ctt.CylonContext.init_distributed(
                                             ctt.GPUConfig(device="cpu", world_size=P)).comm)
    for pid, pid_cpu in zip(pids, want):
        assert torch.equal(pid.cpu(), pid_cpu)
        n = pid.shape[0] - pid.shape[0] // 7
        lane, hist = cuda_codec.pack_hist(None, None, (), n, P, pid=pid)
        lane_p, hist_p = cuda_codec.pack_hist_plain(None, None, (), n, P, pid=pid_cpu)
        torch.cuda.synchronize()
        assert torch.equal(lane.cpu(), lane_p) and torch.equal(hist.cpu(), hist_p)


def test_two_gloo_ranks_on_one_card_match_cpu(dev, tmp_path):
    """The torch.distributed backend on the card: two processes, each one
    shard on cuda:0, gloo through the host, against LocalCommunicator on
    the CPU at world 2, shard by shard (float sums and means within the
    tolerances of tests/test_torch_multiprocess.py: the card's segment
    sums add in no fixed order). Each rank launched its kernels."""
    import _torch_mp_worker as W

    cases = ["join_groupby", "skew", "sort", "setops", "aggregates", "pk", "ingest", "frame"]
    codes, logs, _s = W.run_ranks(tmp_path, 2, cases, device=str(dev), backend="gloo",
                                  limit=600)
    assert codes == [0, 0], "\n".join(log[-3000:] for log in logs)
    ranks = W.load_ranks(tmp_path, 2)
    local = W.run_cases(ctt.CylonEnv(config=ctt.GPUConfig(device="cpu", world_size=2)), cases)
    for r, res in enumerate(ranks):
        for case in cases:
            assert res[case]["__plans__"] == local[case]["__plans__"], case
            for key, want in local[case].items():
                if key != "__plans__":
                    W.record_equal(res[case][key], want, f"{case}.{key}", r, sums_close=True)
        launched = res["__launches__"]
        for k in ("radix_lane_hist", "radix_onesweep", "expand_rows", "pack_hist",
                  "pack_dest", "compact_move", "pk_probe"):
            assert launched[k] > 0, (r, k, launched)


@pytest.mark.parametrize("kind", ["hash", "linear"])
def test_loc_list_probes_the_index_on_the_card(dev, kind):
    """``loc`` with a list of labels, with and without ``build_index``,
    probes the index column's sorted view on the card (its K1 argsort
    launched there) and gives the CPU's rows: request order, repeats,
    nulls never matched, a missing label skipped or, for 'linear', a
    KeyError."""
    rng = np.random.default_rng(8)
    n = 70_001
    k = rng.integers(0, 20_000, n).astype(np.int64)
    cols = {"k": k, "x": rng.normal(size=n)}
    labels = [int(k[5]), int(k[9]), 20_001, int(k[5])] if kind == "hash" else \
        [int(k[5]), int(k[9]), int(k[5])]
    outs = []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=2))
        t = ctt.Table.from_pydict(ctx, cols).set_index("k")
        before = cuda_radix.LAUNCHES["radix_onesweep"]
        eager = t.loc[labels]
        idx = t.build_index(kind)
        built = t.loc[labels]
        if device is dev:
            assert idx._sorted.is_cuda and idx._positions.is_cuda
            assert cuda_radix.LAUNCHES["radix_onesweep"] > before
            if kind == "linear":
                with pytest.raises(KeyError):
                    t.loc[[20_001]]
        outs += [_shard_dump(eager), _shard_dump(built)]
    for a in outs[1:]:
        _dumps_equal(outs[0], a)


def test_key_order_emit_and_pushdown_on_card_match_cpu(dev):
    """The key-order join emit and the fused join-sum at 1M rows a side on
    the card against their plain versions on the CPU: the same rows in the
    same order, the same groups, sums within float32 tolerance; their merged
    sort goes through K1 (its launch counters advance)."""
    from cylon_tpu_torch.ops import join as tjoin

    rng = np.random.default_rng(21)
    n = 1 << 20
    lk = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    rk = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    lv = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    rv = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    outs = []
    for d in (dev, torch.device("cpu")):
        before = dict(cuda_radix.LAUNCHES)
        l_cols = [(lk.to(d), None), (lv.to(d), None)]
        r_cols = [(rk.to(d), None), (rv.to(d), None)]
        probe = tjoin.spec_probe(l_cols[:1], r_cols[:1], r_cols, tjoin.LEFT, emit_key_order=True)
        total = int(probe["total"])
        emitted = tjoin.spec_emit(probe, l_cols, r_cols, tjoin.LEFT, total)
        fused = tjoin.join_sum_by_key_pushdown([(lk.to(d), None)], [(rk.to(d), None)],
                                               (lv.to(d), valid.to(d)))
        if d.type == "cuda":
            assert cuda_radix.LAUNCHES["radix_onesweep"] > before["radix_onesweep"]
            assert cuda_radix.LAUNCHES["radix_lane_hist"] >= before["radix_lane_hist"] + 3
        outs.append((total, [(x.cpu(), None if v is None else v.cpu()) for x, v in emitted],
                     [x.cpu() for x in fused]))
    (tg, eg, fg), (tc, ec, fc) = outs
    assert tg == tc
    for (xg, vg), (xc, vc) in zip(eg, ec):
        assert torch.equal(xg, xc) and ((vg is None and vc is None) or torch.equal(vg, vc))
    ng = int(fg[1])
    assert ng == int(fc[1]) and int(fg[2]) == int(fc[2])
    torch.testing.assert_close(fg[0][:ng], fc[0][:ng], rtol=1e-5, atol=1e-4)
    assert torch.equal(fg[3][:ng], fc[3][:ng]) and torch.equal(fg[4][:ng], fc[4][:ng])


@pytest.mark.parametrize("world", [1, 4])
def test_lazy_plans_on_card_match_cpu(dev, world):
    """The lazy q3, its filtered form and the two-aggregate form on the
    card against the CPU, shard by shard."""
    rng = np.random.default_rng(22)
    n = 200_000
    left = {"k": rng.integers(0, n, n).astype(np.int32), "v": rng.normal(size=n).astype(np.float32)}
    right = {"rk": rng.integers(0, n, n).astype(np.int32), "w": rng.normal(size=n).astype(np.float32)}
    outs = []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=world))
        a, b = ctt.Table.from_pydict(ctx, left).lazy(), ctt.Table.from_pydict(ctx, right).lazy()
        j = a.join(b, left_on="k", right_on="rk")
        res = [j.groupby("k", {"v": "sum"}).collect(),
               j.filter(ctt.col("w") > 0.0).groupby("k", {"v": "sum"}).collect(),
               j.groupby("k", {"v": ["sum", "mean"]}).collect()]
        outs.append([_shard_dump(t) for t in res])
    for (cg, sg), (cc, sc) in zip(*outs):
        np.testing.assert_array_equal(cg, cc)
        for xg, xc in zip(sg, sc):
            np.testing.assert_array_equal(xg["k"][0], xc["k"][0])
            for c in xg:
                if c != "k":
                    np.testing.assert_allclose(xg[c][0], xc[c][0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("world", [1, 4])
def test_served_queries_on_card_match_cpu(dev, world):
    """Eight threads submit a q3 binding each through ``collect_async`` to
    the card context's paused scheduler, which then runs them as one
    stacked batch (its worker thread launches the kernels and records the
    events ``result()`` waits on): every result equals the CPU's serial
    collect of its binding, rows and exact integer-valued sums. No batch
    fell back to singles and no query failed: the fallback would give the
    same results, so only the counters show it."""
    from concurrent.futures import ThreadPoolExecutor

    from cylon_tpu_torch import serve
    from cylon_tpu_torch.utils import tracing

    rng = np.random.default_rng(33)
    bindings = []
    for i in range(8):
        n = 20_000 + 1000 * i
        bindings.append(({"k": rng.integers(0, 5000, n).astype(np.int32),
                          "v": rng.integers(-50, 50, n).astype(np.float32)},
                         {"rk": rng.integers(0, 5000, n).astype(np.int32),
                          "w": rng.integers(-50, 50, n).astype(np.float32)}))

    def plans(device):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=world))
        return [ctt.Table.from_pydict(ctx, a).lazy().join(
            ctt.Table.from_pydict(ctx, b).lazy(), left_on="k", right_on="rk")
            .groupby("k", {"v": "sum"}) for a, b in bindings]

    def frame(t):
        return t.to_pandas().sort_values("k").reset_index(drop=True)

    def executed():
        return ({c: tracing.get_count(c) for c in ("serve.batches", "serve.singles",
                                                   "serve.batch_fallback", "serve.errors")},
                int(tracing.get_trace_report().get("serve.batches", {}).get("rows", 0)))

    want = [frame(p.collect()) for p in plans("cpu")]
    card = plans(dev)
    sched = serve.scheduler(card[0]._ctx)
    (c0, r0) = executed()
    sched.pause()
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            futs = list(ex.map(lambda p: p.collect_async(), card))
    finally:
        sched.resume()
    with ThreadPoolExecutor(max_workers=8) as ex:
        got = list(ex.map(lambda f: frame(f.result(timeout=300)), futs))
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)
    (c1, r1) = executed()
    assert {c: c1[c] - c0[c] for c in c0} == {"serve.batches": 1, "serve.singles": 0,
                                              "serve.batch_fallback": 0, "serve.errors": 0}
    assert r1 - r0 == 8


def test_served_query_waits_for_inputs_built_on_a_side_stream(dev):
    """A caller uploads its tables on a side stream queued behind a long
    kernel and submits from under that stream: the scheduler's worker
    orders its own stream after the event ``submit`` recorded there, so
    it reads the uploaded inputs and the result equals the CPU's."""
    rng = np.random.default_rng(34)
    n = 300_000
    a = {"k": rng.integers(0, 50_000, n).astype(np.int32),
         "v": rng.integers(-50, 50, n).astype(np.float32)}
    b = {"rk": rng.integers(0, 50_000, n).astype(np.int32),
         "w": rng.integers(-50, 50, n).astype(np.float32)}

    def plan(device):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device))
        return (ctt.Table.from_pydict(ctx, a).lazy()
                .join(ctt.Table.from_pydict(ctx, b).lazy(), left_on="k", right_on="rk")
                .groupby("k", {"v": "sum"}))

    def frame(t):
        return t.to_pandas().sort_values("k").reset_index(drop=True)

    want = frame(plan("cpu").collect())
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(500_000_000)  # a few hundred ms of the card's clock
        fut = plan(dev).collect_async()
    pd.testing.assert_frame_equal(frame(fut.result(timeout=300)), want)


@pytest.mark.parametrize("cap", [4097, 70_001])
def test_pack_hist_pid_mode_on_semi_filter_sentinels(dev, cap):
    """B2a in pid mode on the lane the semi filter gives it: a real key
    sketch of the other side (built and probed on the card, its words equal
    to the CPU's), the hash partition id where a row may match and the
    sentinel P where the sketch prunes it, against the plain version."""
    from cylon_tpu_torch.ops import sketch

    rng = np.random.default_rng(cap)
    P, bits = 4, 1 << 15
    keys = torch.from_numpy(rng.permutation(2 * cap)[:cap].astype(np.int32))
    other = torch.from_numpy(rng.choice(keys.numpy(), cap // 10).astype(np.int32))
    sk = sketch.build_local([(other.to(dev), None)], bits, True)
    sk_cpu = sketch.build_local([(other, None)], bits, True)
    assert torch.equal(sk.cpu(), sk_cpu)
    ok = sketch.probe([(keys.to(dev), None)], sk, True)
    assert torch.equal(ok.cpu(), sketch.probe([(keys, None)], sk_cpu, True))
    assert 0 < int(ok.sum()) < cap
    words, valids, hv = cuda_codec.key_words([(keys.to(dev), None)])
    lane, _hist = cuda_codec.pack_hist(words, valids, hv, cap, P)
    pid_f = torch.where(ok, lane, torch.full_like(lane, P))
    got_l, got_h = cuda_codec.pack_hist(None, None, (), cap, P, pid=pid_f)
    want_l, want_h = cuda_codec.pack_hist_plain(None, None, (), cap, P, pid=pid_f.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got_l.cpu(), want_l) and torch.equal(got_h.cpu(), want_h)
    assert int(got_h.sum()) == int(ok.sum())


@pytest.mark.parametrize("n", [70_001, 2**22 + 7])
def test_radix_on_a_fused_uint64_word_matches_plain(dev, n):
    """K1 on the one uint64 sort word of lane_pack_bench's 12/16/20-bit
    keys (a null flag and a descending key among them), over the word's
    live bits, against its plain version and the unfused lexsort."""
    from cylon_tpu_torch.ops import sort as tsort
    from cylon_tpu_torch.ops import stats

    rng = np.random.default_rng(n)
    cols = [torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)) for hi in (4000, 60000, 10**6)]
    valid = torch.from_numpy(rng.random(n) > 0.1)
    key_cols = [(cols[0], None), (cols[1], valid), (cols[2], None)]
    asc = [True, True, False]
    specs = [(stats.enc_class(c.dtype), stats.field_bits(stats.fold_stat_words(
        stats.stat_words((c, None)).numpy()[None], "i32")), v is not None, a)
        for (c, v), a in zip(key_cols, asc)]
    fuse = tsort.plan_lane_fusion(specs, pad_bits=2, prefix_bits=0, allow64=True)
    assert fuse.allow64 and fuse.n_words == 1
    (word,) = tsort.fused_key_words(fuse, [(c.to(dev), None if v is None else v.to(dev))
                                           for c, v in key_cols])
    (word_cpu,) = tsort.fused_key_words(fuse, key_cols)
    assert word.dtype == torch.int64 and torch.equal(word.cpu(), word_cpu)
    (_, lo, hi), = radix.fuse_word_hints(fuse)
    got_k, got_p = cuda_radix.radix_sort_lane(word, None, lo, hi)
    torch.cuda.synchronize()
    want_k, want_p = cuda_radix.radix_sort_lane_plain(word_cpu, None, lo, hi)
    assert torch.equal(got_k.cpu(), want_k) and torch.equal(got_p.cpu(), want_p)
    plain, _ = tsort.lexsort_rows_payload(key_cols, n, ascending=asc)
    assert torch.equal(got_p.cpu(), plain)


@pytest.mark.parametrize("world", [1, 4])
def test_shuffle_tiers_on_card_match_cpu(dev, world):
    """The semi-filtered join (10% selectivity), the wire-narrowed groupby
    shuffle and the fused multi-key sort on the card against the CPU, shard
    by shard, with the same gates taken."""
    from cylon_tpu_torch.utils import tracing

    rng = np.random.default_rng(31)
    n = 200_000
    lk = rng.permutation(n).astype(np.int32)
    rk = np.concatenate([rng.choice(lk, n // 10, replace=False), np.arange(n, 2 * n - n // 10)])
    left = {"k": lk, "g": rng.integers(0, 4000, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.permutation(rk).astype(np.int32), "w": rng.normal(size=n).astype(np.float32)}
    outs, gates = [], []
    for device in (dev, "cpu"):
        tracing.reset_trace()
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=world))
        tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
        j = tl.distributed_join(tr, on="k")
        res = [j, tl.distributed_groupby(["g"], {"k": "count"}), tl.sort(["g", "k"], [True, False])]
        outs.append([_shard_dump(t) for t in res])
        gates.append({k: v["count"] for p in ("shuffle.semi_filter.", "lane_pack.")
                      for k, v in tracing.report(p).items()})
    for a, b in zip(*outs):
        _dumps_equal(a, b)
    assert gates[0] == gates[1] and gates[0]["lane_pack.sort_fused"] == 1
    if world > 1:
        assert gates[0]["shuffle.semi_filter.applied"] == 2 and gates[0]["lane_pack.wire.applied"] >= 1


@pytest.mark.parametrize("P,bc", [(4, 64), (4, 4096), (3, 4097)])
def test_codec_kernels_on_a_quantized_plan_match_plain(dev, P, bc):
    """B2b's slots and B3's compact on a quantized plan's round buffers
    (q8 scale rows in the headers, each row's scales as extra lanes)."""
    from cylon_tpu_torch.ops import gather, quant
    from cylon_tpu_torch.parallel import shuffle as sh

    rng = np.random.default_rng(5)
    n = 3 * bc + 17
    cols = [(torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)), None),
            (torch.from_numpy(rng.normal(size=n).astype(np.float32)), None),
            (torch.from_numpy(rng.normal(size=n)), None)]
    spec = quant.quant_spec([d.dtype for d, _v in cols], (0,), 1e-2)
    wplan = gather.static_wire_plan(cols, quant=spec)
    assert gather.wire_q8_cols(wplan) and sh.wire_header_rows(wplan) >= 1
    nh = sh.wire_header_rows(wplan)
    outs = []
    for device in (dev, "cpu"):
        c = [(d.to(device), v) for d, v in cols]
        lane, hist = cuda_codec.pack_hist(*cuda_codec.key_words(c[:1]), n, P)
        base, cnt = cuda_codec.scan_tiles(hist), hist.sum(1, dtype=torch.int32)
        per_round = []
        for r in range(2):
            dest = cuda_codec.pack_dest(lane, base, r, P, bc)
            packed, hx = sh.round_send(c, wplan, None, dest, P, bc)
            buf = sh.pack_lane_buffer(packed, dest, sh.round_counts(cnt, bc, r), P, bc,
                                      header_extra=hx, n_header=nh)
            move = sh.with_scale_lanes(buf, wplan, P, nh)
            recv = sh.header_counts(move, P)
            moved = cuda_codec.compact_move(move, recv, P, bc, n_header=nh)
            per_round.append([x.cpu() for x in (dest, buf, moved)])
        outs.append(per_round)
    for ra, rb in zip(*outs):
        for a, b in zip(ra, rb):
            assert torch.equal(a, b)
    # and the card's compact against its own plain version on the card
    assert torch.equal(cuda_codec.compact_move(move.to(dev), recv.to(dev), P, bc, nh).cpu(),
                       cuda_codec.compact_move_plain(move.to(dev), recv.to(dev), P, bc, nh).cpu())


@pytest.mark.parametrize("how", ["inner", "outer"])
@pytest.mark.parametrize("quant_tol", ["", "0.01"])
def test_fused_join_world4_on_card_matches_cpu(dev, how, quant_tol):
    """distributed_join(mode="fused") at world 4 on the card against the
    CPU, shard by shard, exact and under the quantized wire, in two hash
    slices; one host read each."""
    from cylon_tpu_torch.utils import tracing

    rng = np.random.default_rng(9)
    n = 60_000
    left = {"k": rng.integers(0, n, n).astype(np.int32), "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int32), "w": rng.normal(size=n)}
    outs = []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=4))
        ctx.add_config("quant_tol", quant_tol)
        tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
        tracing.reset_trace()
        res = [tl.distributed_join(tr, on="k", how=how, mode="fused"),
               tl.distributed_join(tr, on="k", how=how, mode="fused", num_slices=2)]
        assert tracing.get_count("host_sync") == 2
        outs.append([_shard_dump(t) for t in res])
    for a, b in zip(*outs):
        _dumps_equal(a, b)


@pytest.mark.parametrize("tier", ["0", "1", "2"])
@pytest.mark.parametrize("quant_tol", ["", "0.01"])
def test_skew_relay_and_spill_tiers_on_card_match_cpu(dev, tmp_path, monkeypatch, tier, quant_tol):
    """A one-hot shuffle and a skewed join at world 8 (the skew split
    relays each hot tail through the host: pinned buffers on a side
    stream), at several rounds, staged through each spill tier, on the
    card against the CPU, shard by shard, with the same counters; a
    quantized relay (float64 payload, q8) too."""
    from cylon_tpu_torch.parallel import spill
    from cylon_tpu_torch.utils import tracing

    monkeypatch.setenv("CYLON_TPU_TORCH_SPILL_TIER", tier)
    monkeypatch.setenv("CYLON_TPU_TORCH_SPILL_DIR", str(tmp_path))
    rng = np.random.default_rng(12)
    n = 200_000
    one_hot = {"k": np.zeros(n, np.int32), "v": np.arange(n, dtype=np.float32)}
    k = np.where(rng.random(n) < 0.5, 3, rng.integers(0, 5000, n)).astype(np.int32)
    left = {"k": k, "v": rng.normal(size=n)}
    right = {"k": rng.integers(0, 5000, 3000).astype(np.int32), "w": rng.normal(size=3000)}
    outs, counts = [], []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=8))
        ctx.add_config("quant_tol", quant_tol)
        ctx.add_config("shuffle_byte_budget", str(8 * 4096 * 8))
        tracing.reset_trace()
        t = ctt.Table.from_pydict(ctx, one_hot)
        tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
        res = [t.shuffle(["k"]), tl.distributed_join(tr, on="k")]
        outs.append([_shard_dump(x) for x in res])
        counts.append({k: (v["count"], v["rows"]) for k, v in tracing.report("shuffle.").items()
                       if k in ("shuffle.skew_split", "shuffle.spill.relay_bytes", "shuffle.rounds",
                                "shuffle.spill.staged_rounds", "shuffle.quant.relay_bytes_saved")})
    for a, b in zip(*outs):
        _dumps_equal(a, b)
    assert counts[0] == counts[1] and counts[0]["shuffle.skew_split"][0] == 2
    assert ("shuffle.spill.staged_rounds" in counts[0]) == (tier != "0")
    assert ("shuffle.quant.relay_bytes_saved" in counts[0]) == (quant_tol != "")
    assert spill.arena_bytes()[0] == 0


def test_relay_send_slots_on_card_match_cpu(dev):
    """The relay slots over B2a's lane and B2b's bases on the card equal
    the CPU's, past several tiles."""
    from cylon_tpu_torch.parallel import shuffle as sh

    rng = np.random.default_rng(4)
    n, P = 300_001, 8
    pid = torch.from_numpy(np.where(rng.random(n) < 0.6, 2, rng.integers(0, P, n)).astype(np.int32))
    got = []
    for device in (dev, "cpu"):
        lane, hist = cuda_codec.pack_hist(None, None, (), n, P, pid=pid.to(device))
        cnt = hist.sum(1).cpu().numpy()
        relay = np.maximum(cnt - 1000, 0)
        got.append(sh.relay_send_slots(lane, cuda_codec.scan_tiles(hist), relay, 1000,
                                       int(relay.sum())).cpu())
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("mesh,world", [("4x2", 8), ("2x4", 8), ("2x2", 4)])
def test_two_hop_compact_parts_match_plain(dev, mesh, world):
    """B3 on both parts of a two-hop round against its plain version: the
    same-group rows ``[inner x bucket_cap]`` with their hop-1 counts (a
    strided view into the hop-1 headers) and no header, and the combined
    cross-outer chunks ``[outer x (cap_o + 1)]`` with their header counts;
    also a part whose counts are all 0 and one past a 16-byte line."""
    from cylon_tpu_torch.parallel import shuffle as sh
    from cylon_tpu_torch.parallel import topo

    t = topo.parse_mesh(mesh, world)
    rng = np.random.default_rng(world + t.inner)
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=dev, world_size=world))
    for lm, bc in ((2, 64), (3, 1000)):
        m = rng.integers(0, bc + 1, (world, world))
        m[0] = 0  # shard 0 sends nothing: its self part's counts are 0
        tp = topo.plan_two_hop(m, t, bc, 1, 1)
        bufs = []
        for s in range(world):
            buf = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (world * (bc + 1), lm))
                                   .astype(np.int32)).to(dev)
            buf.view(world, bc + 1, lm)[:, 0, 0] = torch.from_numpy(m[s].astype(np.int32)).to(dev)
            bufs.append(buf)
        parts = topo.two_hop_exchange(ctx.comm, bufs, range(world), t, bc, tp.cap_o, 1)
        n_self, n_cross = topo.round_split(m, t, bc, 0)
        for d, (g2, self_rows, self_cnt) in enumerate(parts):
            recv2 = sh.header_counts(g2, t.outer)
            for move, cnt, P, cap, nh in ((self_rows, self_cnt, t.inner, bc, 0),
                                          (g2, recv2, t.outer, tp.cap_o, 1)):
                got = cuda_codec.compact_move(move, cnt, P, cap, nh)
                torch.cuda.synchronize()
                want = cuda_codec.compact_move_plain(move.cpu(), cnt.cpu(), P, cap, nh)
                assert torch.equal(got.cpu(), want), (mesh, d, P, cap)
            assert int(self_cnt.sum()) == n_self[d] and int(recv2.sum()) == n_cross[d]


@pytest.mark.parametrize("mesh,world", [("4x2", 8), ("2x4", 8), ("2x2", 4)])
def test_two_hop_ops_on_card_match_cpu(dev, mesh, world):
    """A shuffle, a one-hot shuffle (its same-group relay tail on the ring
    at world 8), a join and the fused join under a 2-D mesh on the card
    against the CPU, shard by shard, with the same per-axis counters."""
    from cylon_tpu_torch.utils import tracing

    rng = np.random.default_rng(13)
    n = 100_000
    left = {"k": rng.integers(0, 5000, n).astype(np.int32), "v": rng.normal(size=n)}
    right = {"k": rng.integers(0, 5000, 4000).astype(np.int32),
             "w": rng.normal(size=4000).astype(np.float32)}
    hot = {"k": np.zeros(n, np.int32), "v": np.arange(n, dtype=np.float32)}
    names = ("shuffle.coll_bytes.intra", "shuffle.coll_bytes.inter", "shuffle.coll_bytes.inter_alt",
             "shuffle.relay.ring_rows", "shuffle.exchanged_bytes", "shuffle.rounds")
    outs, counts = [], []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(
            ctt.GPUConfig(device=device, world_size=world, mesh_shape=mesh))
        tracing.reset_trace()
        tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
        res = [tl.shuffle(["k"]), ctt.Table.from_pydict(ctx, hot).shuffle(["k"]),
               tl.distributed_join(tr, on="k"), tl.distributed_join(tr, on="k", mode="fused")]
        outs.append([_shard_dump(x) for x in res])
        counts.append({k: (v["count"], v["rows"]) for k, v in tracing.report("shuffle.").items()
                       if k in names})
    for a, b in zip(*outs):
        _dumps_equal(a, b)
    assert counts[0] == counts[1]
    assert ("shuffle.relay.ring_rows" in counts[0]) == (world == 8)


@pytest.mark.parametrize("world,tier", [(1, ""), (4, ""), (4, "2")])
def test_out_of_core_layers_on_card_match_cpu(dev, tmp_path, monkeypatch, world, tier):
    """The task shuffle (T = 3W), the streaming join graph and the
    out-of-core join (8 buckets, chunks of 20,000 rows; its results leave
    the card on the drain thread through a side stream after each join's
    event) on the card against the CPU: each task's table and the graph's
    result shard by shard, the join's rows in order, the same spill
    counters; tier 2 puts the arenas on disk and closes them all."""
    from cylon_tpu_torch.parallel import LogicalTaskPlan, dag, spill
    from cylon_tpu_torch.parallel.ooc import OutOfCoreJoin
    from cylon_tpu_torch.utils import tracing

    monkeypatch.setenv("CYLON_TPU_TORCH_SPILL_TIER", tier)
    monkeypatch.setenv("CYLON_TPU_TORCH_SPILL_DIR", str(tmp_path))
    rng = np.random.default_rng(14)
    n = 120_000
    left = {"k": rng.integers(0, 2 * n, n).astype(np.int32), "v": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.integers(0, 2 * n, n // 2).astype(np.int32),
             "w": rng.normal(size=n // 2).astype(np.float32)}

    def chunks(cols):
        m = len(cols["k"])
        for lo in range(0, m, 20_000):
            yield {c: v[lo:lo + 20_000] for c, v in cols.items()}

    outs, counts = [], []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=world))
        tracing.reset_trace()
        tl, tr = ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right)
        parts = tl.task_partition(["k"], LogicalTaskPlan(3 * world, world))
        graph = dag.DisJoinOp(on="k").execute([tl, tl], [tr])
        sink = OutOfCoreJoin(ctx, on="k", num_buckets=8).execute(chunks(left), chunks(right))
        rows = sink.result_pydict()
        outs.append(([_shard_dump(p) for _t, p in sorted(parts.items())], _shard_dump(graph),
                     sink.rows, {c: v.copy() for c, v in rows.items()}))
        sink.close()
        counts.append({k: (v["count"], v["rows"]) for k, v in tracing.report("shuffle.").items()
                       if k.startswith(("shuffle.spill.", "shuffle.rounds"))
                       and k not in ("shuffle.spill.ooc_ingest", "shuffle.spill.ooc_join",
                                     "shuffle.spill.stage", "shuffle.spill.host_bytes",
                                     "shuffle.spill.disk_bytes", "shuffle.spill.peak_device_bytes")})
    for a, b in zip(outs[0][0], outs[1][0]):
        _dumps_equal(a, b)
    _dumps_equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] == len(pd.DataFrame(left).merge(pd.DataFrame(right), on="k"))
    for c in outs[1][3]:
        np.testing.assert_array_equal(outs[0][3][c], outs[1][3][c])
    assert counts[0] == counts[1] and counts[0]["shuffle.spill.ooc_joins"][0] == 1
    assert spill.arena_bytes()[0] == 0 and not list(tmp_path.iterdir())


def test_stage_to_sink_waits_for_its_event(dev):
    """The drain path's copy: a table whose columns a long kernel is still
    writing on the current stream, staged from another thread on a side
    stream that waits for the event recorded after that kernel, comes
    back with the kernel's values, not the ones before it."""
    import threading

    from cylon_tpu_torch.parallel import spill

    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=dev))
    n = 1 << 22
    t = ctt.Table.from_pydict(ctx, {"x": np.zeros(n, np.float32)})
    x = t._shards[0]["x"].data
    torch.cuda._sleep(200_000_000)  # about 0.1 s of card time ahead of the write
    x.add_(1.0)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))

    class Sink:
        got = None

        def accept(self, table, shard_cols, counts):
            Sink.got = shard_cols[0][0][0].copy()

    th = threading.Thread(target=spill.stage_to_sink, args=(Sink(), t, t.row_counts),
                          kwargs={"after": {x.device: ev}})
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert Sink.got is not None and (Sink.got == 1.0).all()


@pytest.mark.parametrize("world,layout", [(1, "one"), (4, "one"), (4, "per_shard")])
def test_csv_io_on_card_matches_cpu(dev, tmp_path, world, layout):
    """write_csv of a table on the card (int64, float64 with nulls, a
    string column) gives the CPU's bytes; read_csv onto the card (one path
    split evenly, or one file a shard) gives the CPU's shards; the join ->
    groupby (max, min) over the read tables equals the CPU's shard for
    shard."""
    rng = np.random.default_rng(15)
    n = 50_000
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    cols = {"k": rng.integers(0, n, n), "x": x, "s": rng.choice(["a", "b,c", "d"], n)}
    right = {"k": rng.integers(0, n, n // 2), "w": rng.normal(size=n // 2)}
    outs = []
    for device in (dev, "cpu"):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=world))
        tag = "card" if device != "cpu" else "cpu"
        paths = {}
        for side, data in (("l", cols), ("r", right)):
            t = ctt.Table.from_pydict(ctx, data)
            if layout == "one":
                paths[side] = str(tmp_path / f"{tag}_{side}.csv")
            else:
                paths[side] = [str(tmp_path / f"{tag}_{side}{s}.csv") for s in range(world)]
            ctt.write_csv(t, paths[side])
        tl, tr = ctt.read_csv(ctx, paths["l"]), ctt.read_csv(ctx, paths["r"])
        assert tl._ref["k"].data.device.type == torch.device(device).type
        # min and max: exact whatever order the card adds in
        g = tl.distributed_join(tr, on="k").distributed_groupby("k_x", {"x": "max", "w": "min"})
        files = paths["l"] if layout == "per_shard" else [paths["l"]]
        outs.append(([open(p, "rb").read() for p in files], _shard_dump(tl), _shard_dump(g)))
    assert outs[0][0] == outs[1][0]
    _dumps_equal(outs[0][1], outs[1][1])
    _dumps_equal(outs[0][2], outs[1][2])


def test_capi_client_on_card_matches_the_python_api(dev, tmp_path):
    """The C ABI's client (native/examples/capi_client.c) with no
    CYLON_TPU_TORCH_PLATFORM, so on cuda:0: read -> distributed_join ->
    distributed_sort -> project -> write_csv equals the same calls through
    the Python API on the card, byte for byte."""
    import os
    import shutil
    import subprocess
    import sys
    import sysconfig

    from cylon_tpu_torch import native

    if shutil.which("gcc") is None:
        pytest.skip("no gcc")
    so = native.build_capi()
    exe = str(tmp_path / "capi_client")
    subprocess.run(["gcc", "-O2", str(native.HERE / "examples" / "capi_client.c"), "-o", exe,
                    "-ldl"], check=True, timeout=120)
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=dev))
    rng = np.random.default_rng(16)
    lp, rp, out = (str(tmp_path / f) for f in ("l.csv", "r.csv", "out.csv"))
    ctt.write_csv(ctt.Table.from_pydict(ctx, {"k": rng.integers(0, 5000, 20_000),
                                               "x": rng.normal(size=20_000)}), lp)
    ctt.write_csv(ctt.Table.from_pydict(ctx, {"k": rng.integers(0, 5000, 10_000),
                                               "y": rng.normal(size=10_000)}), rp)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in sys.path if p]),
               LD_LIBRARY_PATH=sysconfig.get_config_var("LIBDIR") or "")
    env.pop("CYLON_TPU_TORCH_PLATFORM", None)
    res = subprocess.run([exe, so, lp, rp, out], capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    want = (ctt.read_csv(ctx, lp).distributed_join(ctt.read_csv(ctx, rp), on="k")
            .distributed_sort("k_x").project(["k_x", "x", "y"]))
    ctt.write_csv(want, str(tmp_path / "want.csv"))
    assert f"rows={want.row_count} cols=3" in res.stdout
    assert open(out, "rb").read() == (tmp_path / "want.csv").read_bytes()


def test_traced_join_times_spans_with_events_and_reads_no_more(dev, monkeypatch):
    """A traced and profiled world-4 join -> groupby on the card: every
    span and the shuffle's stage profile carry completed CUDA events (read
    at export), the host_sync count equals the untraced call's, and the
    outputs are equal but for the float sums' add order."""
    from cylon_tpu_torch.obs import export, prof, trace
    from cylon_tpu_torch.utils import tracing

    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=str(dev), world_size=4))
    rng = np.random.default_rng(12)
    a = ctt.Table.from_pydict(ctx, {"k": rng.integers(0, 5000, 20000).astype(np.int32),
                                    "v": rng.normal(size=20000).astype(np.float32)})
    b = ctt.Table.from_pydict(ctx, {"k": rng.integers(0, 5000, 20000).astype(np.int32),
                                    "w": rng.normal(size=20000).astype(np.float32)})

    def call():
        return a.distributed_join(b, on="k").distributed_groupby("k_x", {"w": "count"})

    call()
    before = tracing.get_count("host_sync")
    want = call()
    untraced = tracing.get_count("host_sync") - before
    monkeypatch.setenv("CYLON_TPU_TORCH_PROF", "1")
    prof.reset()
    before = tracing.get_count("host_sync")
    with trace.query_trace("join", force=True) as q:
        got = call()
    assert tracing.get_count("host_sync") - before == untraced > 0
    spans = list(q.all_spans())
    assert spans and all(sp.device_ms(wait=True) is not None for sp in spans)
    profs = q.attrs[prof.PROF_ATTR]
    assert profs and all(p.on_device() and p.seconds(wait=True) for p in profs)
    doc = export.chrome_doc([q])
    assert export.validate_chrome(doc) == []
    assert all("device_ms" in e["args"] for e in doc["traceEvents"]
               if e["ph"] == "X" and e.get("cat") == "span")
    for s in range(4):
        for c in want.column_names:
            assert torch.equal(got._shards[s][c].data, want._shards[s][c].data), c


@pytest.mark.parametrize("world", [1, 4])
def test_stream_q3_view_on_card_matches_cpu(dev, world):
    """A q3 view (stream/: an appendable left side joined to an appendable
    right side, summed by key through the pushdown) refreshed after appends
    to the left, to the right and to both: every refresh on the card equals
    the same sequence on the CPU (integer-valued float32 sums, so exactly),
    the dL join R_cur term at world 4 among them, and the card's refreshes
    launch K1 (and the codec at world 4)."""
    def run(device):
        ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device=device, world_size=world))
        rng = np.random.default_rng(18)

        def side(n, key, val):
            return {key: rng.integers(0, 300, n).astype(np.int32),
                    val: rng.integers(-50, 50, n).astype(np.float32)}

        left = ctt.AppendableTable(ctx, side(40_000, "k", "v"))
        right = ctt.AppendableTable(ctx, side(5_000, "rk", "w"))
        view = ctt.stream.view(lambda a, b: a.lazy().join(b.lazy(), left_on="k", right_on="rk")
                               .groupby("k", {"v": "sum"}), left, right)
        outs = [view.refresh().to_pydict()]
        for step in ("left", "right", "both"):
            if step in ("left", "both"):
                left.append(side(400, "k", "v"))
            if step in ("right", "both"):
                right.append(side(50, "rk", "w"))
            outs.append(view.refresh().to_pydict())
        assert view.stats == {"noop": 0, "full": 1, "fallback": 0, "inc": 3}
        return outs

    for d in (cuda_radix.LAUNCHES, cuda_codec.LAUNCHES):
        for k in d:
            d[k] = 0
    got = run(str(dev))
    assert cuda_radix.LAUNCHES["radix_lane_hist"] > 0 and cuda_radix.LAUNCHES["radix_onesweep"] > 0
    if world > 1:
        assert all(cuda_codec.LAUNCHES[k] > 0 for k in cuda_codec.LAUNCHES)
    want = run("cpu")
    for g, w in zip(got, want):
        og, ow = np.argsort(g["k"], kind="stable"), np.argsort(w["k"], kind="stable")
        for c in ("k", "v_sum"):
            assert g[c].dtype == w[c].dtype
            np.testing.assert_array_equal(g[c][og], w[c][ow])
