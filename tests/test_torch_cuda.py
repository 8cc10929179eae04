"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
built with nvcc on first use); without one they skip. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

import cylon_tpu_torch as ctt
from cylon_tpu_torch.ops import cuda_codec, cuda_gather, cuda_radix

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 4095, 4096, 70_001])
@pytest.mark.parametrize("wide", [False, True])
def test_radix_kernels_match_plain(dev, n, wide):
    g = torch.Generator(device="cpu").manual_seed(n)
    dt = torch.int64 if wide else torch.int32
    info = torch.iinfo(dt)
    enc = torch.randint(info.min, info.max, (n,), dtype=dt, generator=g).to(dev)
    perm = torch.randperm(n, generator=g).to(torch.int32).to(dev)
    width = 8 * enc.element_size()
    for shift, bits in [(s, 8) for s in range(0, width, 8)] + [(width - 3, 3), (5, 8)]:
        hist = cuda_radix.radix_hist(enc, perm, shift, bits)
        assert torch.equal(hist, cuda_radix.radix_hist_plain(enc, perm, shift, bits))
        offs = cuda_radix.scan_offsets(hist)
        got = cuda_radix.radix_scatter(enc, perm, offs, shift, bits)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_radix.radix_scatter_plain(enc, perm, offs, shift, bits))
        assert torch.equal(got, cuda_radix.radix_pass_plain(enc, perm, shift, bits))


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
    x[:4] = torch.tensor([0.0, -0.0, float("nan"), float("inf")], dtype=torch.float64)
    return [(k.to(device), valid.to(device)), (x.to(device), None)]


@pytest.mark.parametrize("P", [3, 4, 8])
@pytest.mark.parametrize("wide", [False, True])
def test_pack_kernels_match_plain(dev, P, wide):
    """B2a and B2b (hash mode: 32- or 64-bit key words, nulls, a float64
    key; pid-input mode with out-of-range pids) against their plain
    versions, over several rounds and with rows past n."""
    rng = np.random.default_rng(P + 10 * wide)
    cap, n = 70_001, 69_000
    words, valids, hv = cuda_codec.key_words(_key_cols(rng, cap, wide, dev))
    lane, hist = cuda_codec.pack_hist(words, valids, hv, n, P)
    lane_p, hist_p = cuda_codec.pack_hist_plain(words.cpu(), valids.cpu(), hv, n, P)
    torch.cuda.synchronize()
    assert torch.equal(lane.cpu(), lane_p) and torch.equal(hist.cpu(), hist_p)
    bc = max(8, (n // P) // 3)
    for r in range(5):
        dest = cuda_codec.pack_dest(lane, cuda_codec.scan_tiles(hist), r, P, bc)
        torch.cuda.synchronize()
        assert torch.equal(dest.cpu(), cuda_codec.pack_dest_plain(lane_p, None, r, P, bc)), r
        d2, c2 = cuda_codec.fused_pack_dest(words, valids, hv, n, r, P, bc)
        d3, c3 = cuda_codec.fused_pack_dest_plain(words.cpu(), valids.cpu(), hv, n, r, P, bc)
        assert torch.equal(d2.cpu(), d3) and torch.equal(c2.cpu(), c3)
    pid = torch.from_numpy(rng.integers(-1, P + 2, cap).astype(np.int32)).to(dev)
    lane, hist = cuda_codec.pack_hist(None, None, (), n, P, pid=pid)
    lane_p, hist_p = cuda_codec.pack_hist_plain(None, None, (), n, P, pid=pid.cpu())
    assert torch.equal(lane.cpu(), lane_p) and torch.equal(hist.cpu(), hist_p)
    for r in range(2):
        assert torch.equal(cuda_codec.pack_dest(lane, cuda_codec.scan_tiles(hist), r, P, bc).cpu(),
                           cuda_codec.pack_dest_plain(lane_p, None, r, P, bc))


@pytest.mark.parametrize("P,bc,lm", [(8, 16, 3), (4, 5000, 1), (3, 4097, 7), (1, 64, 2)])
def test_compact_kernel_matches_plain(dev, P, bc, lm):
    rng = np.random.default_rng(bc)
    for n_header in (0, 1):
        rows = P * (bc + n_header)
        move = torch.from_numpy(
            rng.integers(-(2**31), 2**31 - 1, (rows, lm)).astype(np.int32)).to(dev)
        for counts in (rng.integers(0, bc + 1, P), np.zeros(P), np.full(P, bc),
                       rng.integers(-3, bc + 4, P)):
            rc = torch.from_numpy(np.asarray(counts, np.int32)).to(dev)
            if n_header:  # the counts read where they arrive: lane 0 of the headers
                move.view(P, bc + 1, lm)[:, 0, 0] = rc
                rc = move.view(P, bc + 1, lm)[:, 0, 0]
            got = cuda_codec.compact_move(move, rc, P, bc, n_header)
            torch.cuda.synchronize()
            want = cuda_codec.compact_move_plain(move.cpu(), rc.cpu(), P, bc, n_header)
            assert torch.equal(got.cpu(), want), (counts, n_header)


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
