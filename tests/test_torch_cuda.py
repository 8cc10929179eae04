"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
built with nvcc on first use); without one they skip. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

import cylon_tpu_torch as ctt
from cylon_tpu_torch.ops import cuda_gather, cuda_radix

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
