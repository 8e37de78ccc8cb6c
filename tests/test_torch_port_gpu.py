"""dtt_torch's CUDA kernels held against their plain PyTorch versions on a
CUDA card, at small shapes with ragged edges (``chip_smoke.py`` checks
them at the main path's shapes and end to end). Marked ``gpu``: they skip
without a card. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from dtt_torch.ops import correlation as tcorr
from dtt_torch.ops import psroi as tpsroi

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# f32 sums of the same products in another order: 1e-5 in f32; in bf16 one
# bf16 ulp of each output (2^-7 |x| + 1e-5), which a dropped block of
# channels or a wrong displacement plane exceeds many times
CORR_TOL = {torch.float32: dict(rtol=0.0, atol=1e-5),
            torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}
# the main path's 38x68 maps at d=8/s=2, and the edges of the tiling: C not
# a multiple of the 32-channel step (40) or of 8 (36, 16-byte copies
# misaligned), W under one 16-column tile, H = 1 (under 2d + 1 rows)
CORR_SHAPES = [((2, 12, 20, 64), 2, 1), ((2, 12, 20, 64), 8, 2),
               ((3, 9, 37, 40), 8, 2), ((1, 38, 68, 512), 8, 2),
               ((2, 5, 18, 40), 2, 1), ((2, 7, 21, 36), 8, 2),
               ((2, 6, 19, 36), 2, 1), ((2, 6, 11, 64), 8, 2),
               ((2, 1, 20, 48), 8, 2), ((3, 1, 9, 24), 2, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d,s", CORR_SHAPES)
def test_correlation_kernel_matches_plain(cuda, dtype, shape, d, s):
    g = torch.Generator().manual_seed(0)
    f1 = torch.randn(shape, generator=g).to(cuda, dtype)
    f2 = torch.randn(shape, generator=g).to(cuda, dtype)
    before = tcorr.correlation_cuda.launches
    got = tcorr.correlation(f1, f2, d, s)
    torch.cuda.synchronize()
    assert tcorr.correlation_cuda.launches == before + 1
    want = tcorr.correlation_plain(f1, f2, d, s)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **CORR_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_psroi_kernel_matches_plain(cuda, dtype):
    """f32 sums of the same values in another order (1e-4 on sums of up to
    ~100 values of O(1))."""
    rng = np.random.RandomState(1)
    b, h, w, k, d, n = 2, 10, 14, 7, 43, 16
    maps = torch.from_numpy(rng.randn(b, h, w, k * k * d).astype(np.float32))
    xy = rng.uniform(-20, 240, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 160, (b, n, 2))], axis=-1)
    rois[:, 0] = [0, 0, w * 16 - 1, h * 16 - 1]
    rois[:, 1] = [40.5, 23.5, 72.5, 88.5]
    maps = maps.to(cuda, dtype)
    bounds = tpsroi.roi_bounds(torch.from_numpy(rois.astype(np.float32)).to(cuda),
                               1 / 16, k, h, w)
    before = tpsroi.psroi_sums_cuda.launches
    got = tpsroi.psroi_sums(maps, *bounds)
    torch.cuda.synchronize()
    assert tpsroi.psroi_sums_cuda.launches == before + 1
    want = tpsroi.psroi_sums_plain(maps, *bounds)
    assert got.dtype == torch.float32 and got.shape == (b, n, k, k, d)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d,s", CORR_SHAPES)
def test_correlation_bwd_kernel_matches_plain(cuda, dtype, shape, d, s):
    """Both gradients, f32 sums of up to 81 products in another order:
    1e-5 in f32; bf16 outputs within one bf16 ulp (2^-7 |x| + 1e-5)."""
    g = torch.Generator().manual_seed(1)
    f1, f2 = (torch.randn(shape, generator=g).to(cuda, dtype)
              for _ in range(2))
    go = torch.randn((*shape[:3], tcorr.num_corr_channels(d, s)),
                     generator=g).to(cuda, dtype)
    before = tcorr.correlation_bwd_cuda.launches
    got = tcorr.correlation_bwd_cuda(f1, f2, go, d, s)
    torch.cuda.synchronize()
    assert tcorr.correlation_bwd_cuda.launches == before + 1
    want = tcorr.correlation_bwd_plain(f1, f2, go, d, s)
    for x, w in zip(got, want):
        assert x.dtype == dtype and x.shape == f1.shape
        torch.testing.assert_close(x.float(), w.float(), **CORR_TOL[dtype])


def test_correlation_bf16_band_limit_raises(cuda):
    """The bf16 tensor-core bodies take max_displacement <= 8: beyond it
    both wrappers raise, naming the limit, and launch nothing; float32
    maps still run."""
    f = torch.zeros(1, 4, 20, 16, device=cuda, dtype=torch.bfloat16)
    g = torch.zeros(1, 4, 20, 81, device=cuda, dtype=torch.bfloat16)
    before = (tcorr.correlation_cuda.launches,
              tcorr.correlation_bwd_cuda.launches)
    with pytest.raises(ValueError, match="max_displacement <= 8"):
        tcorr.correlation_cuda(f, f, 12, 3)
    with pytest.raises(ValueError, match="max_displacement <= 8"):
        tcorr.correlation_bwd_cuda(f, f, g, 12, 3)
    assert (tcorr.correlation_cuda.launches,
            tcorr.correlation_bwd_cuda.launches) == before
    tcorr.correlation_cuda(f.float(), f.float(), 12, 3)
    assert tcorr.correlation_cuda.launches == before[0] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_autograd_launches_both_kernels(cuda, dtype):
    """Forward and backward each launch their kernel once (in bf16 the
    tensor-core bodies), and the gradients are the backward kernel's for
    the output gradient autograd hands it."""
    g = torch.Generator().manual_seed(3)
    f1, f2 = (torch.randn(1, 6, 10, 32, generator=g).to(cuda, dtype)
              .requires_grad_() for _ in range(2))
    before = (tcorr.correlation_cuda.launches,
              tcorr.correlation_bwd_cuda.launches)
    out = tcorr.correlation(f1, f2, 2, 1)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tcorr.correlation_cuda.launches,
            tcorr.correlation_bwd_cuda.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = tcorr.correlation_bwd_plain(f1.detach(), f2.detach(),
                                       (2 * out.detach().float()).to(dtype),
                                       2, 1)
    for x, w in zip((f1.grad, f2.grad), want):
        assert x.dtype == dtype
        torch.testing.assert_close(x.float(), w.float(), **CORR_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,k,d,n", [(2, 10, 14, 7, 8, 16),
                                         (3, 9, 13, 3, 31, 70)])
def test_psroi_bwd_kernel_matches_plain(cuda, dtype, b, h, w, k, d, n):
    """The map gradient through the pool's autograd: f32 sums of ghat in
    RoI order vs the plain contraction (1e-5 in f32; bf16 outputs within
    one bf16 ulp)."""
    rng = np.random.RandomState(2)
    xy = rng.uniform(-20, w * 16, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 160, (b, n, 2))], axis=-1)
    rois[:, 0] = [0, 0, w * 16 - 1, h * 16 - 1]
    rois[:, 1] = [40.5, 23.5, 72.5, 88.5]
    rois[:, 2] = [41.5, 24.5, 41.5, 24.5]
    rois = torch.from_numpy(rois.astype(np.float32)).to(cuda)
    maps = torch.from_numpy(rng.randn(b, h, w, k * k * d).astype(
        np.float32)).to(cuda, dtype).requires_grad_()
    go = torch.from_numpy(rng.randn(b, n, k, k, d).astype(np.float32)).to(
        cuda, dtype)
    before = tpsroi.psroi_bwd_cuda.launches
    tpsroi.psroi_pool_batched_direct(maps, rois, 1 / 16, k).backward(go)
    torch.cuda.synchronize()
    assert tpsroi.psroi_bwd_cuda.launches == before + 1
    bounds = tpsroi.roi_bounds(rois, 1 / 16, k, h, w)
    area = tpsroi.bin_areas(*bounds)[..., None]
    ghat = torch.where(area > 0, go.float() / area.clamp(min=1.0), 0.0)
    want = tpsroi.psroi_bwd_plain(ghat, *bounds, h, w, dtype)
    assert maps.grad.dtype == dtype and maps.grad.shape == maps.shape
    tol = (dict(rtol=0, atol=1e-5) if dtype == torch.float32
           else dict(rtol=8e-3, atol=1e-6))
    torch.testing.assert_close(maps.grad.float(), want.float(), **tol)


@pytest.mark.parametrize("b,h,w,k,d,n", [(2, 10, 14, 7, 9, 24),
                                         (3, 9, 13, 3, 43, 70)])
def test_psroi_sat_kernel_matches_plain(cuda, b, h, w, k, d, n):
    """The SAT bin sums: four corner reads subtracted in the order the
    plain version's one-hot contractions add them, so the two agree to
    the bit on one table (TF32 off). RoIs cover the whole map, sit on .5
    coordinates, have zero-area bins and cross the map's edges."""
    rng = np.random.RandomState(3)
    xy = rng.uniform(-40, w * 16, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 200, (b, n, 2))], axis=-1)
    rois[:, 0] = [0, 0, w * 16 - 1, h * 16 - 1]
    rois[:, 1] = [40.5, 23.5, 72.5, 88.5]
    rois[:, 2] = [41.5, 24.5, 41.5, 24.5]
    rois = torch.from_numpy(rois.astype(np.float32)).to(cuda)
    maps = torch.from_numpy(rng.randn(b, h, w, k * k * d).astype(
        np.float32)).to(cuda)
    table = tpsroi.sat(maps).contiguous()
    bounds = [x.contiguous() for x in tpsroi.roi_bounds(rois, 1 / 16, k, h, w)]
    before = tpsroi.psroi_mm_sums_cuda.launches
    got = tpsroi.psroi_mm_sums(table, *bounds)
    torch.cuda.synchronize()
    assert tpsroi.psroi_mm_sums_cuda.launches == before + 1
    want = tpsroi.psroi_mm_sums_plain(table, *bounds)
    assert got.dtype == torch.float32 and got.shape == (b, n, k, k, d)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    pooled = tpsroi.psroi_pool_batched_pallas_mm(maps, rois, 1 / 16, k)
    assert tpsroi.psroi_mm_sums_cuda.launches == before + 2
    torch.testing.assert_close(
        pooled, tpsroi.psroi_pool_batched_direct(maps, rois, 1 / 16, k),
        rtol=1e-5, atol=8 * torch.finfo(torch.float32).eps
        * table.abs().max().item())


def _frame_pool_case(rng, h, w, k, d, n, dtype, cuda):
    """One frame's maps and RoIs that cover the whole map, sit on .5
    coordinates, have zero-area bins and cross the map's edges."""
    xy = rng.uniform(-40, w * 16, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 200, (n, 2))], axis=-1)
    rois[0] = [0, 0, w * 16 - 1, h * 16 - 1]
    rois[1] = [40.5, 23.5, 72.5, 88.5]
    rois[2] = [41.5, 24.5, 41.5, 24.5]
    maps = torch.from_numpy(rng.randn(h, w, k * k * d).astype(np.float32))
    return (maps.to(cuda, dtype),
            torch.from_numpy(rois.astype(np.float32)).to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,k,d,n", [(10, 14, 7, 9, 24), (9, 13, 3, 43, 70)])
def test_psroi_sat_mean_kernel_matches_plain(cuda, dtype, h, w, k, d, n):
    """Kernel 6 (``dtt_psroi_sat_mean``): the gather form's corner order and
    division, so the same bits as its plain version on one table, and
    ``psroi_pool(impl="pallas")`` the same bits as the ``"xla"`` form, map
    gradient included (the xla form's scatter-add)."""
    maps, rois = _frame_pool_case(np.random.RandomState(4), h, w, k, d, n,
                                  dtype, cuda)
    table = tpsroi.sat(maps[None]).contiguous()
    bounds = [t[None].contiguous() for t in
              tpsroi.roi_bounds(rois, 1 / 16, k, h, w)]
    before = tpsroi.psroi_sat_means_cuda.launches
    got = tpsroi.psroi_sat_means(table, *bounds)
    torch.cuda.synchronize()
    assert tpsroi.psroi_sat_means_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (1, n, k, k, d)
    torch.testing.assert_close(got, tpsroi.psroi_sat_means_plain(table,
                                                                 *bounds),
                               rtol=0, atol=0)
    m = maps.clone().requires_grad_()
    pooled = tpsroi.psroi_pool(m, rois, 1 / 16, k, "pallas")
    assert tpsroi.psroi_sat_means_cuda.launches == before + 2
    go = torch.randn(pooled.shape, device=cuda).to(dtype)
    pooled.backward(go)
    x = maps.clone().requires_grad_()
    want = tpsroi.psroi_pool(x, rois, 1 / 16, k, "xla")
    want.backward(go)
    assert pooled.dtype == dtype
    torch.testing.assert_close(pooled, want, rtol=0, atol=0)
    # the scatter-add may add in another order on the card: 1e-5 of the
    # largest in f32, one bf16 ulp of it in bf16
    rel = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(m.grad.float(), x.grad.float(), rtol=0,
                               atol=rel * x.grad.float().abs().max().item())


def test_psroi_sat_kernel_at_one_frame(cuda):
    """Kernel 5 (``_psroi_mm_kernel``'s port, ``dtt_psroi_sat`` at B=1):
    its sums equal the plain version's bits, ``psroi_pool(impl=
    "pallas_mm")`` launches it once, and its means and map gradient match
    the ``"xla"`` form (the SAT's f32 error; the same scatter-add, 1e-5 of
    the largest)."""
    h, w, k, d, n = 10, 14, 7, 31, 40
    maps, rois = _frame_pool_case(np.random.RandomState(5), h, w, k, d, n,
                                  torch.float32, cuda)
    table = tpsroi.sat(maps[None]).contiguous()
    bounds = [t[None].contiguous() for t in
              tpsroi.roi_bounds(rois, 1 / 16, k, h, w)]
    before = tpsroi.psroi_mm_sums_cuda.launches
    torch.testing.assert_close(tpsroi.psroi_mm_sums(table, *bounds),
                               tpsroi.psroi_mm_sums_plain(table, *bounds),
                               rtol=0, atol=0)
    m = maps.clone().requires_grad_()
    pooled = tpsroi.psroi_pool(m, rois, 1 / 16, k, "pallas_mm")
    torch.cuda.synchronize()
    assert tpsroi.psroi_mm_sums_cuda.launches == before + 2
    go = torch.randn(pooled.shape, device=cuda)
    pooled.backward(go)
    x = maps.clone().requires_grad_()
    want = tpsroi.psroi_pool(x, rois, 1 / 16, k, "xla")
    want.backward(go)
    torch.testing.assert_close(pooled, want, rtol=1e-5,
                               atol=8 * torch.finfo(torch.float32).eps
                               * table.abs().max().item())
    torch.testing.assert_close(m.grad, x.grad, rtol=0,
                               atol=1e-5 * x.grad.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d,s", [((2, 12, 20, 64), 8, 2),
                                       ((2, 7, 11, 160), 2, 1),
                                       ((3, 9, 37, 300), 8, 2)])
def test_correlation_split_kernel_matches_plain(cuda, dtype, shape, d, s):
    """Kernel 7 (``dtt_correlation_split``): 128-channel blocks summed in
    block order, a partial last block, against the plain version (f32:
    1e-5; bf16: one bf16 ulp of each output, 2^-7 |x|, which a dropped
    block of channels would exceed many times)."""
    g = torch.Generator().manual_seed(2)
    f1 = torch.randn(shape, generator=g).to(cuda, dtype)
    f2 = torch.randn(shape, generator=g).to(cuda, dtype)
    before = tcorr.correlation_split_cuda.launches
    got = tcorr.correlation(f1, f2, d, s, "pallas")
    torch.cuda.synchronize()
    assert tcorr.correlation_split_cuda.launches == before + 1
    want = tcorr.correlation_plain(f1, f2, d, s)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **CORR_TOL[dtype])


def test_correlation_pallas_autograd_launches_split_and_bwd(cuda):
    """``correlation(impl="pallas")`` runs the split forward and shares the
    backward kernel with ``"pallas_mm"``: both give the same gradients."""
    f1, f2 = (torch.randn(1, 6, 10, 160, device=cuda) for _ in range(2))
    grads = []
    for impl in ("pallas", "pallas_mm"):
        a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
        before = (tcorr.correlation_split_cuda.launches,
                  tcorr.correlation_bwd_cuda.launches)
        tcorr.correlation(a, b, 2, 1, impl).square().sum().backward()
        torch.cuda.synchronize()
        after = (tcorr.correlation_split_cuda.launches,
                 tcorr.correlation_bwd_cuda.launches)
        assert after == (before[0] + (impl == "pallas"), before[1] + 1)
        grads.append((a.grad, b.grad))
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [3, 7])
def test_roi_bounds_match_the_cpu(cuda, k):
    """Bin bounds on the card equal the CPU's (and so the reference's) for
    many RoIs: every operation rounds alike, the division by k included."""
    rng = np.random.RandomState(6)
    xy = rng.uniform(-40, 1100, (5000, 2))
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(0, 600, (5000, 2))], axis=-1).astype(np.float32))
    got = tpsroi.roi_bounds(rois.to(cuda), 1 / 16, k, 38, 68)
    want = tpsroi.roi_bounds(rois, 1 / 16, k, 38, 68)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.cpu(), w_, rtol=0, atol=0)
