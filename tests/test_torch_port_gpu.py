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
# misaligned), W under one 16-column tile, H = 1 (under 2d + 1 rows). The
# bf16 forward takes two rows a block where B * H * ceil(W / 64) one-row
# blocks fill the card's SMs: on a 132-SM H100 the first ten cases (at most
# 76 one-row blocks) run one row a block with the dy split over three
# blocks, the last three two rows a block
CORR_SHAPES = [((2, 12, 20, 64), 2, 1), ((2, 12, 20, 64), 8, 2),
               ((3, 9, 37, 40), 8, 2), ((1, 38, 68, 512), 8, 2),
               ((2, 5, 18, 40), 2, 1), ((2, 7, 21, 36), 8, 2),
               ((2, 6, 19, 36), 2, 1), ((2, 6, 11, 64), 8, 2),
               ((2, 1, 20, 48), 8, 2), ((3, 1, 9, 24), 2, 1),
               # 304 one-row blocks: two rows, 2-byte staging (C % 8 != 0)
               ((4, 38, 68, 36), 8, 2),
               # 304: two rows by TMA, C not a multiple of the 32-channel step
               ((4, 38, 68, 40), 8, 2),
               # 272: two rows at stride 1, 17 rows (the last block has one),
               # 2-byte staging, a 6-column last group
               ((8, 17, 70, 36), 2, 1)]


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


# (frames, H, W, k, D, RoIs) of the direct pool: the main path's calls (a
# video chunk's fused maps at 300 proposals; a train step's cls, bbox and
# track maps at 300 proposals + 30 gt slots) and the edges: D = 1, odd D,
# k = 3, one RoI, RoIs past one warp (32) and past one 256-RoI list chunk of
# the backward
POOL_VIDEO = [(16, 38, 68, 7, 43, 300)]
POOL_TRAIN = [(2, 38, 68, 7, 31, 330), (2, 38, 68, 7, 8, 330),
              (1, 38, 68, 7, 4, 330)]
POOL_EDGES = [(2, 10, 14, 7, 1, 16), (2, 9, 13, 3, 5, 70),
              (3, 9, 13, 3, 43, 1), (1, 10, 14, 7, 9, 40),
              (2, 12, 17, 3, 8, 600)]


def _pool_case(shape, dtype, cuda, seed):
    """Maps and RoIs of `shape`: RoIs up to 600 px, the first ones covering
    the whole map, on .5 coordinates, degenerate (one-pixel and empty bins),
    past the map and before it. Returns maps, RoIs and their bin bounds."""
    b, h, w, k, d, n = shape
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-40, w * 16, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 600, (b, n, 2))], axis=-1)
    special = [[0, 0, w * 16 - 1, h * 16 - 1], [40.5, 23.5, 72.5, 88.5],
               [41.5, 24.5, 41.5, 24.5],
               [w * 16 + 50, h * 16 + 20, w * 16 + 300, h * 16 + 200],
               [-60, -40, -10, -5]]
    rois[:, :min(n, len(special))] = special[:n]
    rois = torch.from_numpy(rois.astype(np.float32)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    maps = torch.randn(b, h, w, k * k * d, device=cuda, generator=g).to(dtype)
    bounds = [t.contiguous() for t in tpsroi.roi_bounds(rois, 1 / 16, k, h, w)]
    return maps, rois, bounds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", POOL_VIDEO + POOL_TRAIN + POOL_EDGES)
def test_psroi_kernel_matches_plain(cuda, dtype, shape):
    """f32 sums of the same values in another order (1e-4 on sums of up to
    ~100 values of O(1)); empty bins 0."""
    b, h, w, k, d, n = shape
    maps, _, bounds = _pool_case(shape, dtype, cuda, 1)
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
    """Past the tensor-core band (max_displacement > 8) bf16 maps run on the
    CUDA-core bodies, forward and backward, within one bf16 ulp of the
    plain versions; what still raises is a window past the CUDA-core
    forward's card limits (more than 32 displacements per axis), in both
    forward forms, naming the limit and launching nothing."""
    assert tcorr.correlation_body(torch.bfloat16, 12, 3) == "cuda_cores"
    g = torch.Generator().manual_seed(4)
    f1, f2 = (torch.randn(1, 9, 20, 16, generator=g).to(cuda, torch.bfloat16)
              for _ in range(2))
    go = torch.randn(1, 9, 20, 81, generator=g).to(cuda, torch.bfloat16)
    got = tcorr.correlation_cuda(f1, f2, 12, 3)
    grads = tcorr.correlation_bwd_cuda(f1, f2, go, 12, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), tcorr.correlation_plain(f1, f2, 12, 3).float(),
        **CORR_TOL[torch.bfloat16])
    for x, w in zip(grads, tcorr.correlation_bwd_plain(f1, f2, go, 12, 3)):
        torch.testing.assert_close(x.float(), w.float(),
                                   **CORR_TOL[torch.bfloat16])
    before = (tcorr.correlation_cuda.launches,
              tcorr.correlation_split_cuda.launches)
    with pytest.raises(ValueError, match="at most 32"):
        tcorr.correlation_cuda(f1, f2, 33, 1)
    with pytest.raises(ValueError, match="at most 32"):
        tcorr.correlation_split_cuda(f1, f2, 33, 1)
    assert (tcorr.correlation_cuda.launches,
            tcorr.correlation_split_cuda.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["auto", "pallas_mm", "pallas"])
@pytest.mark.parametrize("d,s", [(16, 4), (10, 2), (20, 2)])
def test_correlation_wide_windows_match_plain(cuda, dtype, impl, d, s):
    """Windows that dtt takes past the tensor-core band (d=16/s=4, d=10/s=2
    and FlowNet-C's d=20/s=2, whose staging needs more than 48 KB of shared
    memory) under every kernel form, forward and backward: the CUDA-core
    bodies, each launched once, against the plain versions."""
    g = torch.Generator().manual_seed(5)
    f1, f2 = (torch.randn(2, 12, 40, 48, generator=g).to(cuda, dtype)
              for _ in range(2))
    go = torch.randn(2, 12, 40, tcorr.num_corr_channels(d, s),
                     generator=g).to(cuda, dtype)
    fwd = (tcorr.correlation_split_cuda if impl == "pallas"
           else tcorr.correlation_cuda)
    before = (fwd.launches, tcorr.correlation_bwd_cuda.launches)
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    out = tcorr.correlation(a, b, d, s, impl)
    out.backward(go)
    torch.cuda.synchronize()
    assert (fwd.launches, tcorr.correlation_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        out.float(), tcorr.correlation_plain(f1, f2, d, s).float(),
        **CORR_TOL[dtype])
    for x, w in zip((a.grad, b.grad),
                    tcorr.correlation_bwd_plain(f1, f2, go, d, s)):
        torch.testing.assert_close(x.float(), w.float(), **CORR_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 6, 10, 32), (8, 17, 70, 36)])
def test_correlation_autograd_launches_both_kernels(cuda, dtype, shape):
    """Forward and backward each launch their kernel once (in bf16 the
    tensor-core bodies; at (8, 17, 70, 36) the forward's two-row blocks),
    and the gradients are the backward kernel's for the output gradient
    autograd hands it."""
    g = torch.Generator().manual_seed(3)
    f1, f2 = (torch.randn(shape, generator=g).to(cuda, dtype)
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


def _pool_ghat(shape, bounds, cuda, seed, dtype=torch.float32):
    """A random output gradient in `dtype` and ghat, its f32 values over
    the bins' areas (0 for empty bins), as the pool's autograd hands the
    backward kernel."""
    b, _, _, k, d, n = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    area = tpsroi.bin_areas(*bounds)[..., None]
    go = torch.randn(b, n, k, k, d, device=cuda, generator=g).to(dtype)
    return go, torch.where(area > 0, go.float() / area.clamp(min=1.0), 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", POOL_TRAIN + POOL_EDGES)
def test_psroi_bwd_kernel_matches_plain(cuda, dtype, shape):
    """The map gradient through the pool's autograd: f32 sums of ghat in
    RoI order vs the plain contraction, 1e-5 in f32; bf16 outputs within
    one bf16 ulp of the largest (both round an f32 sum once)."""
    b, h, w, k, d, n = shape
    maps, rois, bounds = _pool_case(shape, dtype, cuda, 2)
    maps.requires_grad_()
    go, ghat = _pool_ghat(shape, bounds, cuda, 3, dtype)
    before = tpsroi.psroi_bwd_cuda.launches
    tpsroi.psroi_pool_batched_direct(maps, rois, 1 / 16, k).backward(go)
    torch.cuda.synchronize()
    assert tpsroi.psroi_bwd_cuda.launches == before + 1
    want = tpsroi.psroi_bwd_plain(ghat, *bounds, h, w, dtype).float()
    assert maps.grad.dtype == dtype and maps.grad.shape == maps.shape
    top = want.abs().max().item()
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(
        max(top, 1e-30))) - 7)
    torch.testing.assert_close(maps.grad.float(), want, rtol=0, atol=atol)


def test_psroi_bwd_kernel_is_deterministic(cuda):
    """Each map-gradient element is summed by one thread in RoI order with
    no atomics: two runs on the same inputs give the same bits, in both
    dtypes, at a train step's largest call."""
    shape = (2, 38, 68, 7, 31, 330)
    _, _, bounds = _pool_case(shape, torch.float32, cuda, 4)
    _, ghat = _pool_ghat(shape, bounds, cuda, 5)
    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        runs = [tpsroi.psroi_bwd_cuda(ghat, *bounds, 38, 68, dtype)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0].view(bits), runs[1].view(bits))


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


# Kernel 7's cases, each with its bf16 body and the ranks split_plan takes
# on a 132-SM H100: the fewest whose launch has as many clusters (output
# tiles) as the card holds at once, else the most (f32 in brackets)
SPLIT_SHAPES = [
    # C < 128: clusters of 1; tensor cores by TMA
    ((2, 12, 20, 64), 8, 2),
    # tensor cores by TMA, 2 ranks of 128, the second 32 channels (f32: the
    # same)
    ((2, 7, 11, 160), 2, 1),
    # C % 8 != 0: tensor cores with 2-byte staging, 3 ranks of 128, the
    # third 44 channels (f32: the same)
    ((3, 9, 37, 300), 8, 2),
    ((2, 7, 11, 300), 2, 1),
    # the main path's maps at one pair, tensor cores by TMA: 40 tiles fill
    # the card's 30 clusters of 4 ranks of 128 and of 256 (f32: 114 tiles,
    # 4 ranks of 128 and 8 of 128)
    ((1, 38, 68, 512), 8, 2),
    ((1, 38, 68, 1024), 8, 2),
    # 80 tiles fill the card's 66 clusters of 2 ranks of 128 (f32: 228
    # tiles, none fill: 2 ranks)
    ((2, 38, 68, 256), 8, 2),
    # 6 tiles: 8 ranks of 128 (f32: the same)
    ((1, 12, 20, 1024), 8, 2),
    # C > 1024, several blocks a rank: 12 blocks, 6 ranks of 256 (f32: the
    # same); 17 blocks, 6 ranks of 384, the last block 32 channels (f32:
    # the same)
    ((2, 12, 20, 1536), 8, 2),
    ((1, 9, 17, 2080), 2, 1),
    # a bf16 window past the band: the CUDA cores, 2 ranks of 128
    ((2, 12, 20, 256), 16, 4),
    # the widest window the CUDA cores take (32 displacements an axis:
    # 1,024 threads and 196 KB of staging a block) in clusters of 8 ranks
    ((1, 6, 40, 1024), 31, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d,s", SPLIT_SHAPES)
def test_correlation_split_kernel_matches_plain(cuda, dtype, shape, d, s):
    """Kernel 7 (``dtt_correlation_split``): 128-channel blocks summed in
    rank order across a cluster, against the plain version (f32: 1e-5;
    bf16: one bf16 ulp of each output, 2^-7 |x|, which a dropped block of
    channels would exceed many times); the launcher's form is
    ``split_plan``'s, one cluster an output tile."""
    g = torch.Generator().manual_seed(2)
    f1 = torch.randn(shape, generator=g).to(cuda, dtype)
    f2 = torch.randn(shape, generator=g).to(cuda, dtype)
    b, h, w, c = shape
    form = tcorr.split_form(shape, dtype, d, s)
    assert form["body"] == tcorr.correlation_body(dtype, d, s)
    assert 1 <= form["ranks"] <= 8 and form["max_active_clusters"] >= 1
    # one cluster an output tile: 64 columns x 2 rows of one residue class
    # mod s (tensor cores), 32 columns x 1 row (CUDA cores)
    rows = -(-h // s)                # rows of a residue class, at most
    tiles = (-(-w // 64) * s * -(-rows // 2)
             if form["body"] == "tensor_cores" else -(-w // 32) * h)
    assert form["clusters"] == b * tiles
    before = tcorr.correlation_split_cuda.launches
    got = tcorr.correlation(f1, f2, d, s, "pallas")
    torch.cuda.synchronize()
    assert tcorr.correlation_split_cuda.launches == before + 1
    want = tcorr.correlation_plain(f1, f2, d, s)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **CORR_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_split_kernel_is_deterministic(cuda, dtype):
    """The ranks' partial tiles are summed in rank order, not in the order
    the blocks ran: three runs give the same bits."""
    g = torch.Generator().manual_seed(7)
    f1, f2 = (torch.randn(1, 38, 68, 1024, generator=g).to(cuda, dtype)
              for _ in range(2))
    runs = [tcorr.correlation_split_cuda(f1, f2, 8, 2) for _ in range(3)]
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for run in runs[1:]:
        assert torch.equal(run.view(bits), runs[0].view(bits))


def test_correlation_split_makes_one_launch_and_allocates_its_output(cuda):
    """One kernel on the device and one allocation, the output: no
    workspace and no second pass."""
    g = torch.Generator().manual_seed(8)
    f1, f2 = (torch.randn(1, 38, 68, 1024, generator=g).to(cuda,
                                                          torch.bfloat16)
              for _ in range(2))
    tcorr.correlation_split_cuda(f1, f2, 8, 2)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    before = tcorr.correlation_split_cuda.launches
    tcorr.correlation_split_cuda(f1, f2, 8, 2)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1
    assert tcorr.correlation_split_cuda.launches == before + 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tcorr.correlation_split_cuda(f1, f2, 8, 2)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "correlation_split" in kernels[0], kernels


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


# SAT pools, kernels 4-6 (``dtt_psroi_sat`` in both modes and
# ``dtt_psroi_sat_mean``), each held to its plain version bit for bit on
# one table: the main path's shapes (a pair batch, 4 frames x 300 RoIs at
# D = 43, its f32 table past the 50 MB L2; one frame's cls, bbox and track
# tables at D = 31, 8, 4) and the edges: N = 1 at k = 3, D = 6 (8-byte
# vectors), odd D (scalars), D = 12 on a map smaller than the RoIs (bounds
# at H and W). ``_pool_case``'s RoIs add the whole map, .5 coordinates,
# one-pixel and empty bins and RoIs past the map.
SAT_FORMS = {"mm_sums": tpsroi.psroi_mm_sums_plain,
             "mm_means": tpsroi.psroi_mm_means_plain,
             "sat_means": tpsroi.psroi_sat_means_plain}
SAT_SHAPES = [(4, 38, 68, 7, 43, 300), (1, 38, 68, 7, 31, 300),
              (1, 38, 68, 7, 8, 300), (1, 38, 68, 7, 4, 300),
              (1, 9, 13, 3, 43, 1), (2, 10, 14, 7, 6, 24),
              (2, 10, 14, 7, 9, 24), (3, 5, 4, 3, 12, 70)]


def _sat_launches():
    return (tpsroi.psroi_mm_sums_cuda.launches,
            tpsroi.psroi_sat_means_cuda.launches)


def _one_launch(form, before):
    """The launch counts after one launch of `form`'s C entry."""
    sums, means = before
    return (sums + 1, means) if form != "sat_means" else (sums, means + 1)


@pytest.mark.parametrize("form", sorted(SAT_FORMS))
@pytest.mark.parametrize("shape", SAT_SHAPES)
def test_sat_kernels_match_plain_bit_for_bit(cuda, form, shape):
    b, h, w, k, d, n = shape
    maps, _, bounds = _pool_case(shape, torch.float32, cuda, 7)
    table = tpsroi.sat(maps).contiguous()
    before = _sat_launches()
    (got,) = tpsroi.psroi_sat_group(form, [(table, bounds)])
    torch.cuda.synchronize()
    assert _sat_launches() == _one_launch(form, before)
    assert got.dtype == torch.float32 and got.shape == (b, n, k, k, d)
    torch.testing.assert_close(got, SAT_FORMS[form](table, *bounds), rtol=0,
                               atol=0)


@pytest.mark.parametrize("form", sorted(SAT_FORMS))
def test_sat_kernels_on_a_misaligned_table(cuda, form):
    """A table 4 bytes off a 16-byte boundary at D = 8: the kernel reads
    scalars, and the bits stay the plain version's."""
    shape = (2, 10, 14, 7, 8, 24)
    maps, _, bounds = _pool_case(shape, torch.float32, cuda, 8)
    table = tpsroi.sat(maps).contiguous()
    buf = torch.empty(table.numel() + 1, device=cuda)
    moved = buf[1:].view(table.shape)
    moved.copy_(table)
    assert moved.is_contiguous() and moved.data_ptr() % 16 == 4
    (got,) = tpsroi.psroi_sat_group_cuda(form, [(moved, bounds)])
    torch.testing.assert_close(got, SAT_FORMS[form](table, *bounds), rtol=0,
                               atol=0)


@pytest.mark.parametrize("form", sorted(SAT_FORMS))
def test_sat_kernels_group_members_in_one_launch(cuda, form):
    """One launch for members that differ in frames, map size, k, D and
    RoIs (a frame's three tables beside a pair batch's and a one-RoI
    member): each output is its member's plain version, bit for bit."""
    shapes = [(1, 38, 68, 7, 31, 300), (1, 38, 68, 7, 8, 17),
              (1, 9, 13, 3, 43, 1), (4, 10, 14, 7, 4, 70)]
    members = []
    for i, shape in enumerate(shapes):
        maps, _, bounds = _pool_case(shape, torch.float32, cuda, 10 + i)
        members.append((tpsroi.sat(maps).contiguous(), bounds))
    before = _sat_launches()
    outs = tpsroi.psroi_sat_group(form, members)
    torch.cuda.synchronize()
    assert _sat_launches() == _one_launch(form, before)
    for (table, bounds), out in zip(members, outs):
        torch.testing.assert_close(out, SAT_FORMS[form](table, *bounds),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["pallas_mm", "pallas"])
def test_rfcn_head_launches_one_sat_kernel(cuda, impl):
    """``rfcn_head`` under each kernel form pools its cls and bbox maps in
    one launch a call; its votes match the ``"xla"`` form (``pallas``: to
    the bit; ``pallas_mm``: to the SAT's f32 error) and so do its map
    gradients (the same scatter-add, 1e-5 of the largest)."""
    from dtt_torch.core.config import Config
    from dtt_torch.models import dnt as tdnt

    cfg = Config().model
    k = cfg.roi.ps_grid
    cls, rois, _ = _pool_case((1, 38, 68, k, cfg.num_classes, 300),
                              torch.float32, cuda, 12)
    bbox, _, _ = _pool_case((1, 38, 68, k, 8, 300), torch.float32, cuda, 13)
    cls, bbox, rois = cls[0], bbox[0], rois[0]
    xs = [cls.clone().requires_grad_(), bbox.clone().requires_grad_()]
    ys = [cls.clone().requires_grad_(), bbox.clone().requires_grad_()]
    want = tdnt.rfcn_head(cfg, *ys, rois, 1 / 16, "xla")
    for _ in range(2):
        before = _sat_launches()
        got = tdnt.rfcn_head(cfg, *xs, rois, 1 / 16, impl)
        torch.cuda.synchronize()
        form = "mm_means" if impl == "pallas_mm" else "sat_means"
        assert _sat_launches() == _one_launch(form, before)
    gos = [torch.randn(g.shape, device=cuda) for g in got]
    torch.autograd.backward(got, gos)
    torch.autograd.backward(want, gos)
    for g, w_, m in zip(got, want, (cls, bbox)):
        atol = 0.0 if impl == "pallas" else (
            8 * torch.finfo(torch.float32).eps
            * tpsroi.sat(m[None]).abs().max().item())
        torch.testing.assert_close(g, w_, rtol=0 if impl == "pallas" else
                                   1e-5, atol=atol)
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x.grad, y.grad, rtol=0,
                                   atol=1e-5 * y.grad.abs().max().item())


# ------------------------------------------------------------------- data

def _host_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"images": rng.randn(2, 2, 96, 128, 3).astype(np.float32) * 50,
             "gt_boxes": rng.uniform(0, 90, (2, 2, 4, 4)).astype(np.float32),
             "gt_labels": rng.randint(0, 31, (2, 4)).astype(np.int32),
             "gt_valid": rng.rand(2, 2, 4) > 0.3,
             "im_scale": np.full((2,), 0.8, np.float32)} for _ in range(n)]


@pytest.mark.parametrize("cast", [None, {"images": torch.bfloat16}])
def test_device_prefetch_uploads_bit_equal(cuda, cast):
    """Every uploaded batch equals its host batch (after the host cast),
    while the consumer's stream allocates, fills and frees big tensors
    between batches: a copy not ordered before the consumer, or memory the
    allocator hands back early, shows as a changed value."""
    from dtt_torch.data.loader import device_prefetch
    host = _host_batches(12)
    seen = 0
    for i, batch in enumerate(device_prefetch(iter(host), cuda, size=3,
                                              cast=cast)):
        for _ in range(3):   # churn the caching allocator on this stream
            junk = torch.full((2, 2, 96, 128, 3), float(i), device=cuda)
            junk.mul_(3.0).add_(1.0)
            del junk
        for k, v in host[i].items():
            want = torch.from_numpy(v)
            if cast and k in cast:
                want = want.to(cast[k])
            got = batch[k]
            assert got.device.type == "cuda" and got.dtype == want.dtype, k
            assert torch.equal(got.cpu(), want), (i, k)
        seen += 1
    assert seen == len(host)


def test_device_prefetch_raises_iterator_errors(cuda):
    from dtt_torch.data.loader import device_prefetch

    def broken():
        yield _host_batches(1)[0]
        raise OSError("unreadable frame")

    it = device_prefetch(broken(), cuda)
    next(it)
    with pytest.raises(OSError, match="unreadable frame"):
        next(it)


def test_render_pairs_on_the_card_equals_the_host_renderer(cuda):
    """Pixel for pixel, at the full canvas and at a small one, with
    overlapping, clipped, degenerate and invalid slots, on the same
    backgrounds (the same generator seed)."""
    from dtt_torch.data import device_synth, synthetic
    for h, w, seed in ((608, 1088, 0), (64, 96, 1)):
        p = synthetic.sample_params_batch(np.random.RandomState(seed), 2, h,
                                          w, 31, 30, num_objects=(5, 30))
        p["gt_boxes"][0, 0, 0] = [-30, -12, 40, 50]
        p["gt_boxes"][1, 1, 1] = [8, 8, 8, 20]
        out = device_synth.render_pairs(
            p["gt_boxes"], p["gt_labels"], p["gt_valid"],
            torch.Generator(device=cuda).manual_seed(seed), h, w, cuda)
        assert out.device.type == "cuda" and out.dtype == torch.uint8
        bg = device_synth.pair_background(
            torch.Generator(device=cuda).manual_seed(seed), 2, h, w,
            cuda).cpu().numpy()
        assert bg.min() == 23 and bg.max() == 37
        out = out.cpu().numpy()
        for b in range(2):
            for f in range(2):
                want = synthetic.render_frame(
                    bg[b, f].copy(), p["gt_boxes"][b, f], p["gt_labels"][b],
                    p["gt_valid"][b, f])
                np.testing.assert_array_equal(out[b, f], want)


def test_prefetch_and_renderer_raise_without_cuda(cuda, monkeypatch):
    from dtt_torch.data.device_synth import make_pair_render_fn, render_pairs
    from dtt_torch.data.loader import device_prefetch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        device_prefetch(iter([]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pair_render_fn(64, 96)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_pairs(np.zeros((1, 2, 3, 4)), np.zeros((1, 3), np.int32),
                     np.zeros((1, 2, 3), bool), None, 64, 96)


# The pooling modes other than PSRoI (plain PyTorch on both devices): a
# train step's cls, bbox and track maps at 330 RoIs (roi_pool's row stage
# in several chunks at D = 31) and small maps with RoIs past the map,
# degenerate ones, and RoIs whose integer width is a multiple of k, where a
# bin edge lies on an integer only under a true division by k (a multiply
# by the rounded 1/k, what ``tensor / k`` is on CUDA, lands below it)
ROI_SHAPES = [(2, 38, 68, 31, 330), (1, 38, 68, 8, 330), (2, 9, 13, 5, 40)]


def _roi_case(shape, k):
    b, h, w, d, n = shape
    rng = np.random.RandomState(n + d)
    maps = torch.from_numpy(rng.randn(b, h, w, d).astype(np.float32))
    xy = rng.uniform(-40, 16 * w + 40, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 600, (b, n, 2))], -1)
    for i in range(1, 6):          # integer widths k * i: edges on integers
        rois[:, i] = [0, 16 * 2, 16 * (k * i - 1), 16 * (k * i + 1)]
    rois[:, 6] = [40, 40, 40, 40]
    rois[:, 7] = [90, 60, 20, 10]
    return maps, torch.from_numpy(rois.astype(np.float32))


@pytest.mark.parametrize("shape", ROI_SHAPES)
@pytest.mark.parametrize("name,kw", [("roi_align", {}),
                                     ("roi_align", {"aligned": True}),
                                     ("roi_pool", {}), ("roi_crop", {})])
def test_roi_ops_match_the_cpu(cuda, shape, name, kw):
    """roi_pool bit for bit (its bin edges divide by a tensor), roi_align
    and roi_crop to 1e-5, at k = 7 and 3."""
    from dtt_torch.ops import roi_ops
    for k in (7, 3):
        maps, rois = _roi_case(shape, k)
        want = getattr(roi_ops, name)(maps, rois, 1 / 16, k, **kw)
        got = getattr(roi_ops, name)(maps.to(cuda), rois.to(cuda), 1 / 16,
                                     k, **kw)
        tol = (dict(rtol=0, atol=0) if name == "roi_pool"
               else dict(rtol=0, atol=1e-5))
        torch.testing.assert_close(got.cpu(), want, **tol)


def test_remat_gradients_match_on_the_card(cuda):
    """A tiny float32 model's train loss and gradients with model.remat
    equal those without it on the card (deterministic cuDNN), to 1e-6 of
    float32 roundoff."""
    from dtt_torch.core.anchors import grid_anchors_for
    from dtt_torch.core.config import Config
    from dtt_torch.data.synthetic import synthetic_batch
    from dtt_torch.models.targets import sample_draws
    from dtt_torch.train.losses import batch_loss
    from dtt_torch.train.trainer import batch_to_device
    from dtt_torch.utils.params import from_jax_params, init_jax_params
    cfg = Config()
    m = cfg.model
    cfg = cfg.replace(
        model=m.replace(backbone="tiny", dtype="float32", frozen_stages=0,
                        reduced_channels=64, num_classes=4,
                        anchors=m.anchors.replace(scales=(1.0, 2.0, 4.0)),
                        rpn=m.rpn.replace(channels=32,
                                          pre_nms_top_n_train=128,
                                          post_nms_top_n_train=32),
                        roi=m.roi.replace(ps_grid=3),
                        track=m.track.replace(max_displacement=2, stride=1)),
        input=cfg.input.replace(canvas_height=64, canvas_width=96,
                                max_gt_boxes=4))
    tree = init_jax_params(cfg.model, seed=2)
    batch = batch_to_device(synthetic_batch(np.random.RandomState(4), 2, 64,
                                            96, 4, 4, uint8=True), cuda)
    anchors = torch.from_numpy(grid_anchors_for(cfg.model.anchors, 4,
                                                6)).to(cuda)
    out = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            c = cfg.replace(model=cfg.model.replace(remat=remat))
            model = from_jax_params(tree, c.model, cuda).train()
            draws = sample_draws(c, 2, torch.Generator(cuda).manual_seed(0),
                                 cuda)
            loss, _ = batch_loss(c, model, anchors, batch, draws)
            loss.backward()
            out.append((loss.detach(), {k: p.grad for k, p in
                                        model.named_parameters()
                                        if p.grad is not None}))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-6)
    assert g0.keys() == g1.keys() and len(g0) > 20
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-6,
                                   msg=k)
