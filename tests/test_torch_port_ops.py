"""dtt_torch's ops held against dtt's on the CPU: config, anchors, boxes,
NMS, correlation and the direct PSRoI pool.

Inputs are made with numpy from a seed and given to both packages. On the
CPU each dtt_torch kernel wrapper runs its plain PyTorch version; the
Pallas kernels run in interpret mode, as dtt's own tests run them.
"""

import dataclasses
import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtt.core.config as jcfg
from dtt.core import boxes as jboxes
from dtt.core.anchors import grid_anchors_for as j_grid_anchors_for
from dtt.ops import nms as jnms
from dtt.ops.correlation import correlation_pallas_mm, correlation_xla
from dtt.ops.psroi import (_roi_bounds, psroi_pool_batched_direct,
                           psroi_pool_batched_direct_ad)
from tests.torch_ref import psroi_pool_caffe

import dtt_torch.core.config as tcfg
from dtt_torch.core import boxes as tboxes
from dtt_torch.core.anchors import grid_anchors_for as t_grid_anchors_for
from dtt_torch.ops import correlation as tcorr
from dtt_torch.ops import nms as tnms
from dtt_torch.ops import psroi as tpsroi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("path", [None] + sorted(glob.glob(
    os.path.join(REPO, "configs", "*.yml"))))
def test_config_matches_dtt(path):
    """Same fields, defaults and YAML keys as dtt.core.config."""
    over = ["model.roi.ps_grid=3", "eval.split_video_step=false"]
    a = dataclasses.asdict(jcfg.load_config(path, over))
    b = dataclasses.asdict(tcfg.load_config(path, over))
    assert a == b
    assert (tcfg.Config().model.track.num_corr_channels
            == jcfg.Config().model.track.num_corr_channels)


# ------------------------------------------------------------------ anchors, boxes

@pytest.mark.parametrize("hw", [(4, 6), (38, 68)])
def test_anchors_bit_identical(hw):
    cfg = jcfg.Config().model.anchors
    a = j_grid_anchors_for(cfg, *hw)
    b = t_grid_anchors_for(tcfg.Config().model.anchors, *hw)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _random_boxes(rng, n, size=100.0):
    x1 = rng.uniform(-10, size, n)
    y1 = rng.uniform(-10, size, n)
    w = rng.uniform(-2, size / 2, n)
    h = rng.uniform(-2, size / 2, n)
    return np.stack([x1, y1, x1 + w, y1 + h], axis=1).astype(np.float32)


def test_boxes_decode_clip_iou_encode_match(rng):
    """Elementwise float32 arithmetic in the same order: equal to 1 ulp
    (exp may differ in its last bit between libraries)."""
    boxes = _random_boxes(rng, 64)
    deltas = (rng.randn(64, 8) * 2).astype(np.float32)  # hits the dw clamp
    means, stds = (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)
    tol = dict(rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        _np(tboxes.decode_boxes(_t(boxes), _t(deltas), means, stds)),
        _np(jboxes.decode_boxes(jnp.asarray(boxes), jnp.asarray(deltas),
                                means, stds)), **tol)
    np.testing.assert_array_equal(
        _np(tboxes.clip_boxes(_t(deltas * 50), 60.0, 80.0)),
        _np(jboxes.clip_boxes(jnp.asarray(deltas * 50), 60.0, 80.0)))
    np.testing.assert_array_equal(
        _np(tboxes.pairwise_iou(_t(boxes), _t(boxes[:9]))),
        _np(jboxes.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes[:9]))))
    gt = _random_boxes(rng, 64) + np.float32(20)
    np.testing.assert_allclose(
        _np(tboxes.encode_boxes(_t(np.abs(boxes)), _t(np.abs(gt)), means, stds)),
        _np(jboxes.encode_boxes(jnp.asarray(np.abs(boxes)),
                                jnp.asarray(np.abs(gt)), means, stds)),
        **tol)


# ------------------------------------------------------------------ NMS

def _tied_case(rng, n=48):
    boxes = _random_boxes(rng, n, size=60.0)
    # scores drawn from 6 values: many exact ties across overlapping boxes
    scores = rng.choice(np.float32([0.9, 0.7, 0.5, 0.5, 0.3, 1e-4]), n)
    valid = rng.rand(n) > 0.1
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_with_ties(seed):
    """Equal indices and validity with tied scores: both packages take the
    lower index first."""
    boxes, scores, valid = _tied_case(np.random.RandomState(seed))
    for thresh, m in ((0.5, 48), (0.3, 10)):
        ji, jv = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                                 thresh, m, valid=jnp.asarray(valid))
        fi, fv = jnms.nms_padded_fast(jnp.asarray(boxes), jnp.asarray(scores),
                                      thresh, m, valid=jnp.asarray(valid),
                                      select_block=8)
        ti, tv = tnms.nms_padded(_t(boxes), _t(scores), thresh, m,
                                 valid=_t(valid))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(fi))


@pytest.mark.parametrize("per_class_boxes", [False, True])
def test_multiclass_nms_matches_batched(rng, per_class_boxes):
    """Batched over frames x classes, with ties and the score threshold."""
    nb, k, c = 3, 32, 4
    cases = [_tied_case(rng, k) for _ in range(nb)]
    boxes = np.stack([b for b, _, _ in cases])
    if per_class_boxes:
        boxes = np.stack([boxes + np.float32(i) for i in range(c)], axis=2)
    scores = np.stack([rng.choice(s, (k, c)) for _, s, _ in cases])
    valid = np.stack([v for _, _, v in cases])
    want = [jnms.multiclass_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                0.3, 5, score_threshold=1e-3,
                                valid=jnp.asarray(valid[i]),
                                per_class_boxes=per_class_boxes)
            for i in range(nb)]
    got = tnms.multiclass_nms(_t(boxes), _t(scores), 0.3, 5,
                              score_threshold=1e-3, valid=_t(valid),
                              per_class_boxes=per_class_boxes)
    for j, name in enumerate(("boxes", "scores", "valid", "idx")):
        np.testing.assert_array_equal(
            got[j].numpy(), np.stack([np.asarray(w[j]) for w in want]),
            err_msg=name)


# ------------------------------------------------------------------ correlation

@pytest.mark.parametrize("d,s", [(2, 1), (8, 2)])
def test_correlation_matches_xla_and_pallas_mm(d, s):
    """float32: the same products summed in another order; 1e-5 absolute
    on channel means of O(1) values."""
    rng = np.random.RandomState(d)
    f1 = rng.randn(2, 12, 20, 64).astype(np.float32)
    f2 = rng.randn(2, 12, 20, 64).astype(np.float32)
    got = tcorr.correlation(_t(f1), _t(f2), d, s).numpy()
    want_xla = np.stack([np.asarray(correlation_xla(
        jnp.asarray(a), jnp.asarray(b), d, s)) for a, b in zip(f1, f2)])
    want_mm = np.asarray(jax.vmap(lambda a, b: correlation_pallas_mm(
        a, b, d, s))(jnp.asarray(f1), jnp.asarray(f2)))
    assert got.shape == (2, 12, 20, tcorr.num_corr_channels(d, s))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_mm, rtol=0, atol=1e-5)


# windows past the tensor-core band, which the port's CUDA-core bodies take:
# more displacements than the band's 9 (d=10/s=2: 11) or a wider band
# (d=16/s=4: 9 displacements, 32 + 16 columns)
WIDE_WINDOWS = [(16, 4), (10, 2)]


@pytest.mark.parametrize("d,s", WIDE_WINDOWS)
def test_correlation_wide_windows_match_xla_and_pallas_mm(d, s):
    """float32 at windows past the band: the port's plain forward against
    dtt's ``correlation_xla`` and its Pallas ``correlation_pallas_mm``
    (interpret mode), 1e-5 absolute on channel means of O(1) values."""
    rng = np.random.RandomState(20 + d)
    f1, f2 = (rng.randn(1, 20, 40, 16).astype(np.float32) for _ in range(2))
    got = tcorr.correlation(_t(f1), _t(f2), d, s).numpy()
    want_xla = np.asarray(correlation_xla(jnp.asarray(f1[0]),
                                          jnp.asarray(f2[0]), d, s))[None]
    want_mm = np.asarray(correlation_pallas_mm(jnp.asarray(f1[0]),
                                               jnp.asarray(f2[0]), d, s))[None]
    assert got.shape == (1, 20, 40, tcorr.num_corr_channels(d, s))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_mm, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d,s", WIDE_WINDOWS)
def test_correlation_wide_window_grads_match_pallas_mm_vjp(d, s):
    """float32 at windows past the band: the port's plain backward against
    jax.vjp of dtt's ``correlation_pallas_mm`` (its einsum AD), sums of up
    to 121 products of O(1) values in another order (1e-5)."""
    rng = np.random.RandomState(30 + d)
    f1, f2 = (rng.randn(1, 20, 40, 16).astype(np.float32) for _ in range(2))
    g = rng.randn(1, 20, 40, tcorr.num_corr_channels(d, s)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: correlation_pallas_mm(a, b, d, s),
                     jnp.asarray(f1[0]), jnp.asarray(f2[0]))
    want = vjp(jnp.asarray(g[0]))
    got = tcorr.correlation_bwd_plain(_t(f1), _t(f2), _t(g), d, s)
    for x, w_ in zip(got, want):
        np.testing.assert_allclose(x[0].numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype,d,s,body", [
    (torch.bfloat16, 8, 2, "tensor_cores"),    # the main path's window
    (torch.bfloat16, 2, 1, "tensor_cores"),
    (torch.bfloat16, 8, 1, "cuda_cores"),      # 17 displacements: past 9
    (torch.bfloat16, 16, 4, "cuda_cores"),     # d past the band's 8
    (torch.bfloat16, 10, 2, "cuda_cores"),
    (torch.float32, 8, 2, "cuda_cores"),       # f32 keeps its 1e-5 sums
    (torch.float32, 2, 1, "cuda_cores")])
def test_correlation_body_routes_by_dtype_and_window(dtype, d, s, body):
    """One rule picks the CUDA body of the forward and the backward: the
    tensor-core band for bf16 windows of d <= 8 and at most 9
    displacements per axis, the CUDA cores for the rest."""
    assert tcorr.correlation_body(dtype, d, s) == body


@pytest.mark.parametrize("d,s,match", [
    (20, 2, None), (16, 4, None), (10, 2, None), (31, 2, None),
    (33, 1, "67 displacements per axis.*at most 32"),
    (62, 4, "323,648 bytes.*227 KB")])
def test_correlation_window_limit_names_the_card(d, s, match):
    """The CUDA-core forward refuses only what the card cannot hold: more
    than 32 displacements per axis (a block of 32 x nd threads) or staged
    f2 rows past a block's 227 KB of shared memory, and says which."""
    limit = tcorr.window_limit(d, s)
    if match is None:
        assert limit is None
    else:
        assert re.search(match, limit), limit


@pytest.mark.parametrize("c,max_ranks,ranks,channels", [
    (1, 8, 1, 128), (64, 8, 1, 128),          # under one block: a cluster of 1
    (300, 8, 3, 128), (300, 2, 2, 256),
    (512, 8, 4, 128), (512, 2, 2, 256),       # the main path's c3
    (1024, 8, 8, 128), (1024, 4, 4, 256),     # c4 and the reduced c5
    (1024, 2, 2, 512),
    (1152, 8, 5, 256),                        # 9 blocks: k = 2, not 8 ranks
    (1536, 8, 6, 256), (2080, 8, 6, 384),     # C > 1024: several blocks a rank
    (4096, 8, 8, 512), (70000, 8, 8, 8832)])
@pytest.mark.parametrize("dtype,d,s", [(torch.bfloat16, 8, 2),
                                       (torch.float32, 2, 1)])
def test_split_plan_takes_whole_channel_blocks(c, max_ranks, ranks,
                                               channels, dtype, d, s):
    """The split forward's clusters: at most 8 ranks, each a contiguous run
    of k = ceil(nblk / cap) whole 128-channel blocks, ceil(nblk / k) ranks
    so that none is empty, together covering C exactly; any C is taken.
    Here no form fills the card and the card holds none of more than
    `max_ranks` ranks, so the plan is the most ranks under that cap."""
    def occupancy(n, ch):
        return 1, (2 if n <= max_ranks else 0)

    plan = tcorr.split_plan(c, dtype, d, s, occupancy)
    assert (plan.ranks, plan.channels) == (ranks, channels)
    assert plan.body == tcorr.correlation_body(dtype, d, s)
    assert 1 <= plan.ranks <= max_ranks <= 8 and plan.channels % 128 == 0
    runs = [(r * plan.channels, min(c, (r + 1) * plan.channels))
            for r in range(plan.ranks)]
    assert runs[0][0] == 0 and runs[-1][1] == c
    assert all(lo < hi for lo, hi in runs)


# clusters a 132-SM H100 holds at once (cudaOccupancyMaxActiveClusters) by
# ranks a cluster, for the main path's window: one 178 KB block an SM on
# the tensor cores, a few small ones on the CUDA cores
_RESIDENT = {"tensor_cores": {1: 132, 2: 66, 4: 30, 8: 15},
             "cuda_cores": {1: 528, 2: 264, 4: 124, 8: 62}}


@pytest.mark.parametrize("dtype,d,s,body", [
    (torch.bfloat16, 8, 2, "tensor_cores"),   # the main path's window
    (torch.bfloat16, 16, 4, "cuda_cores"),    # past the band
    (torch.float32, 8, 2, "cuda_cores")])
def test_split_plan_body_and_default_ranks(dtype, d, s, body):
    """The plan takes the fewest ranks whose launch fills the card (as many
    clusters as the card holds at once), else the most: at one pair of
    38x68 maps (40 tiles on the tensor cores, 114 on the CUDA cores) 4 and
    8 ranks of 128 channels at C = 512 | 1024, at 16 pairs (640 and 1,824
    tiles) one rank; forms the card cannot hold are passed over. The body
    is ``correlation_body``'s, as in the unsplit forward; C < 1 raises."""
    resident = _RESIDENT[body]
    tiles = 40 if body == "tensor_cores" else 114

    def occupancy(pairs, held=resident):
        return lambda n, ch: (pairs * tiles, held.get(n, 0))

    fill = {1024: 4 if body == "tensor_cores" else 8, 512: 4}
    for c in (512, 1024):
        assert tcorr.split_plan(c, dtype, d, s, occupancy(1)) == (
            body, fill[c], c // fill[c])
        assert tcorr.split_plan(c, dtype, d, s, occupancy(16)) == (body, 1, c)
    # none of 8 ranks held: 4; the whole grid fills the card at 2 ranks: 2
    assert tcorr.split_plan(1024, dtype, d, s,
                            occupancy(1, {1: 9999, 2: 9999, 4: 9999})) == (
        body, 4, 256)
    assert tcorr.split_plan(1024, dtype, d, s,
                            occupancy(1, {1: 9999, 2: 1, 4: 1, 8: 1})) == (
        body, 2, 512)
    with pytest.raises(ValueError, match="C >= 1"):
        tcorr.split_plan(0, dtype, d, s, occupancy(1))


def test_correlation_bf16_matches_pallas_mm():
    """bfloat16 in and out, f32 sums in both: the results differ by the
    final rounding to bf16, one bf16 ulp of values below 1 (4e-3)."""
    rng = np.random.RandomState(3)
    f1 = rng.randn(2, 12, 20, 64).astype(np.float32)
    f2 = rng.randn(2, 12, 20, 64).astype(np.float32)
    jb1, jb2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    want = jax.vmap(lambda a, b: correlation_pallas_mm(a, b, 8, 2))(
        jb1, jb2)
    got = tcorr.correlation(_t(f1).bfloat16(), _t(f2).bfloat16(), 8, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=4e-3)


# ------------------------------------------------------------------ PSRoI

# the main path's D (fused maps 43; cls 31, bbox 8, track 4) at k = 7 and 3
POOL_KD = [(k, d) for k in (7, 3) for d in (43, 31, 8, 4)]


def _psroi_case(rng, b=2, h=10, w=14, k=7, d=43, n=16):
    maps = rng.randn(b, h, w, k * k * d).astype(np.float32)
    stride = 16.0
    rois = []
    for _ in range(b):
        r = np.stack([rng.uniform(0, w * stride, n), rng.uniform(0, h * stride, n)],
                     axis=1)
        r = np.concatenate([r, r + rng.uniform(8, 120, (n, 2))], axis=1)
        r[0] = [0, 0, w * stride - 1, h * stride - 1]        # the whole map
        r[1] = [40.5, 23.5, 72.5, 88.5]                      # half-integers
        r[2] = [41.5, 24.5, 41.5, 24.5]                      # degenerate
        r[3] = [300.0, 200.0, 500.0, 400.0]                  # past the map
        r[4] = [-30.0, -20.0, 15.5, 8.5]                     # before the map
        rois.append(r)
    return maps, np.stack(rois).astype(np.float32)


def test_roi_bounds_match():
    maps, rois = _psroi_case(np.random.RandomState(0))
    got = tpsroi.roi_bounds(_t(rois), 1 / 16, 7, 10, 14)
    want = jax.vmap(lambda r: _roi_bounds(r, 1 / 16, 7, 10, 14))(
        jnp.asarray(rois))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("k,d", POOL_KD)
def test_psroi_direct_matches_pallas_f32(k, d):
    """float32: same sums of the same values, another order (1e-5)."""
    maps, rois = _psroi_case(np.random.RandomState(1), k=k, d=d)
    got = tpsroi.psroi_pool_batched_direct(_t(maps), _t(rois), 1 / 16, k)
    want = psroi_pool_batched_direct(jnp.asarray(maps),
                                            jnp.asarray(rois), 1 / 16, k)
    assert got.shape == (2, 16, k, k, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert (got[:, 3] == 0).all()                     # bins past the map
    # Caffe channel order c = (d*k + ph)*k + pw vs bin-major here
    h, w = maps.shape[1:3]
    maps_caffe = maps[0].reshape(h, w, k * k, d).transpose(3, 2, 0, 1)
    caffe = psroi_pool_caffe(maps_caffe.reshape(-1, h, w), rois[0], 1 / 16, k)
    caffe = caffe.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got[0].numpy(), caffe, rtol=0, atol=1e-5)


def test_psroi_direct_matches_pallas_bf16():
    """bfloat16 maps: the TPU kernel rounds its row partial sums to bf16
    before the column sum (dtt/ops/psroi.py:409); the port keeps f32 sums.
    The means of O(1) values then differ by up to a few bf16 ulps (3e-2)."""
    maps, rois = _psroi_case(np.random.RandomState(2))
    got = tpsroi.psroi_pool_batched_direct(_t(maps).bfloat16(), _t(rois),
                                           1 / 16, 7)
    want = psroi_pool_batched_direct(jnp.asarray(maps, jnp.bfloat16),
                                            jnp.asarray(rois), 1 / 16, 7)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=3e-2)


# ------------------------------------------------------------------ gradients

def _cotangent(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("d,s", [(2, 1), (8, 2)])
def test_correlation_grad_matches_pallas_mm_vjp_f32(d, s):
    """The plain backward, through ``correlation``'s autograd, against
    jax.vjp of dtt's training correlation: float32, sums of up to 81
    products of O(1) values in another order (1e-5)."""
    rng = np.random.RandomState(10 + d)
    f1, f2 = (_t(rng.randn(2, 12, 20, 64).astype(np.float32))
              for _ in range(2))
    g = _cotangent(rng, (2, 12, 20, tcorr.num_corr_channels(d, s)))
    _, vjp = jax.vjp(jax.vmap(lambda a, b: correlation_pallas_mm(a, b, d, s)),
                     jnp.asarray(f1.numpy()), jnp.asarray(f2.numpy()))
    want = vjp(jnp.asarray(g.numpy()))
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    tcorr.correlation(a, b, d, s).backward(g)
    direct = tcorr.correlation_bwd_plain(f1, f2, g, d, s)
    for got, plain, w_ in zip((a.grad, b.grad), direct, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("d,s", [(2, 1), (8, 2)])
def test_correlation_grad_matches_pallas_mm_vjp_bf16(d, s):
    """bfloat16 maps and cotangent: dtt rounds its banded products to bf16
    inside the einsum AD, the port sums in f32 and rounds once; the
    gradients differ by a few bf16 ulps (8e-3 of the largest seen; held at
    2e-2 of the largest)."""
    rng = np.random.RandomState(12)
    f1, f2 = (_t(rng.randn(2, 12, 20, 64).astype(np.float32)).bfloat16()
              for _ in range(2))
    g = _cotangent(rng, (2, 12, 20, tcorr.num_corr_channels(d, s)),
                   torch.bfloat16)
    _, vjp = jax.vjp(jax.vmap(lambda a, b: correlation_pallas_mm(a, b, d, s)),
                     jnp.asarray(f1.float().numpy(), jnp.bfloat16),
                     jnp.asarray(f2.float().numpy(), jnp.bfloat16))
    want = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    got = tcorr.correlation_bwd_plain(f1, f2, g, d, s)
    for x, w_ in zip(got, want):
        assert x.dtype == torch.bfloat16
        w_ = _np(w_)
        np.testing.assert_allclose(_np(x), w_, rtol=0,
                                   atol=2e-2 * np.abs(w_).max())


def _pool_grads(maps, rois, g, k=7):
    """dtt's training pool VJP (Pallas backward, interpret mode) and the
    port's, through autograd, for the same cotangent."""
    jdtype = jnp.bfloat16 if maps.dtype == torch.bfloat16 else jnp.float32
    jmaps = jnp.asarray(maps.float().numpy(), jdtype)
    _, vjp = jax.vjp(lambda f: psroi_pool_batched_direct_ad(
        f, jnp.asarray(rois), 1 / 16, k), jmaps)
    (want,) = vjp(jnp.asarray(g.float().numpy(), jmaps.dtype))
    m = maps.clone().requires_grad_()
    tpsroi.psroi_pool_batched_direct(m, _t(rois), 1 / 16, k).backward(g)
    return m.grad, want


@pytest.mark.parametrize("k,d", POOL_KD)
def test_psroi_direct_grad_matches_pallas_f32(k, d):
    """float32: each map gradient is a sum of ghat over the bins holding
    the pixel, in another order (1e-5). Half-integer, degenerate, off-map
    and whole-map RoIs."""
    rng = np.random.RandomState(5)
    maps, rois = _psroi_case(rng, k=k, d=d)
    g = _cotangent(rng, (2, 16, k, k, d))
    got, want = _pool_grads(_t(maps), rois, g, k)
    assert got.dtype == torch.float32 and got.shape == maps.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    hs, he, ws, we = tpsroi.roi_bounds(_t(rois), 1 / 16, k, 10, 14)
    area = tpsroi.bin_areas(hs, he, ws, we)[..., None]
    ghat = torch.where(area > 0, g / area.clamp(min=1.0), 0.0)
    plain = tpsroi.psroi_bwd_plain(ghat, hs, he, ws, we, 10, 14,
                                   torch.float32)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_pool_vote_refuses_other_impls():
    """The train pool takes dtt's two forms, "direct" and "gather"; any
    other name raises, as dtt asserts."""
    from dtt_torch.models.dnt import pool_vote_batched
    maps, rois = _psroi_case(np.random.RandomState(0), d=4)
    for impl in ("direct", "gather"):
        out = pool_vote_batched(tcfg.Config().model, _t(maps), _t(rois),
                                1 / 16, impl)
        assert out.shape == (2, 16, 4)
    for impl in ("pallas_mm", "xla"):
        with pytest.raises(ValueError, match="unknown batched psroi impl"):
            pool_vote_batched(tcfg.Config().model, _t(maps), _t(rois),
                              1 / 16, impl)


def test_psroi_direct_grad_matches_pallas_bf16():
    """bfloat16 maps: dtt's kernel rounds ghat and its column-masked
    expansion to bf16 before the MXU contraction, the port keeps ghat in
    f32 and rounds the sum once, so gradients differ by about one bf16 ulp
    of the largest (9e-4 of it seen; held at 4e-3 of it)."""
    rng = np.random.RandomState(6)
    maps, rois = _psroi_case(rng, d=8)
    g = _cotangent(rng, (2, 16, 7, 7, 8), torch.bfloat16)
    got, want = _pool_grads(_t(maps).bfloat16(), rois, g)
    assert got.dtype == torch.bfloat16
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=4e-3 * np.abs(want).max())


# ------------------------------------------------------------------ wrappers

def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the dispatchers run the plain versions (no launch is
    counted); the kernel wrappers refuse tensors that are not on CUDA."""
    f = torch.zeros(1, 4, 6, 8)
    before = (tcorr.correlation_cuda.launches, tpsroi.psroi_sums_cuda.launches)
    tcorr.correlation(f, f, 2, 1)
    b = torch.zeros(1, 2, 3, dtype=torch.int32)
    tpsroi.psroi_sums(torch.zeros(1, 4, 6, 9 * 2), b, b, b, b)
    assert (tcorr.correlation_cuda.launches,
            tpsroi.psroi_sums_cuda.launches) == before
    with pytest.raises(ValueError):
        tcorr.correlation_cuda(f, f, 2, 1)
    with pytest.raises(ValueError):
        tpsroi.psroi_sums_cuda(torch.zeros(1, 4, 6, 18), b, b, b, b)


def test_kernel_build_targets_hopper():
    from dtt_torch.ops import _build
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR


def test_kernel_library_name_hashes_headers(tmp_path, monkeypatch):
    """A library is named by its source and every csrc header: adding or
    changing a header renames it, so a stale build is never loaded."""
    from dtt_torch.ops import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// source\n")
    names = [_build.library_path("k")]
    (tmp_path / "band.cuh").write_text("// header\n")
    names.append(_build.library_path("k"))
    (tmp_path / "band.cuh").write_text("// header, changed\n")
    names.append(_build.library_path("k"))
    assert len(set(names)) == 3
    assert names[-1] == _build.library_path("k")


# ------------------------------------------------------------------ hygiene

def test_import_leaves_out_jax_and_dtt():
    """Importing dtt_torch, every submodule (the data-parallel
    ``dtt_torch.parallel`` and the timing helpers of ``dtt_torch.utils``
    among them), chip_smoke, train_torch, eval_torch, demo_torch,
    bench_torch, the tree writer chip_smoke runs (with their lazily
    imported modules) and the accuracy tools (run_mid_synth_torch,
    run_hard_bench_torch, run_flagship_synth_torch and what measures them),
    the diagnosis probes (probe_dead_snippet_torch, probe_tau2_torch and
    flagship_probes_torch, which runs them) and the trunk's profile split
    (trunk_split_torch; the conv epilogue ``dtt_torch.ops.epilogue``
    and the step programs ``dtt_torch.utils.programs`` among the
    submodules), the launch-bound paths' A/B
    (host_ab_torch), and kernel 10's host split and device timings
    (epilogue_host_torch, epilogue_device_torch) pulls in no JAX, flax,
    dtt,
    eval.py, demo.py, bench.py, cv2 or msgpack module, and none of dtt's
    accuracy tools or probes."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dtt_torch\n"
        "for m in pkgutil.walk_packages(dtt_torch.__path__, 'dtt_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, train_torch, eval_torch, demo_torch, bench_torch\n"
        "chip_smoke.vid_tree_writer()\n"
        "sys.path.insert(0, 'tools')\n"
        "import run_mid_synth_torch, run_hard_bench_torch\n"
        "import run_flagship_synth_torch, accuracy_runs_torch\n"
        "import checkpoint_bf16_torch, sanitize_linking_torch\n"
        "import compare_detections_torch\n"
        "import probe_dead_snippet_torch, probe_tau2_torch\n"
        "import flagship_probes_torch, trunk_split_torch\n"
        "import host_ab_torch, epilogue_host_torch, epilogue_device_torch\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dtt',\n"
        "                                    'eval', 'demo', 'bench', 'cv2',\n"
        "                                    'msgpack', 'run_mid_synth',\n"
        "                                    'run_hard_bench',\n"
        "                                    'run_flagship_synth',\n"
        "                                    'probe_dead_snippet',\n"
        "                                    'probe_tau2'))\n"
        "assert not bad, bad\n"
        "assert {'dtt_torch.parallel.mesh', 'dtt_torch.utils.timing',\n"
        "        'dtt_torch.utils.profiling',\n"
        "        'dtt_torch.ops.epilogue',\n"
        "        'dtt_torch.utils.programs'} <= set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('dtt_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 45


def test_entry_points_raise_without_gpu(monkeypatch):
    """Called without device="cpu" on a machine with no GPU, every entry
    point raises instead of running on the CPU; the prefetcher raises on
    the CPU too."""
    from dtt_torch.eval.inference import (link_snippet, make_pair_step,
                                          make_video_step)
    from dtt_torch.models.dnt import make_model
    from dtt_torch.train.trainer import create_train_state, make_train_step
    from dtt_torch.utils.params import from_jax_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.Config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(cfg.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params({"params": {}}, cfg.model)
    model = make_model(cfg.model.replace(backbone="tiny"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_video_step(cfg, model, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pair_step(cfg, model, 4)
    box = np.zeros((1, 2, 3, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        link_snippet(cfg, box, box[..., 0], box, box[..., 0] > 0)
    tiny = cfg.replace(model=cfg.model.replace(backbone="tiny"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(tiny)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(tiny, model, (38, 68))
    from dtt_torch.data.device_synth import make_pair_render_fn, render_pairs
    from dtt_torch.data.loader import device_prefetch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pair_render_fn(64, 96)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_pairs(box, np.zeros((1, 3), np.int32), box[..., 0] > 0, None,
                     64, 96)
    for device in (None, "cpu"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            device_prefetch(iter([]), device)
    from dtt_torch.parallel import data_mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_mesh()


@pytest.mark.parametrize("flags", [
    ["--synthetic", "--pretrained", "x"], ["--synthetic", "--calibrate-bn"]])
def test_train_torch_refuses_what_is_not_ported(flags):
    """train_torch.py takes every option train.py takes: --pretrained and
    --calibrate-bn are accepted (no usage error, no "not ported") and the
    command goes on to ask for a card."""
    out = subprocess.run([sys.executable, "train_torch.py", *flags], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr
    assert "not ported" not in out.stderr and "usage:" not in out.stderr


@pytest.mark.parametrize("flags", [["--synthetic", "--parallel"]])
def test_eval_torch_refuses_what_is_not_ported(flags):
    """eval_torch.py takes every option eval.py takes: --parallel is
    accepted (no usage error, no "not ported") and, without torchrun,
    goes on to make a group of one rank on the card, so here it asks for
    one. (tests/test_torch_port_parallel.py runs it on the CPU.)"""
    out = subprocess.run([sys.executable, "eval_torch.py", "--checkpoint",
                          os.devnull, *flags], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr
    assert "not ported" not in out.stderr and "usage:" not in out.stderr


@pytest.mark.parametrize("script,flags,rc,message", [
    ("train_torch.py", ["--device-render"], 2,
     "--device-render only applies to --synthetic training"),
    ("train_torch.py", ["--dataset", "imagenet_vid_train"], 1,
     "--data-root required without --synthetic"),
    ("train_torch.py", ["--synthetic", "--data-root", "/data"], 1,
     "no CUDA device"),
    ("train_torch.py", [], 1, "--data-root required without --synthetic"),
    ("eval_torch.py", ["--dataset", "imagenet_vid_val"], 1,
     "--data-root required without --synthetic"),
    ("eval_torch.py", ["--synthetic", "--data-root", "/data"], 1,
     "no CUDA device"),
    ("eval_torch.py", [], 1, "--data-root required without --synthetic")])
def test_data_options_behave_as_dtt(script, flags, rc, message):
    """The data options train.py and eval.py take are accepted: a dataset
    needs --data-root (train.py's message, exit 1), --device-render needs
    --synthetic (train.py's usage error, exit 2), and an accepted command
    goes on to ask for a card."""
    ck = ["--checkpoint", os.devnull] if script == "eval_torch.py" else []
    out = subprocess.run([sys.executable, script, *ck, *flags], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == rc
    assert message in out.stderr
    assert "not ported" not in out.stderr


def test_eval_torch_raises_without_gpu(monkeypatch, tmp_path):
    """Without a card, eval_torch.py --synthetic raises instead of
    evaluating on the CPU."""
    import eval_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_torch.main(["--synthetic", "--checkpoint", str(tmp_path)])


def test_train_torch_raises_without_gpu(monkeypatch):
    """Without a card, train_torch.py --synthetic raises instead of
    training on the CPU."""
    import train_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_torch.main(["--synthetic", "--out", os.devnull])
