"""dtt_torch's per-frame op surface and single-frame detection held against
dtt's on the CPU: ``psroi_pool`` and ``correlation`` under every ``impl``,
``nms_gather``, ``pool_vote``, ``rfcn_head``, ``track_rois``,
``detect_frame``, the batched detection and tracking pools,
``decode_frame_detections`` and ``make_single_frame_step``.

Inputs are made with numpy from a seed and given to both packages. On the
CPU each dtt_torch kernel wrapper runs its plain PyTorch version; dtt's
Pallas kernels run in interpret mode, as its own tests run them. dtt's pools
run eagerly: jitted, dtt can put a bin bound across an integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtt.core.anchors import grid_anchors_for
from dtt.eval import inference as jinf
from dtt.models import dnt as jdnt
from dtt.ops.correlation import correlation as jcorrelation
from dtt.ops import nms as jnms
from dtt.ops import psroi as jpsroi
from tests.test_models import tiny_config
from tests.test_torch_port_eval import _sat_atol, _sat_case, torch_config

from dtt_torch.eval import inference as tinf
from dtt_torch.models import dnt as tdnt
from dtt_torch.ops import correlation as tcorr
from dtt_torch.ops import nms as tnms
from dtt_torch.ops import psroi as tpsroi
from dtt_torch.utils.params import from_jax_params, init_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96
POOL_IMPLS = ("xla", "mm", "pallas_mm", "pallas")
CORR_IMPLS = ("xla", "mm", "mm_diag", "pallas", "pallas_mm")
BF16_ULP = 2.0 ** -7       # one bf16 ulp relative to |x| (8 mantissa bits)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ psroi_pool

K = 3                      # bins per side of the per-frame pool cases


def _frame_case(seed, d=9):
    """One frame's f32 maps (10, 14, K*K*d) and 24 RoIs, among them the
    whole map, half-integers, zero-area bins, a box past the map and boxes
    across its edges (``_sat_case``)."""
    maps, rois = _sat_case(seed, b=1, k=K, d=d)
    return maps[0], rois[0]


@pytest.mark.parametrize("impl", POOL_IMPLS)
def test_psroi_pool_matches_dtt(impl):
    """Each form against dtt's same ``impl``: values at rtol 1e-5 with the
    SAT-sized atol (``_sat_atol``); the map gradient (dtt: AD of the form,
    or the xla scatter-add its ``custom_vjp`` pins) at 1e-5 of the largest;
    the RoIs get none."""
    maps, rois = _frame_case(11)
    g = np.random.RandomState(12).randn(24, K, K, 9).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jpsroi.psroi_pool(
        f, jnp.asarray(rois), 1 / 16, K, impl), jnp.asarray(maps))
    (want_grad,) = vjp(jnp.asarray(g))
    m = _t(maps).requires_grad_()
    r = _t(rois).requires_grad_()
    got = tpsroi.psroi_pool(m, r, 1 / 16, K, impl)
    got.backward(_t(g))
    assert got.shape == (24, K, K, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=_sat_atol(maps[None]))
    assert (got[3] == 0).all()                       # past the map: empty
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(m.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())
    assert r.grad is None or not r.grad.any()


def test_psroi_pool_bf16_matches_dtt():
    """bfloat16 maps, every form: both sides pool in f32 and round once to
    bf16, so values differ by one bf16 ulp (rtol 2^-7) beside the SAT's
    f32 error; map gradients (f32 sums of g/area rounded to bf16) by one
    bf16 ulp of the largest."""
    maps, rois = _frame_case(13, d=4)
    g = np.random.RandomState(14).randn(24, K, K, 4).astype(np.float32)
    jmaps = jnp.asarray(maps, jnp.bfloat16)
    for impl in POOL_IMPLS:
        want, vjp = jax.vjp(lambda f: jpsroi.psroi_pool(
            f, jnp.asarray(rois), 1 / 16, K, impl), jmaps)
        (want_grad,) = vjp(jnp.asarray(g, jnp.bfloat16))
        m = _t(maps).bfloat16().requires_grad_()
        got = tpsroi.psroi_pool(m, _t(rois), 1 / 16, K, impl)
        got.backward(_t(g).bfloat16())
        assert got.dtype == m.grad.dtype == torch.bfloat16, impl
        np.testing.assert_allclose(_np(got.detach()), _np(want),
                                   rtol=BF16_ULP,
                                   atol=_sat_atol(maps[None]), err_msg=impl)
        want_grad = _np(want_grad)
        np.testing.assert_allclose(_np(m.grad), want_grad, rtol=0,
                                   atol=BF16_ULP * np.abs(want_grad).max(),
                                   err_msg=impl)


def test_psroi_sat_means_plain_is_the_gather_form():
    """Kernel 6's plain version is the xla form's arithmetic to the bit:
    ``psroi_pool_pallas`` and ``psroi_pool_xla`` give the same bits."""
    maps, rois = _frame_case(15)
    got = tpsroi.psroi_pool(_t(maps), _t(rois), 1 / 16, K, "pallas")
    want = tpsroi.psroi_pool(_t(maps), _t(rois), 1 / 16, K, "xla")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_psroi_pool_refuses_unknown_impl():
    maps, rois = _frame_case(0)
    with pytest.raises(ValueError, match="unknown psroi impl"):
        tpsroi.psroi_pool(_t(maps), _t(rois), 1 / 16, K, "direct")


# ---------------------------------------------------------------- correlation

CORR_CASES = {"c64_d8s2": ((2, 12, 20, 64), 8, 2),
              # two 128-channel blocks of _corr_kernel, the second padded
              "c160_d2s1": ((2, 7, 11, 160), 2, 1),
              # three blocks, the last padded (C % 8 != 0)
              "c300_d2s1": ((1, 5, 7, 300), 2, 1),
              # nine blocks: several a rank in the port's split clusters
              "c1152_d8s2": ((1, 6, 9, 1152), 8, 2)}


def _corr_maps(case, seed):
    shape, d, s = CORR_CASES[case]
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32), d, s)


def _dtt_corr(impl, d, s):
    """dtt's per-frame correlation vmapped over the pairs, jitted (the
    eager shifted form dispatches 81 slices one by one)."""
    return jax.jit(jax.vmap(lambda a, b: jcorrelation(a, b, d, s, impl)))


@pytest.mark.parametrize("case", sorted(CORR_CASES))
@pytest.mark.parametrize("impl", CORR_IMPLS)
def test_correlation_matches_dtt(impl, case):
    """float32, each form against dtt's same ``impl`` (vmapped over the
    pairs): the same products summed in another order, 1e-5."""
    f1, f2, d, s = _corr_maps(case, 20)
    got = tcorr.correlation(_t(f1), _t(f2), d, s, impl)
    want = _dtt_corr(impl, d, s)(jnp.asarray(f1), jnp.asarray(f2))
    assert got.shape == (*f1.shape[:3], tcorr.num_corr_channels(d, s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("impl", CORR_IMPLS)
def test_correlation_bf16_matches_dtt(impl):
    """bfloat16 in and out, f32 sums on both sides: the results differ by
    the final rounding, one bf16 ulp of values below 1 (4e-3)."""
    f1, f2, d, s = _corr_maps("c160_d2s1", 21)
    got = tcorr.correlation(_t(f1).bfloat16(), _t(f2).bfloat16(), d, s, impl)
    want = _dtt_corr(impl, d, s)(jnp.asarray(f1, jnp.bfloat16),
                                 jnp.asarray(f2, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=4e-3)


@pytest.mark.parametrize("case", sorted(CORR_CASES))
@pytest.mark.parametrize("impl", CORR_IMPLS)
def test_correlation_grad_matches_dtt(impl, case):
    """float32 gradients of both maps through each form's autograd against
    jax.vjp of dtt's same ``impl`` (the Pallas forms: the mm form's AD,
    which dtt pins both to): sums of up to 81 products in another order,
    1e-5."""
    f1, f2, d, s = _corr_maps(case, 22)
    g = np.random.RandomState(23).randn(
        *f1.shape[:3], tcorr.num_corr_channels(d, s)).astype(np.float32)
    _, vjp = jax.vjp(_dtt_corr(impl, d, s), jnp.asarray(f1), jnp.asarray(f2))
    want = vjp(jnp.asarray(g))
    a, b = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    tcorr.correlation(a, b, d, s, impl).backward(_t(g))
    for got, w_ in zip((a.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-5)


def test_correlation_pallas_grad_bf16_matches_dtt():
    """bfloat16: dtt rounds its banded products to bf16 inside the mm form's
    AD, the port sums in f32 and rounds once (2e-2 of the largest)."""
    f1, f2, d, s = _corr_maps("c160_d2s1", 24)
    g = np.random.RandomState(25).randn(
        *f1.shape[:3], tcorr.num_corr_channels(d, s)).astype(np.float32)
    _, vjp = jax.vjp(_dtt_corr("pallas", d, s), jnp.asarray(f1, jnp.bfloat16),
                     jnp.asarray(f2, jnp.bfloat16))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    a = _t(f1).bfloat16().requires_grad_()
    b = _t(f2).bfloat16().requires_grad_()
    tcorr.correlation(a, b, d, s, "pallas").backward(_t(g).bfloat16())
    for got, w_ in zip((a.grad, b.grad), want):
        assert got.dtype == torch.bfloat16
        w_ = _np(w_)
        np.testing.assert_allclose(_np(got), w_, rtol=0,
                                   atol=2e-2 * np.abs(w_).max())


def test_correlation_refuses_unknown_impl_and_shapes():
    f = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError, match="unknown correlation impl"):
        tcorr.correlation(f, f, 2, 1, "direct")
    with pytest.raises(ValueError, match="one shape"):
        tcorr.correlation(f, torch.zeros(1, 4, 6, 4), 2, 1)


# ------------------------------------------------------------------ nms_gather

@pytest.mark.parametrize("seed", [0, 1])
def test_nms_gather_matches_dtt(seed):
    """Kept boxes, scores and validity equal, per batch row, with tied
    scores, invalid inputs and a score threshold."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 80, (3, 40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (3, 40, 2))],
                           axis=-1).astype(np.float32)
    scores = rng.choice([0.9, 0.5, 0.5, 0.3, 0.05], (3, 40)).astype(
        np.float32)
    valid = rng.rand(3, 40) > 0.2
    got = tnms.nms_gather(_t(boxes), _t(scores), 0.4, 30, _t(valid), 0.1)
    for i in range(3):
        want = jnms.nms_gather(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                               0.4, 30, jnp.asarray(valid[i]), 0.1)
        for name, g_, w_ in zip(("boxes", "scores", "valid"), got, want):
            np.testing.assert_array_equal(g_[i].numpy(), np.asarray(w_),
                                          err_msg=name)
    assert got[2].any() and not got[2].all()


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def setup():
    """The tiny config on a 64x96 canvas, dtt's model with numpy-drawn
    weights and the same weights in the port; dtt's ``frame_features`` of
    two frames and the track maps of the pair."""
    cfg = tiny_config()
    cfg = cfg.replace(input=cfg.input.replace(canvas_height=H, canvas_width=W))
    model = jdnt.make_model(cfg.model)
    params = init_jax_params(torch_config(cfg).model, seed=2)
    tmodel = from_jax_params(params, torch_config(cfg).model, device="cpu")
    images = np.random.RandomState(1).randn(2, H, W, 3).astype(np.float32) * 50
    feats = jax.jit(lambda p, x: model.apply(
        p, x, method=jdnt.DnT.frame_features))(params, jnp.asarray(images))
    f_t = jax.tree.map(lambda x: x[:1], feats)
    f_tau = jax.tree.map(lambda x: x[1:], feats)
    track = model.apply(params, f_t, f_tau, method=jdnt.DnT.track_psmaps)
    rois = np.random.RandomState(3).uniform(0, 60, (2, 10, 2))
    rois = np.concatenate([rois, rois + np.random.RandomState(4).uniform(
        0, 50, (2, 10, 2))], axis=-1).astype(np.float32)
    rois[:, 0] = [0, 0, W - 1, H - 1]
    rois[:, 1] = [20.5, 8.5, 40.5, 30.5]
    return dict(cfg=cfg, tcfg=torch_config(cfg), model=model, params=params,
                tmodel=tmodel, feats=feats, track=track, rois=rois,
                anchors=grid_anchors_for(cfg.model.anchors, H // 16, W // 16))


def _torch_feats(feats):
    return tdnt.FrameFeats(_t(feats.rpn_cls), _t(feats.rpn_bbox),
                           _t(feats.reduced), {}, _t(feats.cls_maps),
                           _t(feats.bbox_maps))


@pytest.mark.parametrize("impl", POOL_IMPLS)
def test_rfcn_head_and_track_rois_match_dtt(setup, impl):
    """``rfcn_head`` under each ``impl`` (``pool_vote`` of the cls and bbox
    maps) and ``track_rois``, on dtt's maps: rtol 1e-5 with the SAT-sized
    atol of the maps voted on."""
    cfg, tcfg_, feats = setup["cfg"], setup["tcfg"], setup["feats"]
    rois = setup["rois"][1]
    want = jdnt.rfcn_head(cfg.model, feats.cls_maps[1], feats.bbox_maps[1],
                          jnp.asarray(rois), 1 / 16, impl)
    got = tdnt.rfcn_head(tcfg_.model, _t(feats.cls_maps[1]),
                         _t(feats.bbox_maps[1]), _t(rois), 1 / 16, impl)
    for g_, w_, maps in zip(got, want, (feats.cls_maps, feats.bbox_maps)):
        assert g_.shape == w_.shape
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=_sat_atol(np.asarray(maps)))
    track = setup["track"]
    want = jdnt.track_rois(cfg.model, track, jnp.asarray(rois))
    got = tdnt.track_rois(tcfg_.model, _t(track), _t(rois))
    assert got.shape == (10, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=_sat_atol(np.asarray(track)))


def test_pool_vote_refuses_other_pooling_modes(setup):
    """An unknown pooling mode is refused; align, pool and crop pool a
    frame's maps as dtt's pool_vote does (eager), to 1e-5."""
    cfg = setup["tcfg"].model
    with pytest.raises(ValueError, match="pooling_mode"):
        tdnt.make_model(cfg.replace(roi=cfg.roi.replace(pooling_mode="x")),
                        device="cpu")
    maps = setup["feats"].cls_maps[0]
    for mode in ("align", "pool", "crop"):
        tc = cfg.replace(roi=cfg.roi.replace(pooling_mode=mode))
        jc = setup["cfg"].model.replace(
            roi=setup["cfg"].model.roi.replace(pooling_mode=mode))
        want = jdnt.pool_vote(jc, maps, jnp.asarray(setup["rois"][0]), 1 / 16)
        got = tdnt.pool_vote(tc, _t(maps), _t(setup["rois"][0]), 1 / 16)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=mode)


def _assert_detections(tprops, tdet, jprops, jdet):
    """Proposal validity equal, proposals to float32 roundoff of the box
    decode, class probabilities and box deltas at rtol 1e-4, atol 1e-4
    (tests/test_fused_heads.py's tolerances)."""
    np.testing.assert_array_equal(tprops.valid.numpy(),
                                  np.asarray(jprops.valid))
    np.testing.assert_allclose(tprops.rois.numpy(), np.asarray(jprops.rois),
                               rtol=1e-6, atol=1e-4)
    for name in ("cls_prob", "bbox_pred"):
        np.testing.assert_allclose(getattr(tdet, name).numpy(),
                                   np.asarray(getattr(jdet, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_detect_frame_matches_dtt(setup):
    """``detect_frame`` on frame 1 of dtt's features, with a partial image
    extent."""
    cfg, feats, anchors = setup["cfg"], setup["feats"], setup["anchors"]
    jprops, jdet = jdnt.detect_frame(cfg.model, feats, jnp.asarray(anchors),
                                     56.0, 80.0, 1.0, frame_idx=1)
    tprops, tdet = tdnt.detect_frame(setup["tcfg"].model, _torch_feats(feats),
                                     _t(anchors), 56.0, 80.0, 1.0,
                                     frame_idx=1)
    assert tdet.cls_prob.shape == (16, 4) and tprops.rois.shape == (16, 4)
    _assert_detections(tprops, tdet, jprops, jdet)
    assert tprops.valid.any()


def test_detect_frames_batched_and_track_rois_batched_match_dtt(setup):
    """The batched detection (gather pools) over both frames, and the
    batched tracking pool at the proposals of frame t."""
    cfg, feats, anchors = setup["cfg"], setup["feats"], setup["anchors"]
    jprops, jdet = jdnt.detect_frames_batched(cfg.model, feats,
                                              jnp.asarray(anchors), 60.0,
                                              90.0, 1.0)
    tprops, tdet = tdnt.detect_frames_batched(setup["tcfg"].model,
                                              _torch_feats(feats),
                                              _t(anchors), 60.0, 90.0, 1.0)
    assert tdet.cls_prob.shape == (2, 16, 4)
    _assert_detections(tprops, tdet, jprops, jdet)
    track, rois = setup["track"], jprops.rois[:1]
    want = jdnt.track_rois_batched(cfg.model, track, rois)
    got = tdnt.track_rois_batched(setup["tcfg"].model, _t(track), _t(rois))
    assert got.shape == (1, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=_sat_atol(np.asarray(track)))


@pytest.mark.parametrize("with_track", [False, True])
def test_decode_frame_detections_matches_dtt(setup, with_track):
    """dtt's detections of frame 0 decoded by both: ``valid`` equal,
    boxes and scores to float32 roundoff, and each kept detection's
    tracked box with the same NMS selection."""
    cfg, feats, anchors = setup["cfg"], setup["feats"], setup["anchors"]
    ecfg = cfg.eval
    _, jdet = jdnt.detect_frame(cfg.model, feats, jnp.asarray(anchors), 56.0,
                                80.0, 1.0)
    deltas = (np.random.RandomState(6).randn(16, 4).astype(np.float32) * 0.1
              if with_track else None)
    args = (56.0, 80.0, ecfg.score_thresh, ecfg.nms_thresh,
            ecfg.max_per_class)
    want = jdnt.decode_frame_detections(
        cfg.model, jdet, *args,
        track_deltas=None if deltas is None else jnp.asarray(deltas))
    tdet = tdnt.Detections(*(_t(x) for x in jdet))
    got = tdnt.decode_frame_detections(
        setup["tcfg"].model, tdet, *args,
        track_deltas=None if deltas is None else _t(deltas))
    assert len(got) == len(want) == (4 if with_track else 3)
    c, m = cfg.model.num_classes - 1, ecfg.max_per_class
    assert got[0].shape == (c, m, 4) and got[2].shape == (c, m)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any()
    for i, atol in ((0, 1e-3), (1, 1e-6)) + (((3, 1e-3),) if with_track
                                              else ()):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-6, atol=atol)


# ------------------------------------------------------------------ single frame

def test_single_frame_step_matches_dtt(setup):
    """``make_single_frame_step`` against dtt's on a 64x96 uint8 frame with
    a partial ``im_hw``: ``valid`` equal, boxes to 1e-2 and scores to 1e-4
    (float32 roundoff of a whole network, as the video test)."""
    cfg, tcfg_ = setup["cfg"], setup["tcfg"]
    image = np.random.RandomState(7).randint(0, 256, (1, H, W, 3)).astype(
        np.uint8)
    im_hw = (56, 80)
    want = jinf.make_single_frame_step(cfg, setup["model"])(
        setup["params"], jnp.asarray(image), jnp.asarray(im_hw, jnp.float32),
        1.0)
    step = tinf.make_single_frame_step(tcfg_, setup["tmodel"], device="cpu")
    got = step(_t(image), im_hw, 1.0)
    c, m = cfg.model.num_classes - 1, cfg.eval.max_per_class
    assert got[0].shape == (c, m, 4) and got[1].shape == got[2].shape == (c, m)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any()
    for i, (name, atol) in enumerate((("boxes", 1e-2), ("scores", 1e-4))):
        assert np.isfinite(got[i].numpy()).all(), name
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=0, atol=atol, err_msg=name)
    assert got[0][..., 2].max() <= im_hw[1] - 1
    assert got[0][..., 3].max() <= im_hw[0] - 1


def test_single_frame_step_refuses_batches_and_needs_a_card(setup,
                                                             monkeypatch):
    """One image per call; without a card the step raises unless asked for
    the CPU."""
    step = tinf.make_single_frame_step(setup["tcfg"], setup["tmodel"],
                                       device="cpu")
    with pytest.raises(ValueError, match="one image"):
        step(torch.zeros(2, H, W, 3, dtype=torch.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.make_single_frame_step(setup["tcfg"], setup["tmodel"])


def test_new_kernel_wrappers_refuse_cpu_tensors():
    """On CPU tensors the dispatchers take the plain versions and count no
    launch; the kernel wrappers refuse CPU tensors instead of falling
    back."""
    maps, rois = _frame_case(8)
    table = tpsroi.sat(_t(maps)[None]).contiguous()
    bounds = [t[None].contiguous() for t in
              tpsroi.roi_bounds(_t(rois), 1 / 16, K, 10, 14)]
    f = torch.zeros(1, 4, 6, 8)
    before = (tpsroi.psroi_sat_means_cuda.launches,
              tpsroi.psroi_mm_sums_cuda.launches,
              tcorr.correlation_split_cuda.launches)
    tpsroi.psroi_sat_means(table, *bounds)
    tpsroi.psroi_pool(_t(maps), _t(rois), 1 / 16, K, "pallas")
    tpsroi.psroi_pool(_t(maps), _t(rois), 1 / 16, K, "pallas_mm")
    tcorr.correlation(f, f, 2, 1, "pallas")
    assert (tpsroi.psroi_sat_means_cuda.launches,
            tpsroi.psroi_mm_sums_cuda.launches,
            tcorr.correlation_split_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tpsroi.psroi_sat_means_cuda(table, *bounds)
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.correlation_split_cuda(f, f, 2, 1)
