"""dtt_torch's evaluation slice held against dtt's on the CPU: the
summed-area-table (SAT) PSRoI pools, the fused detection under each
``roi.eval_pool_impl``, the tau-strided pair step and snippet driver, tube
interpolation, VID mAP and the synthetic snippet generators.

Inputs are made with numpy from a seed and given to both packages. On the
CPU the SAT kernel's wrapper runs its plain PyTorch version; dtt's Pallas
kernels run in interpret mode, as its own tests run them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtt.core.anchors import grid_anchors_for
from dtt.data import synthetic as jsyn
from dtt.data import synthetic_hard as jhard
from dtt.eval import inference as jinf
from dtt.eval import vid_eval as jvid
from dtt.models import dnt as jdnt
from dtt.ops import psroi as jpsroi
from tests.test_models import tiny_config

from dtt_torch.core import config as tcfg
from dtt_torch.data import synthetic as tsyn
from dtt_torch.data import synthetic_hard as thard
from dtt_torch.eval import inference as tinf
from dtt_torch.eval import vid_eval as tvid
from dtt_torch.models import dnt as tdnt
from dtt_torch.ops import psroi as tpsroi
from dtt_torch.utils.params import from_jax_params, init_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96
IMPLS = ("direct", "pallas_mm", "gather")


def _t(x):
    return torch.from_numpy(np.array(x))


def torch_config(cfg):
    """The same config as a dtt_torch Config (one YAML-shaped dict)."""
    return tcfg._merge_into(tcfg.Config(), dataclasses.asdict(cfg))


def with_impl(cfg, impl):
    return cfg.replace(model=cfg.model.replace(
        roi=cfg.model.roi.replace(eval_pool_impl=impl)))


# ------------------------------------------------------------------ SAT pools

def _sat_case(seed, b=2, h=10, w=14, k=7, d=9, n=24):
    """f32 maps and RoIs on a (16h, 16w) canvas, with RoIs that cover the
    whole map, sit on .5 coordinates, have zero-area bins, lie past the
    map or cross its edges."""
    rng = np.random.RandomState(seed)
    maps = rng.randn(b, h, w, k * k * d).astype(np.float32)
    xy = rng.uniform(-40, w * 16, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 200, (b, n, 2))], axis=-1)
    rois[:, 0] = [0, 0, w * 16 - 1, h * 16 - 1]     # the whole map
    rois[:, 1] = [40.5, 23.5, 72.5, 88.5]           # half-integers
    rois[:, 2] = [41.5, 24.5, 41.5, 24.5]           # zero-area bins
    rois[:, 3] = [w * 16 + 60, h * 16 + 40, w * 16 + 200, h * 16 + 90]
    rois[:, 4] = [-30.0, -20.0, 100.5, 60.5]        # across the top left
    rois[:, 5] = [w * 8, h * 8, w * 16 + 90, h * 16 + 70]   # bottom right
    return maps, rois.astype(np.float32)


def _sat_atol(maps):
    """Both sides difference the same four corners of tables built by
    cumsums in different orders, so entries differ by a few float32 ulps
    of the table's largest entry: 8 of them (a bin mean divides that
    by its area, at least 1)."""
    table = tpsroi.sat(_t(maps))
    return 8 * np.finfo(np.float32).eps * table.abs().max().item()


def test_sat_matches_dtt():
    maps, _ = _sat_case(0)
    got = tpsroi.sat(_t(maps))
    want = jax.vmap(jpsroi._sat)(jnp.asarray(maps))
    assert got.shape == (2, 11, 15, 49 * 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=_sat_atol(maps))
    assert (got[:, 0] == 0).all() and (got[:, :, 0] == 0).all()


def test_sat_pool_matches_dtt_pallas_mm():
    """The "pallas_mm" pool: the plain bin sums off the SAT, divided by the
    area outside, against dtt's Pallas kernel in interpret mode (rtol
    1e-5, atol sized to the SAT, see ``_sat_atol``)."""
    maps, rois = _sat_case(1)
    got = tpsroi.psroi_pool_batched_pallas_mm(_t(maps), _t(rois), 1 / 16, 7)
    want = jpsroi.psroi_pool_batched_pallas_mm(jnp.asarray(maps),
                                               jnp.asarray(rois), 1 / 16, 7)
    assert got.shape == (2, 24, 7, 7, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=_sat_atol(maps))
    assert (got[:, 3] == 0).all()                    # past the map: empty
    # the direct pool's bin means, from the maps without a table
    direct = tpsroi.psroi_pool_batched_direct(_t(maps), _t(rois), 1 / 16, 7)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5,
                               atol=_sat_atol(maps))


def test_sat_sums_plain_is_the_four_corner_difference():
    """The one-hot indicator contractions add exact zeros beside their two
    nonzero terms, so the plain version equals, to the bit, the row-first
    corner difference (S[he,we] - S[hs,we]) - (S[he,ws] - S[hs,ws]) that
    the CUDA kernel computes."""
    maps, rois = _sat_case(2)
    table = tpsroi.sat(_t(maps))
    hs, he, ws, we = tpsroi.roi_bounds(_t(rois), 1 / 16, 7, 10, 14)
    got = tpsroi.psroi_mm_sums_plain(table, hs, he, ws, we)
    b = torch.arange(2)[:, None, None, None]
    s6 = table.reshape(2, 11, 15, 7, 7, 9)
    p, q = torch.arange(7)[:, None], torch.arange(7)[None, :]
    corner = lambda y, x: s6[b, y[..., :, None].long(), x[..., None, :].long(),
                             p, q]                     # (B, N, k, k, D)
    want = ((corner(he, we) - corner(hs, we))
            - (corner(he, ws) - corner(hs, ws)))
    assert got.shape == want.shape == (2, 24, 7, 7, 9)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sat_sums_refuse_cpu_tensors_in_the_kernel_wrapper():
    """On CPU tensors the dispatcher takes the plain version and counts no
    launch; the kernel wrapper refuses them instead of falling back."""
    maps, rois = _sat_case(3, n=8)
    table = tpsroi.sat(_t(maps))
    bounds = tpsroi.roi_bounds(_t(rois), 1 / 16, 7, 10, 14)
    before = tpsroi.psroi_mm_sums_cuda.launches
    tpsroi.psroi_mm_sums(table, *bounds)
    assert tpsroi.psroi_mm_sums_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tpsroi.psroi_mm_sums_cuda(table, *bounds)


def test_gather_pool_matches_dtt_with_gradient():
    """The "gather" pool forward and its map gradient (autograd's
    scatter-add) against dtt's ``psroi_pool_batched`` and ``jax.vjp``;
    the train pool ``pool_vote_batched(impl="gather")`` against dtt's."""
    maps, rois = _sat_case(4, d=5)
    rng = np.random.RandomState(5)
    g = rng.randn(2, 24, 7, 7, 5).astype(np.float32)
    # eager, not jitted: under jit XLA moved one of this case's bin bounds
    # across an integer (bin 1, 5 of RoI 11 of frame 1: a mean off by 1.04)
    want, vjp = jax.vjp(lambda f: jpsroi.psroi_pool_batched(
        f, jnp.asarray(rois), 1 / 16, 7), jnp.asarray(maps))
    (want_grad,) = vjp(jnp.asarray(g))
    m = _t(maps).clone().requires_grad_()
    got = tpsroi.psroi_pool_batched(m, _t(rois), 1 / 16, 7)
    got.backward(_t(g))
    atol = _sat_atol(maps)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=atol)
    want_grad = np.asarray(want_grad)
    # each pixel's gradient sums g/area over the bins holding it, in
    # another order: 1e-5 of the largest
    np.testing.assert_allclose(m.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())
    cfg = tiny_config()
    cfg = cfg.replace(model=cfg.model.replace(
        roi=cfg.model.roi.replace(ps_grid=7)))
    got_vote = tdnt.pool_vote_batched(torch_config(cfg).model, _t(maps),
                                      _t(rois), 1 / 16, "gather")
    want_vote = jdnt.pool_vote_batched(cfg.model, jnp.asarray(maps),
                                       jnp.asarray(rois), 1 / 16, "gather")
    assert got_vote.shape == (2, 24, 5)
    np.testing.assert_allclose(got_vote.detach().numpy(),
                               np.asarray(want_vote), rtol=1e-5, atol=atol)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    cfg = cfg.replace(input=cfg.input.replace(canvas_height=H, canvas_width=W))
    model = jdnt.make_model(cfg.model)
    # the flax tree DnT.init makes (tests/test_torch_port_model.py), drawn
    # with numpy: much faster than an eager flax init
    params = init_jax_params(torch_config(cfg).model, seed=1)
    tmodel = from_jax_params(params, torch_config(cfg).model, device="cpu")
    images = np.random.RandomState(0).randn(3, H, W, 3).astype(np.float32) * 50
    feats = jax.jit(lambda p, x: model.apply(p, x, method=jdnt.DnT.frame_trunk)
                    )(params, jnp.asarray(images))
    f_t = jax.tree.map(lambda x: x[:-1], feats)
    f_tau = jax.tree.map(lambda x: x[1:], feats)
    fused = model.apply(params, f_t, f_tau, method=jdnt.DnT.fused_psmaps)
    return dict(cfg=cfg, model=model, params=params, tmodel=tmodel, f_t=f_t,
                fused=fused)


@pytest.mark.parametrize("impl", IMPLS)
def test_detect_track_fused_matches_dtt(setup, impl):
    """Each fused pool form on dtt's features and fused maps: equal
    proposal validity, proposals to float32 roundoff of the box decode (its
    exp may differ in the last bit between libraries), and the class
    probabilities, box and track deltas at tests/test_fused_heads.py's
    tolerances (rtol 1e-4, atol 1e-4)."""
    cfg = with_impl(setup["cfg"], impl)
    jt, fused = setup["f_t"], setup["fused"]
    anchors = grid_anchors_for(cfg.model.anchors, H // 16, W // 16)
    jprops, jdet, jdeltas = jdnt.detect_track_fused(
        cfg.model, jt, fused, jnp.asarray(anchors), 60.0, 90.0, 1.0)
    tt = tdnt.FrameFeats(_t(jt.rpn_cls), _t(jt.rpn_bbox), _t(jt.reduced), {})
    tprops, tdet, tdeltas = tdnt.detect_track_fused(
        torch_config(cfg).model, tt, _t(fused), _t(anchors), 60.0, 90.0, 1.0)
    np.testing.assert_array_equal(tprops.valid.numpy(), np.asarray(jprops.valid))
    np.testing.assert_allclose(tprops.rois.numpy(), np.asarray(jprops.rois),
                               rtol=1e-6, atol=1e-4)
    for name in ("cls_prob", "bbox_pred"):
        np.testing.assert_allclose(getattr(tdet, name).numpy(),
                                   np.asarray(getattr(jdet, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tdeltas.numpy(), np.asarray(jdeltas),
                               rtol=1e-4, atol=1e-4)


def test_detect_track_fused_refuses_unknown_pool(setup):
    cfg = torch_config(with_impl(setup["cfg"], "pallas"))
    jt = setup["f_t"]
    tt = tdnt.FrameFeats(_t(jt.rpn_cls), _t(jt.rpn_bbox), _t(jt.reduced), {})
    anchors = grid_anchors_for(cfg.model.anchors, H // 16, W // 16)
    with pytest.raises(ValueError, match="eval_pool_impl"):
        tdnt.detect_track_fused(cfg.model, tt, _t(setup["fused"]),
                                _t(anchors), 60.0, 90.0, 1.0)


@pytest.mark.parametrize("impl", ["pallas_mm", "direct"])
def test_pair_step_snippet_matches_dtt(setup, impl):
    """``make_pair_step`` + ``evaluate_snippet`` at tau=2 on a 7-frame
    uint8 snippet in batches of 3 pairs (so the tail batch is padded and
    trimmed, and the last keyframe pairs with frame T-1), with a partial
    ``im_hw``: ``valid`` and the keyframes equal, the rest at
    tests/test_torch_port_video.py's tolerances."""
    cfg = with_impl(setup["cfg"], impl)
    frames = np.random.RandomState(5).randint(0, 256, (7, H, W, 3)).astype(
        np.uint8)
    im_hw = (56, 80)
    want = jinf.evaluate_snippet(cfg, jinf.make_pair_step(cfg, setup["model"],
                                                          3),
                                 setup["params"], frames, tau=2, batch=3,
                                 im_hw=im_hw)
    cfg_t = torch_config(cfg)
    step = tinf.make_pair_step(cfg_t, setup["tmodel"], 3, device="cpu")
    got = tinf.evaluate_snippet(cfg_t, step, frames, tau=2, im_hw=im_hw)
    assert got[4] == want[4] == [0, 2, 4, 6]
    c, m = cfg.model.num_classes - 1, cfg.eval.max_per_class
    assert got[0].shape == (c, 4, m, 4) and got[2].shape == (c, 4, m)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert got[2].any()
    for i, (name, atol) in enumerate((("boxes", 1e-2), ("scores", 1e-4),
                                      ("valid", 0), ("tracked", 1e-2))):
        assert np.isfinite(got[i]).all(), name
        np.testing.assert_allclose(got[i], np.asarray(want[i]), rtol=0,
                                   atol=atol, err_msg=name)
    assert got[0][..., 2].max() <= im_hw[1] - 1
    assert got[0][..., 3].max() <= im_hw[0] - 1


def test_pair_step_refuses_wrong_batch_and_device(setup):
    cfg = torch_config(setup["cfg"])
    step = tinf.make_pair_step(cfg, setup["tmodel"], 2, device="cpu")
    with pytest.raises(ValueError, match="batches of 2 pairs"):
        step(torch.zeros(3, 2, H, W, 3, dtype=torch.uint8),
             torch.tensor([H, W], dtype=torch.float32))
    with pytest.raises(ValueError, match="at least one pair"):
        tinf.make_pair_step(cfg, setup["tmodel"], 0, device="cpu")


# ------------------------------------------------------------------ linking, interpolation

def _strided_dets(seed, c=3, t=4, m=5):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (c, 1, m, 2)) + np.arange(t)[None, :, None,
                                                         None] * 4.0
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (c, 1, m, 2))],
                           axis=-1)
    tracked = np.roll(boxes, -1, axis=1) + rng.uniform(-2, 2, boxes.shape)
    scores = rng.uniform(0.01, 1.0, (c, t, m))
    valid = rng.rand(c, t, m) > 0.3
    valid[1, 1] = False
    return (boxes.astype(np.float32), scores.astype(np.float32),
            tracked.astype(np.float32), valid)


@pytest.mark.parametrize("tau", [None, 2, 3])
def test_link_snippet_and_interpolate_tubes_match_dtt(setup, tau):
    """Linking on the CPU and the interpolation of the tubes to every
    frame: frame and class indices equal, scores and boxes to float32
    roundoff of the rescored values."""
    cfg = setup["cfg"]
    boxes, scores, tracked, valid = _strided_dets(7)
    step = tau or 2
    eval_ts = list(range(0, 4 * step, step))
    t_total = eval_ts[-1] + step - 1
    want_sc, want_tubes = jinf.link_snippet(cfg, boxes, scores, tracked, valid)
    got_sc, got_tubes = tinf.link_snippet(torch_config(cfg), boxes, scores,
                                          tracked, valid, device="cpu")
    np.testing.assert_allclose(got_sc, want_sc, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_tubes.det_in_tube,
                                  np.asarray(want_tubes.det_in_tube))
    want = jinf.interpolate_tubes(want_tubes, boxes, eval_ts, t_total, tau=tau)
    got = tinf.interpolate_tubes(got_tubes, boxes, eval_ts, t_total, tau=tau)
    assert got[0].size > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-4)
    assert got[0].max() < t_total


# ------------------------------------------------------------------ VID mAP

def _dets_and_gts(seed, num_classes=4, frames=12):
    rng = np.random.RandomState(seed)
    all_dets, all_gts = {}, {}
    for c in range(1, num_classes):
        gts = {}
        for f in range(frames):
            if rng.rand() < 0.8:
                xy = rng.uniform(0, 200, (rng.randint(1, 4), 2))
                gts[f] = np.concatenate([xy, xy + rng.uniform(5, 80, xy.shape)],
                                        axis=1).astype(np.float32)
        all_gts[c] = gts if c != 2 else {}      # a class with no gt
        n = rng.randint(5, 40)
        fids = rng.randint(0, frames, n)
        boxes = np.stack([gts[f][rng.randint(len(gts[f]))]
                          + rng.uniform(-8, 8, 4) if f in gts
                          else rng.uniform(0, 200, 4) for f in fids])
        # tied scores exercise the stable order
        scores = rng.choice([0.9, 0.7, 0.7, 0.4, 0.1], n)
        all_dets[c] = [(fids[:n // 2], scores[:n // 2], boxes[:n // 2]),
                       (fids[n // 2:], scores[n // 2:], boxes[n // 2:])]
    return all_dets, all_gts


@pytest.mark.parametrize("protocol", ["devkit", "flat"])
def test_vid_eval_matches_dtt(protocol):
    all_dets, all_gts = _dets_and_gts(0)
    want = jvid.eval_detections(all_dets, all_gts, 4, protocol=protocol,
                                class_names=["bg", "a", "b", "c"])
    got = tvid.eval_detections(all_dets, all_gts, 4, protocol=protocol,
                               class_names=["bg", "a", "b", "c"])
    assert got["map"] == want["map"] and got["map"] > 0
    assert np.isnan(got["ap"][2])
    np.testing.assert_array_equal(list(got["ap"].values()),
                                  list(want["ap"].values()))
    fids, scores, boxes = tvid.det_arrays(all_dets[1])
    np.testing.assert_array_equal(
        tvid.nms_frame_dets(fids, scores, boxes, 0.3),
        jvid.nms_frame_dets(fids, scores, boxes, 0.3))


# ------------------------------------------------------------------ synthetic data

@pytest.mark.parametrize("uint8", [True, False])
def test_synthetic_snippet_matches_dtt(uint8):
    args = (12, 64, 96, 5, 6)
    got = tsyn.synthetic_snippet(np.random.RandomState(3), *args, uint8=uint8)
    want = jsyn.synthetic_snippet(np.random.RandomState(3), *args, uint8=uint8)
    assert got[0].dtype == (np.uint8 if uint8 else np.float32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3].any()


@pytest.mark.parametrize("over", [{}, {"visibility": (0.2, 0.3),
                                       "distractors": 3, "noise_sigma": 10.0,
                                       "occlusion_prob": 1.0}])
def test_synthetic_hard_snippet_matches_dtt(over):
    args = (10, 64, 96, 5, 6)
    got = thard.synthetic_hard_snippet(np.random.RandomState(4), *args,
                                       hard=thard.Hardness(**over), uint8=True)
    want = jhard.synthetic_hard_snippet(np.random.RandomState(4), *args,
                                        hard=jhard.Hardness(**over),
                                        uint8=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
