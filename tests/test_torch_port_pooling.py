"""The pooling modes other than PSRoI held against dtt on the CPU: the ops
of ``dtt_torch.ops.roi_ops`` (``bilinear_sample``, ``roi_align``,
``roi_pool``, ``roi_crop``) with RoIs partly outside the map and
degenerate ones, and each ``roi.pooling_mode`` through ``pool_vote``,
``pool_vote_batched``, the video, pair and single-frame steps and
``batch_loss``; and the loss oracles ``pair_loss`` and
``batch_loss_vmapped`` against dtt's and against the port's
``batch_loss``.

Tolerances: the ops at float32 1e-5 (their gradients too), ``roi_pool``
exact (a max); the steps as tests/test_torch_port_video.py (valid equal,
scores 1e-4, boxes 1e-2); losses and gradients at
tests/test_torch_port_train.py's bounds (rtol 2e-4 / atol 1e-5, rtol
5e-3 / atol 1e-5). dtt's ops run eagerly where they are compared alone:
jitted, dtt can put a bin edge across an integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtt.core.anchors import grid_anchors_for
from dtt.eval import inference as jinf
from dtt.models import dnt as jdnt
from dtt.ops import roi_ops as jroi
from dtt.train import losses as jlosses
from tests import test_models
from tests.test_torch_port_train import (GRAD_TOL, LOSS_TOL, _batch,
                                         _jax_draws, torch_config)
from tests.test_train import tiny_config as train_config

from dtt_torch.eval import inference as tinf
from dtt_torch.models import dnt as tdnt
from dtt_torch.ops import roi_ops as troi
from dtt_torch.train import losses as tlosses
from dtt_torch.train import trainer as ttrainer
from dtt_torch.utils.params import (from_jax_params, init_jax_params,
                                    to_jax_tree)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96
MODES = ["align", "pool", "crop"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _rois(seed: int, n: int = 24, extent: float = 250.0) -> np.ndarray:
    """RoIs in image pixels over a map of stride 16: most inside, some
    partly or wholly outside, a zero-size one, an inverted one and one
    whose bin edges fall on exact integers."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(-40, extent, (n, 2))
    rois = np.concatenate([lo, lo + rng.uniform(-8, 90, (n, 2))], 1)
    rois[0] = [10, 10, 10, 10]
    rois[1] = [60, 50, 30, 20]
    rois[2] = [300, 300, 330, 340]
    rois[3] = [0, 0, 111, 111]
    rois[4] = [-30, -20, 40, 35]
    return rois.astype(np.float32)


OPS = [("roi_align", {}), ("roi_align", {"aligned": True,
                                         "sampling_ratio": 3}),
       ("roi_pool", {}), ("roi_crop", {}), ("roi_crop", {"max_pool": False})]


@pytest.mark.parametrize("name,kw", OPS,
                         ids=["align", "align_aligned_sr3", "pool", "crop",
                              "crop_nomax"])
def test_roi_op_matches_dtt(name, kw):
    """One frame and a batch of two (each frame its own RoIs) against
    dtt's per-frame op, k = 3 and 7; roi_pool exact, the rest to 1e-5."""
    rng = np.random.RandomState(0)
    maps = rng.randn(2, 9, 13, 5).astype(np.float32)
    rois = np.stack([_rois(1), _rois(2)])
    atol = 0 if name == "roi_pool" else 1e-5
    for k in (3, 7):
        want = [np.asarray(getattr(jroi, name)(jnp.asarray(maps[b]),
                                               jnp.asarray(rois[b]), 1 / 16,
                                               k, **kw)) for b in range(2)]
        got = getattr(troi, name)(_t(maps[0]), _t(rois[0]), 1 / 16, k, **kw)
        assert got.shape == (24, k, k, 5) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want[0], rtol=0, atol=atol)
        batched = getattr(troi, name)(_t(maps), _t(rois), 1 / 16, k, **kw)
        np.testing.assert_allclose(batched.numpy(), np.stack(want), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("name,kw", OPS[:3] + OPS[3:4],
                         ids=["align", "align_aligned_sr3", "pool", "crop"])
def test_roi_op_gradients_match_dtt(name, kw):
    """The maps' gradient of each op under a random cotangent against
    jax.vjp of dtt's op, to 1e-5 (roi_pool's ties share evenly, as
    jnp.max's do: the map has a plateau of equal values)."""
    rng = np.random.RandomState(3)
    maps = rng.randn(9, 13, 5).astype(np.float32)
    maps[2:6, 3:9] = 0.5                       # ties inside bins
    rois = _rois(4)
    cot = rng.randn(24, 3, 3, 5).astype(np.float32)
    _, vjp = jax.vjp(lambda m: getattr(jroi, name)(m, jnp.asarray(rois),
                                                   1 / 16, 3, **kw),
                     jnp.asarray(maps))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    x = _t(maps).requires_grad_()
    getattr(troi, name)(x, _t(rois), 1 / 16, 3, **kw).backward(_t(cot))
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0


def test_bilinear_sample_matches_dtt():
    """Points inside, on the borders, in the [-1, 0) and (H-1, H] margins
    and beyond them (zero), in one shape and with a leading batch."""
    rng = np.random.RandomState(5)
    maps = rng.randn(2, 9, 13, 4).astype(np.float32)
    ys = rng.uniform(-2.5, 10.5, (2, 7, 6)).astype(np.float32)
    xs = rng.uniform(-2.5, 14.5, (2, 7, 6)).astype(np.float32)
    ys[:, 0, :4] = [-1.0, 0.0, 8.0, 9.0]
    xs[:, 0, :4] = [-1.0, 0.0, 12.0, 13.0]
    want = np.stack([np.asarray(jroi.bilinear_sample(
        jnp.asarray(maps[b]), jnp.asarray(ys[b]), jnp.asarray(xs[b])))
        for b in range(2)])
    got = troi.bilinear_sample(_t(maps[0]), _t(ys[0]), _t(xs[0]))
    np.testing.assert_allclose(got.numpy(), want[0], rtol=0, atol=1e-5)
    got = troi.bilinear_sample(_t(maps), _t(ys), _t(xs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (want == 0).any() and (want != 0).any()


def test_roi_pool_holds_memory_to_chunks(monkeypatch):
    """roi_pool's row stage runs over chunks of RoIs, never the whole
    (N, k, H, W, C) broadcast, with the same result."""
    rng = np.random.RandomState(6)
    maps = _t(rng.randn(2, 9, 13, 5).astype(np.float32))
    rois = _t(np.stack([_rois(7), _rois(8)]))
    whole = troi.roi_pool(maps, rois, 1 / 16, 3)
    monkeypatch.setattr(troi, "_POOL_CHUNK", 3 * 9 * 13 * 5 * 5)
    assert torch.equal(troi.roi_pool(maps, rois, 1 / 16, 3), whole)


# ------------------------------------------------------- the model's modes

def _mode_cfg(mode: str):
    cfg = test_models.tiny_config()
    cfg = cfg.replace(input=cfg.input.replace(canvas_height=H,
                                              canvas_width=W))
    return cfg.replace(model=cfg.model.replace(
        roi=cfg.model.roi.replace(pooling_mode=mode)))


@pytest.fixture(scope="module", params=MODES)
def mode_setup(request):
    """The tiny config under one pooling mode: dtt's model and the port's
    with the same numpy-drawn weights."""
    cfg = _mode_cfg(request.param)
    tc = torch_config(cfg)
    params = init_jax_params(tc.model, seed=2)
    return dict(mode=request.param, cfg=cfg, tcfg=tc, params=params,
                model=jdnt.make_model(cfg.model),
                tmodel=from_jax_params(params, tc.model, device="cpu"))


def test_mode_heads_emit_one_group(mode_setup):
    """Non-psroi heads emit one channel group (k2 = 1), as dtt's, and the
    fused path refuses them."""
    tc, tmodel = mode_setup["tcfg"], mode_setup["tmodel"]
    heads = mode_setup["params"]["params"]
    assert tmodel.cls_maps.kernel.shape == (64, tc.model.num_classes)
    assert heads["bbox_maps"]["kernel"].shape == (1, 1, 64, 8)
    assert heads["track_maps"]["kernel"].shape[-1] == 4
    with pytest.raises(ValueError, match="unfused"):
        tdnt.detect_track_fused(tc.model, None, None, None, H, W, 1.0)


def test_pool_vote_matches_dtt(mode_setup):
    """pool_vote of one frame and pool_vote_batched of two against dtt's
    (eager), to 1e-5 (roi_pool's max exactly, its bin mean to roundoff)."""
    mcfg, tcfg = mode_setup["cfg"].model, mode_setup["tcfg"].model
    rng = np.random.RandomState(9)
    maps = rng.randn(2, 4, 6, 7).astype(np.float32)
    rois = np.stack([_rois(10, extent=90), _rois(11, extent=90)])
    want = np.asarray(jdnt.pool_vote(mcfg, jnp.asarray(maps[0]),
                                     jnp.asarray(rois[0]), 1 / 16))
    got = tdnt.pool_vote(tcfg, _t(maps[0]), _t(rois[0]), 1 / 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want = np.asarray(jdnt.pool_vote_batched(mcfg, jnp.asarray(maps),
                                             jnp.asarray(rois), 1 / 16))
    for impl in ("direct", "gather"):     # psroi forms; ignored here
        got = tdnt.pool_vote_batched(tcfg, _t(maps), _t(rois), 1 / 16, impl)
        assert got.shape == (2, 24, 7)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _assert_dets(got, want, names):
    """valid equal, boxes to 1e-2, scores to 1e-4."""
    tol = {"boxes": 1e-2, "scores": 1e-4, "valid": 0, "tracked": 1e-2}
    valid = names.index("valid")
    np.testing.assert_array_equal(np.asarray(got[valid]),
                                  np.asarray(want[valid]))
    assert np.asarray(got[valid]).any()
    for name, g, w in zip(names, got, want):
        g = np.asarray(g)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=tol[name],
                                   err_msg=name)


NAMES4 = ["boxes", "scores", "valid", "tracked"]


def test_video_step_matches_dtt(mode_setup):
    """The unfused video path (frame_features, track maps, batched
    detection and track pools) over a 7-frame uint8 snippet in chunks of
    4 with a partial im_hw."""
    s = mode_setup
    frames = np.random.RandomState(5).randint(0, 256, (7, H, W, 3)).astype(
        np.uint8)
    im_hw = (56, 80)
    want = jinf.evaluate_snippet_video(
        s["cfg"], jinf.make_video_step(s["cfg"], s["model"], 4), s["params"],
        frames, im_hw=im_hw)
    got = tinf.evaluate_snippet_video(
        s["tcfg"], tinf.make_video_step(s["tcfg"], s["tmodel"], 4, "cpu"),
        frames, im_hw=im_hw)
    _assert_dets(got, want, NAMES4)


def test_pair_step_matches_dtt(mode_setup):
    """The tau = 2 pair step over the same snippet (4-pair batches, the
    tail padded)."""
    s = mode_setup
    frames = np.random.RandomState(6).randint(0, 256, (9, H, W, 3)).astype(
        np.uint8)
    want = jinf.evaluate_snippet(s["cfg"],
                                 jinf.make_pair_step(s["cfg"], s["model"], 4),
                                 s["params"], frames, tau=2)
    got = tinf.evaluate_snippet(
        s["tcfg"], tinf.make_pair_step(s["tcfg"], s["tmodel"], 4, "cpu"),
        frames, tau=2)
    assert got[4] == want[4] == [0, 2, 4, 6, 8]
    _assert_dets(got[:4], want[:4], NAMES4)


def test_single_frame_step_matches_dtt(mode_setup):
    s = mode_setup
    image = np.random.RandomState(7).randint(0, 256, (1, H, W, 3)).astype(
        np.uint8)
    im_hw = (56, 80)
    want = jinf.make_single_frame_step(s["cfg"], s["model"])(
        s["params"], jnp.asarray(image), jnp.asarray(im_hw, jnp.float32), 1.0)
    got = tinf.make_single_frame_step(s["tcfg"], s["tmodel"], "cpu")(
        _t(image), im_hw, 1.0)
    _assert_dets(got, want, NAMES4[:3])


# ------------------------------------------------------------ the losses

def _loss_case(mode: str, ohem: bool = True):
    """tests/test_train.py's tiny training config under `mode` (OHEM or
    sampled RoIs), weights, a batch and dtt's key with the uniforms it
    draws."""
    cfg = train_config(ohem=ohem)
    cfg = cfg.replace(model=cfg.model.replace(
        roi=cfg.model.roi.replace(pooling_mode=mode)))
    tc = torch_config(cfg)
    params = init_jax_params(tc.model, seed=3)
    batch = _batch(cfg, seed=4)
    anchors = grid_anchors_for(cfg.model.anchors, H // 16, W // 16)
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, anchors.shape[0],
                       tc.model.rpn.post_nms_top_n_train
                       + tc.input.max_gt_boxes)
    return cfg, tc, params, batch, anchors, key, draws


def _dtt_loss(fn, cfg, params, batch, anchors, key, jit: bool = True):
    model = jdnt.make_model(cfg.model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p):
        (_, lb), g = jax.value_and_grad(
            lambda q: fn(cfg, model, q, jnp.asarray(anchors), jbatch, key),
            has_aux=True)(p)
        return lb, g
    return jax.tree.map(np.asarray, (jax.jit(run) if jit else run)(params))


def _port_loss(fn, tc, params, batch, anchors, draws):
    model = from_jax_params(params, tc.model, device="cpu").train()
    tbatch = ttrainer.batch_to_device(batch, torch.device("cpu"))
    _, lb = fn(tc, model, _t(anchors), tbatch, draws)
    lb.total.backward()
    return lb, to_jax_tree(model, grads=True)


def _assert_losses(tlb, jlb):
    for name in tlb._fields:
        np.testing.assert_allclose(getattr(tlb, name).item(),
                                   float(getattr(jlb, name)), **LOSS_TOL,
                                   err_msg=name)
    assert tlb.rfcn_cls.item() > 0 and tlb.track.item() > 0


def _assert_grads(tgrads, jgrads):
    n = 0
    for (path, want), (_, got) in zip(
            jax.tree_util.tree_flatten_with_path(jgrads)[0],
            jax.tree_util.tree_flatten_with_path(tgrads)[0]):
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        n += bool(np.abs(want).max() > 0)
    assert n > 20


@pytest.mark.parametrize("mode", MODES)
def test_batch_loss_matches_dtt(mode):
    """batch_loss under each mode (OHEM, injected draws): every loss term
    and every gradient leaf against dtt's batch_loss. Under crop, against
    dtt run eagerly (~60 s): jitted, its 2x2 max splits the gradient of
    samples that tie on the padding's plateau otherwise than its own eager
    run (seen: the conv1 kernel's gradient 0.013 apart, of 0.31; the
    port's is within 3e-7 of the eager one)."""
    cfg, tc, params, batch, anchors, key, draws = _loss_case(mode)
    jlb, jgrads = _dtt_loss(jlosses.batch_loss, cfg, params, batch, anchors,
                            key, jit=mode != "crop")
    tlb, tgrads = _port_loss(tlosses.batch_loss, tc, params, batch, anchors,
                             draws)
    _assert_losses(tlb, jlb)
    _assert_grads(tgrads, jgrads)


@pytest.mark.parametrize("mode,ohem", [("psroi", True), ("align", True),
                                       ("psroi", False)],
                         ids=["psroi", "align", "psroi_sampled"])
def test_loss_oracles_match_dtt_and_batch_loss(mode, ohem):
    """batch_loss_vmapped (pair_loss a pair at a time, per-frame pools)
    against dtt's batch_loss_vmapped, losses and gradients, and against
    the port's batch_loss on the same draws, losses; pair_loss of one pair
    against dtt's pair_loss on that pair's key."""
    cfg, tc, params, batch, anchors, key, draws = _loss_case(mode, ohem)
    jlb, jgrads = _dtt_loss(jlosses.batch_loss_vmapped, cfg, params, batch,
                            anchors, key)
    tlb, tgrads = _port_loss(tlosses.batch_loss_vmapped, tc, params, batch,
                             anchors, draws)
    _assert_losses(tlb, jlb)
    _assert_grads(tgrads, jgrads)
    blb, _ = _port_loss(tlosses.batch_loss, tc, params, batch, anchors,
                        draws)
    _assert_losses(blb, tlb)

    model = from_jax_params(params, tc.model, device="cpu")
    tb = ttrainer.batch_to_device(batch, torch.device("cpu"))
    with torch.no_grad():
        one = tlosses.pair_loss(
            tc, model, _t(anchors), tb["images"][1], tb["gt_boxes"][1],
            tb["gt_labels"][1], tb["gt_valid"][1], tb["im_scale"][1],
            tb["im_size"][1], tlosses.Draws(*(d[1] for d in draws)))
    jone = jax.jit(lambda p, *a: jlosses.pair_loss(
        cfg, jdnt.make_model(cfg.model), p, jnp.asarray(anchors), *a))(
        params, *(jnp.asarray(batch[k][1]) for k in (
            "images", "gt_boxes", "gt_labels", "gt_valid", "im_scale",
            "im_size")), jax.random.split(key, 2)[1])
    _assert_losses(one, jone)
