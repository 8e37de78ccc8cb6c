"""dtt_torch's training slice held against dtt's on the CPU, at the tiny
training config of ``tests/test_train.py`` (64x96 canvas, float32):
``batch_loss``'s stages (decisions, losses, gradients) with OHEM on and
off, one optimizer update against dtt's optax chain, the synthetic batch,
and the checkpoint round trip.

Both sides get the same weights (dtt's ``model.init`` through
``from_jax_params``) and the same batch; the port gets the uniforms that
dtt draws from its keys inside ``batch_loss`` (same key flow), so both
sample the same anchors and RoIs. The discrete decisions are compared
first, so a flip fails by name instead of as a loss difference.
Tolerances are dtt's own batched-vs-vmapped bounds (tests/test_train.py):
rtol 2e-4 / atol 1e-5 on losses, rtol 5e-3 / atol 1e-5 per gradient leaf.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtt.core.anchors import grid_anchors_for
from dtt.data.synthetic import synthetic_batch as j_synthetic_batch
from dtt.models import targets as jt
from dtt.models.dnt import (DnT, make_model, normalize_device_images,
                            pool_vote_batched)
from dtt.models.rpn import proposal_layer, smooth_l1
from dtt.ops.nms import nms_padded
from dtt.train.losses import batch_loss as j_batch_loss
from dtt.train.trainer import _is_frozen as j_is_frozen
from dtt.train.trainer import make_optimizer as j_make_optimizer
from tests.test_train import tiny_config

from dtt_torch.core import config as tcfg
from dtt_torch.data.synthetic import synthetic_batch
from dtt_torch.models import dnt as tdnt
from dtt_torch.models.targets import Draws
from dtt_torch.train import losses as tlosses
from dtt_torch.train import trainer as ttrainer
from dtt_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                        save_checkpoint)
from dtt_torch.utils import params as tparams
from dtt_torch.utils.params import from_jax_params, to_jax_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96
B = 2
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-5)


def torch_config(cfg):
    return tcfg._merge_into(tcfg.Config(), dataclasses.asdict(cfg))


def _batch(cfg, seed):
    """uint8 pairs; the second pair's image fills only part of the canvas,
    so the masking and the per-frame extents run."""
    batch = j_synthetic_batch(np.random.RandomState(seed), B, H, W,
                              cfg.model.num_classes, cfg.input.max_gt_boxes,
                              uint8=True)
    batch["im_size"][1] = (56, 80)
    return batch


def _jax_draws(key, a, r):
    """The uniforms dtt's batch_loss draws: per pair split(key, B) ->
    split(., 4); frame f's anchor key 2f and RoI key 2f+1, each split in
    two for its two uniform draws. (B, 2, n) like ``Draws``."""
    keys4 = jax.vmap(lambda k: jax.random.split(k, 4))(
        jax.random.split(key, B))

    def pair(k, n):
        k0, k1 = jax.vmap(jax.random.split)(k).transpose(1, 0, 2)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (n,)))
        return u(k0), u(k1)

    out = [[], [], [], []]
    for f in range(2):
        for i, x in enumerate(pair(keys4[:, 2 * f], a)
                              + pair(keys4[:, 2 * f + 1], r)):
            out[i].append(x)
    return Draws(*(torch.from_numpy(np.array(jnp.stack(x, axis=1)))
                   for x in out))


def _jax_decisions(cfg, model, params, anchors, batch, key):
    """dtt's discrete decisions inside batch_loss, stage by stage with
    dtt's own functions and key flow: anchor labels, proposals, RoI labels
    and the OHEM selection of ``_rfcn_losses``. (B, 2, ...) per name."""
    mcfg = cfg.model
    keys4 = jax.vmap(lambda k: jax.random.split(k, 4))(
        jax.random.split(key, B))
    images = jax.vmap(lambda im, sz: normalize_device_images(
        im, sz, cfg.input.pixel_means))(batch["images"], batch["im_size"])
    feats = model.apply(params, images.reshape(-1, *images.shape[2:]),
                        method=DnT.frame_features)
    hh, ww = batch["im_size"][:, 0], batch["im_size"][:, 1]
    gb, gv, gl = batch["gt_boxes"], batch["gt_valid"], batch["gt_labels"]
    out = {}
    for f in range(2):
        ff = jax.tree.map(lambda x: x[f::2], feats)
        at = jax.vmap(lambda b, v, h, w, k: jt.anchor_target(
            anchors, b, v, h, w, k, mcfg.rpn))(gb[:, f], gv[:, f], hh, ww,
                                                 keys4[:, 2 * f])
        props = jax.vmap(lambda c, b, h, w, s: proposal_layer(
            c, b, anchors, h, w, s, mcfg.rpn, True))(
            ff.rpn_cls, ff.rpn_bbox, hh, ww, batch["im_scale"])
        args = (props.rois, props.valid, gb[:, f], gl, gv[:, f],
                gb[:, 1 - f], gv[:, 1 - f])
        if cfg.train.ohem:
            tgts = jax.vmap(lambda *a: jt.label_all_rois(
                *a, mcfg.roi, None))(*args)
        else:
            tgts = jax.vmap(lambda *a: jt.proposal_target(
                *a, mcfg.roi, None))(*args, keys4[:, 2 * f + 1])
        cls = pool_vote_batched(mcfg, ff.cls_maps, tgts.rois, 1 / 16,
                                "direct")
        bbox = pool_vote_batched(mcfg, ff.bbox_maps, tgts.rois, 1 / 16,
                                 "direct")

        def ohem_sel(cs, bp, t):   # dtt/train/losses.py _rfcn_losses
            ce = -jnp.take_along_axis(jax.nn.log_softmax(cs, axis=-1),
                                      t.labels[:, None], axis=1)[:, 0]
            box = jnp.sum(smooth_l1(bp[:, 4:8], t.bbox_targets, 1.0),
                          axis=-1) * t.bbox_weights
            per_roi = jnp.where(t.valid, ce + box, 0.0)
            keep_idx, keep_valid = nms_padded(
                t.rois, per_roi, cfg.train.ohem_nms_thresh,
                min(cfg.train.ohem_top_k, per_roi.shape[0]), valid=t.valid,
                score_threshold=-0.5)
            return (jnp.zeros_like(t.valid).at[keep_idx].max(keep_valid)
                    & t.valid)

        for name, x in (("anchor_labels", at.labels),
                        ("proposal_valid", props.valid),
                        ("proposal_rois", props.rois),
                        ("roi_labels", tgts.labels),
                        ("roi_valid", tgts.valid),
                        ("ohem_sel", jax.vmap(ohem_sel)(cls, bbox, tgts))):
            out.setdefault(name, []).append(x)
    return {k: jnp.stack(v, axis=1) for k, v in out.items()}


def _torch_decisions(cfg, feats, asg):
    """The port's discrete decisions from its stages: the assignment's,
    and the OHEM selection of ``_rfcn_losses`` on the pooled votes."""
    tgts = asg.rois
    with torch.no_grad():
        cls, bbox = (tdnt.pool_vote_batched(cfg.model, m, tgts.rois, 1 / 16,
                                            "direct")
                     for m in (feats.cls_maps, feats.bbox_maps))
        sel = tlosses._rfcn_losses(cfg, cls, bbox, tgts)[3]
    return dict(anchor_labels=asg.anchors.labels,
                proposal_valid=asg.proposals.valid,
                proposal_rois=asg.proposals.rois, roi_labels=tgts.labels,
                roi_valid=tgts.valid, ohem_sel=sel)


@pytest.fixture(scope="module")
def jax_params():
    """dtt's initial variables for the tiny config (the same tree for
    every frozen_stages and target path)."""
    model = make_model(tiny_config().model)
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 2, H, W, 3), jnp.float32))


@pytest.fixture(scope="module", params=[True, False], ids=["ohem", "sampled"])
def run(request, jax_params):
    """dtt's loss, gradients and decisions and the port's, once per
    target path. The sampled path also freezes the stem and layer1."""
    ohem = request.param
    cfg = tiny_config(ohem=ohem)
    if not ohem:
        cfg = cfg.replace(model=cfg.model.replace(frozen_stages=2))
    batch = _batch(cfg, seed=4)
    model = make_model(cfg.model)
    params = jax_params
    anchors = grid_anchors_for(cfg.model.anchors, H // 16, W // 16)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def reference(p):
        (_, lb), grads = jax.value_and_grad(
            lambda q: j_batch_loss(cfg, model, q, jnp.asarray(anchors),
                                   jbatch, key), has_aux=True)(p)
        return lb, grads, _jax_decisions(cfg, model, p, jnp.asarray(anchors),
                                         jbatch, key)

    jlb, jgrads, jdec = jax.tree.map(np.asarray, reference(params))
    tree = jax.tree.map(np.asarray, params)

    tc = torch_config(cfg)
    tmodel = from_jax_params(tree, tc.model, device="cpu")
    draws = _jax_draws(key, anchors.shape[0],
                       tc.model.rpn.post_nms_top_n_train
                       + tc.input.max_gt_boxes)
    tbatch = ttrainer.batch_to_device(batch, torch.device("cpu"))
    feats, track_maps = tlosses.forward_heads(tc, tmodel, tbatch)
    asg = tlosses.assign_targets(tc, feats, torch.from_numpy(anchors),
                                 tbatch, draws)
    tlb = tlosses.head_losses(tc, feats, track_maps, asg)
    tlb.total.backward()
    return dict(cfg=cfg, tcfg=tc, jlb=jlb, jgrads=jgrads, jdec=jdec,
                tlb=tlb, tdec=_torch_decisions(tc, feats, asg),
                tgrads=to_jax_tree(tmodel, grads=True))


def test_batch_loss_decisions_match(run):
    """Anchor labels, proposal validity and boxes, RoI labels and
    validity, and the OHEM selection: equal per frame."""
    for name, want in run["jdec"].items():
        if name == "ohem_sel" and not run["cfg"].train.ohem:
            continue
        got = run["tdec"][name].numpy().reshape(want.shape)
        if name == "proposal_rois":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (run["jdec"]["roi_labels"] > 0).any()


def test_batch_loss_matches(run):
    test_batch_loss_decisions_match(run)
    jlb, tlb = run["jlb"], run["tlb"]
    for name in tlb._fields:
        np.testing.assert_allclose(getattr(tlb, name).item(),
                                   float(getattr(jlb, name)), **LOSS_TOL,
                                   err_msg=name)
    assert float(tlb.rpn_cls) > 0 and float(tlb.rfcn_cls) > 0
    assert float(tlb.track) > 0


def test_gradients_match(run):
    """Every leaf within dtt's own gradient bound; frozen leaves (BN
    affines, and the stem + layer1 on the sampled path) exactly 0."""
    frozen_stages = run["cfg"].model.frozen_stages
    jflat = jax.tree_util.tree_flatten_with_path(run["jgrads"])[0]
    tflat = jax.tree_util.tree_flatten_with_path(run["tgrads"])[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    n_frozen = 0
    for (path, want), (_, got) in zip(jflat, tflat):
        name = jax.tree_util.keystr(path)
        if j_is_frozen(path[1:], frozen_stages):
            n_frozen += 1
            assert not got.any() and not want.any(), name
            continue
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=name)
    assert n_frozen > 0
    assert np.abs(run["tgrads"]["params"]["track_maps"]["kernel"]).max() > 0


def test_optimizer_steps_match_optax(jax_params):
    """Three updates on the same gradients as dtt's optax chain: global
    norm clip (the first step's gradients are past the limit), weight
    decay, doubled bias rate, momentum, warm-up over two steps and the
    step decay at step 2; frozen leaves (BN, stem, layer1) unchanged."""
    cfg = tiny_config()
    cfg = cfg.replace(model=cfg.model.replace(frozen_stages=2),
                      train=cfg.train.replace(learning_rate=0.05,
                                              warmup_steps=2,
                                              lr_decay_steps=(2,)))
    params = jax_params["params"]
    tx = j_make_optimizer(cfg)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    tc = torch_config(cfg)
    tmodel = from_jax_params({"params": jax.tree.map(np.asarray, params)},
                             tc.model, device="cpu")
    state = ttrainer.TrainState(tmodel, ttrainer.make_optimizer(tc, tmodel),
                                0)
    rng = np.random.RandomState(0)
    before = to_jax_tree(tmodel)
    for step, scale in enumerate((10.0, 0.01, 0.05)):
        # frozen leaves get zero gradients, as dtt's stop_gradient gives
        grads = jax.tree_util.tree_map_with_path(
            lambda path, x: np.zeros_like(x) if j_is_frozen(path, 2) else
            (rng.randn(*x.shape) * scale).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, p in tmodel.named_parameters():
            if p.requires_grad:
                leaf = tparams._leaf(grads, tparams._flax_path(name))
                p.grad = torch.from_numpy(np.ascontiguousarray(
                    tparams._to_torch_layout(name, leaf)))
        state = ttrainer.apply_gradients(tc, state)
        assert state.step == step + 1
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-6, atol=1e-7),
            to_jax_tree(tmodel)["params"], params)
    after = jax.tree_util.tree_flatten_with_path(to_jax_tree(tmodel))[0]
    n_frozen = 0
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(before)[0], after):
        if j_is_frozen(path[1:], 2):
            n_frozen += 1
            np.testing.assert_array_equal(b, a)
    assert n_frozen > 0


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4])
def test_learning_rate_matches_optax_schedule(step):
    """The step decay takes effect at its boundary (b - 1, b, b + 1 for
    b = 2) and the warm-up multiplies it, as dtt's schedule does."""
    cfg = tcfg.Config()
    for warmup in (0, 3):
        t = cfg.train.replace(learning_rate=0.01, gamma=0.1, warmup_steps=warmup,
                              lr_decay_steps=(2, 4))
        base = optax.piecewise_constant_schedule(0.01, {2: 0.1, 4: 0.1})
        want = base(step) * (jnp.minimum(1.0, (step + 1) / warmup)
                             if warmup else 1.0)
        got = ttrainer.learning_rate(cfg.replace(train=t), step)
        np.testing.assert_allclose(got, float(want), rtol=1e-7)


@pytest.mark.parametrize("uint8", [True, False])
def test_synthetic_batch_matches_dtt(uint8):
    want = j_synthetic_batch(np.random.RandomState(3), 2, 48, 80, 8, 5,
                             uint8=uint8, num_objects=(1, 4))
    got = synthetic_batch(np.random.RandomState(3), 2, 48, 80, 8, 5,
                          uint8=uint8, num_objects=(1, 4))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_step_and_checkpoint_round_trip(tmp_path):
    """Two port train steps move every trainable head; a checkpoint of the
    state restores bitwise into a fresh state (weights, momentum, step)."""
    cfg = torch_config(tiny_config())
    model, state = ttrainer.create_train_state(cfg, device="cpu")
    step = ttrainer.make_train_step(cfg, model, (H // 16, W // 16),
                                    device="cpu")
    from dtt_torch.models.targets import sample_draws
    g = torch.Generator().manual_seed(0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(2):
        batch = synthetic_batch(np.random.RandomState(i), B, H, W,
                                cfg.model.num_classes,
                                cfg.input.max_gt_boxes, uint8=True)
        state, metrics = step(state, batch, sample_draws(cfg, B, g))
        assert all(np.isfinite(float(v)) for v in metrics.values())
    for head in ("rpn.", "reduce.", "cls_maps.", "bbox_maps.",
                 "track_maps.", "backbone.layer4."):
        assert any(not torch.equal(before[k], v)
                   for k, v in model.state_dict().items()
                   if k.startswith(head)), head
    path = save_checkpoint(str(tmp_path), state, cfg)
    assert latest_checkpoint(str(tmp_path)) == path
    _, fresh = ttrainer.create_train_state(cfg, device="cpu")
    fresh = restore_checkpoint(path, fresh)
    assert fresh.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    bufs = [s["momentum_buffer"] for s in state.optimizer.state.values()]
    fresh_bufs = [s["momentum_buffer"]
                  for s in fresh.optimizer.state.values()]
    assert len(bufs) == len(fresh_bufs) > 0
    assert all(torch.equal(a, b) for a, b in zip(bufs, fresh_bufs))


def test_metric_logger_writes_json_lines(tmp_path):
    from dtt_torch.utils.logging import MetricLogger
    logger = MetricLogger(str(tmp_path / "run"), run_name="exp")
    logger.log(1, {"total": 2.5})
    row = logger.log(2, {"total": 1.0})
    with open(logger.path) as f:
        rows = [json.loads(line) for line in f]
    assert rows[1] == row
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[0]["total"] == 2.5 and rows[1]["total"] == 1.0
    assert all(r["exp"] == "exp" for r in rows)
