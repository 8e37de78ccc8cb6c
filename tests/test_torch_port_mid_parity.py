"""One training step of the port held against dtt's on the CPU at the
model section of configs/mid_synth.yml: ResNet-50, frozen_stages 0, the
four anchor scales (12 anchors) and 10 classes, every other model width at
its default (reduced 1024 channels, 7x7 position-sensitive bins, the d=8
s=2 correlation), with OHEM at mid_synth's top 128.

Only the canvas is cut (64x96 in place of 304x544, so 4x6 maps at stride
16) and the arithmetic is float32 (bf16 at this depth would hold neither
side to the tolerances below). Both sides get the same weights, drawn with
numpy by ``init_jax_params`` and then the frozen-BN affines calibrated
from the batch as ``train_torch --calibrate-bn`` does for mid_synth
(uncalibrated, 50 layers without normalization leave RPN deltas near 27),
and the same batch; the port gets the uniforms dtt draws from its keys
inside ``batch_loss``.

Held, with the tolerances of tests/test_torch_port_train.py where it
states them: the discrete decisions (anchor labels, proposal validity,
RoI labels and validity, the OHEM selection) and the proposals as the
pools read them (rounded to pixels) equal; the losses to rtol 2e-4 / atol
1e-5; the gradients of the RPN, the bbox and track maps and the cls maps'
bias to rtol 5e-3 / atol 1e-5. The proposals' coordinates agree to 5e-3
px, not the tiny test's 1e-4: at this depth the decode subtracts half of
exp(dw) times a 256 px anchor (thousands of px) from its centre, and the
features' float32 roundoff (2e-6 of their size) lands there as
thousandths of a pixel. Not held: the cls maps' kernel and the trunk's
gradients. The jitted dtt moves the cls maps' kernel gradient by 9e-3 of
its size (eagerly it agrees with the port to 1e-5), and the trunk's
gradients at this depth move by up to 2e-2 between the port's own float32
and float64 runs, so float32 roundoff alone exceeds 5e-3 there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtt.core.anchors import grid_anchors_for
from dtt.core.config import load_config as j_load_config
from dtt.models.dnt import make_model
from dtt.train.losses import batch_loss as j_batch_loss
from tests.test_torch_port_train import (GRAD_TOL, LOSS_TOL, H, W, _batch,
                                         _jax_decisions, _jax_draws,
                                         _torch_decisions, torch_config)

from dtt_torch.train import losses as tlosses
from dtt_torch.train import trainer as ttrainer
from dtt_torch.utils.calibrate import calibrate_model_backbone
from dtt_torch.utils.params import (from_jax_params, init_jax_params,
                                    to_jax_tree)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MID = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "mid_synth.yml")


def mid_config():
    """dtt's Config of configs/mid_synth.yml in float32 on a 64x96
    canvas."""
    cfg = j_load_config(MID)
    return cfg.replace(model=cfg.model.replace(dtype="float32"),
                       input=cfg.input.replace(canvas_height=H,
                                               canvas_width=W,
                                               target_short_side=H))


@pytest.fixture(scope="module")
def run():
    cfg = mid_config()
    m = cfg.model
    assert (m.backbone, m.frozen_stages, m.num_classes,
            len(m.anchors.scales) * len(m.anchors.ratios)) == (
        "resnet50", 0, 10, 12)
    batch = _batch(cfg, seed=4)
    tc = torch_config(cfg)
    tmodel = from_jax_params(init_jax_params(tc.model, seed=3), tc.model,
                             device="cpu")
    calibrate_model_backbone(tc, tmodel, batch["images"].astype(np.float32)
                             - np.float32(cfg.input.pixel_means))
    params = jax.tree.map(jnp.asarray, to_jax_tree(tmodel))
    model = make_model(m)
    anchors = grid_anchors_for(m.anchors, H // 16, W // 16)
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

    draws = _jax_draws(key, anchors.shape[0],
                       tc.model.rpn.post_nms_top_n_train
                       + tc.input.max_gt_boxes)
    tbatch = ttrainer.batch_to_device(batch, torch.device("cpu"))
    feats, track_maps = tlosses.forward_heads(tc, tmodel, tbatch)
    asg = tlosses.assign_targets(tc, feats, torch.from_numpy(anchors),
                                 tbatch, draws)
    tlb = tlosses.head_losses(tc, feats, track_maps, asg)
    tlb.total.backward()
    return dict(jlb=jlb, jgrads=jgrads, jdec=jdec, tlb=tlb,
                tdec=_torch_decisions(tc, feats, asg),
                tgrads=to_jax_tree(tmodel, grads=True))


def test_mid_decisions_match(run):
    """Anchor labels, proposal validity, RoI labels and validity, and the
    OHEM selection equal per frame; the proposals equal where the pools
    read them (rounded) and within 5e-3 px."""
    for name, want in run["jdec"].items():
        got = run["tdec"][name].numpy().reshape(want.shape)
        if name == "proposal_rois":
            np.testing.assert_array_equal(np.round(got), np.round(want),
                                          err_msg=name)
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-3,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (run["jdec"]["roi_labels"] > 0).any()
    assert run["jdec"]["ohem_sel"].any()


def test_mid_losses_match(run):
    jlb, tlb = run["jlb"], run["tlb"]
    for name in tlb._fields:
        np.testing.assert_allclose(getattr(tlb, name).item(),
                                   float(getattr(jlb, name)), **LOSS_TOL,
                                   err_msg=name)
    assert float(tlb.rpn_cls) > 0 and float(tlb.rfcn_cls) > 0
    assert float(tlb.track) > 0


# the leaves held, as paths into the params tree
HELD = [("rpn", "conv", "kernel"), ("rpn", "conv", "bias"),
        ("rpn", "cls_score", "kernel"), ("rpn", "bbox_pred", "kernel"),
        ("bbox_maps", "kernel"), ("bbox_maps", "bias"),
        ("track_maps", "kernel"), ("track_maps", "bias"),
        ("cls_maps", "bias")]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_mid_gradients_match(run):
    """The RPN's, the bbox and track maps' and the cls maps' bias
    gradients within dtt's own gradient bound; every leaf's tree path the
    same on both sides."""
    jflat = jax.tree_util.tree_flatten_with_path(run["jgrads"])[0]
    tflat = jax.tree_util.tree_flatten_with_path(run["tgrads"])[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for path in HELD:
        want = _leaf(run["jgrads"]["params"], path)
        got = _leaf(run["tgrads"]["params"], path)
        assert np.abs(want).max() > 0, path
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=str(path))
