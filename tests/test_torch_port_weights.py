"""Weights in and out of the port, held against dtt on the CPU: the
msgpack codec against flax, the run-dir format both ways (dtt writes, the
port reads, and the reverse, in both stage layouts), the reference .pth
importer, frozen-BN calibration, remat, and the entry points that use them
(``train_torch.py --pretrained --calibrate-bn``, ``eval_torch.py`` on a run
dir dtt wrote, ``demo_torch.py --synthetic``).

Tolerances: the codec, the checkpoints and the importer are bit-equal;
calibrated affines rtol 1e-4 with atol 1e-5 for entries near 0 (float32
statistics summed in another order, through 17 affines in sequence); one
train step after a restore at tests/test_torch_port_train.py's bounds
(losses rtol 2e-4 / atol 1e-5, update deltas rtol 5e-3 / atol 1e-5);
remat gradients bit-equal.
"""

import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dtt.core.anchors import grid_anchors_for
from dtt.models.dnt import make_model as j_make_model
from dtt.train import checkpoint as jck
from dtt.train.trainer import TrainState as JTrainState
from dtt.train.trainer import create_train_state as j_create_train_state
from dtt.train.trainer import make_optimizer as j_make_optimizer
from dtt.train.trainer import make_train_step as j_make_train_step
from dtt.utils import calibrate as jcal
from dtt.utils import torch_import as jti
from tests import test_models
from tests.test_torch_port_train import (GRAD_TOL, LOSS_TOL, _batch,
                                         _jax_draws, torch_config)
from tests.test_train import tiny_config
from tests.torch_ref import TinyResNet, TorchTinyDnT

import demo_torch
import eval_torch
import train_torch
from dtt_torch.data.synthetic import synthetic_batch
from dtt_torch.models.dnt import make_model
from dtt_torch.models.targets import sample_draws
from dtt_torch.train import checkpoint as tck
from dtt_torch.train import trainer as ttrainer
from dtt_torch.train.losses import batch_loss
from dtt_torch.utils import calibrate as tcal
from dtt_torch.utils import msgpack as tmsgpack
from dtt_torch.utils import torch_import as tti
from dtt_torch.utils.params import (from_jax_params, init_jax_params,
                                    to_jax_tree)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tiny_synth.yml")
SAMPLE = jnp.zeros((1, 2, H, W, 3), jnp.float32)


def _train_cfg():
    """tests/test_train.py's tiny config with the stem and layer1 frozen,
    so frozen leaves other than the BN affines hold a trace too."""
    cfg = tiny_config()
    return cfg.replace(model=cfg.model.replace(frozen_stages=2))


def _scan_cfg(scan: bool = True):
    """The tiny config at resnet50 depth (3, 4, 6, 3 blocks), the stacked
    layout under `scan`."""
    cfg = tiny_config()
    return cfg.replace(model=cfg.model.replace(backbone="resnet50",
                                               scan_blocks=scan))


def _zeros_tree(cfg):
    """dtt's variables for `cfg` as numpy zeros, shapes from eval_shape."""
    shapes = jax.eval_shape(j_make_model(cfg.model).init,
                            jax.random.PRNGKey(0), SAMPLE)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _host_state(state) -> dict:
    return jax.tree.map(np.asarray, {"params": state.params,
                                     "opt_state": state.opt_state,
                                     "step": state.step})


def _assert_trees_equal(got, want):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def _random_momentum(state, seed: int):
    """Give every optimized parameter a random momentum buffer."""
    g = torch.Generator().manual_seed(seed)
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            state.optimizer.state[p]["momentum_buffer"] = torch.randn(
                p.shape, generator=g)
    return state


# ------------------------------------------------------------ stage layout

@pytest.fixture(scope="module")
def scanned():
    """Random values in dtt's scan_blocks layout at resnet50 depth."""
    cfg = _scan_cfg()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda z: rng.standard_normal(z.shape, np.float32),
                        _zeros_tree(cfg))
    return cfg, tree


def test_scan_blocks_layout_loads_and_goes_back(scanned):
    """from_jax_params reads layerK/blocks/block slice i - 1 into block i
    of each stage; to_jax_tree of a scan_blocks model stacks them again,
    equal to the tree it read, structure and bits."""
    cfg, tree = scanned
    tc = torch_config(cfg)
    model = from_jax_params(tree, tc.model, device="cpu")
    state = model.state_dict()
    n = 0
    for li, blocks in enumerate((3, 4, 6, 3), 1):
        layer = tree["params"]["backbone"][f"layer{li}"]
        assert set(layer) == {"block0", "blocks"}
        for mod, leaves in layer["blocks"]["block"].items():
            for leaf, stacked in leaves.items():
                assert stacked.shape[0] == blocks - 1
                for i in range(1, blocks):
                    want = stacked[i - 1]
                    if leaf == "kernel":
                        want, leaf_name = want.transpose(3, 2, 0, 1), "weight"
                    else:
                        leaf_name = leaf
                    got = state[f"backbone.layer{li}.block{i}.{mod}."
                                f"{leaf_name}"]
                    np.testing.assert_array_equal(got.numpy(), want)
                    n += 1
    assert n == 9 * (2 + 3 + 5 + 2)
    _assert_trees_equal(to_jax_tree(model), tree)


def test_scan_blocks_layout_reads_either_layout(scanned):
    """The unstacked tree of the same values loads into the same model, and
    a model of the unscanned config writes it back unstacked."""
    cfg, tree = scanned
    tc = torch_config(cfg)
    want = from_jax_params(tree, tc.model, device="cpu").state_dict()
    flat_cfg = tc.model.replace(scan_blocks=False)
    flat = to_jax_tree(from_jax_params(tree, flat_cfg, device="cpu"))
    assert "blocks" not in flat["params"]["backbone"]["layer3"]
    assert "block5" in flat["params"]["backbone"]["layer3"]
    got = from_jax_params(flat, tc.model, device="cpu").state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    deeper = jax.tree.map(lambda x: x, tree)
    stacked = deeper["params"]["backbone"]["layer3"]["blocks"]["block"]
    stacked["conv1"]["kernel"] = np.concatenate(
        [stacked["conv1"]["kernel"]] * 2)
    with pytest.raises(ValueError, match="stacked blocks"):
        from_jax_params(deeper, tc.model, device="cpu")


# ------------------------------------------------------------------ codec

@pytest.fixture(scope="module")
def dtt_run(tmp_path_factory):
    """A dtt run dir after one dtt train step (momentum nonzero): its
    path, the saved state on the host and the jitted step."""
    cfg = _train_cfg()
    model, state = j_create_train_state(cfg, jax.random.PRNGKey(0), SAMPLE)
    template = jax.tree.map(np.array, state)
    step = j_make_train_step(cfg, model, (H // 16, W // 16))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, seed=4).items()}
    state, _ = step(state, batch, jax.random.PRNGKey(7))
    host = _host_state(state)
    root = str(tmp_path_factory.mktemp("dtt_run"))
    path = jck.save_checkpoint(root, state, cfg)
    return dict(cfg=cfg, root=root, path=path, host=host, step=step,
                template=template)


def test_codec_bytes_equal_flax(dtt_run):
    """The codec packs dtt's train state to flax's to_bytes byte for byte
    and unpacks flax's bytes to bit-equal arrays of the same dtypes."""
    host = dtt_run["host"]
    want = serialization.to_bytes(host)
    got = tmsgpack.packb(tck._sorted(serialization.to_state_dict(host)))
    assert got == want
    with open(os.path.join(dtt_run["path"], "state.msgpack"), "rb") as f:
        assert f.read() == want
    _assert_trees_equal(tmsgpack.unpackb(want),
                        serialization.msgpack_restore(want))


def test_codec_headers_match_flax():
    """Every header size class msgpack has for what flax writes (ints,
    strings, maps, bins, arrays of every rank up to 16 and of 0-d)
    packs as flax packs it; what flax does not write raises."""
    rng = np.random.RandomState(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            -1, -32, -33, -128, -129, -2 ** 15, -2 ** 15 - 1, -2 ** 31 - 1]
    tree = {"ints": {f"i{j:02d}": v for j, v in enumerate(ints)},
            "strs": {"s" * n: "x" * n for n in (0, 31, 32, 255, 256, 70000)},
            "wide": {f"k{j:02d}": np.full((j,), j, np.int64)
                     for j in range(17)},
            "ranks": {f"r{j:02d}": np.zeros((1,) * j, np.float32)
                      for j in range(17)},
            "misc": {"none": None, "t": True, "f": False, "fl": -1.5,
                     "bin": b"\x00" * 300, "u8": np.arange(16, dtype=np.uint8),
                     "b": np.ones(3, bool), "big": rng.randn(70000)},
            "empty": {}}
    want = serialization.msgpack_serialize(tree)
    assert tmsgpack.packb(tck._sorted(tree)) == want
    _assert_trees_equal(tmsgpack.unpackb(want),
                        serialization.msgpack_restore(want))
    for bad in ([1, 2], (1,), np.float32(1.0), {1: 2}):
        with pytest.raises(TypeError):
            tmsgpack.packb({"x": bad})
    with pytest.raises(ValueError, match="not flax's ndarray"):
        tmsgpack.unpackb(b"\xd4\x05\x00")


# ----------------------------------------------------------- checkpoints

def test_dtt_checkpoint_restores_into_the_port(dtt_run):
    """A dtt run dir restores into a fresh port state: the params, every
    momentum trace (biases at twice the port's buffer, frozen leaves 0)
    and the step bit-equal, so the port's own state dict packs to dtt's
    file byte for byte."""
    tc = torch_config(dtt_run["cfg"])
    _, state = ttrainer.create_train_state(tc, device="cpu")
    path = tck.latest_checkpoint(dtt_run["root"])
    assert path == dtt_run["path"]
    state = tck.restore_checkpoint(path, state)
    assert state.step == 1
    host = dtt_run["host"]
    _assert_trees_equal(tck._state_dict(state, tc),
                        tck._sorted(serialization.to_state_dict(host)))
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        assert tmsgpack.packb(tck._state_dict(state, tc)) == f.read()


def test_train_step_after_restore_matches_dtt(dtt_run):
    """One more step from the restored state in both packages (the port
    with the uniforms dtt draws from the step's key): losses and every
    trainable leaf's update at tests/test_torch_port_train.py's bounds."""
    cfg = dtt_run["cfg"]
    tc = torch_config(cfg)
    jstate = jck.restore_checkpoint(dtt_run["path"], dtt_run["template"])
    model, state = ttrainer.create_train_state(tc, device="cpu")
    state = tck.restore_checkpoint(dtt_run["path"], state)
    batch = _batch(cfg, seed=5)
    key = jax.random.PRNGKey(11)
    before = to_jax_tree(model)["params"]
    jstate, jm = dtt_run["step"](jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, key)
    a = (H // 16) * (W // 16) * cfg.model.anchors.num_anchors
    draws = _jax_draws(key, a, tc.model.rpn.post_nms_top_n_train
                       + tc.input.max_gt_boxes)
    step = ttrainer.make_train_step(tc, model, (H // 16, W // 16), "cpu")
    state, tm = step(state, batch, draws)
    assert state.step == int(jstate.step) == 2
    for name, v in tm.items():
        np.testing.assert_allclose(float(v), float(jm[name]), **LOSS_TOL,
                                   err_msg=name)
    after = to_jax_tree(model)["params"]
    jafter = jax.tree.map(np.asarray, jstate.params["params"])
    moved = jax.tree.map(lambda b, a, j: (a - b, j - b), before, after, jafter)
    n = 0
    for path, (got, want) in jax.tree_util.tree_flatten_with_path(
            moved, is_leaf=lambda x: isinstance(x, tuple))[0]:
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        n += bool(np.abs(want).max() > 0)
    assert n > 10


@pytest.mark.parametrize("scan", [False, True], ids=["blocks", "scanned"])
def test_port_checkpoint_restores_into_dtt(scan, tmp_path):
    """A port run dir (random momentum, step 3) is read by dtt's
    restore_checkpoint into a fresh dtt state of the same config, and by
    restore_params_only, equal to the port's state bit for bit; dtt saves
    it back to the same bytes. At resnet50 depth under scan_blocks, the
    tiny backbone otherwise."""
    cfg = _scan_cfg() if scan else _train_cfg()
    tc = torch_config(cfg)
    tree = init_jax_params(tc.model, seed=3)
    _, state = ttrainer.create_train_state(tc, device="cpu", tree=tree)
    state = _random_momentum(state, seed=4)._replace(step=3)
    path = tck.save_checkpoint(str(tmp_path), state, tc)
    params = _zeros_tree(cfg)
    template = JTrainState(params=params,
                           opt_state=j_make_optimizer(cfg).init(
                               params["params"]),
                           step=np.zeros((), np.int32))
    restored = jck.restore_checkpoint(path, template)
    want = tck._state_dict(state, tc)
    _assert_trees_equal(tck._sorted(serialization.to_state_dict(
        _host_state(restored))), want)
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        assert serialization.to_bytes(_host_state(restored)) == f.read()
    only, step = jck.restore_params_only(path, params)
    assert step == 3
    _assert_trees_equal(jax.tree.map(np.asarray, only), want["params"])
    if scan:
        assert "blocks" in want["params"]["params"]["backbone"]["layer2"]


def test_params_export_round_trips(dtt_run, tmp_path):
    """save_params / load_params: the port's export is dtt's save_params
    of the same variables byte for byte, and loads back bit-equal."""
    tc = torch_config(dtt_run["cfg"])
    model, _ = ttrainer.create_train_state(tc, device="cpu")
    tck.save_params(str(tmp_path / "p.msgpack"), model)
    jck.save_params(str(tmp_path / "j.msgpack"), to_jax_tree(model))
    assert ((tmp_path / "p.msgpack").read_bytes()
            == (tmp_path / "j.msgpack").read_bytes())
    fresh = tck.load_params(str(tmp_path / "j.msgpack"),
                            make_model(tc.model, device="cpu"))
    _assert_trees_equal(to_jax_tree(fresh), to_jax_tree(model))


# -------------------------------------------------------------- importer

def _bn_randomized(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Nontrivial conv weights and BN statistics, in eval mode."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.normal_(m.weight, std=0.05, generator=g)
        elif isinstance(m, torch.nn.BatchNorm2d):
            torch.nn.init.uniform_(m.weight, 0.5, 1.5, generator=g)
            torch.nn.init.normal_(m.bias, std=0.1, generator=g)
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
    return module.eval()


@pytest.mark.parametrize("scan", [False, True], ids=["tiny", "scanned50"])
def test_import_resnet_backbone_matches_dtt(scan):
    """A torchvision-layout ResNet state dict (BN statistics folded) lands
    in the port's backbone bit-equal to dtt's importer read through
    from_jax_params, in either of dtt's stage layouts."""
    cfg = _scan_cfg() if scan else tiny_config()
    tc = torch_config(cfg)
    resnet = _bn_randomized(TinyResNet((3, 4, 6, 3) if scan
                                       else (1, 1, 1, 1)), seed=1)
    sd = resnet.state_dict()
    want = from_jax_params(jti.import_resnet_backbone(sd, _zeros_tree(cfg)),
                           tc.model, device="cpu").state_dict()
    got = tti.import_resnet_backbone(sd, make_model(tc.model, "cpu"))
    for k, v in got.state_dict().items():
        if k.startswith("backbone."):
            assert torch.equal(v, want[k]), k
    assert torch.equal(got.backbone.layer1.block0.conv1.weight,
                       sd["layer1.0.conv1.weight"])
    sd["extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="unconsumed"):
        tti.import_resnet_backbone(sd, make_model(tc.model, "cpu"))


def test_import_full_checkpoint_matches_dtt():
    """tests/torch_ref.py's reference-layout TorchTinyDnT through
    import_full_checkpoint: every weight and affine bit-equal to dtt's
    import read through from_jax_params (BN folding, the ps-channel and
    anchor-major RPN-cls permutations)."""
    cfg = test_models.tiny_config()
    cfg = cfg.replace(input=cfg.input.replace(canvas_height=H,
                                              canvas_width=W))
    tc = torch_config(cfg)
    sd = TorchTinyDnT().randomize(0).state_dict()
    want = from_jax_params(jti.import_full_checkpoint(sd, _zeros_tree(cfg),
                                                      cfg.model),
                           tc.model, device="cpu").state_dict()
    got = tti.import_full_checkpoint(sd, make_model(tc.model, "cpu"))
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
    del sd["rfcn_bbox.weight"]
    with pytest.raises(KeyError, match="bbox_maps"):
        tti.import_full_checkpoint(sd, make_model(tc.model, "cpu"))


@pytest.mark.parametrize("form", ["plain", "state_dict", "model", "module"])
def test_load_pth_forms_match_dtt(form, tmp_path):
    """load_pth unwraps a ``state_dict`` or ``model`` entry and drops
    ``module.`` prefixes, as dtt's does."""
    sd = _bn_randomized(TinyResNet(), seed=2).state_dict()
    obj = {"plain": sd, "state_dict": {"state_dict": sd, "epoch": 3},
           "model": {"model": sd},
           "module": {"module." + k: v for k, v in sd.items()}}[form]
    path = str(tmp_path / "w.pth")
    torch.save(obj, path)
    got, want = tti.load_pth(path), jti.load_pth(path)
    assert list(got) == list(want) == list(sd)
    assert all(torch.equal(got[k], want[k]) for k in sd)


# ------------------------------------------------------------ calibration

def _calib_images(cfg, b: int = 2, seed: int = 0) -> np.ndarray:
    batch = synthetic_batch(np.random.RandomState(seed), b, H, W,
                            cfg.model.num_classes, cfg.input.max_gt_boxes,
                            uint8=True)
    return (batch["images"].astype(np.float32)
            - np.asarray(cfg.input.pixel_means, np.float32))


def _affines(model) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if k.rsplit(".", 2)[-2] in ("bn1", "bn2", "bn3", "downsample_bn")}


def test_calibration_matches_dtt():
    """Every frozen affine after calibration equals dtt's at rtol 1e-4,
    atol 1e-5 (float32; the per-channel statistics are summed in another
    order),
    the groups come in dtt's topological order, and the last group's
    outputs come out at mean 0 / std 1 per channel (to 1e-3)."""
    cfg = tiny_config()
    tc = torch_config(cfg)
    tree = init_jax_params(tc.model, seed=1)
    imgs = _calib_images(cfg)
    want = _affines(from_jax_params(
        jcal.calibrate_model_backbone(cfg, tree, imgs), tc.model, "cpu"))
    model = tcal.calibrate_model_backbone(
        tc, from_jax_params(tree, tc.model, "cpu"), imgs)
    got = _affines(model)
    assert got.keys() == want.keys() and len(got) == 2 * 17
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    groups = tcal.affine_groups(model.backbone)
    jgroups = jcal.affine_groups(tree["params"]["backbone"])
    assert groups == [[".".join(p) for p in g] for g in jgroups]
    x = torch.from_numpy(imgs.reshape(-1, H, W, 3)).permute(0, 3, 1, 2)
    stats = tcal.affine_stats(model.backbone, x, groups[-1])
    for mean, var in stats.values():
        assert mean.abs().max() < 1e-3 and (var.sqrt() - 1).abs().max() < 1e-3


def test_calibration_refuses_the_scan_layout():
    cfg = tiny_config()
    tc = torch_config(cfg.replace(model=cfg.model.replace(scan_blocks=True)))
    model = make_model(tc.model, "cpu")
    with pytest.raises(ValueError, match="scan_blocks"):
        tcal.calibrate_model_backbone(tc, model, _calib_images(cfg))


# ------------------------------------------------------------------ remat

def test_remat_gradients_equal_without():
    """model.remat recomputes each bottleneck in the backward: the loss
    and every gradient are bit-equal to the run without it."""
    cfg = torch_config(tiny_config())
    tree = init_jax_params(cfg.model, seed=2)
    batch = ttrainer.batch_to_device(_batch(tiny_config(), seed=4),
                                     torch.device("cpu"))
    anchors = torch.from_numpy(grid_anchors_for(cfg.model.anchors,
                                                H // 16, W // 16))
    out = []
    for remat in (False, True):
        c = cfg.replace(model=cfg.model.replace(remat=remat))
        model = from_jax_params(tree, c.model, "cpu").train()
        assert model.backbone.layer3.remat is remat
        loss, _ = batch_loss(c, model, anchors, batch,
                             sample_draws(c, 2, torch.Generator()
                                          .manual_seed(0)))
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in
                                    model.named_parameters()
                                    if p.grad is not None}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and len(g0) > 20
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# ----------------------------------------------------------- entry points

def test_train_torch_pretrained_and_calibrated_matches_dtt(tmp_path):
    """train_torch.main --pretrained PTH --calibrate-bn on the CPU: every
    backbone conv of its step-0 checkpoint is the .pth's, bit for bit,
    and every affine is dtt's import + calibration on the same first
    synthetic batch at rtol 1e-4; --resume then trains on from it."""
    sd = _bn_randomized(TinyResNet(), seed=5).state_dict()
    pth = str(tmp_path / "resnet.pth")
    torch.save(sd, pth)
    out = str(tmp_path / "run")
    argv = ["--synthetic", "--config", CONFIG, "--out", out, "--set",
            "train.batch_size_per_chip=2", "train.log_every=1"]
    state = train_torch.main(argv + ["train.total_steps=0", "--pretrained",
                                     pth, "--calibrate-bn"], device="cpu")
    assert state.step == 0
    n = 0
    for k, v in state.model.state_dict().items():
        if k.startswith("backbone.") and k.endswith(".weight"):
            src = (k.removeprefix("backbone.").replace(".block", ".")
                   .replace("downsample_conv", "downsample.0"))
            assert torch.equal(v, sd[src]), k
            n += 1
    assert n == 1 + 4 * 4

    from dtt.core.config import load_config as j_load_config
    jcfg = j_load_config(CONFIG, ["train.batch_size_per_chip=2"])
    jtree = jti.import_pretrained_backbone(pth, _zeros_tree(jcfg))
    first = synthetic_batch(np.random.RandomState(jcfg.train.seed), 2, H, W,
                            jcfg.model.num_classes, jcfg.input.max_gt_boxes,
                            jcfg.input.pixel_means, uint8=True,
                            num_objects=jcfg.input.synthetic_objects)
    imgs = (first["images"].astype(np.float32)
            - np.asarray(jcfg.input.pixel_means, np.float32))
    want = _affines(from_jax_params(
        jcal.calibrate_model_backbone(jcfg, jtree, imgs),
        torch_config(jcfg).model, "cpu"))
    ck = tck.latest_checkpoint(out)
    model = make_model(torch_config(jcfg).model, "cpu")
    assert tck.restore_params_only(ck, model) == 0
    got = _affines(model)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    state = train_torch.main(argv + ["train.total_steps=1", "--resume"],
                             device="cpu")
    assert state.step == 1
    assert os.path.exists(os.path.join(out, "step_00000001",
                                       "state.msgpack"))


def test_eval_torch_reads_a_dtt_run_dir(dtt_run, tmp_path):
    """eval_torch.main on the run dir dtt wrote (its config.yml and
    state.msgpack) gives the result it gives on the port's checkpoint of
    the same restored weights."""
    tc = torch_config(dtt_run["cfg"])
    _, state = ttrainer.create_train_state(tc, device="cpu")
    state = tck.restore_checkpoint(dtt_run["path"], state)
    port_dir = str(tmp_path / "port")
    tck.save_checkpoint(port_dir, state, tc)
    argv = ["--synthetic", "--synthetic-snippets", "1", "--synthetic-frames",
            "6", "--link"]
    got, _, pairs = eval_torch.main(["--checkpoint", dtt_run["root"], *argv],
                                    device="cpu")
    want, _, _ = eval_torch.main(["--checkpoint", port_dir, *argv],
                                 device="cpu")
    assert got == want and pairs == 6
    assert {"mAP", "mAP_nolink"} <= set(got)


def test_demo_torch_synthetic_on_the_cpu(dtt_run, tmp_path):
    """demo_torch.py --synthetic --link on a dtt run dir writes the 8
    frames with boxes drawn."""
    out = str(tmp_path / "demo")
    n_frames, n_drawn = demo_torch.main(
        ["--checkpoint", dtt_run["root"], "--synthetic", "--link",
         "--score-thresh", "0", "--out", out], device="cpu")
    assert n_frames == 8 and n_drawn > 0
    names = sorted(os.listdir(out))
    assert names == [f"frame_{t:04d}.jpg" for t in range(8)]
    assert cv2.imread(os.path.join(out, names[0])).shape == (H, W, 3)


def test_dtt_run_dir_config_reads_back(dtt_run):
    """checkpoint_config reads dtt's config.yml into the port's Config."""
    from dtt_torch.core.config import config_from_dict
    cfg = config_from_dict(tck.checkpoint_config(dtt_run["path"]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        torch_config(dtt_run["cfg"]))
    with pytest.raises(SystemExit):
        eval_torch.load_model(eval_torch.parse_args(
            ["--checkpoint", os.path.dirname(dtt_run["path"]) + "/none",
             "--synthetic"]), "cpu")
