"""dtt_torch's data path held against dtt's on the CPU: box flip, canvas
scale and resize, the native JPEG pipeline, prepare_pair, the VID/DET
roidbs, PairLoader batches, the synthetic samplers and renderers, and
train_torch.py on a dataset tree.

Every tree is written in the test (``tests/vid_tree.py``: JPEG frames
by PIL, VOC XML) and read by both packages. Tolerances: equal everywhere
(native decode, prepare_pair, roidbs, batches, rendered pixels), except
the resize against ``cv2.resize`` (1e-4 in pixel units), the ``pil``
route against dtt's ``cv2`` route (PIL's decode equal to ``cv2.imread``'s,
then the resize's 1e-4) and ``dtt``'s ``jnp`` renderer (dtt's own bound:
at most 1 on a few texture pixels).
"""

import glob
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dtt.core import boxes as jboxes
from dtt.core.config import InputConfig as JInputConfig
from dtt.data import device_synth as j_device_synth
from dtt.data import imagenet_vid as j_vid
from dtt.data import native as j_native
from dtt.data import synthetic as j_synthetic
from dtt.data import transforms as j_transforms
from dtt.data.imdb import combined_roidb as j_combined_roidb
from dtt.data.loader import PairLoader as JPairLoader

from dtt_torch.core import boxes as tboxes
from dtt_torch.core.config import InputConfig
from dtt_torch.data import device_synth, native, synthetic, transforms
from dtt_torch.data import imagenet_vid as t_vid
from dtt_torch.data.imdb import combined_roidb, list_datasets
from dtt_torch.data.loader import PairLoader
from tests.vid_tree import write_vid_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(target_short_side=96, canvas_height=96, canvas_width=128,
             max_gt_boxes=4)
RESIZE_ATOL = 1e-4          # pixel units (0-255 scale)
PIL_CV2_ATOL = 0.0          # pixel units: PIL's JPEG decode against cv2's


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 train snippets (4 + 3 frames), 1 val snippet (5 frames) and 3 DET
    images at 120 x 160."""
    root = str(tmp_path_factory.mktemp("ilsvrc"))
    write_vid_tree(root, seed=1, height=120, width=160, train_frames=(4, 3),
                   val_frames=(5,), det_images=3)
    return root


def _jpeg(tmp_path, img, name="f.JPEG"):
    path = str(tmp_path / name)
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 92])
    return path


def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ------------------------------------------------------------------ boxes

def test_flip_boxes_matches_dtt():
    """x1' = W - 1 - x2 (the Caffe - 1), batched."""
    rng = np.random.RandomState(0)
    b = rng.uniform(0, 200, (3, 5, 4)).astype(np.float32)
    want = np.asarray(jboxes.flip_boxes(jnp.asarray(b), 317))
    got = tboxes.flip_boxes(torch.from_numpy(b), 317).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("hw", [(120, 160), (720, 1280), (100, 100),
                                (37, 300), (1080, 1920), (64, 96)])
def test_canvas_scale_matches_dtt(hw):
    for kw in (SMALL, {}):
        assert transforms.canvas_scale(*hw, InputConfig(**kw)) == \
            j_transforms.canvas_scale(*hw, JInputConfig(**kw))


@pytest.mark.parametrize("hw,kw", [
    ((720, 1280), {}),                  # VID's usual frame: 600/720
    ((1080, 1920), {}),                 # capped by the canvas width
    ((480, 640), {}),                   # upscaled, rows of padding
    ((120, 160), SMALL), ((100, 140), SMALL), ((37, 53), SMALL),
    ((7, 9), SMALL)])
def test_resize_to_canvas_matches_cv2_path(hw, kw):
    """The port's own bilinear resize against dtt's cv2.resize path on the
    same float32 image: cv2's coordinate map, fused steps and clamping at
    the last row and column, to RESIZE_ATOL; the padding exactly 0."""
    rng = np.random.RandomState(sum(hw))
    img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    want, ws = j_transforms.resize_to_canvas(img.astype(np.float32),
                                             JInputConfig(**kw))
    got, gs = transforms.resize_to_canvas(img, InputConfig(**kw))
    assert gs == ws
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)
    got_f, _ = transforms.resize_to_canvas(img.astype(np.float32),
                                           InputConfig(**kw))
    np.testing.assert_array_equal(got_f, got)
    nh, nw = round(hw[0] * gs), round(hw[1] * gs)
    assert not got[nh:].any() and not got[:, nw:].any()


def test_native_library_is_named_by_source_flags_and_host():
    assert native.available(), native.unavailable_reason()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert "-march=native" in native.GXX_FLAGS
    assert path.name.startswith("libpixelops-")


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("hw", [(240, 320), (100, 100), (720, 1280)])
def test_native_decode_bit_equal_to_dtt(tmp_path, flip, hw):
    """The port's copy of pixelops.cpp, built by the port, against dtt's
    library on the same JPEG bytes: every bit, the zero padding included."""
    rng = np.random.RandomState(hw[0])
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    img = np.stack([120 + 80 * np.sin(yy / 40.0), 120 + 80 * np.cos(xx / 40.0),
                    120 + 60 * np.sin((xx + yy) / 60.0)], -1)
    img = np.clip(img + rng.randint(-20, 21, img.shape), 0, 255)
    data = open(_jpeg(tmp_path, img.astype(np.uint8)), "rb").read()
    for kw in (SMALL, {}):
        want, ws = j_native.decode_resize_normalize(data, JInputConfig(**kw),
                                                    flip)
        got, gs = native.decode_resize_normalize(data, InputConfig(**kw), flip)
        assert gs == ws
        np.testing.assert_array_equal(got, want)
        nw = int(gs * hw[1] + 0.5)
        assert not got[:, nw:].any()


def test_native_decode_raises_on_corrupt_bytes(tmp_path):
    with pytest.raises(ValueError):
        native.decode_resize_normalize(b"not a jpeg", InputConfig(**SMALL))
    path = str(tmp_path / "bad.JPEG")
    with open(path, "wb") as f:
        f.write(b"\xff\xd8 not a jpeg either")
    with pytest.raises(ValueError, match="bad.JPEG"):
        transforms.prepare_frame(path, InputConfig(**SMALL))


def test_frame_routes(tmp_path, monkeypatch, capsys):
    """JPEG by the native library, PNG by PIL (resize_to_canvas of its
    decode, flipped first), neither available an error naming the file;
    no route falls back to another."""
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (90, 150, 3)).astype(np.uint8)
    jpeg = _jpeg(tmp_path, img)
    png = str(tmp_path / "f.png")
    cv2.imwrite(png, img)
    cfg = InputConfig(**SMALL)
    assert transforms.frame_route(jpeg) == "native"
    assert transforms.frame_route(png) == "pil"
    for flip in (False, True):
        got, scale = transforms.prepare_frame(png, cfg, flip=flip)
        src = img[:, ::-1] if flip else img
        want, want_scale = j_transforms.resize_to_canvas(
            src.astype(np.float32), JInputConfig(**SMALL))
        assert scale == want_scale
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)
    np.testing.assert_array_equal(transforms.load_image_bgr(png),
                                  img.astype(np.float32))
    monkeypatch.setattr(native, "available", lambda: False)
    assert transforms.frame_route(jpeg) == "pil"
    got, _ = transforms.prepare_frame(jpeg, cfg)
    want, _ = transforms.resize_to_canvas(transforms.load_image_bgr(jpeg), cfg)
    np.testing.assert_array_equal(got, want)
    assert "decode by pil" in capsys.readouterr().err
    monkeypatch.setattr(transforms, "_pil", lambda: None)
    with pytest.raises(RuntimeError, match="f.JPEG.*PIL is not importable"):
        transforms.prepare_frame(jpeg, cfg)


def _without_native(monkeypatch):
    """Neither package's native library, as on a machine without libjpeg:
    the port decodes JPEG by PIL, dtt by cv2.imread."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(j_native, "available", lambda: False)


@pytest.mark.parametrize("flip", [False, True])
def test_pil_route_matches_dtt_cv2_path(tree, tmp_path, monkeypatch, flip):
    """The decode the card's machine runs (no libjpeg there): PIL's decode
    and the port's resize, against dtt's own path where its native library
    is missing, cv2.imread and cv2.resize. Every JPEG of the tree on the
    small canvas, and one 1280 x 720 frame (VID's usual size, written by
    PIL as the card's tree is) on the full canvas: the decode within
    PIL_CV2_ATOL of cv2's, the canvas within that plus RESIZE_ATOL, the
    scale equal."""
    _without_native(monkeypatch)
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:720, 0:1280]
    img = np.stack([120 + 80 * np.sin(yy / 50.0), 120 + 80 * np.cos(xx / 70.0),
                    120 + 60 * np.sin((xx + yy) / 90.0)], -1)
    img = np.clip(img + rng.randint(-20, 21, img.shape), 0, 255)
    big = str(tmp_path / "big.JPEG")
    Image.fromarray(img.astype(np.uint8)).save(big, format="JPEG", quality=90)
    cases = [(p, SMALL) for p in sorted(glob.glob(
        os.path.join(tree, "Data", "**", "*.JPEG"), recursive=True))]
    assert len(cases) == 15
    for path, kw in cases + [(big, {})]:
        assert transforms.frame_route(path) == "pil"
        np.testing.assert_allclose(transforms.load_image_bgr(path),
                                   cv2.imread(path).astype(np.float32),
                                   rtol=0, atol=PIL_CV2_ATOL)
        got, gs = transforms.prepare_frame(path, InputConfig(**kw), flip)
        want, ws = j_transforms.prepare_frame(path, JInputConfig(**kw), flip,
                                              use_native=False)
        assert gs == ws
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=PIL_CV2_ATOL + RESIZE_ATOL)


def test_prepare_pair_pil_route_matches_dtt_cv2_path(tree, monkeypatch):
    """Every sample of the VID and DET roidb, flipped and not, with neither
    package's native library: images within PIL_CV2_ATOL + RESIZE_ATOL of
    dtt's cv2 route; gt_boxes, labels, valid, im_scale and im_size
    equal."""
    _without_native(monkeypatch)
    got_db, want_db = _roidb(tree)
    assert any(e["flipped"] for e in want_db)
    cfg, jcfg = InputConfig(**SMALL), JInputConfig(**SMALL)
    for g, w in zip(got_db, want_db):
        got = transforms.prepare_pair(g, cfg)
        want = j_transforms.prepare_pair(w, jcfg)
        np.testing.assert_allclose(got.pop("images"), want.pop("images"),
                                   rtol=0, atol=PIL_CV2_ATOL + RESIZE_ATOL)
        _assert_same_tree(got, want)


def test_flip_image_and_boxes_matches_dtt():
    rng = np.random.RandomState(5)
    img = rng.rand(6, 9, 3).astype(np.float32)
    boxes = rng.uniform(0, 8, (4, 4)).astype(np.float32)
    for got, want in zip(transforms.flip_image_and_boxes(img, boxes),
                         j_transforms.flip_image_and_boxes(img, boxes)):
        np.testing.assert_array_equal(got, want)


def _roidb(tree, use_flipped=True):
    names = "imagenet_vid_train+imagenet_det_train"
    return (combined_roidb(names, root=tree, use_flipped=use_flipped),
            j_combined_roidb(names, root=tree, use_flipped=use_flipped))


def test_prepare_pair_matches_dtt(tree):
    """Every sample of the VID and DET roidb, flipped and not: images,
    gt_boxes, labels, valid, im_scale and im_size equal."""
    got_db, want_db = _roidb(tree)
    assert any(e["flipped"] for e in want_db)
    for kw in (SMALL, {"max_gt_boxes": 4}):
        for g, w in zip(got_db, want_db):
            _assert_same_tree(transforms.prepare_pair(g, InputConfig(**kw)),
                              j_transforms.prepare_pair(w, JInputConfig(**kw)))
            assert (transforms.prepare_image(g["paths"][0], InputConfig(**kw))
                    [0] == j_transforms.prepare_image(
                        w["paths"][0], JInputConfig(**kw))[0]).all()


def test_prepare_pair_track_alignment_and_leaving_object(tree):
    """A track leaves mid-snippet: its slot stays, invalid at tau."""
    db, _ = _roidb(tree, use_flipped=False)
    cfg = InputConfig(**SMALL)
    entry = [e for e in db if e["paths"][0].endswith("snippet_000/000001.JPEG")
             and "/VID/" in e["paths"][0]][0]
    s = transforms.prepare_pair(entry, cfg)
    assert s["gt_valid"][0, 1] and not s["gt_valid"][1, 1]   # left at t=2
    assert s["gt_valid"][:, 0].all()


# ------------------------------------------------------------------ roidb

def test_roidbs_match_dtt(tree):
    """VID train (flipped), VID val, DET, and the combined roidb with its
    source tags: the same entries in the same order."""
    assert {"imagenet_vid_train", "imagenet_vid_val",
            "imagenet_det_train"} <= set(list_datasets())
    got, want = _roidb(tree)
    _assert_same_tree(got, want)
    assert {e["source"] for e in got} == {"imagenet_vid_train",
                                          "imagenet_det_train"}
    for cls_t, cls_j, kw in [(t_vid.ImagenetVID, j_vid.ImagenetVID,
                              {"split": "val", "use_flipped": False}),
                             (t_vid.ImagenetVID, j_vid.ImagenetVID,
                              {"split": "train", "tau": 2}),
                             (t_vid.ImagenetDET, j_vid.ImagenetDET,
                              {"max_images": 2})]:
        _assert_same_tree(cls_t(root=tree, **kw).roidb(),
                          cls_j(root=tree, **kw).roidb())
    det = t_vid.ImagenetDET(root=tree).roidb()
    assert all(e["paths"][0] == e["paths"][1] for e in det)
    assert t_vid.CLASS_NAMES == j_vid.CLASS_NAMES
    assert t_vid.WNID_TO_LABEL == j_vid.WNID_TO_LABEL


def test_vid_roidb_cache(tree, tmp_path):
    """The snippet pickle cache: written once, then read back."""
    a = t_vid.ImagenetVID(root=tree, cache_dir=str(tmp_path))
    assert os.path.exists(tmp_path / "vid_train_tau1.pkl")
    b = t_vid.ImagenetVID(root=str(tmp_path / "missing"),
                          cache_dir=str(tmp_path))
    _assert_same_tree(b.roidb(), a.roidb())


def test_parse_vid_xml_matches_dtt(tree):
    ann_dir = os.path.join(tree, "Annotations", "DET", "train", "fold")
    for name in sorted(os.listdir(ann_dir)):
        path = os.path.join(ann_dir, name)
        _assert_same_tree(t_vid.parse_vid_xml(path), j_vid.parse_vid_xml(path))


# ----------------------------------------------------------------- loader

@pytest.mark.parametrize("det_fraction", [None, 0.5])
def test_pair_loader_matches_dtt(tree, det_fraction):
    """The same seed gives the same batches as dtt's PairLoader, with and
    without the DET:VID mixture, over more than one epoch."""
    got_db, want_db = _roidb(tree)
    cfg = dict(SMALL)
    got = PairLoader(got_db, InputConfig(**cfg), batch_size=3, seed=7,
                     num_workers=3, det_fraction=det_fraction)
    want = JPairLoader(want_db, JInputConfig(**cfg), batch_size=3, seed=7,
                       num_workers=3, det_fraction=det_fraction)
    n = 2 * len(got_db) // 3 + 1
    try:
        for g, w, _ in zip(got, want, range(n)):
            _assert_same_tree(g, w)
    finally:
        got.stop()
        want.stop()


def test_pair_loader_raises_worker_errors():
    def broken(entry, cfg):
        raise OSError("unreadable frame")
    loader = PairLoader([{"source": "x"}] * 4, InputConfig(), 2,
                        prepare_fn=broken)
    with pytest.raises(OSError, match="unreadable frame"):
        next(iter(loader))
    loader.stop()
    with pytest.raises(ValueError, match="empty roidb"):
        PairLoader([], InputConfig(), 2)


# -------------------------------------------------------------- synthetic

def test_sample_params_batch_matches_dtt():
    for n_obj in (None, (2, 5)):
        got = synthetic.sample_params_batch(np.random.RandomState(3), 3, 64,
                                            96, 31, 6, num_objects=n_obj)
        want = j_synthetic.sample_params_batch(np.random.RandomState(3), 3,
                                               64, 96, 31, 6,
                                               num_objects=n_obj)
        _assert_same_tree(got, want)
        assert "images" not in got


@pytest.mark.parametrize("hw", [(64, 96), (608, 1088)])
def test_render_frame_matches_dtt(hw):
    """The port's renderer (on CPU tensors) against dtt's host renderer on
    the same background: pixel-exact, objects overlapping, clipped at the
    edges; against dtt's jnp renderer within dtt's own bound."""
    rng = np.random.RandomState(hw[0])
    h, w = hw
    for trial in range(3):
        p = j_synthetic.sample_pair_params(rng, h, w, 31, 8,
                                           num_objects=(3, 8))
        p["gt_boxes"][:, 0] += [[-20, -10, 5, 5], [10, 0, 40, 60]]
        background = rng.randint(23, 38, (h, w, 3)).astype(np.uint8)
        for f in range(2):
            args = (p["gt_boxes"][f], p["gt_labels"], p["gt_valid"][f])
            host = j_synthetic.render_frame(background.copy(), *args)
            got = device_synth.render_frame(
                *(torch.from_numpy(a) for a in args),
                torch.from_numpy(background)).numpy()
            np.testing.assert_array_equal(got, host)
            jdev = np.asarray(j_device_synth.render_frame(
                *(jnp.asarray(a) for a in args), jnp.asarray(background)))
            diff = np.abs(got.astype(int) - jdev.astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def test_render_frame_skips_invalid_and_degenerate():
    boxes = np.array([[5, 5, 20, 20], [8, 8, 8, 8], [2, 2, 25, 25],
                      [2.5, 3.5, 9.5, 10.5]], np.float32)
    labels = np.array([1, 2, 3, 4], np.int32)
    valid = np.array([True, True, False, True])
    background = np.zeros((32, 32, 3), np.uint8)
    got = device_synth.render_frame(torch.from_numpy(boxes),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(background)).numpy()
    np.testing.assert_array_equal(got, j_synthetic.render_frame(
        background.copy(), boxes, labels, valid))
    assert (got[:, 26:] == 0).all()
    with pytest.raises(ValueError, match="class ids"):
        device_synth.render_frame(torch.from_numpy(boxes),
                                  torch.full((4,), 300),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(background))


def test_render_pairs_background_and_objects():
    """Backgrounds are uniform integers in [23, 37] from the generator (the
    same seed, the same canvases), and the objects are the host
    renderer's on that background."""
    h, w = 24, 40
    empty = device_synth.render_pairs(
        np.zeros((2, 2, 3, 4), np.float32), np.zeros((2, 3), np.int32),
        np.zeros((2, 2, 3), bool), torch.Generator().manual_seed(0), h, w,
        device="cpu")
    assert empty.shape == (2, 2, h, w, 3) and empty.dtype == torch.uint8
    assert empty.min() == 23 and empty.max() == 37
    assert 28 < empty.float().mean() < 32
    p = synthetic.sample_params_batch(np.random.RandomState(1), 2, h, w, 31, 3)
    out = device_synth.render_pairs(p["gt_boxes"], p["gt_labels"],
                                    p["gt_valid"],
                                    torch.Generator().manual_seed(5), h, w,
                                    device="cpu").numpy()
    bg = device_synth.pair_background(torch.Generator().manual_seed(5), 2, h,
                                      w, "cpu").numpy()
    for b in range(2):
        for f in range(2):
            np.testing.assert_array_equal(out[b, f], synthetic.render_frame(
                bg[b, f].copy(), p["gt_boxes"][b, f], p["gt_labels"][b],
                p["gt_valid"][b, f]))
    render = device_synth.make_pair_render_fn(h, w, "cpu")
    np.testing.assert_array_equal(
        render(p, torch.Generator().manual_seed(5)).numpy(), out)


# ------------------------------------------------------------ train script

TINY = os.path.join(REPO, "configs", "tiny_synth.yml")


@pytest.mark.parametrize("source", [
    ["--dataset", "imagenet_vid_train+imagenet_det_train"],
    ["--synthetic", "--device-render"]])
def test_train_torch_trains_on_a_dataset_and_on_device_render(tree, tmp_path,
                                                              source):
    """train_torch.main on the CPU: tiny steps from the loader (VID and DET
    mixed 1:1) or from scene parameters drawn by the renderer, finite
    losses logged, a checkpoint, and a resumed run that continues it."""
    import train_torch
    from dtt_torch.train.checkpoint import latest_checkpoint

    out = str(tmp_path / "run")

    def run(steps, *extra):
        return train_torch.main(
            [*source, "--data-root", tree, "--config", TINY, "--out", out,
             "--num-workers", "2", *extra, "--set",
             f"train.total_steps={steps}", "train.batch_size_per_chip=2",
             "train.log_every=1", "input.det_fraction=0.5",
             "model.num_classes=31"], device="cpu")

    assert run(2).step == 2
    assert latest_checkpoint(out).endswith("step_00000002")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [m["step"] for m in logged] == [1, 2]
    for m in logged:
        assert np.isfinite(m["total"]) and m["rpn_cls"] > 0
    assert run(3, "--resume").step == 3
