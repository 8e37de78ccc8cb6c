"""Streaming evaluation of dataset snippets in the port, held against dtt
on the CPU: LazyFrames decodes each frame once with a bounded cache, the
snippet drivers size that cache to their working set, streamed detections
equal stacked ones bit for bit, and ``eval_torch.py --dataset`` gives
``eval.py``'s detections and mAP on the same tree and weights.

Trees are written in the test (``tests/vid_tree.py``). Tolerances:
frames, gt arrays and streamed-vs-stacked detections equal; the end-to-end
comparison as ``tests/test_torch_port_eval_script.py`` (scores 1e-5,
boxes 1e-2 pixels, APs 1e-6).
"""

import argparse
import importlib
import json
import os
import pickle
import sys

import numpy as np
import optax
import pytest
import torch

from dtt.core.config import load_config as j_load_config
from dtt.train.checkpoint import save_checkpoint as j_save_checkpoint
from dtt.train.trainer import TrainState

from dtt_torch.core.config import load_config
from dtt_torch.data.imagenet_vid import ImagenetVID
from dtt_torch.data.transforms import prepare_image
from tests.vid_tree import write_vid_tree
from dtt_torch.eval.inference import (LazyFrames, PairOutputs,
                                      evaluate_snippet, evaluate_snippet_video,
                                      make_video_step)
from dtt_torch.eval.vid_eval import det_arrays
from dtt_torch.models.dnt import make_model
from dtt_torch.train.checkpoint import save_checkpoint
from dtt_torch.train.trainer import create_train_state
from dtt_torch.utils.params import init_jax_params

import eval_torch

eval_script = importlib.import_module("eval")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tiny_synth.yml")
VID31 = ["model.num_classes=31"]          # the dataset's label space
T_LONG = 220


@pytest.fixture(scope="module")
def long_tree(tmp_path_factory):
    """One val snippet of 220 frames at 64 x 96 (scale 1 on the tiny
    canvas)."""
    root = str(tmp_path_factory.mktemp("long"))
    write_vid_tree(root, seed=3, height=64, width=96, train_frames=(),
                   val_frames=(T_LONG,), det_images=0, num_objects=1)
    return root


@pytest.fixture(scope="module")
def val_tree(tmp_path_factory):
    """Two val snippets (9 and 6 frames) at 96 x 128: scaled by 2/3 onto
    the tiny 64 x 96 canvas, with a strip of padding."""
    root = str(tmp_path_factory.mktemp("val"))
    write_vid_tree(root, seed=4, height=96, width=128, train_frames=(),
                   val_frames=(9, 6), det_images=0, num_objects=3)
    return root


def test_snippet_stream_reads_headers_and_decodes_lazily(long_tree):
    """eval_torch's dataset stream gives dtt's name, extent, scale and gt
    arrays from the annotation headers, with nothing decoded; then the
    frames read through chunked access with one frame of overlap decode
    once each, equal to dtt's, and the cache stays at its cap."""
    cfg = load_config(CONFIG, VID31)
    snippets = ImagenetVID(root=long_tree, split="val",
                           use_flipped=False).snippets
    (name, frames, im_hw, scale, gt), = list(
        eval_torch.snippet_stream_vid(cfg, snippets))
    args = argparse.Namespace(dataset="imagenet_vid_val", data_root=long_tree,
                              max_snippets=None)
    (j_name, j_frames, j_hw, j_scale, j_gt), = list(
        eval_script.snippet_stream_vid(j_load_config(CONFIG, VID31), args))
    assert isinstance(frames, LazyFrames) and frames.decode_count == 0
    assert (name, im_hw, scale) == (j_name, j_hw, j_scale) == (
        "snippet_000", (64, 96), 1.0)
    assert frames.shape == j_frames.shape == (T_LONG, 64, 96, 3)
    for got, want in zip(gt, j_gt):
        np.testing.assert_array_equal(got, want)
    f, start = 9, 0
    while start < T_LONG:
        for i in range(start, start + f):
            t = min(i, T_LONG - 1)
            np.testing.assert_array_equal(frames[t], j_frames[t])
        start += f - 1
    assert frames.decode_count == T_LONG and frames.peak_cached <= 8
    assert frames.decode_ms > 0
    with pytest.raises(IndexError):
        frames[T_LONG]
    np.testing.assert_array_equal(frames[-1], frames[T_LONG - 1])


def _fake_lazy(t_len, cfg, h=8, w=12):
    """LazyFrames over index 'paths' with a counting fake decoder."""
    imgs = np.random.RandomState(0).randint(0, 255, (t_len, h, w, 3)
                                            ).astype(np.uint8)
    cfg_in = cfg.input.replace(canvas_height=h, canvas_width=w)
    return LazyFrames(list(range(t_len)), cfg_in,
                      prepare=lambda p, _: (imgs[p], 1.0))


def _fake_outputs(b, m=5):
    return PairOutputs(torch.zeros(b, 2, m, 4), torch.zeros(b, 2, m),
                       torch.zeros(b, 2, m, dtype=torch.bool),
                       torch.zeros(b, 2, m, 4))


@pytest.mark.parametrize("fpc", [9, 32])
def test_video_eval_decodes_each_frame_once(fpc):
    """evaluate_snippet_video grows the cache to its chunk and overlap."""
    cfg = load_config(CONFIG)
    t_len = 100
    frames = _fake_lazy(t_len, cfg)

    def video_step(chunk, im_hw, scale):
        assert chunk.shape[0] == fpc
        return _fake_outputs(fpc - 1)

    video_step.frames_per_chunk, video_step.device = fpc, torch.device("cpu")
    evaluate_snippet_video(cfg, video_step, frames, im_hw=(8, 12))
    assert frames.decode_count == t_len
    assert frames.peak_cached <= fpc + 1


@pytest.mark.parametrize("tau,batch", [(1, 4), (2, 16), (3, 16)])
def test_strided_eval_decodes_each_frame_once(tau, batch):
    """evaluate_snippet grows the cache to a batch of pairs, so the
    touched frames of tau-strided batches decode once."""
    cfg = load_config(CONFIG)
    t_len = 97
    frames = _fake_lazy(t_len, cfg)

    def pair_step(pairs, im_hw, scale):
        assert pairs.shape[:2] == (batch, 2)
        return _fake_outputs(batch)

    pair_step.batch, pair_step.device = batch, torch.device("cpu")
    evaluate_snippet(cfg, pair_step, frames, tau=tau, im_hw=(8, 12))
    touched = {min(t + d, t_len - 1)
               for t in range(0, t_len, tau) for d in (0, tau)}
    assert frames.decode_count == len(touched)
    assert frames.peak_cached <= 2 * batch


def test_streamed_eval_matches_stacked(val_tree):
    """evaluate_snippet_video over a LazyFrames equals it over the stacked
    snippet bit for bit (tiny model, float32, CPU)."""
    cfg = load_config(CONFIG, VID31)
    model = make_model(cfg.model, device="cpu")
    step = make_video_step(cfg, model, 4, device="cpu")
    sn = ImagenetVID(root=val_tree, split="val", use_flipped=False).snippets[0]
    stacked = np.stack([prepare_image(p, cfg.input)[0] for p in sn.frames])
    lazy = LazyFrames(sn.frames, cfg.input)
    out_lazy = evaluate_snippet_video(cfg, step, lazy, im_hw=(64, 85),
                                      scale=2 / 3)
    out_stacked = evaluate_snippet_video(cfg, step, stacked, im_hw=(64, 85),
                                         scale=2 / 3)
    for a, b in zip(out_lazy, out_stacked):
        np.testing.assert_array_equal(a, b)
    assert lazy.decode_count == len(sn.frames)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of tiny weights for VID's 31 classes, as a dtt checkpoint
    and as a port checkpoint."""
    root = tmp_path_factory.mktemp("ck")
    cfg_t = load_config(CONFIG, VID31)
    tree = init_jax_params(cfg_t.model, seed=2)
    _, state = create_train_state(cfg_t, "cpu", tree=tree)
    save_checkpoint(str(root / "port"), state, cfg_t)
    j_state = TrainState(params=tree, opt_state=optax.sgd(0.1).init(tree),
                         step=np.zeros((), np.int32))
    j_save_checkpoint(str(root / "dtt"), j_state, j_load_config(CONFIG, VID31))
    return str(root / "dtt"), str(root / "port")


@pytest.mark.parametrize("extra", [["--link"], ["--tau", "2"]])
def test_eval_torch_dataset_matches_eval_py(val_tree, checkpoints, tmp_path,
                                            monkeypatch, capsys, extra):
    """eval_torch.main --dataset against eval.py --dataset, in process, on
    the same tree and weights: the same detections, ground truth and mAP;
    every frame decoded once."""
    j_ck, t_ck = checkpoints
    j_out, t_out = str(tmp_path / "dtt.pkl"), str(tmp_path / "port.pkl")
    data = ["--dataset", "imagenet_vid_val", "--data-root", val_tree,
            "--set", *VID31]
    monkeypatch.setattr("dtt.utils.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["eval.py", "--config", CONFIG,
                                      "--checkpoint", j_ck, "--out", j_out,
                                      *data, *extra])
    eval_script.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, clock, pairs = eval_torch.main(
        ["--config", CONFIG, "--checkpoint", t_ck, "--out", t_out, *data,
         *extra], device="cpu")
    printed = capsys.readouterr().out
    assert json.loads(printed.strip().splitlines()[-1]) == got
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, abs=1e-6), key
        else:
            assert got[key] == value, key
    assert pairs == (15 if extra == ["--link"] else 8)
    assert clock["decode_in_detect"] > 0
    tau = int(extra[-1]) if extra[0] == "--tau" else 1
    for t_len in (9, 6):                 # the frames the pairs touch, once
        touched = {min(t + d, t_len - 1)
                   for t in range(0, t_len, tau) for d in (0, tau)}
        assert (f"{t_len} frames done (tau={tau}), {len(touched)} decoded"
                in printed)

    with open(j_out, "rb") as f:
        j_pkl = pickle.load(f)
    with open(t_out, "rb") as f:
        t_pkl = pickle.load(f)
    n_dets = 0
    for c, j_dets in j_pkl["dets"].items():
        jf, js, jb = det_arrays(j_dets)
        tf, ts, tb = det_arrays(t_pkl["dets"][c])
        np.testing.assert_array_equal(tf, jf, err_msg=f"class {c} frames")
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-2)
        n_dets += jf.size
    assert n_dets > 0
    assert t_pkl["gts"].keys() == j_pkl["gts"].keys()
    for c, frames in j_pkl["gts"].items():
        assert t_pkl["gts"][c].keys() == frames.keys()
        for fid, boxes in frames.items():
            np.testing.assert_array_equal(t_pkl["gts"][c][fid], boxes)
