"""eval_torch.py held against eval.py on the CPU, end to end: the same tiny
weights saved once as a dtt checkpoint and once as a port checkpoint, the
same synthetic snippet (configs/tiny_synth.yml, 64x96), once with tube
linking at tau=1 and once tau-strided at tau=2. eval.py runs in process
with its own argument parsing; eval_torch.main runs with device="cpu".

The detections pickled by --out must name the same frames per class, with
scores to 1e-5 and boxes to 1e-2 pixels (float32 roundoff of a whole
network, as tests/test_torch_port_video.py); the APs printed in the JSON
line must agree to 1e-6.
"""

import importlib
import json
import os
import pickle
import sys

import numpy as np
import optax
import pytest

from dtt.core.config import load_config as j_load_config
from dtt.train.checkpoint import save_checkpoint as j_save_checkpoint
from dtt.train.trainer import TrainState

from dtt_torch.core.config import load_config
from dtt_torch.eval.vid_eval import det_arrays
from dtt_torch.train.checkpoint import save_checkpoint
from dtt_torch.train.trainer import create_train_state
from dtt_torch.utils.params import init_jax_params

import eval_torch

eval_script = importlib.import_module("eval")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "tiny_synth.yml")
SNIPPET = ["--synthetic", "--synthetic-snippets", "1", "--synthetic-frames",
           "8"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of flax-layout weights (numpy seed) as a dtt checkpoint and
    as a port checkpoint."""
    root = tmp_path_factory.mktemp("eval_ck")
    cfg_t = load_config(CONFIG)
    tree = init_jax_params(cfg_t.model, seed=2)
    _, state = create_train_state(cfg_t, "cpu", tree=tree)
    save_checkpoint(str(root / "port"), state, cfg_t)
    j_state = TrainState(params=tree, opt_state=optax.sgd(0.1).init(tree),
                         step=np.zeros((), np.int32))
    j_save_checkpoint(str(root / "dtt"), j_state, j_load_config(CONFIG))
    return str(root / "dtt"), str(root / "port")


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [["--link"], ["--tau", "2"]])
def test_eval_torch_matches_eval_py(checkpoints, tmp_path, monkeypatch,
                                    capsys, extra):
    j_ck, t_ck = checkpoints
    j_out, t_out = str(tmp_path / "dtt.pkl"), str(tmp_path / "port.pkl")
    # the persistent XLA cache would land in the checkout
    monkeypatch.setattr("dtt.utils.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["eval.py", "--config", CONFIG,
                                      "--checkpoint", j_ck, "--out", j_out,
                                      *SNIPPET, *extra])
    eval_script.main()
    want = _last_json(capsys.readouterr().out)
    got, clock, pairs = eval_torch.main(
        ["--config", CONFIG, "--checkpoint", t_ck, "--out", t_out, *SNIPPET,
         *extra], device="cpu")
    printed = capsys.readouterr().out
    assert _last_json(printed) == got
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, abs=1e-6), key
        else:
            assert got[key] == value, key
    assert {"mAP_nolink", "link_uplift"} <= set(got)
    assert pairs == (8 if extra == ["--link"] else 4)
    assert clock["detect"] > 0 and clock["link"] > 0
    # the phases of the wall ms line, in its order, as the dict has them
    phases = (["detect", "link", "eval_detections"] if extra == ["--link"]
              else ["detect", "link", "interpolate+nms", "eval_detections"])
    assert list(clock) == phases
    (line,) = [x for x in printed.splitlines() if x.startswith("wall ms: ")]
    assert [x.rsplit(" ", 1)[0] for x in
            line[len("wall ms: "):].split("; ")[0].split(", ")] == phases

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


def test_eval_torch_reads_the_checkpoints_config(checkpoints):
    """Without --config the model is rebuilt from the config the
    checkpoint saved (tuples come back as lists), and --set applies on top
    of it."""
    _, t_ck = checkpoints
    cfg, model = eval_torch.load_model(eval_torch.parse_args(
        ["--checkpoint", t_ck, "--synthetic", "--set",
         "model.roi.eval_pool_impl=gather"]), "cpu")
    assert cfg.model.roi.eval_pool_impl == "gather"
    assert cfg.replace(model=cfg.model.replace(roi=cfg.model.roi.replace(
        eval_pool_impl="direct"))) == load_config(CONFIG)
    assert next(model.parameters()).device.type == "cpu"


def test_eval_torch_helpers_match_eval_py():
    """The port's copies of eval.py's host helpers: the per-frame cap
    across classes and the track-aligned ground truth."""
    rng = np.random.RandomState(0)
    scores, valid = rng.rand(3, 2, 4).astype(np.float32), rng.rand(3, 2, 4) > .2
    np.testing.assert_array_equal(eval_torch.cap_frame_dets(scores, valid, 5),
                                  eval_script.cap_frame_dets(scores, valid, 5))
    annots = [{"boxes": rng.uniform(0, 50, (n, 4)),
               "labels": np.arange(n) % 3 + 1, "trackids": np.arange(n)[::-1]}
              for n in (3, 1, 4)]
    for got, want in zip(eval_torch.snippet_gt_arrays(annots, 0.5),
                         eval_script.snippet_gt_arrays(annots, 0.5)):
        np.testing.assert_array_equal(got, want)
