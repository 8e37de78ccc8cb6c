"""The plain reference against ``dtt_torch`` on the CPU at a tiny size:
the same weights and frames give the same detections, tracked boxes and
linked tubes (the program's plain forms run there, in float32)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import tiny_config


def test_weight_names_and_shapes_are_the_programs():
    from dtt_torch.core.config import Config
    from dtt_torch.models.dnt import DnT
    from benchmark.reference.dnt import param_spec
    for backbone in ("resnet101", "resnet50"):
        cfg = Config()
        cfg = cfg.replace(model=cfg.model.replace(backbone=backbone))
        want = {k: tuple(v.shape) for k, v in
                DnT(cfg.model, device="meta").state_dict().items()}
        got = {n: s for n, s, _ in param_spec(dataclasses.asdict(cfg)["model"])}
        assert got == want


@pytest.fixture(scope="module")
def tiny_run():
    from dtt_torch.core.config import config_from_dict
    from dtt_torch.eval.inference import (evaluate_snippet_video,
                                          link_snippet, make_video_step)
    from dtt_torch.models.dnt import make_model
    from benchmark.weights import make_weights
    cd = tiny_config()
    cfg = config_from_dict(cd)
    w = make_weights(cd["model"], 2**31 + 3, "cpu")
    model = make_model(cfg.model, "cpu")
    model.load_state_dict(w)
    frames = np.random.RandomState(5).randint(0, 256, (7, 64, 96, 3)).astype(
        np.uint8)
    step = make_video_step(cfg, model, 4, device="cpu")
    out = evaluate_snippet_video(cfg, step, frames, im_hw=(56, 80))
    rescored, tubes = link_snippet(cfg, out[0], out[1], out[3], out[2],
                                   device="cpu")
    return cd, w, frames, out, rescored, tubes


def test_reference_detections_equal_the_programs(tiny_run):
    from benchmark.reference import dnt as ref
    cd, w, frames, (b, s, v, tr), _, _ = tiny_run
    r = ref.snippet_detections(cd, w, frames, list(range(len(frames))),
                               (56, 80), "cpu", ref.Precision())
    assert sum(int(x["valid"].sum()) for x in r) > 0
    for t, x in enumerate(r):
        np.testing.assert_array_equal(x["valid"].numpy(), v[:, t])
        np.testing.assert_allclose(x["scores"].numpy(), s[:, t], atol=1e-5)
        np.testing.assert_allclose(x["boxes"].numpy(), b[:, t], atol=1e-3)
        np.testing.assert_allclose(x["tracked"].numpy(), tr[:, t], atol=1e-3)


def test_reference_linking_equals_the_programs(tiny_run):
    from benchmark.reference import linking as rlink
    cd, _, _, (b, s, v, tr), rescored, tubes = tiny_run
    ev = cd["eval"]
    got = rlink.link(*(torch.from_numpy(x) for x in (b, s, tr, v)),
                     ev["max_tubes_per_class"], ev["link_iou_weight"],
                     ev["tube_score_boost"])
    np.testing.assert_array_equal(got["det_in_tube"].numpy(),
                                  tubes.det_in_tube)
    np.testing.assert_allclose(got["rescored"].numpy(), rescored, atol=1e-6)
    np.testing.assert_array_equal(got["det_idx"].numpy(), tubes.det_idx)


def test_float8_control_moves_every_stage(tiny_run):
    """The control's rounding reaches the trunk, the heads and linking."""
    from benchmark.reference import dnt as ref
    cd, w, frames, _, _, _ = tiny_run
    a = ref.snippet_detections(cd, w, frames, [0], (56, 80), "cpu",
                               ref.Precision())[0]
    b = ref.snippet_detections(cd, w, frames, [0], (56, 80), "cpu",
                               ref.Precision("fp8"))[0]
    assert not torch.equal(a["cls_prob"], b["cls_prob"])
    q = ref.Precision("fp8")
    x = torch.linspace(0.01, 1, 97)
    assert 0 < (q(x) - x).abs().max() < 0.07
