"""A run of the video cell's whole path at a tiny size on the CPU, the
harness's look for a card skipped: sound, it comes out correct; with the
timed path broken underneath it comes out not correct, once for each
fault the cell can have (a step that returns its state unchanged, half
of a chunk's pairs left out, an answer altered where it is produced; the
cell runs on one chip, so no exchange between chips can be left out).
The limits are the real cell's."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_cell

SEED = 2**31 + 101


def _run(cell):
    from benchmark import run as brun
    return brun.run_cell(cell, SEED, 0.5, False, device="cpu")


def _broken(monkeypatch, fault):
    """Wrap the program's video step so that its outputs carry `fault`."""
    from dtt_torch.eval import inference
    make = inference.make_video_step

    def make_broken(cfg, model, frames_per_chunk=33, device=None):
        step = make(cfg, model, frames_per_chunk, device)
        last = {}

        def broken(x, im_hw, scale=1.0):
            out = step(x, im_hw, scale)
            return fault(out, last)

        broken.__dict__.update(step.__dict__)
        return broken

    monkeypatch.setattr(inference, "make_video_step", make_broken)


def _stale(out, last):
    """The step's state unchanged: every call returns the first call's
    outputs."""
    last.setdefault("out", out)
    return last["out"]


def _half(out, last):
    """Half of the chunk's pairs left out: no detections there."""
    b, s, v, t = out
    n = b.shape[0] // 2
    v, s = v.clone(), s.clone()
    v[n:], s[n:] = False, 0.0
    return type(out)(b, s, v, t)


def _boxes(out, last):
    """An answer altered where it is produced: every box moved 2 px."""
    return type(out)(out.boxes + 2.0, out.scores, out.valid, out.tracked)


def _scores(out, last):
    """An answer altered where it is produced: scores raised by 0.1."""
    return type(out)(out.boxes, out.scores + 0.1 * out.valid, out.valid,
                     out.tracked)


def test_sound_run_is_correct():
    line = _run(tiny_cell())
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [_stale, _half, _boxes, _scores],
                         ids=["state_unchanged", "half_left_out",
                              "boxes_altered", "scores_altered"])
def test_broken_run_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    line = _run(tiny_cell())
    assert not line["correct"], line["checks"]


def test_broken_linking_is_not_correct(monkeypatch):
    """Tube rescoring altered where it is produced."""
    from dtt_torch.eval import inference
    link = inference.link_snippet

    def broken(*a, **k):
        rescored, tubes = link(*a, **k)
        return rescored * 0.9, tubes

    monkeypatch.setattr(inference, "link_snippet", broken)
    line = _run(tiny_cell())
    assert not line["correct"]
    assert line["checks"]["link_gap"]["value"] > line["checks"]["link_gap"]["limit"]
