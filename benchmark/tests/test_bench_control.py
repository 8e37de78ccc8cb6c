"""The control: the plain reference in float8 (e4m3, a scale per tensor)
put in the program's place comes out not correct under the cell's
limits, and the program on the same sample correct. At the tiny size on
the CPU, and with the card at the cell's own size (one seed, a short
window at its load; the limits' readings over more seeds come from
``benchmark/readings.py --control``)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import ROOT, tiny_cell


def _readings(cell, seed, seconds, device):
    """The program's and the control's numbers on one sample, each with
    the harness's verdict on it."""
    from dtt_torch.core.config import config_from_dict
    from benchmark import cells
    from benchmark.run import compare
    from benchmark.trace import Spans
    cd = cell["config"]["config"]
    ctx = SimpleNamespace(cfg=config_from_dict(cd), cfg_dict=cd,
                          traffic=cell["traffic"], seed=seed, spans=Spans(),
                          workload=cell["workload"]["name"], device=device)
    run = cells.load_module("kinds", cell["traffic"]["kind"], ROOT).make(ctx)
    run.setup()
    run.window(seconds, False)
    program = run.check()
    control = run.control()
    return ((program, compare(program, cell["limits"])[1]),
            (control, compare(control, cell["limits"])[1]))


def test_control_fails_and_program_passes_at_tiny_size():
    cell = tiny_cell()
    (program, ok), (control, control_ok) = _readings(cell, 2**31 + 55,
                                                     0.3, "cpu")
    assert ok, program
    assert not control_ok, control


@pytest.mark.gpu
def test_control_fails_and_program_passes_at_the_cells_size(cuda):
    from benchmark import cells
    cell = cells.cell(ROOT, "dnt-r101.vid-snippets")
    (program, ok), (control, control_ok) = _readings(cell, 2**31 + 77,
                                                     5.0, "cuda")
    assert ok, program
    assert not control_ok, control
