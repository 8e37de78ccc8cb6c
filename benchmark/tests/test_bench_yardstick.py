"""The yardstick's arithmetic: the frozen bounds give the bound column of
the port's kernel table, and the model FLOP count agrees with
``torch.utils.flop_counter`` over the plain reference."""

from __future__ import annotations

import dataclasses

import pytest
import torch


def test_frozen_bounds_give_the_kernel_tables_column():
    from benchmark import roofline
    # the table's "V": a 17-frame chunk of the video path, 16 pairs
    calls = roofline.epilogue_calls("resnet101", 17, 608, 1088)
    assert len(calls) == 100
    assert round(roofline.epilogue_bound_ms(calls), 4) == 5.5994
    assert round(roofline.corr_bound_ms(16, 38, 68, [512, 1024, 1024], 81),
                 4) == 0.1324
    assert len(roofline.epilogue_calls("resnet50", 1, 608, 1088)) == 49


def test_busy_ms_is_the_union_of_intervals():
    from benchmark.roofline import busy_ms
    assert busy_ms([(0, 1000), (500, 1500), (3000, 4000)]) == 2.5


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_flops_agree_with_the_flop_counter(backbone):
    from torch.utils.flop_counter import FlopCounterMode
    from dtt_torch.core.config import Config
    from benchmark import flops
    from benchmark.reference import dnt as ref
    from benchmark.weights import make_weights
    cfg = Config()
    cfg = cfg.replace(model=cfg.model.replace(backbone=backbone),
                      input=cfg.input.replace(canvas_height=64,
                                              canvas_width=128))
    cd = dataclasses.asdict(cfg)
    m = cd["model"]
    w = make_weights(m, 1, "cpu")
    x = torch.zeros(1, 3, 64, 128)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        f = ref.Trunk(w, m, ref.Precision())(x)
    assert fc.get_total_flops() == flops.trunk_flop(m, 64, 128)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.head_maps(w, m, f, f, ref.Precision())
    h16, w16 = 64 // 16, 128 // 16
    assert fc.get_total_flops() == flops.map_flop(m, h16, w16)
    # the correlation is elementwise, which the counter leaves out
    assert flops.corr_flop(m, h16, w16) == 2 * (512 + 1024 + 1024) * 81 * h16 * w16


def test_video_pair_flop_at_the_cells_size():
    from dtt_torch.core.config import Config
    from benchmark import flops
    cd = dataclasses.asdict(Config())
    assert 296e9 < flops.trunk_flop(cd["model"], 608, 1088) < 298e9
    assert 310e9 < flops.video_pair_flop(cd) < 311e9
