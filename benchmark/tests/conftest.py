"""Shared pieces of the benchmark's own tests: the ``gpu`` marker (a
test that needs the card takes the ``cuda`` fixture and skips without
one), and a tiny configuration and traffic that the CPU runs the video
cell's whole path at, through the program's plain forms."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_config() -> dict:
    """The program's configuration at a tiny size (float32 compute)."""
    from dtt_torch.core.config import Config
    cfg = Config()
    m = cfg.model
    cfg = cfg.replace(
        model=m.replace(backbone="tiny", dtype="float32",
                        reduced_channels=64, num_classes=4,
                        rpn=m.rpn.replace(channels=32, pre_nms_top_n_test=200,
                                          post_nms_top_n_test=50),
                        roi=m.roi.replace(ps_grid=3),
                        track=m.track.replace(max_displacement=2, stride=1)),
        input=cfg.input.replace(canvas_height=64, canvas_width=96))
    return dataclasses.asdict(cfg)


TINY_TRAFFIC = {"kind": "video", "chunk": 4,
                "snippet_blocks": [[3, 9], [5, 7]], "rounds": 2,
                "pool_frames": 12, "extent": [56, 80],
                "objects": 2, "object_size": [8, 24], "speed": 2.0,
                "check_chunks": 3, "check_pairs_per_chunk": 2,
                "check_snippets": 2, "trace_stretch": [0.3, 1.0]}


def tiny_cell(limits: dict | None = None) -> dict:
    """The video cell's entries at the tiny size, with the real cell's
    limits unless `limits` are given."""
    from benchmark import cells
    real = cells.cell(ROOT, "dnt-r101.vid-snippets")
    return dict(real, workload={"name": "tiny", "chips": 1},
                config={"config": tiny_config()}, traffic=dict(TINY_TRAFFIC),
                limits=limits or real["limits"], per_layer=[])
