"""A configuration, a traffic, a cell and a per-layer metric added as new
files and new ``BENCHMARK.json`` entries are found by name, with no file
of the benchmark edited."""

from __future__ import annotations

import json
import shutil
from types import SimpleNamespace

from conftest import ROOT, TINY_TRAFFIC, tiny_config


def test_new_files_are_found_without_edits(tmp_path):
    from benchmark import cells, run as brun
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = tmp_path / "benchmark"
    (b / "configs" / "dnt-tiny.json").write_text(json.dumps(
        {"source": "a test", "reduced": [], "config": tiny_config()}))
    (b / "traffic" / "tiny-snips.json").write_text(json.dumps(TINY_TRAFFIC))
    (b / "limits" / "dnt-tiny.tiny-snips.json").write_text(json.dumps(
        {"trunk_err": 1e-5, "box_err": 1e-3,
         "score_err": 1e-5, "link_gap": 1e-5}))
    (b / "metrics" / "snippets_done.tiny.py").write_text(
        "def read(r):\n    return float(r.window['attempted'])\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dnt-tiny", "source": "a test",
                            "file": "benchmark/configs/dnt-tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dnt-tiny.tiny-snips",
                              "config": "dnt-tiny", "traffic": "tiny-snips",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("dnt-tiny.tiny-snips")
    spec["per_layer"].append({"name": "snippets_done.tiny", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "snippet loop and programs",
                              "moves": "video_pairs_per_s",
                              "workloads": ["dnt-tiny.tiny-snips"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = cells.cell(tmp_path, "dnt-tiny.tiny-snips")
    assert cell["config"]["config"] == json.loads(json.dumps(tiny_config()))
    assert [m["name"] for m in cell["per_layer"]] == ["snippets_done.tiny"]
    assert {m["name"] for m in cell["end_to_end"]} == {"video_pairs_per_s",
                                                       "setup_s"}
    line = brun.run_cell(cell, 5, 0.3, False, device="cpu")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"video_pairs_per_s", "setup_s"}
    reader = cells.load_module("metrics", "snippets_done.tiny", tmp_path)
    assert reader.read(SimpleNamespace(window={"attempted": 3})) == 3.0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
