"""``bench_torch.py`` on the CPU at the tiny config: it runs the video step
and ends its standard output in one JSON line of ``bench.py``'s keys (under
a CPU metric name, since no card was timed), with its statistics on
stderr. No JAX here."""

import json
import os

import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_torch_prints_one_json_line(capsys):
    result = bench_torch.main([
        "--config", os.path.join(REPO, "configs", "tiny_synth.yml"),
        "--device", "cpu", "--chunk", "3", "--runs", "2"])
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last == result
    assert last["metric"] == "dnt_torch_inference_frame_pairs_per_sec_per_cpu"
    assert last["value"] > 0
    assert abs(last["vs_baseline"] - last["value"] / 15.0) < 1e-3
    assert "cpu;" in err and "median" in err and "2 runs" in err
