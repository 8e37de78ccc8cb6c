"""The port's accuracy tools (tools/run_mid_synth_torch.py,
run_hard_bench_torch.py, run_flagship_synth_torch.py) held against dtt's
(tools/run_mid_synth.py, run_hard_bench.py, run_flagship_synth.py) on the
CPU.

(a) Each pair runs in process on the same canned eval JSON lines: dtt's
tool with its subprocess ``run`` replaced, the port's with
``train_torch.main`` and ``eval_torch.main`` replaced. Both must pass the
same train and eval arguments (train.py / eval.py's against train_torch /
eval_torch's), print the same JSON lines, write the same hard_bench.json
and exit the same way: passing, mAP < 0.7, linking hurting, the hardness
ladder stopping at its first point with no-link mAP in [0.5, 0.9], a tau=2
delta outside its tolerance, and no informative point at all.

(b) ``run_mid_synth_torch.main(device="cpu")`` trains configs/tiny_synth.yml
for a few steps and evaluates one snippet with linking; dtt's eval.py,
run in process, scores the run dir the port trained: the same mAPs (to
1e-6) and the same detections (frames equal, scores to 1e-5, boxes to
1e-2 px, as tests/test_torch_port_eval_script.py holds them).
"""

import importlib
import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import run_flagship_synth_torch  # noqa: E402
import run_hard_bench_torch  # noqa: E402
import run_mid_synth_torch  # noqa: E402

from dtt_torch.eval.vid_eval import det_arrays  # noqa: E402

eval_script = importlib.import_module("eval")


def _dtt_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"dtt_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _call(fn):
    """fn()'s exit: None, or its SystemExit code (a message or a
    number)."""
    try:
        fn()
    except SystemExit as e:
        return e.code
    return None


def _eval_line(link, nolink):
    return {"mAP": link, "protocol": "devkit", "mAP_nolink": nolink,
            "link_uplift": round(link - nolink, 4), "class_1": 0.5}


def _run_side(monkeypatch, capsys, side, name, port, argv, results):
    """dtt's tool `name` (side "dtt") or the port's `port` (side "port")
    on `argv`, each eval answering with ``results(eval_args)``. Returns
    (the train argument lists, the eval argument lists, the JSON lines
    printed, the PASS lines, the exit), with the port's config path
    written as dtt's tool writes it."""
    out_trains, out_evals = [], []
    if side == "dtt":
        dtt = _dtt_tool(name)

        def fake_run(cmd):
            (out_trains if cmd[1] == "train.py" else out_evals).append(
                cmd[2:])
            if cmd[1] == "train.py":
                return ""
            res = results(cmd[2:])
            return res if name == "run_hard_bench" else json.dumps(res) + "\n"

        monkeypatch.setattr(dtt, "run", fake_run)
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        code = _call(dtt.main)
    else:
        config = getattr(port, "CONFIG", None)

        def fake_train(a, device=None):
            assert device == "cpu"
            out_trains.append([os.path.relpath(x, REPO) if x == config
                               else x for x in a])

        def fake_eval(a, device=None):
            assert device == "cpu"
            out_evals.append(list(a))
            return results(list(a)), {}, 0

        if config is not None:
            monkeypatch.setattr(port.train_torch, "main", fake_train)
        monkeypatch.setattr(port.eval_torch, "main", fake_eval)
        code = _call(lambda: port.main(argv, device="cpu"))
    out = capsys.readouterr().out
    return (out_trains, out_evals, _json_lines(out),
            [ln for ln in out.splitlines() if ln.startswith("PASS")], code)


def _run_pair(monkeypatch, capsys, name, port, argv, results):
    return {side: _run_side(monkeypatch, capsys, side, name, port, argv,
                            results) for side in ("dtt", "port")}


MID_CASES = {"pass": (0.82, 0.8), "low": (0.65, 0.6), "hurts": (0.75, 0.78),
             "at_gate": (0.7, 0.7)}


@pytest.mark.parametrize("case", sorted(MID_CASES))
@pytest.mark.parametrize("argv", [["--out", "o", "--steps", "200"],
                                  ["--out", "o", "--skip-train",
                                   "--snippets", "2"]],
                         ids=["train", "skip_train"])
def test_mid_synth_gate_matches_dtt(monkeypatch, capsys, case, argv):
    link, nolink = MID_CASES[case]
    got = _run_pair(monkeypatch, capsys, "run_mid_synth", run_mid_synth_torch,
                    argv, lambda a: _eval_line(link, nolink))
    assert got["port"] == got["dtt"]
    assert (got["port"][4] is None) == (case in ("pass", "at_gate"))
    assert len(got["port"][1]) == 1


@pytest.mark.parametrize("case", sorted(MID_CASES))
@pytest.mark.parametrize("argv", [["--out", "o", "--steps", "300"],
                                  ["--out", "o", "--resume"],
                                  ["--out", "o", "--skip-train"]],
                         ids=["train", "resume", "skip_train"])
def test_flagship_gate_matches_dtt(monkeypatch, capsys, case, argv):
    link, nolink = MID_CASES[case]
    got = _run_pair(monkeypatch, capsys, "run_flagship_synth",
                    run_flagship_synth_torch, argv,
                    lambda a: _eval_line(link, nolink))
    assert got["port"] == got["dtt"]
    assert (got["port"][4] is None) == (case in ("pass", "at_gate"))


def _ladder(points):
    """An eval answer from (nolink, link, tau2 link) per ladder rung: the
    default point, visibility 0.35-0.6, then 0.5-0.75 with noise 20."""
    def results(a):
        rung = (0 if "--hard-visibility" not in a
                else 1 if a[a.index("--hard-visibility") + 1] == "0.35"
                else 2)
        nolink, link, tau2 = points[rung]
        return _eval_line(tau2 if "--tau" in a else link, nolink)
    return results


HARD_CASES = {
    # informative at the default point, linking recovers enough
    "pass_first": [(0.6, 0.65, 0.64)],
    # the default too hard, the next rung informative: the ladder stops
    "stop_second": [(0.3, 0.35, 0.35), (0.55, 0.6, 0.6)],
    # informative, but the uplift is below --min-uplift
    "small_uplift": [(0.6, 0.61, 0.61)],
    # informative, uplift 0.03, but tau=2 off by 0.05 > 0.015 + 0.03
    "tau2_off": [(0.6, 0.63, 0.58)],
    # never informative: every rung runs, then the gate fails
    "none_informative": [(0.95, 0.97, 0.97), (0.92, 0.95, 0.95),
                         (0.91, 0.93, 0.93)],
}


@pytest.mark.parametrize("case", sorted(HARD_CASES))
@pytest.mark.parametrize("extra", [[], ["--visibility", "0.35", "0.6"],
                                   ["--frames", "8", "--min-uplift", "0.005",
                                    "--tau-tolerance", "0.06"]],
                         ids=["ladder", "one_point", "options"])
def test_hard_bench_gate_matches_dtt(monkeypatch, capsys, tmp_path, case,
                                     extra):
    points = HARD_CASES[case]
    if extra[:1] == ["--visibility"]:
        points = [points[0]] * 3
    out_json = str(tmp_path / "hard_bench.json")
    argv = ["--checkpoint", str(tmp_path), "--out-json", out_json, *extra]
    got, written = {}, {}
    for side in ("dtt", "port"):
        got[side] = _run_side(monkeypatch, capsys, side, "run_hard_bench",
                              run_hard_bench_torch, argv, _ladder(points))
        with open(out_json) as f:
            written[side] = json.load(f)
        os.remove(out_json)
    assert got["port"] == got["dtt"]
    assert written["port"] == written["dtt"]
    want = written["dtt"]
    rungs = len(want["results"])
    if not extra[:1] == ["--visibility"]:
        assert rungs == {"stop_second": 2, "none_informative": 3}.get(case, 1)
    assert len(got["port"][1]) == 2 * rungs


# --------------------------------------------------- (b) a tiny run, end to end

def test_tiny_run_scored_by_dtt(monkeypatch, capsys, tmp_path):
    """The port trains and evaluates through the tool; dtt's eval.py
    scores the run dir the port wrote, with the same result."""
    run_dir = str(tmp_path / "run")
    tiny = os.path.join(REPO, "configs", "tiny_synth.yml")
    monkeypatch.setattr(run_mid_synth_torch, "CONFIG", tiny)
    code = _call(lambda: run_mid_synth_torch.main(
        ["--out", run_dir, "--steps", "4", "--snippets", "1"], device="cpu"))
    out = capsys.readouterr().out
    lines = _json_lines(out)
    verdict = lines[-1]
    res = lines[-2]
    assert verdict == run_mid_synth_torch.verdict(res)
    assert code == run_mid_synth_torch.gate(res)
    with open(os.path.join(run_dir, "LATEST")) as f:
        assert f.read().strip() == "step_00000004"

    t_out, j_out = str(tmp_path / "port.pkl"), str(tmp_path / "dtt.pkl")
    args = ["--synthetic", "--checkpoint", run_dir, "--synthetic-snippets",
            "1", "--link"]
    got = run_mid_synth_torch.eval_torch.main(args + ["--out", t_out],
                                              device="cpu")[0]
    assert got == res
    monkeypatch.setattr("dtt.utils.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["eval.py", *args, "--out", j_out])
    eval_script.main()
    want = _json_lines(capsys.readouterr().out)[-1]
    for key in ("mAP", "mAP_nolink"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
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
