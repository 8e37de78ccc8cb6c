"""The port's diagnosis probes (tools/probe_dead_snippet_torch.py,
tools/probe_tau2_torch.py) held against dtt's (tools/probe_dead_snippet.py,
tools/probe_tau2.py) on the CPU.

One tiny run dir (configs/tiny_synth.yml's model at 64x96) is written by
dtt's ``create_train_state`` and ``save_checkpoint``; both packages' probes
read it, each in process. Checked:
- the snippet each probe reconstructs from eval's RandomState(123) chain,
  and every variant's rendered frames, bit for bit (dtt's and the port's
  ``evaluate_snippet_video`` see the same uint8 canvases);
- stage 1's lines: each variant's tag, its detections above 0.3 and the
  best score per object, equal as printed (3 decimals);
- stage 2 (``PROBE_STAGE=2``'s ``proposal_probe``): the valid proposals
  and each object's argmax class equal, the top proposal score, best IoU,
  its RPN score and the R-FCN probabilities within PROBE_TOL of dtt's
  printed 3 decimals;
- probe_tau2's keyframes, tubes per class, per-frame coverage counts and
  the tubes' keyframe memberships equal, their rescored scores within
  PROBE_TOL of dtt's printed 2 decimals.
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import probe_dead_snippet_torch  # noqa: E402
import probe_tau2_torch  # noqa: E402

# dtt prints 3 (stage 2) or 2 (tubes' rescored) decimals: half a unit of
# the last printed place, plus float32 roundoff between the packages
PROBE_TOL = {3: 5e-4 + 1e-5, 2: 5e-3 + 1e-5}
SNIPPET, FRAMES = 1, 8


def _dtt_tool(monkeypatch, name):
    """dtt's ``tools/<name>.py`` as a module, with its compile cache call
    made a no-op (the test writes no cache into the repo)."""
    monkeypatch.setattr("dtt.utils.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        f"dtt_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run dir of tiny_synth.yml's model at dtt's initial weights, with
    the R-FCN's class-1 bias raised so that detections above 0.3 exist."""
    import jax
    import jax.numpy as jnp

    from dtt.core.config import load_config, save_config
    from dtt.train.checkpoint import save_checkpoint
    from dtt.train.trainer import create_train_state

    d = str(tmp_path_factory.mktemp("probe_run"))
    cfg = load_config(os.path.join(REPO, "configs", "tiny_synth.yml"))
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    _, state = create_train_state(cfg, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 2, h, w, 3), jnp.float32))
    params = jax.tree.map(np.asarray, state.params)
    bias = params["params"]["cls_maps"]["bias"].reshape(-1, 4).copy()
    bias[:, 1] += 2.0
    params["params"]["cls_maps"]["bias"] = bias.reshape(-1)
    save_checkpoint(d, state._replace(params=params), cfg)
    save_config(cfg, os.path.join(d, "config.yml"))
    return d


def _frames_seen(monkeypatch, module, attr):
    """Patch ``module.attr`` (an evaluate_snippet_video) to record the
    frames it is given."""
    seen = []
    fn = getattr(module, attr)

    def spy(cfg, step, *a, **k):
        frames = a[1] if len(a) > 1 and not isinstance(a[0], np.ndarray) \
            else a[0]
        seen.append(np.array(frames))
        return fn(cfg, step, *a, **k)
    monkeypatch.setattr(module, attr, spy)
    return seen


LINE = re.compile(r"^(.{40}) hi-dets\s+(\d+)\s+best score obj0/obj1: "
                  r"\[(.*)\]$")


def _stage1_lines(text):
    out = []
    for ln in text.splitlines():
        m = LINE.match(ln)
        if m:
            out.append((m.group(1).rstrip(), int(m.group(2)),
                        [float(x) for x in m.group(3).split(",")]))
    return out


def test_scene_matches_dtt(run_dir):
    """The reconstruction of eval's chain, bit for bit, at snippet 0, 1
    and 7."""
    from dtt.core.config import load_config
    from dtt.data.synthetic import _background, sample_snippet_params

    cfg = load_config(os.path.join(run_dir, "config.yml"))
    pcfg = probe_dead_snippet_torch.load(
        probe_dead_snippet_torch.parse_args(["--checkpoint", run_dir]),
        "cpu")[0]
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    for snippet in (0, SNIPPET, 7):
        rng = np.random.RandomState(123)
        for _ in range(snippet):
            sample_snippet_params(rng, FRAMES, h, w, cfg.model.num_classes,
                                  cfg.input.max_gt_boxes)
            _background(rng, (FRAMES, h, w, 3))
        want = (*sample_snippet_params(rng, FRAMES, h, w,
                                       cfg.model.num_classes,
                                       cfg.input.max_gt_boxes),
                _background(rng, (FRAMES, h, w, 3)))
        got = probe_dead_snippet_torch.snippet_scene(pcfg, snippet, FRAMES)
        for name, x, y in zip(("gt_boxes", "gt_labels", "gt_valid",
                               "background"), got, want):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_dead_snippet_stage1_matches_dtt(run_dir, monkeypatch, capsys):
    """Stage 1: the same frames reach both video steps, and the printed
    numbers of every variant are equal."""
    from dtt.eval import inference as dtt_inference

    from dtt_torch.eval import inference

    dtt_probe = _dtt_tool(monkeypatch, "probe_dead_snippet")
    argv = ["--checkpoint", run_dir, "--snippet", str(SNIPPET), "--frames",
            str(FRAMES)]
    want_frames = _frames_seen(monkeypatch, dtt_inference,
                               "evaluate_snippet_video")
    monkeypatch.setattr(sys, "argv", ["probe_dead_snippet.py", *argv])
    dtt_probe.main()
    want = _stage1_lines(capsys.readouterr().out)
    got_frames = _frames_seen(monkeypatch, inference,
                              "evaluate_snippet_video")
    rows = probe_dead_snippet_torch.main(
        probe_dead_snippet_torch.parse_args(argv), device="cpu")
    printed = _stage1_lines(capsys.readouterr().out)
    assert len(want) == len(got_frames) == len(want_frames) == 6
    for x, y in zip(got_frames, want_frames):
        assert x.dtype == y.dtype == np.uint8
        np.testing.assert_array_equal(x, y)
    assert printed == [(t.rstrip()[:40], n, b) for t, n, b in rows]
    assert printed == want
    assert sum(n for _, n, _ in want) > 0      # some detection above 0.3


def _stage2_numbers(text):
    head = re.search(r"valid proposals: (\d+), top score ([-\d.]+)", text)
    objs = re.findall(
        r"obj(\d+) cls=(\d+) box=.*?: best proposal IoU ([-\d.]+) \(rpn "
        r"score ([-\d.]+)\); RFCN@gt: argmax cls (\d+) p=([-\d.]+), "
        r"p\[true\]=([-\d.]+)", text)
    return int(head.group(1)), float(head.group(2)), objs


def test_dead_snippet_stage2_matches_dtt(run_dir, monkeypatch, capsys):
    """Stage 2 (``proposal_probe``): the proposals' coverage of each gt
    box and the R-FCN's probabilities there, against dtt's printed
    values."""
    dtt_probe = _dtt_tool(monkeypatch, "probe_dead_snippet")
    argv = ["--checkpoint", run_dir, "--snippet", str(SNIPPET), "--frames",
            str(FRAMES)]
    dtt_probe.proposal_probe(argv)
    valid, top, objs = _stage2_numbers(capsys.readouterr().out)
    got = probe_dead_snippet_torch.proposal_probe(
        probe_dead_snippet_torch.parse_args(argv), device="cpu")
    tol = PROBE_TOL[3]
    assert got["valid"] == valid
    assert got["top_score"] == pytest.approx(top, abs=tol)
    assert len(got["objects"]) == len(objs) >= 1
    for o, (_, cls, best, rpn, arg, p, pt) in zip(got["objects"], objs):
        assert o["cls"] == int(cls) and o["argmax_cls"] == int(arg)
        for key, v in (("best_iou", best), ("rpn_score", rpn), ("p_max", p),
                       ("p_true", pt)):
            assert o[key] == pytest.approx(float(v), abs=tol), key


def test_tau2_matches_dtt(run_dir, monkeypatch, capsys):
    """probe_tau2: coverage counts, tubes and their keyframes equal."""
    dtt_probe = _dtt_tool(monkeypatch, "probe_tau2")
    argv = ["--checkpoint", run_dir, "--snippets", "2", "--frames", "8"]
    monkeypatch.setattr(sys, "argv", ["probe_tau2.py", *argv])
    dtt_probe.main()
    text = capsys.readouterr().out
    got = probe_tau2_torch.main(probe_tau2_torch.parse_args(argv),
                                device="cpu")
    heads = re.findall(r"snippet (\d+): eval_ts=\[(.*?)\]  tubes/class="
                       r"\[(.*?)\]", text)
    frames = re.findall(r"t=\s*(\d+) (KEY|   ) raw (\d+)/(\d+)  interp "
                        r"(\d+)/(\d+)", text)
    tubes = re.findall(r"class (\d+) tube (\d+): on=\[(.*?)\] rescored="
                       r"\[(.*?)\]", text)
    assert len(heads) == len(got) == 2
    ints = lambda s: [int(x) for x in s.split(",") if x.strip()]
    for (_, ts, tv), rec in zip(heads, got):
        assert rec["eval_ts"] == ints(ts) and rec["tubes"] == ints(tv)
    assert [(t, k, raw, itp, n) for rec in got
            for t, k, raw, itp, n in rec["frames"]] == [
        (int(t), k == "KEY", int(r), int(i), int(n))
        for t, k, r, n, i, _ in frames]
    rows = [row for rec in got for row in rec["tube_rows"]]
    assert len(rows) == len(tubes) >= 1
    for (c, k, on, rs), (wc, wk, won, wrs) in zip(rows, tubes):
        assert (c, k, on) == (int(wc), int(wk), ints(won))
        np.testing.assert_allclose(rs, [float(x) for x in wrs.split(",")],
                                   rtol=0, atol=PROBE_TOL[2])


def test_flagship_probes_run_both_probes(run_dir, tmp_path, capsys):
    """tools/flagship_probes_torch.py on the CPU: the eval's detections
    name the dead snippets (none above 0.3), the probes run on them (or
    on snippet 7) and on tau=2, and each writes its lines and numbers."""
    import json
    import pickle

    import flagship_probes_torch

    dets = {1: [(np.array([0, 9]), np.array([0.2, 0.9]), np.zeros((2, 4)))],
            2: [(np.array([17]), np.array([0.31]), np.zeros((1, 4)))]}
    assert flagship_probes_torch.dead_snippets(dets, 4) == [0, 3]
    out = str(tmp_path / "probes")
    got = flagship_probes_torch.main(
        [run_dir, out, "--snippets", "2", "--tau2-snippets", "1"],
        device="cpu")
    with open(os.path.join(out, "dets.pkl"), "rb") as f:
        dead = flagship_probes_torch.dead_snippets(pickle.load(f)["dets"], 2)
    assert got["dead"] == dead and got["probed"] == (dead or [7])
    for s in got["probed"]:
        assert [r[0] for r in got["dead_snippet"][s]["stage1"]][:3] == [
            "original (dead?)", "shifted +40,+24", "zero velocity"]
        assert got["dead_snippet"][s]["stage2"]["valid"] > 0
        for name in (f"probe_dead_snippet_{s}.txt",
                     f"probe_dead_snippet_{s}_stage2.txt"):
            assert os.path.getsize(os.path.join(out, name)) > 0
    assert len(got["tau2"]) == 1
    with open(os.path.join(out, "probes.json")) as f:
        assert json.load(f)["eval"] == got["eval"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["dead"] == dead
