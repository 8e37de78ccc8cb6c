#!/usr/bin/env python
"""Run ``dtt``'s two diagnosis probes, as ported
(``tools/probe_dead_snippet_torch.py``, ``tools/probe_tau2_torch.py``),
on a trained run dir, in this process, on one CUDA card: the way a
flagship run's weights are diagnosed before the machine that trained them
is gone.

1. ``eval_torch`` scores the run dir as ``run_flagship_synth_torch.py``
   does (``--synthetic --synthetic-snippets N --link``), writing the
   detections to OUT/dets.pkl and its result to OUT/eval.json;
2. every snippet with no detection above 0.3, or snippet 7 if there is
   none, goes through
   ``probe_dead_snippet_torch``'s stage 1 (the variants) and stage 2 (the
   proposals and the R-FCN at the gt boxes);
3. ``probe_tau2_torch`` runs on --tau2-snippets snippets.

Each probe's printed lines go to OUT/<probe>.txt and its numbers to
OUT/probes.json; a JSON summary line ends the output::

    python tools/flagship_probes_torch.py /tmp/flagship_torch out/flag
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pickle
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [d for d in (os.path.dirname(HERE), HERE) if d not in sys.path]

DEAD_SCORE = 0.3       # a snippet is dead with no detection above this
FRAMES = 8             # a synthetic eval snippet's frames (eval_torch's)


def captured(path: str, fn, *a, **k):
    """fn's result; what it prints goes to stdout and to `path`."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    sys.stdout.write(buf.getvalue())
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return out


def dead_snippets(dets: dict, snippets: int) -> list:
    """The snippets whose frames hold no detection above DEAD_SCORE in an
    ``eval_torch --out`` detections dict of FRAMES-frame snippets."""
    alive = set()
    for entries in dets.values():
        for fids, scores, _ in entries:
            alive.update(int(f) // FRAMES for f, s in zip(fids, scores)
                         if s > DEAD_SCORE)
    return [i for i in range(snippets) if i not in alive]


def main(argv=None, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run", help="the run dir (LATEST, config.yml)")
    p.add_argument("out", help="where the probes' output goes")
    p.add_argument("--snippets", type=int, default=32)
    p.add_argument("--tau2-snippets", type=int, default=3)
    a = p.parse_args(argv)
    import eval_torch
    import probe_dead_snippet_torch as dead
    import probe_tau2_torch as tau2

    os.makedirs(a.out, exist_ok=True)
    t0 = time.perf_counter()
    pkl = os.path.join(a.out, "dets.pkl")
    res = captured(os.path.join(a.out, "eval.txt"), eval_torch.main,
                   ["--synthetic", "--checkpoint", a.run,
                    "--synthetic-snippets", str(a.snippets), "--link",
                    "--out", pkl], device=device)[0]
    with open(os.path.join(a.out, "eval.json"), "w") as f:
        json.dump(res, f)
    with open(pkl, "rb") as f:
        found = dead_snippets(pickle.load(f)["dets"], a.snippets)
    probed = found or [7]
    out = {"eval": {k: res[k] for k in ("mAP", "mAP_nolink", "link_uplift")},
           "dead": found, "probed": probed, "dead_snippet": {}}
    for s in probed:
        args = dead.parse_args(["--checkpoint", a.run, "--snippet", str(s),
                                "--frames", str(FRAMES)])
        out["dead_snippet"][s] = {
            "stage1": captured(os.path.join(
                a.out, f"probe_dead_snippet_{s}.txt"), dead.main, args,
                device),
            "stage2": captured(os.path.join(
                a.out, f"probe_dead_snippet_{s}_stage2.txt"),
                dead.proposal_probe, args, device)}
    out["tau2"] = captured(
        os.path.join(a.out, "probe_tau2.txt"), tau2.main,
        tau2.parse_args(["--checkpoint", a.run, "--snippets",
                         str(a.tau2_snippets)]), device)
    out["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(a.out, "probes.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps({k: out[k] for k in ("eval", "dead", "probed",
                                          "wall_s")}))
    return out


if __name__ == "__main__":
    main()
