#!/usr/bin/env python
"""The linking benchmark for dtt_torch on one CUDA card (the counterpart
of ``tools/run_hard_bench.py``): tube linking and rescoring recovering
mAP on detector-breaking video.

Evaluates an existing checkpoint with ``eval_torch``, in this process, on
the HARD synthetic stream (occlusion windows, flickering distractors,
noise bursts, confusable textures) at one or more hardness operating
points, and records, per point:

  * detection mAP without linking      (mAP_nolink, from the same pass)
  * detection mAP with tube linking    (mAP)
  * temporally-strided testing, tau=2  (separate pass, --tau 2 --link)

Writes the verdict JSON next to the checkpoint and exits nonzero unless,
at some operating point with no-link mAP in [0.5, 0.9], linking recovers
>= --min-uplift (default +0.02) and tau=2 stays within --tau-tolerance of
tau=1 linked mAP. The ladder, the arguments and the gate are
run_hard_bench.py's.

Usage (on a CUDA card, after tools/run_mid_synth_torch.py --out DIR):
  python tools/run_hard_bench_torch.py --checkpoint DIR [--frames 16]
``main(argv, device="cpu")`` evaluates on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import eval_torch  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--snippets", type=int, default=8)
    p.add_argument("--frames", type=int, default=16,
                   help="frames per snippet (>= occlusion window + context)")
    p.add_argument("--min-uplift", type=float, default=0.02)
    p.add_argument("--tau-tolerance", type=float, default=0.015)
    p.add_argument("--visibility", type=float, nargs=2, default=None,
                   help="probe a single operating point instead of the sweep")
    p.add_argument("--out-json", default=None,
                   help="default: <checkpoint>/hard_bench.json")
    return p.parse_args(argv)


def points(args) -> list:
    """The hardness ladder: defaults first; easier points only if the
    default lands below the informative no-link band."""
    if args.visibility:
        return [{"visibility": tuple(args.visibility)}]
    return [{},                                      # Hardness() defaults
            {"visibility": (0.35, 0.6)},
            {"visibility": (0.5, 0.75), "noise_sigma": 20.0}]


def point_argv(args, pt: dict) -> list:
    """eval_torch's arguments at the operating point `pt`, tau=1."""
    argv = ["--synthetic-hard", "--checkpoint", args.checkpoint,
            "--synthetic-snippets", str(args.snippets),
            "--synthetic-frames", str(args.frames), "--link"]
    if "visibility" in pt:
        argv += ["--hard-visibility", str(pt["visibility"][0]),
                 str(pt["visibility"][1])]
    if "noise_sigma" in pt:
        argv += ["--hard-noise-sigma", str(pt["noise_sigma"])]
    return argv


def entry(pt: dict, r1: dict, r2: dict) -> dict:
    """One point's record from its tau=1 and tau=2 eval results."""
    return {"point": pt, "mAP_nolink": r1["mAP_nolink"],
            "mAP_link": r1["mAP"],
            "uplift": round(r1["mAP"] - r1["mAP_nolink"], 4),
            "mAP_tau2_link": r2["mAP"],
            "tau2_delta": round(r2["mAP"] - r1["mAP"], 4)}


def informative(e: dict) -> bool:
    return 0.5 <= e["mAP_nolink"] <= 0.9


def gate(args, results: list) -> str | None:
    """The failure message of the ladder's `results`, or None if some
    informative point passes."""
    ok = [r for r in results
          if informative(r) and r["uplift"] >= args.min_uplift
          and abs(r["tau2_delta"]) <= args.tau_tolerance + r["uplift"]]
    if ok:
        return None
    return (f"FAIL: no operating point with no-link mAP in [0.5, 0.9], "
            f"uplift >= {args.min_uplift} and tau=2 within tolerance: "
            f"{json.dumps(results)}")


def run(args, device=None) -> list:
    """The ladder up to its first informative point; returns the
    points' records."""
    results = []
    for pt in points(args):
        argv = point_argv(args, pt)
        r1 = eval_torch.main(argv, device=device)[0]
        r2 = eval_torch.main(argv + ["--tau", "2"], device=device)[0]
        results.append(entry(pt, r1, r2))
        print(json.dumps(results[-1]), flush=True)
        if informative(results[-1]):
            break                                    # informative point found
    return results


def main(argv=None, device=None):
    args = parse_args(argv)
    results = run(args, device)
    verdict = {"checkpoint": args.checkpoint, "frames": args.frames,
               "snippets": args.snippets, "results": results}
    out = args.out_json or os.path.join(args.checkpoint, "hard_bench.json")
    with open(out, "w") as f:
        json.dump(verdict, f, indent=1)
    print(json.dumps({"hard_bench": out}))

    fail = gate(args, results)
    if fail:
        sys.exit(fail)
    ok = next(r for r in results if gate(args, [r]) is None)
    print(f"PASS: linking recovers {ok['uplift']:+.4f} mAP at no-link "
          f"{ok['mAP_nolink']:.4f}; tau=2 delta {ok['tau2_delta']:+.4f}")


if __name__ == "__main__":
    main()
