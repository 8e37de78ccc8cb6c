#!/usr/bin/env python
"""Compare two detection pickles that ``eval_torch.py --out`` or
``eval.py --out`` wrote (``{"dets": {class: [(frames, scores, boxes),
...]}, "gts": ...}``), class by class: the detections each holds, whether
they name the same frames, and the largest score and box differences
where they do. Prints one JSON line a class and a summary line; exits 1
if any class's frames differ or the ground truth does::

    python tools/compare_detections_torch.py card.pkl cpu_dtt.pkl
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))


def compare(a: dict, b: dict) -> dict:
    from dtt_torch.eval.vid_eval import det_arrays
    rows, same = [], True
    for c in sorted(set(a["dets"]) | set(b["dets"])):
        fa, sa, ba = det_arrays(a["dets"].get(c, []))
        fb, sb, bb = det_arrays(b["dets"].get(c, []))
        row = {"class": int(c), "dets": [int(fa.size), int(fb.size)],
               "frames_equal": bool(fa.shape == fb.shape
                                    and np.array_equal(fa, fb))}
        if row["frames_equal"] and fa.size:
            row["max_score_diff"] = float(np.abs(sa - sb).max())
            row["max_box_diff"] = float(np.abs(ba - bb).max())
        same &= row["frames_equal"]
        rows.append(row)
    gts = a["gts"].keys() == b["gts"].keys() and all(
        a["gts"][c].keys() == b["gts"][c].keys()
        and all(np.array_equal(a["gts"][c][f], b["gts"][c][f])
                for f in a["gts"][c]) for c in a["gts"])
    return {"classes": rows, "frames_equal": same, "gts_equal": gts,
            "max_score_diff": max((r.get("max_score_diff", 0.0)
                                   for r in rows), default=0.0),
            "max_box_diff": max((r.get("max_box_diff", 0.0) for r in rows),
                                default=0.0)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a")
    p.add_argument("b")
    args = p.parse_args()
    with open(args.a, "rb") as f:
        a = pickle.load(f)
    with open(args.b, "rb") as f:
        b = pickle.load(f)
    out = compare(a, b)
    for row in out["classes"]:
        print(json.dumps(row))
    print(json.dumps({k: v for k, v in out.items() if k != "classes"}))
    return 0 if out["frames_equal"] and out["gts_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
