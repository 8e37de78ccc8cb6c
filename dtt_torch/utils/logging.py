"""Metrics logging: one json line per log call (the jsonl writer of
``dtt.utils.logging``; its TensorBoard mirror is not ported). The train
step returns a metrics dict; this module is the host-side sink.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    """Appends one json line per log call to ``out_dir/metrics.jsonl``."""

    def __init__(self, out_dir: str, run_name: str | None = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.run_name = run_name  # cfg.exp_name: stamped into every row
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: Mapping[str, float], prefix: str = ""):
        """Append the row: step, wall time, the run name and each metric
        under `prefix` + its name; returns the row."""
        row = {"step": int(step), "wall_time": round(time.perf_counter() - self._t0, 3)}
        if self.run_name:
            row["exp"] = self.run_name
        for k, v in metrics.items():
            row[prefix + k] = float(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return row


def read_metrics(path: str) -> list[dict]:
    """The rows of a metrics jsonl file, blank lines skipped."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
