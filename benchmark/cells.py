"""What a cell is made of, found by name.

``BENCHMARK.json`` names a cell's configuration and traffic, and a
configuration's file. The configuration file holds its source, what was
reduced and assumed, and under ``config`` the program's whole
configuration tree (every key, so that a later change of the program's
defaults cannot move the benchmark). The traffic is
``benchmark/traffic/<traffic>.json``: its ``kind`` names the code
``benchmark/kinds/<kind>.py`` that runs it, and the rest are its parameters.
A per-layer metric ``<name>`` is read by ``benchmark/metrics/<name>.py``
and a cell's limits are ``benchmark/limits/<cell>.json``. A new cell,
configuration, traffic or metric is a new file and a new entry in
``BENCHMARK.json``; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: Path, name: str) -> dict:
    """The cell `name` of the checkout at `root` with its configuration,
    traffic and metrics: ``workload`` (its entry), ``config`` (the
    configuration file), ``traffic`` (the traffic file), ``end_to_end``
    and ``per_layer`` (the metric entries this cell reports)."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return {"workload": w,
            "config": load_json(root / configs[w["config"]]["file"]),
            "traffic": load_json(root / "benchmark" / "traffic"
                                 / f"{w['traffic']}.json"),
            "limits": load_json(root / "benchmark" / "limits"
                                / f"{name}.json"),
            "end_to_end": e2e, "per_layer": layer, "root": root}


def load_module(kind: str, name: str, root: Path = ROOT):
    """``benchmark/<kind>/<name>.py`` of the checkout at `root`."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
