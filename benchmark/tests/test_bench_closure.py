"""What a run and the reference import: no ``jax``, ``jaxlib``,
``flax`` or ``dtt`` (top-level names compared whole; ``dtt_torch`` is
the program), and the reference nothing of the program either."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dtt"}

RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from benchmark import run as brun
line = brun.run_cell(tiny_cell(), 7, 0.2, False, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.dnt, benchmark.reference.linking
import benchmark.reference.boxes, benchmark.judge, benchmark.weights
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           tests=str(ROOT / "benchmark"
                                                     / "tests"))],
        capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax_and_no_dtt():
    mods = _top_level(RUN)
    assert "dtt_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = _top_level(REFERENCE)
    assert not mods & (FORBIDDEN | {"dtt_torch"})


def test_a_run_that_loads_jax_after_its_window_prints_no_result(tmp_path):
    """The look at ``sys.modules`` comes last: a per-layer metric's reader
    that loads ``jax`` (a stub) leaves the run without a result line."""
    import shutil
    from conftest import tiny_cell
    from benchmark import run as brun
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "metrics" / "loads_jax.py").write_text(
        "import sys, types\n\n\ndef read(r):\n"
        "    sys.modules.setdefault('jax', types.ModuleType('jax'))\n"
        "    return None\n")
    cell = tiny_cell()
    # the profiler's stretch starts past the window: the CPU has no trace
    cell = dict(cell, root=tmp_path,
                traffic=dict(cell["traffic"], trace_stretch=[2.0, 1.0]),
                per_layer=[{"name": "loads_jax", "unit": "1"}])
    try:
        assert brun.run_cell(cell, 11, 0.3, True, device="cpu") is None
    finally:
        sys.modules.pop("jax", None)
