"""Where the NMS kernel's time goes, by phase, on one card.

Builds a copy of ``dtt_torch/ops/csrc/nms.cu`` with ``clock64`` counters
into ``dtt_torch/_build/split/`` (the kernel of the package is left as it
is) and launches it through ``nms_cuda``. Block 0 counts SM cycles of
three phases, each up to the block barrier that ends it: the order pass
(from the entry to the first step), warp 0's find-and-resolve of each
step's candidates, and the block's mask pass of each step. One JSON line
a problem, with the card's name and power limit: row 8's frame problem
(``tests/nms_cases.py``, 1 x 6,000 -> 300, 10 steps), the same at IoU 0.1,
the anchor problem, and the first proposals and per-class calls of a
full-width video chunk at random weights (``tools/bench_nms_torch.py``'s
``model`` group; block 0 is one frame's problem).

    python tools/nms_split_torch.py
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (anchor in nms.cu, text put after it): the counters and their read-out
PROBES = (
    ("#include <cmath>\n", "\n__device__ long long g_split[4];\n"),
    ("  int nstep = 0;\n", "  const long long c0 = clock64();\n"),
    ("    // 5. The walk: two block barriers a step.\n",
     "    long long c1 = clock64(), cf = 0, cm = 0, a1 = 0;\n"),
    ("    for (;;) {\n", "      const long long a0 = clock64();\n"),
    ("      __syncthreads();                        // candidates, kept, count\n",
     "      a1 = clock64();\n      cf += a1 - a0;\n"),
    ("      __syncthreads();                        // the alive bits\n",
     "      cm += clock64() - a1;\n"),
    ("      cm += clock64() - a1;\n    }\n",
     "    if (tid == 0 && p == 0) {\n      g_split[0] = c1 - c0;\n"
     "      g_split[1] = cf;\n      g_split[2] = cm;\n"
     "      g_split[3] = nstep;\n    }\n"),
)
READ_OUT = """
extern "C" int dtt_nms_split(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
}
"""


def instrumented_source(src: str) -> str:
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"nms.cu: anchor {anchor.strip()!r} is not "
                               f"there once; update the probes")
        src = src.replace(anchor, anchor + text)
    return src + READ_OUT


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    if not torch.cuda.is_available():
        print("nms_split_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from bench_nms_torch import model_calls
    from dtt_torch.ops import _build
    from dtt_torch.ops import nms as ops

    out = os.path.join(ROOT, "dtt_torch", "_build", "split")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "nms_split.cu")
    with open(os.path.join(ROOT, "dtt_torch", "ops", "csrc", "nms.cu")) as f:
        text = instrumented_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out, "libnms_split.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    fn = lib.dtt_nms_select
    fn.argtypes = ops._entry()[0].argtypes
    fn.restype = ctypes.c_int
    ops._entry = lambda: (fn, lib.dtt_nms_max_boxes())
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    spec = importlib.util.spec_from_file_location(
        "nms_cases", os.path.join(ROOT, "tests", "nms_cases.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    def on_card(c):
        return (torch.from_numpy(c["boxes"]).cuda(),
                torch.from_numpy(c["scores"]).cuda(), c["iou"], c["m"],
                torch.from_numpy(c["valid"]).cuda(), c["score"])

    def split(name, args, kwargs):
        counts = (ctypes.c_longlong * 4)()
        for _ in range(3):                  # the last of three launches
            ops.nms_cuda(*args, **kwargs)
            torch.cuda.synchronize()
        if lib.dtt_nms_split(counts):
            raise RuntimeError("nms_split_torch: reading the counters failed")
        order, find, mask, steps = counts
        total = order + find + mask
        print(json.dumps({"case": name, "steps": steps, "order_cycles": order,
                          "find_cycles": find, "mask_cycles": mask,
                          "mask_share": mask / total if total else 0.0,
                          "card": card}), flush=True)

    frame = cases.path_problem("video_proposals", 1, 6000, 300, 0.7, -0.5,
                               seed=40)
    split("frame_proposals", on_card(frame), {"select_block": 32})
    split("iou_0.1", on_card(dict(frame, iou=0.1)), {"select_block": 32})
    split("anchors_1", on_card(cases.anchor_problem(1, 6000, seed=47)),
          {"select_block": 32})
    for i, (a, kw) in enumerate(model_calls(ops)[:2]):
        split(f"model_call_{i}", a, kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
