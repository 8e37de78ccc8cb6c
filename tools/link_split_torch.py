"""Where the tube-linking kernel's time goes, by phase, on one card.

Builds a copy of ``dtt_torch/ops/csrc/linking.cu`` with ``clock64``
counters into ``dtt_torch/_build/split/`` (the kernel of the package is
left as it is) and launches it through ``link_cuda``. Thread 0 of block 0
(lane 0 of the chain warp) counts SM cycles of the staging (entry to the
first tube), the forward passes of every tube, split into what comes
before each frame step's candidates (the ring's copy and wait), the
candidates and their stores, and the warp barrier after them; each tube's
end (the path's end, the backtrack, the claim); its wait at the tube
barrier for the warp boosting the tube before; and the relinking with its
barrier. The global timer gives the block's ns, so cycles convert to
time. One JSON line a length, at the eval widths (30 classes, 20 slots, 20
tubes), with the card's name and power limit::

    python tools/link_split_torch.py [--frames 16 8 300]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, N, K = 30, 20, 20

# (text in linking.cu, what takes its place): the counters and their
# read-out
PROBES = (
    ("#include <cmath>\n",
     "#include <cmath>\n\n__device__ long long g_split[11];\n"
     "__device__ __forceinline__ long long split_ns() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const bool ring = m.ring.frames != nullptr;\n",
     "  const bool ring = m.ring.frames != nullptr;\n"
     "  const long long k0 = clock64();\n"
     "  long long s_pre = 0, s_cand = 0, s_post = 0;\n"),
    ("  for (int t = 0; t + 1 < T; ++t) {\n",
     "  for (int t = 0; t + 1 < T; ++t) {\n"
     "    const long long s0 = clock64();\n"),
    ("    for (int j0 = 0; j0 < N; j0 += 32) {\n",
     "    const long long s1 = clock64();\n    s_pre += s1 - s0;\n"
     "    for (int j0 = 0; j0 < N; j0 += 32) {\n"),
    ("    __syncwarp();\n  }\n  const float* fin",
     "    const long long s2 = clock64();\n    s_cand += s2 - s1;\n"
     "    __syncwarp();\n    s_post += clock64() - s2;\n  }\n"
     "  const long long k1 = clock64();\n  const float* fin"),
    ("  __syncwarp();\n}\n\n// The links a tube's claims changed",
     "  __syncwarp();\n  if (lane == 0 && c == 0) {\n"
     "    g_split[1] += k1 - k0;\n    g_split[2] += clock64() - k1;\n"
     "    g_split[8] += s_pre;\n    g_split[9] += s_cand;\n"
     "    g_split[10] += s_post;\n  }\n}\n\n"
     "// The links a tube's claims changed"),
    ("  // 1. Staging",
     "  const long long c0 = clock64(), n0 = split_ns();\n"
     "  if (tid == 0 && c == 0)\n"
     "    for (int q = 0; q < 11; ++q) g_split[q] = 0;\n  // 1. Staging"),
    ("  // 2. The tubes, in turn",
     "  if (tid == 0 && c == 0) g_split[0] = clock64() - c0;\n"
     "  // 2. The tubes, in turn"),
    ("    __syncthreads();\n    if (k + 1 < K) {\n",
     "    const long long ba = clock64();\n    __syncthreads();\n"
     "    if (tid == 0 && c == 0) g_split[4] += clock64() - ba;\n"
     "    if (k + 1 < K) {\n      const long long r0 = clock64();\n"),
    ("      __syncthreads();\n    }\n  }\n  if (warp == boost_warp(K - 1))",
     "      __syncthreads();\n"
     "      if (tid == 0 && c == 0) g_split[3] += clock64() - r0;\n"
     "    }\n  }\n  if (tid == 0 && c == 0) {\n"
     "    g_split[5] = split_ns() - n0;\n    g_split[6] = clock64() - c0;\n"
     "    g_split[7] = (long long)K * (T - 1);\n  }\n"
     "  if (warp == boost_warp(K - 1))"),
)
READ_OUT = """
extern "C" int dtt_link_split(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_split, 11 * sizeof(long long));
}
"""


def instrumented_source(src: str) -> str:
    for old, new in PROBES:
        if src.count(old) != 1:
            raise RuntimeError(f"linking.cu: {old.strip()!r} is not there "
                               f"once; update the probes")
        src = src.replace(old, new)
    return src + READ_OUT


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, nargs="*", default=[16, 8, 300])
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("link_split_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    from dtt_torch.eval import linking
    from dtt_torch.ops import _build

    out = os.path.join(ROOT, "dtt_torch", "_build", "split")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "linking_split.cu")
    with open(os.path.join(ROOT, "dtt_torch", "ops", "csrc",
                           "linking.cu")) as f:
        text = instrumented_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out, "liblinking_split.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    fn = lib.dtt_link_tubes
    fn.argtypes = linking._entry().argtypes
    fn.restype = ctypes.c_int
    linking._entry = lambda: fn
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    spec = importlib.util.spec_from_file_location(
        "linking_cases", os.path.join(ROOT, "tests", "linking_cases.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    for t in args.frames:
        a = tuple(torch.from_numpy(x).cuda()
                  for x in cases.detections(seed=40 + t, c=C, t=t, n=N))
        counts = (ctypes.c_longlong * 11)()
        for _ in range(3):                  # the last of three launches
            linking.link_cuda(*a, max_tubes=K)
            torch.cuda.synchronize()
        if lib.dtt_link_split(counts):
            raise RuntimeError("link_split_torch: reading the counters "
                               "failed")
        (stage, fwd, end, relink, wait, ns, total, steps, pre, cand,
         after) = counts
        ghz = total / ns if ns else 0.0
        print(json.dumps({
            "T": t, "C": C, "N": N, "K": K,
            "staging_cycles": stage, "forward_cycles": fwd,
            "end_backtrack_claim_cycles": end, "relink_cycles": relink,
            "boost_wait_cycles": wait, "chain_block_cycles": total,
            "chain_block_ns": ns,
            "sm_ghz": round(ghz, 3), "frame_steps": steps,
            "cycles_a_frame_step": round(fwd / steps, 1) if steps else None,
            "step_cycles_before": pre, "step_cycles_candidates": cand,
            "step_cycles_after": after,
            "cycles_a_tube_end": round(end / K, 1),
            "layout": linking.link_layout(t, N).body, "card": card}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
