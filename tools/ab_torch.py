"""A/B of two trees of the port on one card, in one call: ``chip_smoke.py``
and ``bench_torch.py``'s chunk sweep of each tree, in turns.

    python3 tools/ab_torch.py --parent _chip_tree/parent \
        [--order pccp] [--chunks 17 33 65 97] [--out ab_out] \
        [--also "python3 {here}/tools/epilogue_host_torch.py --root ." ...]

`--parent` is an unpacked archive of the other tree (``git archive <rev> |
tar -x -C _chip_tree/parent``); the change is this checkout. `--order`
gives the turns (p: parent, c: change; the default runs parent, change,
change, parent, labelled E1..E4). A tree without ``bench_torch.py`` gets
this checkout's copy, which drives that tree's ``dtt_torch``. Each run's
output goes to OUT/E<n>_<tree>.log and OUT/E<n>_<tree>_bench<chunk>.log;
the bench JSON lines, with their stderr statistics, are gathered in
OUT/bench.jsonl, and one summary line a run goes to stdout. Each
``--also`` command (a shell line) runs after the bench in every turn, in
that turn's tree, with ``{here}`` replaced by this checkout, ``{label}``
by the turn's label and ``{out}`` by OUT; its output goes to
OUT/E<n>_<tree>_also<i>.log and its JSON lines to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(cmd: list, cwd: str, log: str, timeout: float) -> tuple:
    """(exit code, seconds, stdout, stderr) of `cmd` in `cwd`, its output
    in `log`."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)
    with open(log, "w") as f:
        f.write(proc.stdout)
        f.write(proc.stderr)
    return proc.returncode, time.perf_counter() - t0, proc.stdout, proc.stderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=True)
    p.add_argument("--order", default="pccp")
    p.add_argument("--chunks", type=int, nargs="*", default=[17, 33, 65, 97])
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--out", default=os.path.join(HERE, "ab_out"))
    p.add_argument("--smoke-timeout", type=float, default=900)
    p.add_argument("--also", action="append", default=[],
                   help="a shell line to run in each turn's tree")
    args = p.parse_args(argv)
    trees = {"p": os.path.abspath(args.parent), "c": HERE}
    name = {"p": "parent", "c": "change"}
    for t in trees.values():
        if not os.path.exists(os.path.join(t, "bench_torch.py")):
            shutil.copy(os.path.join(HERE, "bench_torch.py"), t)
    os.makedirs(args.out, exist_ok=True)
    failed = 0
    with open(os.path.join(args.out, "bench.jsonl"), "a") as bench_log:
        for n, key in enumerate(args.order, 1):
            label = f"E{n}_{name[key]}"
            rc, sec, out, _ = run([sys.executable, "chip_smoke.py"],
                                  trees[key],
                                  os.path.join(args.out, f"{label}.log"),
                                  args.smoke_timeout)
            failed += rc != 0
            last = out.strip().splitlines()[-1] if out.strip() else ""
            print(f"{label}: chip_smoke rc {rc} in {sec:.1f} s; last line "
                  f"{last[:120]}", flush=True)
            for chunk in args.chunks:
                rc, sec, out, err = run(
                    [sys.executable, "bench_torch.py", "--chunk", str(chunk),
                     "--runs", str(args.runs)], trees[key],
                    os.path.join(args.out, f"{label}_bench{chunk}.log"), 600)
                failed += rc != 0
                line = out.strip().splitlines()[-1] if out.strip() else "{}"
                stats = [x for x in err.splitlines()
                         if x.startswith("bench_torch:")]
                record = {"run": label, "chunk": chunk, "rc": rc,
                          "result": json.loads(line) if rc == 0 else None,
                          "stats": stats[-1] if stats else None}
                bench_log.write(json.dumps(record) + "\n")
                bench_log.flush()
                print(f"{label} bench chunk {chunk}: {line} "
                      f"{record['stats']}", flush=True)
            for i, cmd in enumerate(args.also):
                cmd = cmd.format(here=HERE, label=label,
                                 out=os.path.abspath(args.out))
                rc, sec, out, err = run(
                    ["bash", "-c", cmd], trees[key],
                    os.path.join(args.out, f"{label}_also{i}.log"), 1200)
                failed += rc != 0
                print(f"{label} also {i}: rc {rc} in {sec:.1f} s", flush=True)
                for text in out.splitlines():
                    if text.startswith("{"):
                        print(f"{label} also {i}: {text}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
