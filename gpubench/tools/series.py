"""Run one cell several times, one process after another, and keep each
run's result line: the runs that measure a cell's spread.

    python3 -m gpubench.tools.series --workload <cell> --seconds 20 \\
        --seeds 11 12 13 [--trace-seeds 14] --out <file>.jsonl

Each run is `python3 -m gpubench.run ...` from the repository's root; its
rc, wall, result line and the end of its standard error go to --out, one
JSON line a run, and a summary of each end-to-end metric (median and the
spread between its quartiles over the median, statistics.quantiles) to
standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    runs = [(s, 0) for s in args.seeds] + [(s, 1) for s in args.trace_seeds]
    values = {}
    with open(args.out, "a") as out:
        for seed, trace in runs:
            cmd = [sys.executable, "-m", "gpubench.run", "--workload", args.workload,
                   "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=args.timeout)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            row = {"workload": args.workload, "seed": seed, "trace": trace, "rc": p.returncode,
                   "wall_s": wall, "result": result, "stderr_tail": p.stderr[-3000:]}
            if p.returncode:
                with open(f"{args.out}.{seed}.err", "w") as f:
                    f.write(p.stderr)
            out.write(json.dumps(row) + "\n")
            out.flush()
            brief = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
            print(json.dumps({"seed": seed, "trace": trace, "rc": p.returncode,
                              "wall_s": round(wall, 1),
                              "correct": (result or {}).get("correct"), **brief,
                              "checks": (result or {}).get("checks")}), flush=True)
            if result and not trace:
                for k, v in brief.items():
                    values.setdefault(k, []).append(v)
    print(json.dumps({"summary": {k: {"median": statistics.median(v), "spread": spread(v)}
                                  for k, v in values.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
