"""Search harness CLI: L-sweep, repetitions, recall + QPS TSV reporting (port
of bang_tpu/harness/driver.py).

    python -m bang_tpu_torch.harness.driver <index_prefix> <query_file> \\
        <gt_file> <num_queries> <k> <float|uint8|int8> <l2|mips> \\
        [--variant base|inmemory|exactdistance] [--mode auto|interactive|single] \\
        [--L L] [--reps N] [--device cuda|cpu] ...

Functional parity with the reference harness (BANG_Base/test_driver.cpp):
  * the positional arguments above (test_driver.cpp:573-577);
  * auto mode sweeps L from k upward in steps of 12 until MAX_L
    (test_driver.cpp:376-377, 414-417), runs each L `--reps` times (5 by
    default, :424), and prints `L  wall_ms  QPS  recall` rows (:526);
  * interactive mode prompts for an L value and re-runs (:390-405, 536-543);
  * the documented methodology — discard run 1, report the remaining runs —
    follows BANG_Inmemory/parANN.h:19-35 (per-rep rows plus the best-rep
    summary).
As in the JAX harness, `--variant` picks base/inmemory/exactdistance
(separate binaries in the reference) and `--json` adds one JSON line per L.
The port adds `--device` (the card by default; "cpu" runs the plain PyTorch
path), and `--profile-dir` writes a torch.profiler Chrome trace of the first
rep. Each timed rep ends with the results on the host, so its wall holds
the device's work.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.constants import ENABLE_GPU_STATS, ENUM_DIST_L2, ENUM_DIST_MIPS, MAX_L
from bang_tpu_torch.formats.bin_io import load_bin_auto, load_truthset
from bang_tpu_torch.utils.config import DATASET_PRESETS
from bang_tpu_torch.utils.logging import log_message
from bang_tpu_torch.utils.recall import calculate_recall

DTYPE_MAP = {"float": np.float32, "float32": np.float32, "uint8": np.uint8, "int8": np.int8}


def _profiler(profile_dir, device):
    """A torch.profiler session that writes a Chrome trace into
    `profile_dir` when it ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    return profile(activities=activities,
                   on_trace_ready=lambda prof: prof.export_chrome_trace(path))


def run_L(engine: BANGSearch, queries, gt_ids, gt_dists, L, k, reps,
          visited_mode="exact", stats=False, beam=1, extra_iters=50,
          entry_mode="medoid", profile_dir=None):
    """Run one L value `reps` times; returns list of (wall_ms, qps, recall)."""
    engine.bang_set_searchparams(
        k, L, visited_mode=visited_mode, beam_width=beam, extra_iters=extra_iters,
        capabilities=ENABLE_GPU_STATS if stats else 0, entry_mode=entry_mode,
    )
    engine.bang_alloc(queries.shape[0])
    rows = []
    for rep in range(reps):
        engine.bang_init()
        prof = contextlib.nullcontext()
        if profile_dir and rep == 0:
            prof = _profiler(profile_dir, engine.device)
        t0 = time.perf_counter()
        with prof:
            ids, _dists = engine.bang_query(queries)  # host arrays: the device is done
        wall_ms = (time.perf_counter() - t0) * 1000.0
        qps = queries.shape[0] / (wall_ms / 1000.0)
        recall = calculate_recall(gt_ids, ids, k, gt_dists)
        rows.append((wall_ms, qps, recall))
        if stats and engine.last_stats is not None:
            st = engine.last_stats
            print(f"# stats: iters={st.iters} expanded={st.n_expanded} "
                  f"dist_comps={st.n_dist_comps}")
        if stats:
            report = engine.timers.report()
            if engine.variant == "base":
                report = engine._searcher.timers.report() + "\n" + report
            print("# stage timers:\n" + report)
    engine.bang_free()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("index_prefix")
    p.add_argument("query_file")
    p.add_argument("gt_file")
    p.add_argument("num_queries", type=int)
    p.add_argument("k", type=int)
    p.add_argument("dtype", choices=list(DTYPE_MAP))
    p.add_argument("distfn", choices=["l2", "mips"])
    p.add_argument("--variant", default="inmemory",
                   choices=["base", "inmemory", "exactdistance"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--mode", default="auto", choices=["auto", "interactive", "single"])
    p.add_argument("--L", type=int, default=None, help="single-mode worklist length")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--step", type=int, default=12, help="auto-mode L step")
    p.add_argument("--max-L", type=int, default=MAX_L)
    p.add_argument("--target-recall", type=float, default=None,
                   help="auto mode: stop once recall reaches this value")
    p.add_argument("--visited-mode", default="exact", choices=["exact", "bloom"])
    p.add_argument("--beam", type=int, default=1, help="parents expanded per iteration")
    p.add_argument("--entry-mode", default="medoid", choices=["medoid", "sampled"],
                   help="search entry: shared medoid (reference behavior) or "
                        "per-query sampled entry (models/entry.py)")
    p.add_argument("--extra-iters", type=int, default=50,
                   help="expansion budget beyond L (reference: 50)")
    p.add_argument("--stats", action="store_true",
                   help="print per-run search statistics and the stage report "
                        "(ENABLE_GPU_STATS analog: the API's host spans, the HBM "
                        "variants' device stages and capture records, base's "
                        "stage timers)")
    p.add_argument("--pipeline", type=int, default=None,
                   help="base variant: query sub-batches kept in flight")
    p.add_argument("--json", action="store_true", help="emit one JSON line per L")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the first rep "
                        "into this directory (trace.json)")
    p.add_argument("--dataset", default=None,
                   help="dataset preset name (utils/config.py::DATASET_PRESETS; "
                        "the reference's parANN.h #define blocks): validates "
                        "index dim/dtype and seeds the auto-sweep start L")
    args = p.parse_args(argv)

    preset = None
    if args.dataset is not None:
        preset = DATASET_PRESETS.get(args.dataset)
        if preset is None:
            p.error(f"unknown dataset {args.dataset!r}; "
                    f"known: {', '.join(sorted(DATASET_PRESETS))}")
        if preset.dtype != args.dtype and not (
            preset.dtype == "float32" and args.dtype == "float"
        ):
            log_message(f"WARNING: dataset {preset.name} is {preset.dtype}, "
                        f"CLI says {args.dtype}")

    dist_func = ENUM_DIST_L2 if args.distfn == "l2" else ENUM_DIST_MIPS
    engine = BANGSearch(variant=args.variant, dist_func=dist_func, device=args.device)
    log_message("LOAD STARTED")
    engine.bang_load(args.index_prefix, n_pipeline_batches=args.pipeline)
    log_message("LOAD DONE")
    if preset is not None:
        dim = engine._dim()
        if dim != preset.dim:
            log_message(f"WARNING: index dim {dim} != preset {preset.name} "
                        f"dim {preset.dim}")

    # queries: element dtype matches the dataset (size-probed for f32
    # tooling output); search always runs f32
    queries = load_bin_auto(args.query_file, DTYPE_MAP[args.dtype])[: args.num_queries]
    queries = queries.astype(np.float32)
    gt_ids, gt_dists = load_truthset(args.gt_file)
    gt_ids, gt_dists = gt_ids[: args.num_queries], gt_dists[: args.num_queries]

    def report(L, rows):
        for i, (wall, qps, rec) in enumerate(rows):
            tag = "warmup" if i == 0 and len(rows) > 1 else f"rep{i}"
            print(f"{L}\t{wall:.2f}\t{qps:.1f}\t{rec:.2f}\t{tag}")
        steady = rows[1:] or rows
        best = max(steady, key=lambda r: r[1])
        print(f"{L}\t{best[0]:.2f}\t{best[1]:.1f}\t{best[2]:.2f}\tbest")
        if args.json:
            print(json.dumps({
                "L": L, "wall_ms": best[0], "qps": best[1], "recall": best[2],
                "num_queries": int(queries.shape[0]), "k": args.k,
                "variant": args.variant, "device": str(engine.device),
            }))
        return best

    def run(L):
        return run_L(engine, queries, gt_ids, gt_dists, L, args.k, args.reps,
                     args.visited_mode, args.stats, args.beam, args.extra_iters,
                     args.entry_mode, args.profile_dir)

    print("L\twall_ms\tQPS\trecall\trep")
    if args.mode == "single":
        L = args.L or max(args.k, 10)
        report(L, run(L))
    elif args.mode == "auto":
        L = max(args.k, 10) if preset is None else max(args.k, preset.default_L)
        while L <= args.max_L:
            best = report(L, run(L))
            if args.target_recall is not None and best[2] >= args.target_recall:
                log_message(f"target recall {args.target_recall} reached at L={L}")
                break
            L += args.step
    else:  # interactive (reference: "Try Next run? [y|n]")
        while True:
            line = input("Enter L (or q to quit): ").strip()
            if line.lower() in ("q", "n", "quit", "exit", ""):
                break
            report(int(line), run(int(line)))

    engine.bang_unload()
    log_message("SEARCH END")
    return 0


if __name__ == "__main__":
    sys.exit(main())
