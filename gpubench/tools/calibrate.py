"""One-off measurements that fix a cell's numbers; the benchmark's runs never
call this.

    python3 -m gpubench.tools.calibrate lsweep --config sift1m-exact --seeds 1 2 3 \\
        --grid 10 12 16 20 30 40 60
        recall@10 and the wall of a 10K call at each L, per seed: the
        config's L is the smallest at which every seed reaches its
        recall_limit
    python3 -m gpubench.tools.calibrate rates --cell sift1m-exact.online4096 \\
        --seed 7 --rates 40 60 80 --seconds 10
        the open loop at each rate: latency, lateness and whether the
        backlog grows; the cell's rate is 4/5 of the highest that holds
    python3 -m gpubench.tools.calibrate control --config sift1m-exact --seeds 1 2 3
        the control: the reference itself, computed in a lower precision,
        put in the program's place and judged as a run's answers are

Each prints one JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from gpubench import generator, run


def _config(name: str) -> dict:
    with open(os.path.join(run.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def _corpus(cfg, seed, dev):
    base_t, pool_t = run.make_corpus(cfg, seed, dev)
    ref = run.reference_of(cfg)
    return base_t, pool_t, ref.exact_knn(base_t, pool_t, ref.GOLD)


def _built(cfg, seed, dev, tmp):
    from bang_tpu_torch.device import set_exact_float32

    set_exact_float32()
    base_t, pool_t, gold = _corpus(cfg, seed, dev)
    stages = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        run._sync(dev)
        stages[name] = time.perf_counter() - t0
        return out

    prefix = os.path.join(tmp, "index")
    run._build_index(cfg, base_t.cpu().numpy(), seed, prefix, dev, stage)
    return base_t, pool_t, gold, prefix, stages


def lsweep(args, dev) -> None:
    cfg = _config(args.config)
    ref = run.reference_of(cfg)
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="gpubench-") as tmp:
            base_t, pool_t, gold, prefix, stages = _built(cfg, seed, dev, tmp)
            _emit({"seed": seed, "stages": stages})
            pool = pool_t.cpu().numpy().astype(np.float32)
            for L in args.grid:
                call, srv = run._open_system(dict(cfg, L=L), {"entry": "bang_query",
                                                              "batch": len(pool)}, prefix, dev)
                walls = []
                for _ in range(args.calls):
                    t0 = time.perf_counter()
                    ids, dists = call(pool)
                    walls.append(time.perf_counter() - t0)
                iters = srv.engine.last_stats.iters
                run.close_system(srv)
                judge = ref.Judge(base_t, pool_t, *gold, cfg["k"])
                judge.add(np.arange(len(pool)), ids, dists)
                _emit({"config": cfg["name"], "seed": seed, "L": L, "recall": judge.recall(),
                       "dist_gap": judge.gap, "iters": iters,
                       "wall_s": walls, "qps": len(pool) / float(np.median(walls))})


def rates(args, dev) -> None:
    cell = run.load_cell(args.cell)
    cfg, traffic = cell["config"], dict(cell["traffic"])
    with tempfile.TemporaryDirectory(prefix="gpubench-") as tmp:
        _, pool_t, _, prefix, stages = _built(cfg, args.seed, dev, tmp)
        call, srv = run._open_system(cfg, traffic, prefix, dev)
    pool = pool_t.cpu().numpy().astype(np.float32)
    service = []
    for size in (traffic["size_min"], traffic["batch"]):
        for _ in range(5):
            t0 = time.perf_counter()
            call(pool[:size])
            service.append((size, time.perf_counter() - t0))
    _emit({"cell": args.cell, "stages": stages, "service_s": service})
    for rate in args.rates:
        traffic["rate_per_s"] = rate
        sched = generator.open_schedule(traffic, len(pool), args.seed, args.seconds)
        lat, late = [], []
        t_open = time.perf_counter()
        for req in sched:
            q = pool[req.idx]
            due = t_open + req.due
            while (wait := due - time.perf_counter()) > 0:
                time.sleep(wait - 0.0005 if wait > 0.001 else 0)
            t0 = time.perf_counter()
            call(q)
            t1 = time.perf_counter()
            lat.append(t1 - due)
            late.append(t0 - due)
        third = max(1, len(late) // 3)
        _emit({"cell": args.cell, "rate": rate, "requests": len(sched),
               "done_s": time.perf_counter() - t_open,
               "p50_ms": 1e3 * float(np.percentile(lat, 50)),
               "p95_ms": 1e3 * float(np.percentile(lat, 95)),
               "late_p95_ms": 1e3 * float(np.percentile(late, 95)),
               "late_first_third_ms": 1e3 * float(np.mean(late[:third])),
               "late_last_third_ms": 1e3 * float(np.mean(late[-third:]))})
    run.close_system(srv)


def control(args, dev) -> None:
    """The reference in the program's place, judged by the run's own
    decision (the reference's Judge.correct)."""
    cfg = _config(args.config)
    ref = run.reference_of(cfg)
    for seed in args.seeds:
        base_t, pool_t, gold = _corpus(cfg, seed, dev)
        for precision in args.precisions:
            ids, dists = ref.exact_knn(base_t, pool_t, cfg["k"], precision=precision)
            judge = ref.Judge(base_t, pool_t, *gold, cfg["k"])
            judge.add(np.arange(pool_t.shape[0]), ids.cpu().numpy(), dists.cpu().numpy())
            _emit({"config": cfg["name"], "seed": seed, "precision": precision,
                   "checks": judge.checks(cfg), "correct": judge.correct(cfg)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("lsweep")
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--grid", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=3)
    p = sub.add_parser("rates")
    p.add_argument("--cell", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p = sub.add_parser("control")
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precisions", nargs="+", default=["tf32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    {"lsweep": lsweep, "rates": rates, "control": control}[args.cmd](args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
