"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as setup_s, from the process's start to the first timed
request): make the corpus and the query pool from the seed on the card
(the config's corpus module, corpus/<corpus>.py); build the index with
the program's offline builders (formats/vamana.build_vamana_graph, and for
PQ formats/synthetic.train_pq and formats/accel.encode_pq); save it under
$TMPDIR with formats/graph.save_graph_index and formats/pq.save_pq; load
it as a user does, through harness/serving.SearchServer, which calls
BANGSearch.bang_load with the config's `load`, bang_set_searchparams with
its `search` and bang_alloc, which warm up and capture the search at the
mix's batch shape.

The window: the traffic of generator.py for `--seconds` seconds, every
request through BANGSearch.bang_query (SearchServer.query for the serving
mix), each timed on the host clock until its ids and distances are host
arrays. `--trace 1` opens a profiler session before anything is captured
and keeps it open to the end of one steady slice of the window
(trace.Slice), whose events it keeps; its
result line carries the per-layer metrics, `--trace 0`'s the end-to-end
ones.

After the window: the peak device memory is read, the program's index and
graphs are freed, and the config's reference (reference/<name>.py) judges a
seeded sample of KEEP of the window's answers (all of them when fewer). The
last line of standard output is the result; the
last lines of standard error are the numbers judged, each beside its limit.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here: before any import

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gpubench")
FORBIDDEN = ("jax", "jaxlib", "flax", "bang_tpu")  # top-level names, whole
TRACE_AT = 1.0  # s into the window where the profiled slice starts (30% of a short one)
TRACE_SECONDS = 3.0  # and lasts this long (at most half the window)
KEEP = 64  # answers judged a run: a seeded sample of the window's requests


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` of root/BENCHMARK.json: its entry, its configuration
    (configs/<config>.json), its mix (traffic/<traffic>.json with
    cells/<name>.json's params over it), and the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = _json(os.path.join(root, "gpubench", "cells", f"{name}.json"))
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"cells/{name}.json names {cell['config']}/{cell['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/{entry['traffic']}")
    traffic = _json(os.path.join(root, "gpubench", "traffic", f"{entry['traffic']}.json"))
    traffic.update(cell.get("params", {}))

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {
        "name": name,
        "chips": entry["chips"],
        "config": _json(os.path.join(root, "gpubench", "configs", f"{entry['config']}.json")),
        "traffic": traffic,
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
    }


@dataclasses.dataclass
class Record:
    """What a run saw, for the metric readers (metrics/<name>.py)."""

    kind: str  # the device's name (torch.cuda.get_device_name), "cpu" off the card
    config: dict
    batch: int  # the batch shape every call is padded to
    setup: dict  # set-up stage -> seconds
    params: object = None  # the program's SearchParams the run searched with
    walls: list = dataclasses.field(default_factory=list)  # s a call
    latencies: list = dataclasses.field(default_factory=list)  # s a request
    lateness: list = dataclasses.field(default_factory=list)  # s, open loop
    sizes: list = dataclasses.field(default_factory=list)  # queries a request
    iters: list = dataclasses.field(default_factory=list)  # a call
    expanded: list = dataclasses.field(default_factory=list)  # a call
    window_s: float = 0.0
    timeline: object = None  # trace.Timeline of the profiled slice
    slice_calls: range = range(0)
    launches: dict | None = None  # kernel -> launches in the slice

    def untraced_wall_s(self):
        """Mean host-clock wall of the calls outside the profiled slice (the
        profiler's host events slow the calls inside it), None without a
        slice or without such calls."""
        outside = [w for i, w in enumerate(self.walls) if i not in self.slice_calls]
        if not len(self.slice_calls) or not outside:
            return None
        return sum(outside) / len(outside)


def _reader(name: str):
    """metrics/<name>.py, else metrics/<name up to its first dot>.py."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader metrics/{name}.py for per-layer metric {name!r}")


def _end_to_end(name: str, rec: Record, recall: float, setup_s: float):
    if name == "qps":
        return sum(rec.sizes) / rec.window_s
    if name == "p95_ms":
        return float(np.percentile(np.asarray(rec.latencies), 95)) * 1e3
    if name == "recall_at_10":
        return recall
    if name == "setup_s":
        return setup_s
    raise SystemExit(f"the harness measures no end-to-end metric {name!r}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def reference_of(cfg: dict):
    """The config's plain reference, reference/<reference>.py."""
    return importlib.import_module(f"gpubench.reference.{cfg['reference']}")


def make_corpus(cfg: dict, seed: int, dev):
    """(base, queries) of the config's corpus module (corpus/<corpus>.py),
    made from the seed on `dev`."""
    return importlib.import_module(f"gpubench.corpus.{cfg['corpus']}").make(cfg, seed, dev)


def _open_system(cfg: dict, traffic: dict, prefix: str, dev):
    """The program, loaded and warmed up as a user does: a SearchServer
    (BANGSearch, bang_load(**cfg["load"]), bang_set_searchparams with
    SearchParams(**cfg["search"]), bang_alloc(traffic["batch"])).
    Returns (call, server): `call` is the entry the mix drives,
    BANGSearch.bang_query or SearchServer.query."""
    from bang_tpu_torch.harness.serving import SearchServer
    from bang_tpu_torch.utils.config import SearchParams

    srv = SearchServer(prefix, variant=cfg["variant"], batch_size=traffic["batch"],
                       params=SearchParams(L=cfg["L"], k=cfg["k"], **cfg["search"]),
                       device=dev, **cfg["load"])
    entries = {"bang_query": srv.engine.bang_query, "search_server": srv.query}
    if traffic["entry"] not in entries:
        srv.close()
        raise SystemExit(f"unknown entry {traffic['entry']!r}")
    return entries[traffic["entry"]], srv


def close_system(srv) -> None:
    srv.close()
    srv.engine.bang_unload()


def _build_index(cfg: dict, base: np.ndarray, seed: int, prefix: str, dev, stage) -> None:
    from bang_tpu_torch.formats import accel, synthetic, vamana
    from bang_tpu_torch.formats.graph import GraphIndex, save_graph_index
    from bang_tpu_torch.formats.pq import save_pq

    adj, degrees, medoid = stage("graph", lambda: vamana.build_vamana_graph(
        base, cfg["R"], dev, l_build=cfg["L_build"], alpha=cfg["alpha"],
        batch=cfg["build_batch"], seed=seed, n_passes=cfg["build_passes"], verbose=False))
    pq = None
    if cfg["pq_chunks"]:
        pq = stage("pq_train", lambda: synthetic.train_pq(base, cfg["pq_chunks"], seed=seed))
        pq.codes = stage("pq_encode", lambda: accel.encode_pq(base, pq, dev))

    def save():
        save_graph_index(prefix, GraphIndex(vectors=base, adj=adj, degrees=degrees,
                                            medoid=medoid))
        if pq is not None:
            save_pq(prefix, pq)

    stage("save", save)


def execute(cell: dict, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    """Run `cell` once; returns the result line's object (its last key,
    "checks", holds the numbers judged beside their limits)."""
    import torch

    from gpubench import generator
    from gpubench import trace as tracing

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg, traffic = cell["config"], cell["traffic"]
    reference = reference_of(cfg)
    from bang_tpu_torch.device import set_exact_float32

    set_exact_float32()
    slicer = tracing.Slice(dev) if trace and on_card else None
    setup = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        setup[name] = time.perf_counter() - t0
        log(f"set-up {name} {setup[name]:.3f} s")
        return out

    def corpus():
        base_t, pool_t = make_corpus(cfg, seed, dev)
        return base_t.cpu().numpy(), pool_t.cpu().numpy()

    base, pool_raw = stage("corpus", corpus)
    pool = pool_raw.astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        prefix = os.path.join(tmp, "index")
        _build_index(cfg, base, seed, prefix, dev, stage)
        if slicer is not None:  # before anything is captured
            slicer.open()
        call, srv = stage("load", lambda: _open_system(cfg, traffic, prefix, dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rec = Record(kind=kind, config=cfg, params=srv.params, batch=traffic["batch"], setup=setup)
    attempted = failed = 0
    slice_at = min(TRACE_AT, 0.3 * seconds)
    slice_len = min(TRACE_SECONDS, seconds / 2)
    slice_first = None
    clock = time.perf_counter

    def issue(req, due):
        nonlocal attempted, failed, slice_first
        q = pool if len(req.idx) == len(pool) else pool[req.idx]
        if slicer is not None:
            if slice_first is None and clock() - t_open >= slice_at:
                from bang_tpu_torch.ops import pq_kernels

                pq_kernels.reset_launch_counts()
                slicer.mark(clock)
                slice_first = len(rec.walls)
                log(f"trace slice opens at request {attempted}, {clock() - t_open:.3f} s "
                    "into the window")
        t0 = clock()
        if due is not None:
            rec.lateness.append(t0 - due)
        attempted += 1
        try:
            if slicer is not None and slicer.recording:
                with torch.profiler.record_function("gpubench.request"):
                    ids, dists = call(q)
            else:
                ids, dists = call(q)
        except Exception:  # noqa: BLE001 - a failed request is counted, the run goes on
            failed += 1
            if failed == 1:
                traceback.print_exc()
            return
        t1 = clock()
        rec.walls.append(t1 - t0)
        rec.latencies.append(t1 - (t0 if due is None else due))
        rec.sizes.append(len(req.idx))
        st = srv.engine.last_stats
        rec.iters.append(st.iters)
        rec.expanded.append(st.n_expanded)
        keep(req.idx, ids, dists)
        if slicer is not None and slicer.recording and t1 - slicer.t0 >= slice_len:
            end_slice()

    def end_slice():
        from bang_tpu_torch.ops import pq_kernels

        t0 = clock()
        rec.timeline = slicer.stop()
        rec.launches = pq_kernels.launch_counts()
        rec.slice_calls = range(slice_first, len(rec.walls))
        log(f"trace slice: {len(rec.timeline.kernels)} kernels, {len(rec.timeline.host)} "
            f"host ranges read in {clock() - t0:.3f} s")

    # a seeded sample of the window's answers, copied: holding the arrays
    # bang_query returns would hold its pinned readback blocks, and every
    # later call would pin fresh ones
    answers = []
    kept_rng = generator.rng_for(seed, 3)
    n_seen = 0

    def keep(idx, ids, dists):
        nonlocal n_seen
        slot = n_seen if n_seen < KEEP else int(kept_rng.integers(0, n_seen + 1))
        n_seen += 1
        if slot < KEEP:
            a = (idx, np.array(ids), np.array(dists))
            if slot < len(answers):
                answers[slot] = a
            else:
                answers.append(a)

    setup_s = clock() - T_START
    log(f"set-up {setup_s:.3f} s; window {seconds} s of {traffic['loop']}-loop traffic")
    t_open = clock()
    if traffic["loop"] == "closed":
        for req in generator.closed_requests(traffic, len(pool), seed):
            if clock() - t_open >= seconds:
                break
            issue(req, None)
    elif traffic["loop"] == "open":
        for req in generator.open_schedule(traffic, len(pool), seed, seconds):
            due = t_open + req.due
            while (wait := due - clock()) > 0:
                time.sleep(wait - 0.0005 if wait > 0.001 else 0)
            issue(req, due)
    else:
        raise SystemExit(f"unknown loop {traffic['loop']!r}")
    rec.window_s = clock() - t_open
    if slicer is not None and slicer.recording:  # the window ended first
        end_slice()

    if rec.latencies:
        pct = np.percentile(np.asarray(rec.latencies) * 1e3, [50, 90, 95, 99, 100])
        log(f"{len(rec.latencies)} requests in {rec.window_s:.3f} s; latency ms p50 p90 p95 "
            f"p99 max {' '.join(f'{v:.3f}' for v in pct)}")
    if rec.slice_calls:
        inside = [rec.walls[i] for i in rec.slice_calls]
        outside = [w for i, w in enumerate(rec.walls) if i not in rec.slice_calls]
        if outside:
            log(f"traced calls {1e3 * np.mean(inside):.3f} ms a call, untraced "
                f"{1e3 * np.mean(outside):.3f} ms ({len(inside)} and {len(outside)} calls)")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"modules loaded in the benchmark's process: {found}")
    close_system(srv)
    del call, srv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = clock()
    base_t = torch.as_tensor(base, device=dev)
    pool_t = torch.as_tensor(pool_raw, device=dev)
    gold_ids, gold_d = reference.exact_knn(base_t, pool_t, reference.GOLD)
    judge = reference.Judge(base_t, pool_t, gold_ids, gold_d, cfg["k"])
    for idx, ids, dists in answers:
        judge.add(idx, ids, dists)
    log(f"reference {clock() - t0:.3f} s over {judge.answered} answered queries of "
        f"{len(answers)} sampled requests"
        + (f"; {judge.clipped} gold sets cut at {reference.GOLD}" if judge.clipped else ""))
    recall = judge.recall()
    checks = judge.checks(cfg)

    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = _reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": _end_to_end(m["name"], rec, recall, setup_s),
                                  "unit": m["unit"]}
    if on_card:
        device_info = {"platform": "gpu", "kind": kind,
                       "count": cell["chips"], "memory_peak_bytes": peak}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": None}
    correct = not failed and judge.correct(cfg)
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace and rec.timeline is not None:
        t0 = clock()
        tl = rec.timeline
        device_info["busy_s"] = tl.busy_s()
        device_info["window_s"] = tl.window_s
        out["breakdown"] = {"device_ops": tl.top_ops(), "idle_gaps": tl.idle_gaps()}
        log(f"trace reduced in {clock() - t0:.3f} s")
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "bang_tpu_torch", "_build", sub)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
