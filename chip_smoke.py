#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bang_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, each printing progress; any failure raises and exits non-zero:
  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), torch, CUDA and nvcc versions.
  2. build    — build both kernels from bang_tpu_torch/csrc with nvcc.
  3. kernels  — K1 pq_lookup and K2 frontier_lookup against their plain
                PyTorch versions on the card at the main path's shape and
                three others: ids bit-exact, distances within rtol 1e-5 plus
                atol 1e-5 x the row's largest distance (f32 summation order
                is all that differs). Times both at the main path's shape.
  4. bundle   — build the bench's headline bundle on the card with the
                port's builders (bench.py's settings: 1M x 128 u8 clustered
                data, 10K queries at noise 2.0, pruned-kNN R=64, PQ m=64) and
                write it in the reference's file formats to a temp dir.
  5. search   — BANGSearch("inmemory") on the fused-row layout (K2), L in
                {32, 64, 128, 256, 512}, beam 2, extra_iters 11: recall@10,
                iterations, wall time and QPS; recall@10 >= 90 at the best L.
  6. scattered — the same bundle on the scattered-codes layout (K1) at the
                best L: recall within 0.5 points of phase 5.
The kernels' launch counters are zeroed just before phase 5 and read after
phase 6. The second-to-last line is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

N, D, Q, K = 1_000_000, 128, 10_000, 10
R, M, BEAM, EXTRA = 64, 64, 2, 11
L_SWEEP = (32, 64, 128, 256, 512)
RECALL_TARGET = 90.0
SCATTERED_RECALL_GAP = 0.5

# (label, Q, N rows, R, m, beam, ids drawn below): the main path's shape,
# then the other shapes the kernels must take.
KERNEL_SHAPES = (
    ("main Q=10K R=64 m=64 beam=2", Q, N, R, M, BEAM, N),
    ("R=32 m=32", Q, 200_000, 32, 32, 2, 200_000),
    ("R=24 m=12 beam=4", 4096, 100_000, 24, 12, 4, 100_000),
    ("ids up to 2^30", 4096, 50_000, 64, 64, 2, 1 << 30),
)
KERNEL_SOURCES = {
    "pq_lookup": ("bang_tpu_torch/csrc/pq_lookup.cu", "bang_tpu/ops/pq_pallas.py:74"),
    "frontier_lookup": ("bang_tpu_torch/csrc/frontier_lookup.cu",
                        "bang_tpu/ops/pq_pallas.py:267"),
}


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from bang_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc}")
    log(f"device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return smi


def phase_build():
    from bang_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for name in KERNEL_SOURCES:
        _build.load_library(name)
        info = _build.BUILD_INFO[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines() if "ptxas info" in ln]
        log(f"built {name} in {info['seconds']:.2f}s (cached={info['cached']}): "
            + " | ".join(ptxas))
    secs = time.perf_counter() - t0
    log(f"build {secs:.2f}s")
    return secs


def _fused_inputs(gen, q, n, r, m, beam, id_hi, dev):
    from bang_tpu_torch.ops.adjacency import pack_adj_planes

    tables = torch.randn((q, m, 256), generator=gen, device=dev) ** 2
    ids = torch.randint(0, id_hi, (n, r), generator=gen, device=dev,
                        dtype=torch.int32)
    codes = torch.randint(0, 256, (n, m * r), generator=gen, device=dev,
                          dtype=torch.uint8)
    rows = torch.cat([pack_adj_planes(ids), codes], dim=1)
    del codes
    parents = torch.randint(0, n, (q, beam), generator=gen, device=dev,
                            dtype=torch.int32)
    return tables, rows, parents, ids


def _dist_err(label, got, want):
    """Max |got - want|; raises past rtol 1e-5 + atol 1e-5 x row max."""
    err = (got - want).abs()
    tol = 1e-5 * want.abs() + 1e-5 * want.abs().amax(dim=1, keepdim=True)
    bad = int((err > tol).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: {bad} distances out of tolerance, "
                             f"max err {float(err.max())}")
    return float(err.max())


def _time_ms(fn, reps=20):
    """Mean device ms per call over `reps` calls, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(dev):
    from bang_tpu_torch.ops import pq_kernels as pk

    gen = torch.Generator(device=dev).manual_seed(0)
    result = {name: {"max_abs_err": 0.0} for name in KERNEL_SOURCES}
    for i, (label, q, n, r, m, beam, id_hi) in enumerate(KERNEL_SHAPES):
        tables, rows, parents, ids = _fused_inputs(gen, q, n, r, m, beam, id_hi, dev)
        got_ids, got_d = pk.frontier_lookup(tables, rows, parents)
        torch.cuda.synchronize()
        want_ids, want_d = pk.frontier_lookup_plain(tables, rows, parents)
        if not torch.equal(got_ids, want_ids) or not torch.equal(
                got_ids, ids[parents.long()].reshape(q, -1)):
            raise AssertionError(f"frontier_lookup {label}: ids differ")
        e2 = _dist_err(f"frontier_lookup {label}", got_d, want_d)

        codes = torch.randint(0, 256, (q, beam * r, m), generator=gen,
                              device=dev, dtype=torch.uint8)
        got = pk.pq_lookup(tables, codes)
        torch.cuda.synchronize()
        e1 = _dist_err(f"pq_lookup {label}", got, pk.pq_lookup_plain(tables, codes))
        result["pq_lookup"]["max_abs_err"] = max(result["pq_lookup"]["max_abs_err"], e1)
        result["frontier_lookup"]["max_abs_err"] = max(
            result["frontier_lookup"]["max_abs_err"], e2)
        log(f"kernels {label}: ids exact, max abs err K1 {e1:.3g} K2 {e2:.3g}")

        if i == 0:  # time at the main path's shape: plain, kernel, kernel, plain
            runs = {
                "pq_lookup": (lambda: pk.pq_lookup(tables, codes),
                              lambda: pk.pq_lookup_plain(tables, codes)),
                "frontier_lookup": (
                    lambda: pk.frontier_lookup(tables, rows, parents),
                    lambda: pk.frontier_lookup_plain(tables, rows, parents)),
            }
            for name, (kern, plain) in runs.items():
                p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern),
                                  _time_ms(kern), _time_ms(plain))
                result[name]["ms"] = (k1 + k2) / 2
                result[name]["plain_ms"] = (p1 + p2) / 2
                log(f"time {name} at {label}: kernel {k1:.4f} / {k2:.4f} ms, "
                    f"plain {p1:.4f} / {p2:.4f} ms")
        del tables, rows, parents, ids, codes, got_ids, got_d, want_ids, want_d, got
        torch.cuda.empty_cache()
    return result


def build_bundle(prefix, dev, n=N, d=D, q=Q, r=R, m=M):
    """The bench's headline bundle (bench.py build_bundle, graph='pruned'),
    built with the port's builders on `dev`; returns stage seconds."""
    from bang_tpu.formats import synthetic
    from bang_tpu.formats.bin_io import save_bin, save_truthset
    from bang_tpu.formats.graph import GraphIndex, save_graph_index
    from bang_tpu.formats.pq import save_pq
    from bang_tpu_torch.formats import accel

    t = {}
    t0 = time.perf_counter()
    n_clusters = max(64, min(4096, n // 1000))
    data = synthetic.make_clustered_data(n, d, n_clusters=n_clusters,
                                         dtype=np.uint8, seed=0)
    rng = np.random.default_rng(1)
    queries = data[rng.integers(0, n, q)].astype(np.float32)
    queries += rng.normal(0, 2.0, queries.shape).astype(np.float32)
    queries = np.clip(np.rint(queries), 0, 255).astype(np.uint8)
    t["data"] = time.perf_counter() - t0

    def stage(name, fn):
        s = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t[name] = time.perf_counter() - s
        log(f"bundle {name} {t[name]:.1f}s")
        return out

    gt_ids, gt_dists = stage("groundtruth", lambda: accel.compute_groundtruth(
        data, queries.astype(np.float32), 100, dev))
    adj, degrees = stage("graph", lambda: accel.build_pruned_knn_graph(
        data, r, dev, n_random=r // 8, seed=0, block=2048))
    pq = stage("pq_train", lambda: synthetic.train_pq(data, m, seed=0))
    pq.codes = stage("pq_encode", lambda: accel.encode_pq(data, pq, dev))

    def save():
        medoid = synthetic.medoid_of(data)
        save_graph_index(prefix, GraphIndex(data, adj, degrees, medoid))
        save_pq(prefix, pq)
        save_bin(prefix + "_query.bin", queries)
        save_truthset(prefix + "_gt.bin", gt_ids, gt_dists)

    stage("save", save)
    t["total"] = time.perf_counter() - t0
    log(f"bundle N={n} D={d} R={r} m={m} Q={q} built in {t['total']:.1f}s")
    return t


def _check_output(ids, dists, queries, vectors, n):
    """Shape, range, finiteness, ascending order, and the returned distances
    against a float64 numpy recomputation on the first 200 queries."""
    if ids.shape != (len(queries), K) or ids.dtype != np.int64:
        raise AssertionError(f"ids {ids.shape} {ids.dtype}")
    if not ((ids >= 0) & (ids < n)).all() or not np.isfinite(dists).all():
        raise AssertionError("ids out of range or distances not finite")
    if (np.diff(dists, axis=1) < 0).any():
        raise AssertionError("distances not ascending")
    qs = queries[:200].astype(np.float64)
    ref = ((vectors[ids[:200]].astype(np.float64) - qs[:, None]) ** 2).sum(-1)
    if not np.allclose(dists[:200], ref, rtol=1e-6, atol=1e-3):
        raise AssertionError(f"re-ranked distances off the reference by "
                             f"{np.abs(dists[:200] - ref).max()}")


def run_search(prefix, dev, l_values, fused_frontier=None):
    """BANGSearch("inmemory") over `l_values`; one row per L."""
    from bang_tpu.formats.bin_io import load_bin, load_truthset
    from bang_tpu.formats.graph import load_graph_index
    from bang_tpu.utils.recall import calculate_recall
    from bang_tpu_torch.api import BANGSearch

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    vectors = load_graph_index(prefix).vectors
    s = BANGSearch("inmemory", device=dev)
    t0 = time.perf_counter()
    s.bang_load(prefix, fused_frontier=fused_frontier)
    layout = "fused" if s._index.fused_rows is not None else "scattered"
    log(f"bang_load {layout} layout in {time.perf_counter() - t0:.1f}s")
    rows = []
    for L in l_values:
        s.bang_set_searchparams(K, L, beam_width=BEAM, extra_iters=EXTRA)
        s.bang_alloc(len(queries))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, dists = s.bang_query(queries)  # host arrays: the device is done
        wall = time.perf_counter() - t0
        _check_output(ids, dists, queries, vectors, len(vectors))
        row = {"layout": layout, "L": L,
               "recall": calculate_recall(gt_ids, ids, K, gt_dists),
               "iters": s.last_stats.iters, "wall_s": wall,
               "qps": len(queries) / wall}
        log(f"search {layout} L={L} recall@10={row['recall']:.2f} "
            f"iters={row['iters']} wall={wall:.4f}s qps={row['qps']:.1f}")
        rows.append(row)
    s.bang_unload()
    return rows


def main():
    smi = phase_device()
    dev = torch.device("cuda")
    import bang_tpu_torch  # noqa: F401  (TF32 off)
    from bang_tpu_torch.ops import pq_kernels as pk

    phase_build()
    kern = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        prefix = os.path.join(tmp, "synth1m")
        build_bundle(prefix, dev)

        pk.reset_launch_counts()
        fused = run_search(prefix, dev, L_SWEEP)
        best = max(fused, key=lambda row: row["recall"])
        if best["recall"] < RECALL_TARGET:
            raise AssertionError(f"best recall@10 {best['recall']:.2f} < {RECALL_TARGET}")
        if pk.frontier_lookup.launches == 0 or pk.pq_lookup.launches != 0:
            raise AssertionError(
                f"fused search launches: frontier_lookup "
                f"{pk.frontier_lookup.launches}, pq_lookup {pk.pq_lookup.launches}")
        k2_launches = pk.frontier_lookup.launches
        torch.cuda.empty_cache()

        scattered = run_search(prefix, dev, (best["L"],), fused_frontier=False)[0]
        if pk.pq_lookup.launches == 0 or pk.frontier_lookup.launches != k2_launches:
            raise AssertionError(
                f"scattered search launches: pq_lookup {pk.pq_lookup.launches}, "
                f"frontier_lookup {pk.frontier_lookup.launches - k2_launches}")
        gap = abs(scattered["recall"] - best["recall"])
        if gap > SCATTERED_RECALL_GAP:
            raise AssertionError(f"scattered recall {scattered['recall']:.2f} vs "
                                 f"fused {best['recall']:.2f}")
    log(f"ok: best L={best['L']} recall@10 {best['recall']:.2f}; scattered "
        f"recall@10 {scattered['recall']:.2f}; on {smi}")

    launches = {"pq_lookup": pk.pq_lookup.launches,
                "frontier_lookup": pk.frontier_lookup.launches}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kern[name]["max_abs_err"],
         "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"]}
        for name, (src, rep) in KERNEL_SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
