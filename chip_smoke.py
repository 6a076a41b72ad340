#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bang_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, each printing progress; any failure raises and exits non-zero:
  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), torch, CUDA and nvcc versions.
  2. build    — build the five kernel sources of bang_tpu_torch/csrc (six
                wrappers: lookup_packed launches K1's), one nvcc per source,
                all started together.
  3. kernels  — K1 pq_lookup, K2 frontier_lookup and K3 exact_frontier
                against their plain PyTorch versions on the card at the main
                paths' shapes and others: ids bit-exact; K1 and K2 (both on
                bf16-pair tables, pack_tables) distances within rtol 1e-5
                plus atol 1e-5 x the row's largest distance (f32 summation
                order is all that differs), at shapes that take each of
                their copy paths (16-byte, 4-byte, byte) and candidates or
                parents in groups; K1 also on code tiles 4 and 1 bytes off
                a 16-byte boundary, bit for bit equal to its aligned launch;
                K2 also with parents outside [0, N) (id -1, +inf); at the
                main shape K2, and K1 on the codes of the same rows,
                identical bit for bit to K6 row_gather + K5 frontier_packed
                on the same parents (the same sum in the same order); K3
                distances bit-exact for integer queries at D <= 128 (every
                partial sum is an integer below 2^24), else within rtol
                1e-5 plus atol 1e-5 x (||q||^2 + the row's largest norm),
                at shapes that take each of its row-copy paths (16-byte,
                4-byte, byte) and parents in groups, and with parents
                outside [0, N) (id -1, +inf). Times each at its main path's
                shape; K1's and K2's bounds count the packed tables' bytes.
  mask        — the sorted visited mask (ops/visited.exact_new_mask, plain
                PyTorch) identical to its dense form on random ids at both
                search shapes (Q=10K; C=128 L=128 MI=140 and C=64 L=100
                MI=106), INVALID_ID padding and candidates included; both
                timed.
  probes      — lookup_packed (K1's kernel), K5 frontier_packed (with and
                without id planes) and K6 row_gather, the counterparts of
                the six Pallas probes in scripts/, against their plain
                versions at the probes' shape and at R=24 m=12 beam 4 with
                ids up to 2^30 (ids and gathered bytes bit-exact, distances
                as K1's: the bf16 entries are the same, only the f32
                summation order may differ; lookup_packed equal to K5 bit
                for bit), K6 also at widths 5120, 4352 and 100 with odd
                and out-of-range parents (zero rows); times each, K6 beside
                torch.index_select. Then runs the five probe scripts
                (bang_tpu_torch.scripts.exp_*.main("cuda")) at their own
                sizes, each with the launch counts zeroed before and read
                after: each must launch its kernels and no other.
  4. bundle   — build the bench's headline bundle on the card with the
                port's builders (bench.py's settings: 1M x 128 u8 clustered
                data, 10K queries at noise 2.0, Vamana R=64 l_build 48 batch
                4096 alpha 1.44 2 passes, PQ m=64) and write it in the
                reference's file formats to a temp dir.
  5. search   — BANGSearch("inmemory") on the fused-row layout (K2), L in
                {32, 64, 128, 256, 512}, beam 2, extra_iters 11: recall@10,
                iterations, wall time and QPS; recall@10 >= 90 at the best L.
                Then one call at L=128 under torch.profiler, after three
                timed ones, with the sorted visited mask and again with its
                dense form: kernel device ms by name and by traversal stage,
                busy share, peak memory.
  6. scattered — the same bundle on the scattered-codes layout (K1 over the
                packed tables) at the best L: ids and iterations identical
                to phase 5's (K1 and K2 sum the same entries in the same
                order). Then one call at L=512 under torch.profiler, as
                phase 5's (the sorted mask only).
  7. exact    — BANGSearch("exactdistance") on the fused exact rows (K3),
                L in {10, 16, 30, 60, 100}, beam 1, extra_iters 6: recall@10
                >= 90 at the best L; no re-rank, so the distances checked are
                K3's own. Then the L=100 profile, as phase 5's.
  8. exact scattered — the scattered exact layout (plain fetch, no kernel)
                at the best L: ids identical to phase 7 for every query.
  9. sampled  — entry_mode="sampled" at each variant's best L (K3, K2):
                recall@10 >= 90; and at its sweep's smallest L. Both printed
                beside the medoid runs.
 10. base     — BANGSearch("base") on the same bundle at bench.py::
                sweep_base's operating point: the packed graph read into host
                RAM (mmap=False), the PQ codes on the card, 8 pipeline
                sub-batches (one CUDA stream each), L in {30, 45, 60, 90},
                beam 2, extra_iters 16, ENABLE_GPU_STATS on: recall@10, device
                steps, readback waits, the four stage ms, wall and QPS per L;
                recall@10 >= 90 at the best L; K1 launched once per device
                step and no other kernel. At the best L: one sub-batch
                (serial) must return the pipelined run's ids for every query
                (its wall gives the pipeline's speedup), and sampled entry
                recall@10 >= 90. Then the native host gather alone on one
                sub-batch's parents, and one call under torch.profiler
                (kernel ms by name and by step stage, the code gather's ms,
                the card's busy share over the union of kernel intervals on
                all streams, peak memory).
 11. bloom    — visited_mode="bloom" (ops/bloom.py, plain PyTorch) on each
                search of the bundle: in-memory fused L in {64, 128, 256}
                (K2), in-memory scattered L=512 (K1), exact fused L in {30,
                60, 100} (K3), base L in {30, 90} (K1 once a device step),
                each run in the order exact, bloom, bloom, exact: each L's
                recall@10 >= the exact mode's at that L - 1.5 (the JAX
                package's bar, tests/test_large_l.py) and >= 90 at the best
                L, the same ids in both runs of a mode; walls, iterations
                and peak memory beside the exact mode's. Then the fused
                L=128 profile in bloom mode, the hash, query and insert in
                profiler ranges.
 12. warm-up and serving — ENABLE_CACHE_WARMUP on the three variants: the
                touched count equal to the BFS count from the medoid, the ids
                identical to a call without the bit. SearchServer("inmemory",
                batch_size=128) over the 10K queries: ids and distances
                identical to bang_query at Q=128, latency percentiles. The
                latency probes: measure_device_batch_latency at 128 queries
                (in-memory, exact) and measure_base_device_step_ms at 1,250
                (exact, bloom, bloom, exact), each launching its variant's
                kernel.
 13. streaming — bench.py::streaming_row's point: StreamingIndex from empty
                over 200K x 128 f32 clustered points (seed 11, 200 clusters),
                R=32, l_build 32, inserts of 4,096; search at L=64, beam 2,
                extra_iters 24 over 2,048 queries; 10% churn (delete,
                consolidate(batch=4096), re-insert 4,096 into freed slots):
                recall@10 over the live set >= 90 before and after the churn,
                no kernel launched.
 14. sharded  — parallel/ on the bundle's data, every mesh on [card] * n
                (one card): K1 against its plain version and timed at each
                code width the sharded paths give it (m/4 chunks, and the dry
                run's 1 and 8); the card's kNN graph against numpy's on 20K
                points (rows reported); 4 node shards of 250K points (R=64,
                m=64, the bundle's codebook) searched on a (1, 4) mesh at L in
                {128, 256}, fused (K2) and scattered (K1): ids and every
                shard's iterations identical, recall@10 >= 90 at the best L;
                the merge equal to each shard searched alone with
                search_inmemory and merged on the host; exact shards at L=256
                (no kernel), recall@10 >= 90; search_data_parallel on a (2, 1)
                mesh, ids identical to search_inmemory; ShardedBaseSearcher
                on a (1, 4) mesh (8 sub-batches, base L in {30, 90}, medoid
                and sampled entry): ids equal to the single-card base's on
                >= 98% of slots, recall@10 >= 90, K1 launched 4 times a step
                (and 4 times per sub-batch's sampled entries); then
                entry.dryrun_multichip(4). Walls, iterations and peak memory.
 15. sharded build — formats/bigbuild.py: BlockGen at N=1M x 128 u8 on the
                card, build_sharded_vamana (4 shards, overlap 2, R=64, l_build
                48, batch 4096, one pass; no kernel), k-means and the
                assignment run again and equal, each shard's measured
                peak memory beside shard_build_hbm_bytes; the int8 ground
                truth for 10K queries equal to formats/accel.
                compute_groundtruth's distances on every slot; PQ (m=64,
                trained on 16,384 points) encoded on the card; in-memory search
                (K2) over the merged graph at L in {64, 128}, recall@10 >= 90.
Each probe script and each search phase zeroes every launch count just
before it and reads them just after: the kernels of its path must have
launched and no other. The second-to-last line is a JSON object describing
each kernel (its launches summed over those runs, its bound from this run's
byte and operation counts); the last is {"ok": true, "device": {...}}.
"""

import contextlib
import importlib
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

N, D, Q, K = 1_000_000, 128, 10_000, 10
R, M = 64, 64
# bench.py's operating points (VARIANT_CONFIGS) and Vamana settings
BEAM_EXTRA = {"inmemory": (2, 11), "exactdistance": (1, 6)}
L_SWEEP = (32, 64, 128, 256, 512)
PROFILE_L = 128  # the in-memory L whose fused search is profiled (PERF.md §5)
SCATTERED_PROFILE_L = 512  # the in-memory L whose scattered search is profiled
EXACT_L_SWEEP = (10, 16, 30, 60, 100)
EXACT_PROFILE_L = 100  # the exact L whose fused search is profiled
VAMANA = {"l_build": 48, "batch": 4096, "alpha": 1.44, "n_passes": 2, "seed": 0}
RECALL_TARGET = 90.0
# base: bench.py::sweep_base's operating point (bench.py:502-503), the graph
# read into RAM as in the reference's configuration
BASE_L_SWEEP = (30, 45, 60, 90)
BASE_BEAM, BASE_EXTRA, BASE_PIPELINE = 2, 16, 8
# phase 11: the Ls searched in bloom mode, and the JAX package's bar for the
# recall bloom may lose against the exact mask at the same L
BLOOM_L = {"inmemory": (64, 128, 256), "exactdistance": (30, 60, 100)}
BLOOM_BASE_L = (30, 90)
BLOOM_RECALL_SLACK = 1.5
# phase 12: each variant's L for the warm-up and the probes; the server's batch
WARMUP_L = {"inmemory": 64, "exactdistance": 30, "base": 30}
SERVER_BATCH = 128
# phase 13: bench.py::streaming_row's point (bench.py:628-717)
STREAM_N, STREAM_R, STREAM_Q, STREAM_CHUNK = 200_000, 32, 2048, 4096

# phase 14: the bundle's data in SHARDS node shards (or chunk shards for
# base), each mesh on [card] * n; the node-sharded and chunk-sharded Ls. A
# shard's graph is partition.py's kNN + random edges, not Vamana: at 250K
# points in ~1000 clusters the walk finds the query's cluster through the
# random edges, so recall needs a longer walk than the bundle's graph
# (75.5 at L=64, 88.8 at L=128 on the card, PERF.md)
SHARDS = 4
SHARD_L = (128, 256)
EXACT_SHARD_L = 256
TP_BASE_L = (30, 90)
KNN_CHECK_N = 20_000  # the card's kNN graph against numpy's on this many points
# K1 at the code widths the sharded paths launch it with: (label, Q, C, m)
K1_WIDTHS = (
    ("the chunk-sharded base, m/4 chunks a shard", Q // BASE_PIPELINE, BASE_BEAM * R,
     M // SHARDS),
    ("the dry run's base, 1 chunk a shard", 8, 64, 1),
    ("the dry run's node shards", 8, 24, 8),
)
# phase 15: the sharded build's dataset, the PQ training sample, the Ls
BIG_N = 1_000_000
PQ_SAMPLE = 16_384
BIG_L = (64, 128)

# (label, Q, N rows, R, m, beam, ids drawn below): the main path's shape,
# then the other shapes the kernels must take.
KERNEL_SHAPES = (
    ("main Q=10K R=64 m=64 beam=2", Q, N, R, M, 2, N),
    ("R=32 m=32", Q, 200_000, 32, 32, 2, 200_000),
    ("R=24 m=12 beam=4", 4096, 100_000, 24, 12, 4, 100_000),
    ("ids up to 2^30", 4096, 50_000, 64, 64, 2, 1 << 30),
    # K2's other copy paths: 4-byte and byte copies of rows whose width is
    # not a multiple of 16 (or 4), parents in groups of 3 + 2, and a table
    # so large that each parent is a group of its own
    ("R=20 m=13 beam=3 (4-byte row copies)", 4096, 50_000, 20, 13, 3, 50_000),
    ("R=15 m=9 beam=2 (byte row copies)", 4096, 50_000, 15, 9, 2, 50_000),
    ("R=64 m=64 beam=5 (parents in groups)", 4096, 100_000, 64, 64, 5, 100_000),
    ("R=64 m=200 beam=2 (a parent a group)", 2048, 20_000, 64, 200, 2, 20_000),
    # K1's groups of candidates at the scattered route's largest C (beam 16
    # x R=64: six groups of 171), and the largest table K1 and K2 take
    # (m=453: one candidate, one parent a group)
    ("R=64 m=64 beam=16 (candidates in groups)", 4096, 100_000, 64, 64, 16, 100_000),
    ("R=1 m=453 beam=16 (the largest table)", 512, 5_000, 1, 453, 16, 5_000),
)
# K3: (label, Q, N rows, R, D, beam, ids drawn below, integer queries)
EXACT_SHAPES = (
    ("main Q=10K R=64 D=128 beam=1", Q, N, R, D, 1, N, True),
    ("R=32 D=96 beam=4", 4096, 200_000, 32, 96, 4, 200_000, True),
    ("R=24 D=100 beam=2", 4096, 100_000, 24, 100, 2, 100_000, True),
    ("ids up to 2^30", 4096, 50_000, 64, 128, 2, 1 << 30, True),
    ("non-integer queries", 4096, 100_000, 64, 128, 1, 100_000, False),
    ("R=16 D=45 beam=3 (byte reads of the vectors)", 4096, 50_000, 16, 45, 3, 50_000, True),
    # K3's other copy paths: 4-byte and byte copies of rows whose width is
    # not a multiple of 16 (or 4), and a beam whose rows go in groups
    ("R=20 D=13 beam=3 (4-byte row copies)", 4096, 50_000, 20, 13, 3, 50_000, True),
    ("R=15 D=9 beam=2 (byte row copies)", 4096, 50_000, 15, 9, 2, 50_000, True),
    ("R=64 D=128 beam=16 (parents in groups)", 4096, 100_000, 64, 128, 16, 100_000, True),
)
# the visited mask at both search shapes: (label, Q, C candidates, L, MI)
MASK_SHAPES = (
    ("inmemory L=128", Q, 2 * R, 128, 140),
    ("exactdistance L=100", Q, R, 100, 106),
)
# lookup_packed/K5: (label, Q, N rows, R, m, beam, ids drawn below)
PROBE_SHAPES = (
    ("probes Q=10K R=64 m=64 beam=2", Q, N, R, M, 2, N),
    ("R=24 m=12 beam=4, ids up to 2^30", 4096, 100_000, 24, 12, 4, 1 << 30),
)
GATHER_WIDTHS = (5120, 4352, 100)  # K6: TPU-tiled, flat PQ row, ragged
# the probe scripts and the kernels each launches
PROBE_SCRIPTS = (
    ("exp_lookup", {"pq_lookup", "lookup_packed", "row_gather"}),
    ("exp_flat_lookup", {"lookup_packed", "row_gather"}),
    ("exp_flat2", {"lookup_packed", "frontier_packed", "row_gather"}),
    ("exp_fused", {"frontier_packed", "row_gather"}),
    ("exp_dma_tiled", {"row_gather", "frontier_lookup", "frontier_packed",
                       "exact_frontier"}),
)
# wrapper name -> (source, the TPU kernel it replaces, the other TPU kernels
# it replaces)
KERNEL_SOURCES = {
    "pq_lookup": ("bang_tpu_torch/csrc/pq_lookup.cu", "bang_tpu/ops/pq_pallas.py:74", []),
    "frontier_lookup": ("bang_tpu_torch/csrc/frontier_lookup.cu",
                        "bang_tpu/ops/pq_pallas.py:267", ["bang_tpu/ops/pq_pallas.py:411"]),
    "exact_frontier": ("bang_tpu_torch/csrc/exact_frontier.cu",
                       "bang_tpu/ops/pq_pallas.py:564", []),
    "lookup_packed": ("bang_tpu_torch/csrc/pq_lookup.cu", "scripts/exp_lookup.py:85",
                      ["scripts/exp_flat_lookup.py:90", "scripts/exp_flat2.py:106"]),
    "frontier_packed": ("bang_tpu_torch/csrc/frontier_packed.cu", "scripts/exp_fused.py:79",
                        ["scripts/exp_flat2.py:148"]),
    "row_gather": ("bang_tpu_torch/csrc/row_gather.cu", "scripts/exp_dma_tiled.py:71", []),
}
# one H100 SXM (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    libraries = sorted({os.path.basename(src)[: -len(".cu")]
                        for src, _, _ in KERNEL_SOURCES.values()})
    _build.build_libraries(libraries)
    for name in libraries:
        info = _build.BUILD_INFO[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines() if "ptxas info" in ln]
        log(f"built {name} in {info['seconds']:.2f}s (cached={info['cached']}): "
            + " | ".join(ptxas))
    secs = time.perf_counter() - t0
    log(f"build {secs:.2f}s")
    return secs


def _fused_inputs(gen, q, n, r, m, beam, id_hi, dev):
    from bang_tpu_torch.scripts import _common as cm

    tables = cm.tables(gen, q, m, dev)
    rows, ids = cm.fused_rows(gen, n, r, m, id_hi, dev)
    parents = torch.randint(0, n, (q, beam), generator=gen, device=dev,
                            dtype=torch.int32)
    return tables, rows, parents, ids


def _bound(result, name, nbytes, ops=0):
    """Record the least time the card could take: the larger of `nbytes`
    over the HBM rate and `ops` f32 operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    result[name]["bound_ms"] = max(t_bytes, t_ops)
    result[name]["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"bound {name}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G op -> "
        f"{result[name]['bound_ms']:.4f} ms ({result[name]['bound_by']})")


def _unique_rows(parents):
    """How many distinct rows `parents` reads: the rows a call must move."""
    return int(torch.unique(parents).numel())


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


def _time_pair(result, name, label, kern, plain):
    """Time a kernel and its plain version in the order plain, kernel,
    kernel, plain; record the means."""
    p1, k1, k2, p2 = _time_ms(plain), _time_ms(kern), _time_ms(kern), _time_ms(plain)
    result[name]["ms"] = (k1 + k2) / 2
    result[name]["plain_ms"] = (p1 + p2) / 2
    log(f"time {name} at {label}: kernel {k1:.4f} / {k2:.4f} ms, "
        f"plain {p1:.4f} / {p2:.4f} ms")


def phase_exact_kernel(gen, dev, result):
    """K3 against exact_frontier_plain at EXACT_SHAPES; times the first."""
    from bang_tpu_torch.ops import exact_kernels as ek
    from bang_tpu_torch.ops.l2 import decode_exact_frontier_rows
    from bang_tpu_torch.scripts import _common as cm

    for i, (label, q, n, r, d, beam, id_hi, integer) in enumerate(EXACT_SHAPES):
        rows = cm.exact_rows(gen, n, r, d, id_hi, dev)
        parents = torch.randint(0, n, (q, beam), generator=gen, device=dev,
                                dtype=torch.int32)
        if integer:
            queries = torch.randint(0, 256, (q, d), generator=gen, device=dev).float()
        else:
            queries = torch.rand((q, d), generator=gen, device=dev) * 255.0
        got_ids, got_d = ek.exact_frontier(queries, rows, parents)
        torch.cuda.synchronize()
        want_ids, want_d = ek.exact_frontier_plain(queries, rows, parents)
        if not torch.equal(got_ids, want_ids):
            raise AssertionError(f"exact_frontier {label}: ids differ")
        if id_hi > 1 << 24 and int(got_ids.max()) < 1 << 24:
            raise AssertionError(f"exact_frontier {label}: id plane 3 never set")
        err = (got_d - want_d).abs()
        if integer and d <= 128:
            if not torch.equal(got_d, want_d):
                raise AssertionError(f"exact_frontier {label}: distances not "
                                     f"bit-exact, max err {float(err.max())}")
        else:
            norms = decode_exact_frontier_rows(rows[parents.long()], r, d)[1]
            scale = (queries ** 2).sum(1, keepdim=True) + norms.amax(1, keepdim=True)
            bad = int((err > 1e-5 * want_d.abs() + 1e-5 * scale).sum())
            if bad or not torch.isfinite(got_d).all():
                raise AssertionError(f"exact_frontier {label}: {bad} distances "
                                     f"out of tolerance, max err {float(err.max())}")
        e3 = float(err.max())
        result["exact_frontier"]["max_abs_err"] = max(
            result["exact_frontier"]["max_abs_err"], e3)
        log(f"kernels exact {label}: ids exact, max abs err K3 {e3:.3g}")
        if i == 0:
            _time_pair(result, "exact_frontier", label,
                       lambda: ek.exact_frontier(queries, rows, parents),
                       lambda: ek.exact_frontier_plain(queries, rows, parents))
            c = beam * r
            _bound(result, "exact_frontier",
                   queries.numel() * 4 + _unique_rows(parents) * rows.shape[1]
                   + parents.numel() * 4 + q * c * 8, 2 * q * c * d)
        del rows, parents, queries, got_ids, got_d, want_ids, want_d, err
        torch.cuda.empty_cache()
    _k3_out_of_range(gen, dev)


def _k3_out_of_range(gen, dev):
    """K3 with parents outside [0, N): id -1 and +inf on their lanes, the
    rest bit-exact against the plain version (integer queries)."""
    from bang_tpu_torch.ops import exact_kernels as ek
    from bang_tpu_torch.scripts import _common as cm

    n = 5_000
    rows = cm.exact_rows(gen, n, R, D, n, dev)
    parents = torch.randint(0, n, (256, 2), generator=gen, device=dev, dtype=torch.int32)
    parents[::3, 0] = -1
    parents[1::3, 1] = n
    queries = torch.randint(0, 256, (256, D), generator=gen, device=dev).float()
    ids, d = ek.exact_frontier(queries, rows, parents)
    torch.cuda.synchronize()
    bad = ((parents < 0) | (parents >= n)).repeat_interleave(R, dim=1)
    want_ids, want_d = ek.exact_frontier_plain(queries, rows, parents.clamp(0, n - 1))
    cm.same("exact_frontier out-of-range ids", ids, torch.where(bad, -1, want_ids))
    cm.same("exact_frontier out-of-range dists", d,
            torch.where(bad, float("inf"), want_d))
    log("kernels K3 parents outside [0, N): id -1 and +inf, the rest as plain")


def phase_mask(dev):
    """The sorted visited mask (ops/visited.exact_new_mask, plain PyTorch on
    the search path) against its dense oracle on the card, at both search
    shapes, on random ids with INVALID_ID tails and INVALID_ID candidates:
    identical or raise. Times both."""
    from bang_tpu_torch.ops import visited

    gen = torch.Generator(device=dev).manual_seed(2)
    for label, q, c, l, mi in MASK_SHAPES:
        def ids(cols):  # a small id range, so that candidates hit both lists
            return torch.randint(0, 2 * (l + mi), (q, cols), generator=gen,
                                 device=dev, dtype=torch.int32)

        cand, wl, vis = ids(c), ids(l), ids(mi)
        cand[torch.rand((q, c), generator=gen, device=dev) < 0.05] = -1
        wl[:, 3 * l // 4 :] = -1
        vis[:, mi // 2 :] = -1
        got = visited.exact_new_mask(cand, wl, vis)
        want = visited.exact_new_mask_dense(cand, wl, vis)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"exact_new_mask {label}: differs from the dense "
                                 f"form on {int((got != want).sum())} candidates")
        t = [_time_ms(lambda: fn(cand, wl, vis)) for fn in (
            visited.exact_new_mask_dense, visited.exact_new_mask,
            visited.exact_new_mask, visited.exact_new_mask_dense)]
        log(f"mask {label} Q={q} C={c} L={l} MI={mi}: sorted identical to dense "
            f"({float(got.float().mean()):.3f} new); sorted {t[1]:.4f} / {t[2]:.4f} ms, "
            f"dense {t[0]:.4f} / {t[3]:.4f} ms")
        del cand, wl, vis, got, want
    torch.cuda.empty_cache()


def _against_k6_k5(packed, rows, parents, ids, dists):
    """K2 at the main shape against K6 row_gather + K5 frontier_packed on the
    same parents and packed tables, and K1 on the codes of the same rows
    made candidate-major: identical bit for bit."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.ops import probe_kernels as prk
    from bang_tpu_torch.scripts._common import same

    q, beam = parents.shape
    m = packed.shape[1]
    r = ids.shape[1] // beam
    gathered = prk.row_gather(rows, parents.view(-1)).view(q, beam, rows.shape[1])
    ids5, d5 = prk.frontier_packed(packed, gathered, r, 4)
    codes = gathered[..., 4 * r :].reshape(q, beam, m, r).transpose(2, 3).reshape(
        q, beam * r, m)
    d1 = pk.pq_lookup(packed, codes)
    torch.cuda.synchronize()
    same("frontier_lookup vs row_gather + frontier_packed ids", ids, ids5)
    same("frontier_lookup vs row_gather + frontier_packed dists", dists, d5)
    same("pq_lookup vs row_gather + frontier_packed dists", d1, d5)
    log("kernels K2, and K1 on the same codes, identical bit for bit to K6 + K5 "
        "on the same parents")


def _k1_unaligned(packed, codes):
    """K1 on copies of `codes` 4 and 1 bytes off a 16-byte boundary (its
    4-byte and byte copy paths): bit for bit its aligned launch's sums."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts._common import same

    want = pk.pq_lookup(packed, codes)
    for off in (4, 1):
        buf = torch.empty(codes.numel() + 16, dtype=torch.uint8, device=codes.device)
        moved = buf[off : off + codes.numel()].view(codes.shape)
        moved.copy_(codes)
        got = pk.pq_lookup(packed, moved)
        torch.cuda.synchronize()
        same(f"pq_lookup codes {off} bytes off a 16-byte boundary", got, want)
    log("kernels K1 on codes 4 and 1 bytes off a 16-byte boundary: as aligned")


def _k1_empty(packed, codes):
    """K1's two wrappers on empty batches (C=0, Q=0): an empty result, and
    no launch counted, since none is made."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.ops import probe_kernels as prk

    before = (pk.pq_lookup.launches, prk.lookup_packed.launches)
    for wrapper in (pk.pq_lookup, prk.lookup_packed):
        for p, c in ((packed, codes[:, :0]), (packed[:0], codes[:0])):
            out = wrapper(p, c.contiguous())
            if out.shape != c.shape[:2]:
                raise AssertionError(
                    f"{wrapper.__name__} on codes {tuple(c.shape)}: "
                    f"result {tuple(out.shape)}")
    after = (pk.pq_lookup.launches, prk.lookup_packed.launches)
    if after != before:
        raise AssertionError(f"K1 on empty batches counted launches: {before} -> {after}")
    log("kernels K1 on empty batches (C=0, Q=0): empty results, no launch counted")


def _k2_out_of_range(gen, dev):
    """K2 with parents outside [0, N): id -1 and +inf on their lanes, the
    rest as the plain version."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts._common import dist_err, same

    tables, rows, parents, _ = _fused_inputs(gen, 256, 5_000, R, M, 2, 5_000, dev)
    parents[::3, 0] = -1
    parents[1::3, 1] = rows.shape[0]
    packed = pk.pack_tables(tables)
    ids, d = pk.frontier_lookup(packed, rows, parents)
    torch.cuda.synchronize()
    want_ids, want_d = pk.frontier_lookup_plain(packed, rows, parents)
    same("frontier_lookup out-of-range ids", ids, want_ids)
    bad = want_ids < 0
    same("frontier_lookup out-of-range lanes", torch.isinf(d), bad)
    dist_err("frontier_lookup out-of-range dists", d[~bad], want_d[~bad])
    log("kernels K2 parents outside [0, N): id -1 and +inf, the rest as plain")


def phase_kernels(dev):
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts._common import dist_err

    gen = torch.Generator(device=dev).manual_seed(0)
    result = {name: {"max_abs_err": 0.0, "library_ms": None} for name in KERNEL_SOURCES}
    for i, (label, q, n, r, m, beam, id_hi) in enumerate(KERNEL_SHAPES):
        tables, rows, parents, ids = _fused_inputs(gen, q, n, r, m, beam, id_hi, dev)
        packed = pk.pack_tables(tables)
        del tables  # both kernels read the packed tables
        got_ids, got_d = pk.frontier_lookup(packed, rows, parents)
        torch.cuda.synchronize()
        want_ids, want_d = pk.frontier_lookup_plain(packed, rows, parents)
        if not torch.equal(got_ids, want_ids) or not torch.equal(
                got_ids, ids[parents.long()].reshape(q, -1)):
            raise AssertionError(f"frontier_lookup {label}: ids differ")
        e2 = dist_err(f"frontier_lookup {label}", got_d, want_d)

        codes = torch.randint(0, 256, (q, beam * r, m), generator=gen,
                              device=dev, dtype=torch.uint8)
        got = pk.pq_lookup(packed, codes)
        torch.cuda.synchronize()
        e1 = dist_err(f"pq_lookup {label}", got, pk.lookup_packed_plain(packed, codes))
        result["pq_lookup"]["max_abs_err"] = max(result["pq_lookup"]["max_abs_err"], e1)
        result["frontier_lookup"]["max_abs_err"] = max(
            result["frontier_lookup"]["max_abs_err"], e2)
        log(f"kernels {label}: ids exact, max abs err K1 {e1:.3g} K2 {e2:.3g}")

        if i == 0:  # time at the main path's shape
            _against_k6_k5(packed, rows, parents, got_ids, got_d)
            _k1_unaligned(packed, codes)
            _k1_empty(packed, codes)
            _time_pair(result, "pq_lookup", label,
                       lambda: pk.pq_lookup(packed, codes),
                       lambda: pk.lookup_packed_plain(packed, codes))
            _time_pair(result, "frontier_lookup", label,
                       lambda: pk.frontier_lookup(packed, rows, parents),
                       lambda: pk.frontier_lookup_plain(packed, rows, parents))
            c = beam * r
            _bound(result, "pq_lookup",
                   packed.numel() * 4 + codes.numel() + q * c * 4, q * c * m)
            _bound(result, "frontier_lookup",
                   packed.numel() * 4 + _unique_rows(parents) * rows.shape[1]
                   + parents.numel() * 4 + q * c * 8, q * c * m)
        del packed, rows, parents, ids, codes, got_ids, got_d, want_ids, want_d, got
        torch.cuda.empty_cache()
    _k2_out_of_range(gen, dev)
    phase_exact_kernel(gen, dev, result)
    return result


def _note_err(result, name, err):
    result[name]["max_abs_err"] = max(result[name]["max_abs_err"], err)
    return err


def phase_probes(dev, result):
    """lookup_packed (K1's kernel), K5 and K6 against their plain versions
    at PROBE_SHAPES and GATHER_WIDTHS; times each at the probes' shape."""
    from bang_tpu_torch.ops import probe_kernels as prk
    from bang_tpu_torch.ops.pq_kernels import pack_tables
    from bang_tpu_torch.scripts._common import dist_err, fused_rows, same, tables, u8

    gen = torch.Generator(device=dev).manual_seed(1)
    for i, (label, q, n, r, m, beam, id_hi) in enumerate(PROBE_SHAPES):
        rows, ids = fused_rows(gen, n, r, m, id_hi, dev)
        packed = pack_tables(tables(gen, q, m, dev))
        parents = torch.randint(0, n, (q * beam,), generator=gen, device=dev,
                                dtype=torch.int32)
        c, w = beam * r, (4 + m) * r
        gathered = prk.row_gather(rows, parents)
        torch.cuda.synchronize()
        same(f"row_gather {label}", gathered, prk.row_gather_plain(rows, parents))
        gathered = gathered.view(q, beam, w)

        ids5, d5 = prk.frontier_packed(packed, gathered, r, 4)
        torch.cuda.synchronize()
        want_ids, want_d = prk.frontier_packed_plain(packed, gathered, r, 4)
        same(f"frontier_packed ids {label}", ids5, want_ids)
        same(f"frontier_packed ids {label} vs adjacency", ids5,
             ids[parents.long()].reshape(q, c))
        if id_hi > 1 << 24 and int(ids5.max()) < 1 << 24:
            raise AssertionError(f"frontier_packed {label}: id plane 3 never set")
        e5 = _note_err(result, "frontier_packed",
                       dist_err(f"frontier_packed {label}", d5, want_d))
        codes_cm = gathered[..., 4 * r :].contiguous()  # v7's rows: no id planes
        ids7, d7 = prk.frontier_packed(packed, codes_cm, r, 0)
        if ids7 is not None:
            raise AssertionError("frontier_packed without id planes returned ids")
        # same entries summed in the same order as with id planes
        same(f"frontier_packed no-ids {label}", d7, d5)
        codes = codes_cm.view(q, beam, m, r).transpose(2, 3).reshape(q, c, m)
        d4 = prk.lookup_packed(packed, codes)
        torch.cuda.synchronize()
        e4 = _note_err(result, "lookup_packed",
                       dist_err(f"lookup_packed {label}", d4,
                                prk.lookup_packed_plain(packed, codes)))
        same(f"lookup_packed vs frontier_packed {label}", d4, d5)
        log(f"probes {label}: ids and gathers exact, max abs err lookup_packed "
            f"{e4:.3g} K5 {e5:.3g}")

        if i == 0:  # time at the probes' shape
            _time_pair(result, "lookup_packed", label,
                       lambda: prk.lookup_packed(packed, codes),
                       lambda: prk.lookup_packed_plain(packed, codes))
            _time_pair(result, "frontier_packed", label,
                       lambda: prk.frontier_packed(packed, gathered, r, 4),
                       lambda: prk.frontier_packed_plain(packed, gathered, r, 4))
            _time_pair(result, "row_gather", f"{q * beam} rows of {w} B",
                       lambda: prk.row_gather(rows, parents),
                       lambda: prk.row_gather_plain(rows, parents))
            lib = [_time_ms(lambda: torch.index_select(rows, 0, parents))
                   for _ in range(2)]
            result["row_gather"]["library_ms"] = sum(lib) / 2
            log(f"time torch.index_select beside row_gather: {lib[0]:.4f} / "
                f"{lib[1]:.4f} ms")
            _bound(result, "lookup_packed",
                   packed.numel() * 4 + codes.numel() + q * c * 4, q * c * m)
            _bound(result, "frontier_packed",
                   packed.numel() * 4 + gathered.numel() + q * c * 8, q * c * m)
            _bound(result, "row_gather",
                   _unique_rows(parents) * w + parents.numel() * (w + 4))
        del rows, ids, packed, parents, gathered, ids5, d5, want_ids, want_d
        del codes_cm, d7, codes, d4
        torch.cuda.empty_cache()

    n = 100_000
    for s in GATHER_WIDTHS:
        rows = u8(gen, (n, s), dev)
        parents = torch.randint(0, n // 2, (4096,), generator=gen, device=dev,
                                dtype=torch.int32) * 2 + 1  # odd rows
        parents[-2:] = torch.tensor([-1, n], dtype=torch.int32, device=dev)
        got = prk.row_gather(rows, parents)
        torch.cuda.synchronize()
        same(f"row_gather S={s}", got[:-2], prk.row_gather_plain(rows, parents[:-2]))
        if got[-2:].any():
            raise AssertionError(f"row_gather S={s}: out-of-range parents not zero")
        log(f"probes row_gather S={s}: odd parents exact, out-of-range rows zero")
        del rows, parents, got
    torch.cuda.empty_cache()


def probe_scripts(totals):
    """Run each probe script at its own sizes, its launches counted."""
    for name, launched in PROBE_SCRIPTS:
        mod = importlib.import_module(f"bang_tpu_torch.scripts.{name}")
        t0 = time.perf_counter()
        counted(f"probe {name}", launched, lambda: mod.main("cuda"), totals)
        log(f"probe {name} took {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()


def build_bundle(prefix, dev, n=N, d=D, q=Q, r=R, m=M):
    """The bench's headline bundle (bench.py build_bundle, graph='vamana'),
    built with the port's builders on `dev`; returns stage seconds."""
    from bang_tpu_torch.formats import accel, synthetic, vamana
    from bang_tpu_torch.formats.bin_io import save_bin, save_truthset
    from bang_tpu_torch.formats.graph import GraphIndex, save_graph_index
    from bang_tpu_torch.formats.pq import save_pq

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
    adj, degrees, medoid = stage("graph", lambda: vamana.build_vamana_graph(
        data, r, dev, **VAMANA))
    pq = stage("pq_train", lambda: synthetic.train_pq(data, m, seed=0))
    pq.codes = stage("pq_encode", lambda: accel.encode_pq(data, pq, dev))

    def save():
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
        raise AssertionError(f"returned distances off the reference by "
                             f"{np.abs(dists[:200] - ref).max()}")


def run_search(prefix, dev, variant, l_values, fused_frontier=None,
               entry_mode="medoid", visited_mode="exact"):
    """BANGSearch(variant) over `l_values` at bench.py's beam and
    extra_iters; one row per L (with the returned ids and the query call's
    peak memory)."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.formats.graph import load_graph_index
    from bang_tpu_torch.utils.recall import calculate_recall

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    vectors = load_graph_index(prefix).vectors
    beam, extra = BEAM_EXTRA[variant]
    s = BANGSearch(variant, device=dev)
    t0 = time.perf_counter()
    s.bang_load(prefix, fused_frontier=fused_frontier)
    ix = s._index
    fused = ix.fused_rows is not None or ix.fused_vec_rows is not None
    layout = "fused" if fused else "scattered"
    label = f"{variant} {layout} {entry_mode} {visited_mode}"
    log(f"bang_load {variant} {layout} layout in {time.perf_counter() - t0:.1f}s")
    rows = []
    for L in l_values:
        s.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra,
                                entry_mode=entry_mode, visited_mode=visited_mode)
        s.bang_alloc(len(queries))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ids, dists = s.bang_query(queries)  # host arrays: the device is done
        wall = time.perf_counter() - t0
        _check_output(ids, dists, queries, vectors, len(vectors))
        row = {"search": label, "L": L,
               "recall": calculate_recall(gt_ids, ids, K, gt_dists),
               "iters": s.last_stats.iters, "dist_comps": s.last_stats.n_dist_comps,
               "wall_s": wall, "qps": len(queries) / wall, "ids": ids,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"search {label} L={L} recall@10={row['recall']:.2f} "
            f"iters={row['iters']} dist_comps={row['dist_comps']} wall={wall:.4f}s "
            f"qps={row['qps']:.1f} peak={row['peak_gb']:.2f}GB")
        rows.append(row)
    s.bang_unload()
    torch.cuda.empty_cache()
    return rows


# the traversal's steps whose device time profile_search reads by name:
# models/traversal's module globals, each run inside a profiler range. The
# profiler ties no kernel launched through ctypes (K2, K3) to a range: their
# times are in the per-kernel rows.
PROFILE_STAGES = ("exact_new_mask", "first_occurrence_mask_blocks", "merge_worklist",
                  "select_parents_beam", "bloom_positions", "bloom_query", "bloom_insert")
BLOOM_STAGES = PROFILE_STAGES[-3:]


@contextlib.contextmanager
def _traversal_stages(mask, traversal=None):
    """Run the traversal (models/traversal, or the module given, which calls
    the same step functions by the same names: models/base) with `mask` as
    its visited mask and each of PROFILE_STAGES inside a torch.profiler
    range of its name (the kernels a range launches count towards its device
    time); restore them after."""
    if traversal is None:
        from bang_tpu_torch.models import traversal

    saved = {name: getattr(traversal, name) for name in PROFILE_STAGES}
    fns = {**saved, "exact_new_mask": mask}

    def ranged(name, fn):
        def run(*args):
            with torch.profiler.record_function(name):
                return fn(*args)
        return run

    try:
        for name, fn in fns.items():
            setattr(traversal, name, ranged(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(traversal, name, fn)


def profile_search(prefix, dev, variant, L, fused_frontier=None, dense=True,
                   visited_mode="exact"):
    """BANGSearch(variant) at L on the layout `fused_frontier` picks (the
    fused one by default), with the sorted visited mask and, when `dense`,
    again with its dense form (the JAX expression), or with the bloom
    filter: each three timed calls, then one under torch.profiler. Prints
    the device ms of each kernel name and of each traversal stage
    (PROFILE_STAGES) summed over the call, the kernels' total against the
    profiled call's wall (the device's busy share) and the peak memory of
    that call; in bloom mode also the filter's ms a step (hash, query and
    insert)."""
    from torch.profiler import ProfilerActivity, profile

    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.formats.bin_io import load_bin
    from bang_tpu_torch.ops import visited

    queries = load_bin(prefix + "_query.bin", np.uint8)
    beam, extra = BEAM_EXTRA[variant]
    s = BANGSearch(variant, device=dev)
    s.bang_load(prefix, fused_frontier=fused_frontier)
    ix = s._index
    layout = ("fused" if ix.fused_rows is not None or ix.fused_vec_rows is not None
              else "scattered")
    s.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra,
                            visited_mode=visited_mode)
    s.bang_alloc(len(queries))
    if visited_mode == "bloom":  # the mask is not called
        masks = [("bloom filter", visited.exact_new_mask)]
    else:
        masks = [("sorted mask", visited.exact_new_mask)]
        if dense:
            masks.append(("dense mask", visited.exact_new_mask_dense))
    for mask_name, mask in masks:
        label = f"profile {variant} {layout} L={L} {mask_name}"
        with _traversal_stages(mask):
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.bang_query(queries)
                walls.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                s.bang_query(queries)
                wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        log(f"{label}: {s.last_stats.iters} iterations; walls of 3 timed calls "
            + " / ".join(f"{w:.4f}" for w in walls) + f" s; profiled call {wall:.4f} s")
        total, stages, _ = _read_profile(prof, label, PROFILE_STAGES)
        log(f"{label}: kernels {total:.3f} ms in a {wall * 1e3:.3f} ms wall, busy "
            f"{total / (wall * 1e3):.1%}; peak {peak / 1e9:.2f} GB")
        if visited_mode == "bloom":
            ms = sum(stages.get(name, (0.0, 0))[0] for name in BLOOM_STAGES)
            steps = stages.get("bloom_query", (0.0, 0))[1]
            if not steps:
                raise AssertionError(f"{label}: the bloom filter was never queried")
            log(f"{label}: bloom hash + query + insert {ms:.3f} ms over {steps} "
                f"steps, {ms / steps:.4f} ms a step")
    s.bang_unload()
    torch.cuda.empty_cache()


def _read_profile(prof, label, stage_names):
    """Print the device ms of each kernel name (the top 16) and of each
    profiler range in `stage_names` (the kernels it launched) over a
    profiled call; returns (kernel ms in all, {range: [ms, calls]}, the
    (ms, calls, name) rows of every kernel, largest first)."""
    # the stage ranges also appear on the device's timeline under their
    # own names: they are spans, not kernels
    kernels = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0 and e.key not in stage_names),
        reverse=True)
    for ms, count, key in kernels[:16]:
        log(f"profile {ms:10.3f} ms {count:6d} calls  {key[:100]}")
    stages = {}  # name -> [device ms of the kernels each range launched, calls]
    for e in prof.events():
        if e.name in stage_names and e.device_type == torch.autograd.DeviceType.CPU:
            acc = stages.setdefault(e.name, [0.0, 0])
            acc[0] += e.device_time_total / 1e3
            acc[1] += 1
    log(f"{label} stages (kernel ms): " + ", ".join(
        f"{k} {ms:.3f} ms ({n} calls)" for k, (ms, n) in stages.items()))
    return sum(k[0] for k in kernels), stages, kernels


def _busy_ms(prof, stage_names):
    """Device ms during which at least one kernel ran, on any stream: the
    union of the kernels' intervals (several streams overlap, so their sum
    can pass the wall)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.name not in stage_names and e.time_range.end > e.time_range.start)
    if not spans:
        raise AssertionError("the profiler recorded no kernel on the card")
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def run_base(prefix, dev, l_values, n_pipeline_batches=BASE_PIPELINE,
             entry_mode="medoid", visited_mode="exact"):
    """BANGSearch("base") over `l_values` at bench.py::sweep_base's beam and
    extra_iters, the graph read into RAM, ENABLE_GPU_STATS on; one row per L
    (the returned ids, device steps, readback waits, stage ms, the query
    call's peak memory). Returns
    (rows, steps): every device step of these calls, the warm-ups of
    bang_alloc included."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.constants import ENABLE_GPU_STATS
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.utils.recall import calculate_recall

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    s = BANGSearch("base", device=dev)
    t0 = time.perf_counter()
    s.bang_load(prefix, mmap=False, n_pipeline_batches=n_pipeline_batches)
    searcher = s._searcher
    vectors = searcher.raw[:, : searcher.vec_bytes]  # u8 data: the vectors' bytes
    label = f"base pipeline={n_pipeline_batches} {entry_mode} {visited_mode}"
    log(f"bang_load base in {time.perf_counter() - t0:.1f}s: "
        f"{searcher.raw.nbytes / 1e6:.1f} MB of records in host RAM, "
        f"{searcher.codes.numel() / 1e6:.1f} MB of codes on the card")
    rows, steps = [], 0
    for L in l_values:
        s.bang_set_searchparams(K, L, beam_width=BASE_BEAM, extra_iters=BASE_EXTRA,
                                entry_mode=entry_mode, visited_mode=visited_mode,
                                capabilities=ENABLE_GPU_STATS)
        s.bang_alloc(len(queries))
        steps += searcher.last_n_steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ids, dists = s.bang_query(queries)  # host arrays: the device is done
        wall = time.perf_counter() - t0
        steps += searcher.last_n_steps
        _check_output(ids, dists, queries, vectors, len(vectors))
        row = {"search": label, "L": L,
               "recall": calculate_recall(gt_ids, ids, K, gt_dists),
               "steps": searcher.last_n_steps, "d2h": searcher.last_n_d2h,
               "stages": dict(searcher.timers.ms), "wall_s": wall,
               "qps": len(queries) / wall, "ids": ids,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"search {label} L={L} recall@10={row['recall']:.2f} "
            f"steps={row['steps']} d2h waits={row['d2h']} wall={wall:.4f}s "
            f"qps={row['qps']:.1f} peak={row['peak_gb']:.2f}GB; stage ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in row["stages"].items()))
        rows.append(row)
    s.bang_unload()
    torch.cuda.empty_cache()
    return rows, steps


def _k1_per_step(label, steps):
    """K1 launched once per device step of the phase just counted."""
    from bang_tpu_torch.ops import pq_kernels as pk

    if pk.pq_lookup.launches != steps:
        raise AssertionError(f"{label}: K1 launched {pk.pq_lookup.launches} times "
                             f"for {steps} device steps")
    log(f"{label}: K1 launches {steps} = device steps dispatched")


def host_gather_alone(prefix, dev):
    """The native host gather alone (bench.py:610-617) on one sub-batch's
    parents (Q/8 x beam random ids) and on the serial call's (Q x beam),
    into pinned buffers as the pipeline calls it, at the automatic thread
    count (native.ROWS_PER_THREAD) and at 1, 2, 4 and 8 threads, each twice
    in the order 1, 2, 4, 8, auto, auto, 8, 4, 2, 1: ms per call over 10
    calls after one warm-up. Returns the automatic count's mean ms on one
    sub-batch."""
    from bang_tpu_torch.models.base import BaseVariantSearcher

    searcher = BaseVariantSearcher(prefix, n_pipeline_batches=BASE_PIPELINE,
                                   mmap=False, device=dev)
    m = searcher.meta
    rng = np.random.default_rng(0)
    pin = dev.type == "cuda"
    out = None
    for rows in (Q // BASE_PIPELINE * BASE_BEAM, Q * BASE_BEAM):
        parents = rng.integers(0, m.n, rows).astype(np.int32)
        nbrs = torch.empty((rows, m.degree), dtype=torch.int32, pin_memory=pin)
        vecs = torch.empty((rows, searcher.vec_bytes), dtype=torch.uint8,
                           pin_memory=pin)
        times = {}  # thread count -> ms, in the order 1 .. 8, auto, auto .. 1
        for threads in (1, 2, 4, 8, 0, 0, 8, 4, 2, 1):
            searcher.n_threads = threads
            searcher._host_gather(parents, nbrs.numpy(), vecs.numpy())  # warm
            t0 = time.perf_counter()
            for _ in range(10):
                searcher._host_gather(parents, nbrs.numpy(), vecs.numpy())
            times.setdefault(threads, []).append((time.perf_counter() - t0) / 10 * 1e3)
        log(f"host gather alone, {rows} parents "
            f"({rows * (m.degree * 4 + searcher.vec_bytes) / 1e6:.2f} MB out): "
            + ", ".join(f"{'auto' if t == 0 else t} threads "
                        + " / ".join(f"{ms:.4f}" for ms in v) + " ms"
                        for t, v in times.items()))
        out = sum(times[0]) / 2 if out is None else out
    return out


def profile_base(prefix, dev, L):
    """BANGSearch("base") at L as in phase 10: three timed calls, then one
    under torch.profiler with each step stage (PROFILE_STAGES, models/base)
    and the code gather of the PQ lookup in profiler ranges. Prints kernel
    ms by name and by range, the stage timers of the profiled call, the
    card's busy share (the union of kernel intervals over the wall) and the
    call's peak memory."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.constants import ENABLE_GPU_STATS
    from bang_tpu_torch.formats.bin_io import load_bin
    from bang_tpu_torch.models import base
    from bang_tpu_torch.ops import visited

    queries = load_bin(prefix + "_query.bin", np.uint8)
    s = BANGSearch("base", device=dev)
    s.bang_load(prefix, mmap=False, n_pipeline_batches=BASE_PIPELINE)
    searcher = s._searcher

    class RangedCodes:
        """The codes, their row gather (`codes[cand]` in the distance
        function) inside a profiler range of its own."""

        def __getitem__(self, idx):
            with record_function("code_gather"):
                return searcher.codes[idx]

    def ranged_tables(sub_queries):  # what _prepare_tables makes, over RangedCodes
        return base.make_pq_distance_fn(sub_queries, searcher.codebook, RangedCodes())

    s.bang_set_searchparams(K, L, beam_width=BASE_BEAM, extra_iters=BASE_EXTRA,
                            capabilities=ENABLE_GPU_STATS)
    s.bang_alloc(len(queries))
    label = f"profile base L={L}"
    names = PROFILE_STAGES + ("code_gather",)
    with _traversal_stages(visited.exact_new_mask, base):
        searcher._prepare_tables = ranged_tables
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.bang_query(queries)
            walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.bang_query(queries)
            wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {searcher.last_n_steps} device steps, {searcher.last_n_d2h} "
        f"readback waits; walls of 3 timed calls "
        + " / ".join(f"{w:.4f}" for w in walls) + f" s; profiled call {wall:.4f} s; "
        "stage ms " + ", ".join(f"{k} {v:.3f}" for k, v in searcher.timers.ms.items()))
    total, stages, kernels = _read_profile(prof, label, names)
    busy = _busy_ms(prof, names)
    # K1 per launch at a sub-batch's shape against its bound there
    q_b, c, m = Q // BASE_PIPELINE, BASE_BEAM * R, M
    k1_ms, k1_n = next((ms, n) for ms, n, key in kernels if "pq_lookup_kernel" in key)
    bound = (q_b * m * 512 + q_b * c * m + q_b * c * 4) / HBM_BYTES_PER_S * 1e3
    gather_ms, gather_n = stages["code_gather"]
    log(f"{label}: K1 {k1_ms / k1_n:.4f} ms a launch at Q={q_b} C={c} m={m} (bound "
        f"{bound:.4f} ms, {bound / (k1_ms / k1_n):.0%} of it); the code gather "
        f"{gather_ms / gather_n:.4f} ms a step")
    log(f"{label}: kernels {total:.3f} ms summed over the streams, busy "
        f"{busy:.3f} ms of a {wall * 1e3:.3f} ms wall ({busy / (wall * 1e3):.1%}); "
        f"peak {peak / 1e9:.2f} GB")
    s.bang_unload()
    torch.cuda.empty_cache()


def phase_base(prefix, dev, totals):
    """Phase 10 on the bundle at `prefix`; adds its launch counts (not the
    profiled call's) to `totals`."""
    rows, steps = counted("search base", {"pq_lookup"},
                          lambda: run_base(prefix, dev, BASE_L_SWEEP), totals)
    _k1_per_step("search base", steps)
    best = _best(rows, "base")
    (serial,), steps = counted(
        "search base serial", {"pq_lookup"},
        lambda: run_base(prefix, dev, (best["L"],), n_pipeline_batches=1), totals)
    _k1_per_step("search base serial", steps)
    same = (serial["ids"] == best["ids"]).all(axis=1)
    if not same.all():
        raise AssertionError(f"base L={best['L']}: one sub-batch's ids differ from "
                             f"the pipelined run's on {int((~same).sum())} queries")
    log(f"base L={best['L']}: ids of 1 and {BASE_PIPELINE} sub-batches identical "
        f"on all {len(same)} queries; wall {serial['wall_s']:.4f} s serial, "
        f"{best['wall_s']:.4f} s pipelined: speedup "
        f"{serial['wall_s'] / best['wall_s']:.3f}")
    (samp,), steps = counted(
        "search base sampled", {"pq_lookup"},
        lambda: run_base(prefix, dev, (best["L"],), entry_mode="sampled"), totals)
    _k1_per_step("search base sampled", steps)
    log(f"entry at L={best['L']}: base sampled recall@10 {samp['recall']:.2f} steps "
        f"{samp['steps']} | medoid recall@10 {best['recall']:.2f} steps {best['steps']}")
    if samp["recall"] < RECALL_TARGET:
        raise AssertionError(f"base sampled: recall@10 {samp['recall']:.2f} "
                             f"< {RECALL_TARGET}")
    pure = host_gather_alone(prefix, dev)
    in_loop = best["stages"]["host_gather"] / best["steps"]
    log(f"host gather per step: {pure:.4f} ms alone, {in_loop:.4f} ms in the loop "
        f"(L={best['L']})")
    profile_base(prefix, dev, best["L"])
    return best, rows


def _against_exact(what, exact_runs, bloom_runs):
    """Each L's bloom rows beside its exact-mode rows, two runs of each
    made in the order exact, bloom, bloom, exact: recall at most
    BLOOM_RECALL_SLACK below the exact mask's, >= RECALL_TARGET at the bloom
    sweep's best L, and the same ids in both runs of a mode."""
    steps = "steps" if "steps" in exact_runs[0][0] else "iters"
    for i, ex in enumerate(exact_runs[0]):
        bl = bloom_runs[0][i]
        for runs in (exact_runs, bloom_runs):
            if not np.array_equal(runs[0][i]["ids"], runs[1][i]["ids"]):
                raise AssertionError(f"{what} L={ex['L']}: two runs of one mode differ")
        walls = [runs[j][i]["wall_s"] for runs, j in
                 ((exact_runs, 0), (bloom_runs, 0), (bloom_runs, 1), (exact_runs, 1))]
        extra = ("" if steps == "steps" else
                 f", dist_comps {bl['dist_comps']} / {ex['dist_comps']}")
        log(f"bloom vs exact {what} L={ex['L']}: recall@10 {bl['recall']:.2f} / "
            f"{ex['recall']:.2f}, {steps} {bl[steps]} / {ex[steps]}{extra}, peak "
            f"{bl['peak_gb']:.2f} / {ex['peak_gb']:.2f} GB; walls exact, bloom, bloom, "
            "exact " + " / ".join(f"{w:.4f}" for w in walls) + " s")
        if bl["recall"] < ex["recall"] - BLOOM_RECALL_SLACK:
            raise AssertionError(f"{what} bloom L={ex['L']}: recall@10 "
                                 f"{bl['recall']:.2f} below the exact mask's "
                                 f"{ex['recall']:.2f} - {BLOOM_RECALL_SLACK}")
    _best(bloom_runs[0], f"{what} bloom")


def _base_rows(prefix, dev, visited_mode, label):
    """Base over BLOOM_BASE_L in `visited_mode`, K1 checked once a step."""
    rows, steps = run_base(prefix, dev, BLOOM_BASE_L, visited_mode=visited_mode)
    _k1_per_step(label, steps)
    return rows


def phase_bloom(prefix, dev, totals):
    """Phase 11: the searches of phases 5-7 and 10 in bloom mode, each beside
    the exact mode in the order exact, bloom, bloom, exact, every call
    counted as its exact-mode phase; then the fused L=128 profile in bloom
    mode."""
    searches = (
        ("inmemory fused", {"frontier_lookup"}, lambda mode: run_search(
            prefix, dev, "inmemory", BLOOM_L["inmemory"], visited_mode=mode)),
        ("inmemory scattered", {"pq_lookup"}, lambda mode: run_search(
            prefix, dev, "inmemory", (SCATTERED_PROFILE_L,), fused_frontier=False,
            visited_mode=mode)),
        ("exactdistance fused", {"exact_frontier"}, lambda mode: run_search(
            prefix, dev, "exactdistance", BLOOM_L["exactdistance"], visited_mode=mode)),
        ("base", {"pq_lookup"}, lambda mode: _base_rows(prefix, dev, mode,
                                                        f"search base {mode}")),
    )
    for what, launched, run in searches:
        runs = {"exact": [], "bloom": []}
        for mode in ("exact", "bloom", "bloom", "exact"):
            runs[mode].append(counted(f"search {what} {mode}", launched,
                                      lambda: run(mode), totals))
        _against_exact(what, runs["exact"], runs["bloom"])
    profile_search(prefix, dev, "inmemory", PROFILE_L, dense=False, visited_mode="bloom")


def _beam_extra(variant):
    return BEAM_EXTRA.get(variant, (BASE_BEAM, BASE_EXTRA))


def _warmup(prefix, dev, variant, queries):
    """BANGSearch(variant) at WARMUP_L: one bang_alloc + query without
    ENABLE_CACHE_WARMUP, one with it. Returns (touched, the two bang_alloc
    seconds, the two results)."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.constants import ENABLE_CACHE_WARMUP

    beam, extra = _beam_extra(variant)
    s = BANGSearch(variant, device=dev)
    s.bang_load(prefix, **({"mmap": False, "n_pipeline_batches": BASE_PIPELINE}
                           if variant == "base" else {}))
    secs, results = [], []
    for caps in (0, ENABLE_CACHE_WARMUP):
        s.bang_set_searchparams(K, WARMUP_L[variant], beam_width=beam,
                                extra_iters=extra, capabilities=caps)
        t0 = time.perf_counter()
        s.bang_alloc(len(queries))
        secs.append(time.perf_counter() - t0)
        results.append(s.bang_query(queries))
    s.bang_unload()
    torch.cuda.empty_cache()
    return s.warmup_touched, secs, results


def _serve(prefix, dev, queries, gt_ids, gt_dists):
    """SearchServer("inmemory", SERVER_BATCH) over `queries` against one
    BANGSearch warmed up at the same Q."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.harness.serving import SearchServer
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    beam, extra = _beam_extra("inmemory")
    L = WARMUP_L["inmemory"]
    server = SearchServer(prefix, "inmemory", batch_size=SERVER_BATCH,
                          params=SearchParams(L=L, k=K, beam_width=beam, extra_iters=extra),
                          device=dev)
    t0 = time.perf_counter()
    ids, dists = server.query(queries)
    wall = time.perf_counter() - t0
    pct, n = server.latency_percentiles(), len(server.latencies_ms)
    server.close()
    ref = BANGSearch("inmemory", device=dev)
    ref.bang_load(prefix)
    ref.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra)
    ref.bang_alloc(SERVER_BATCH)
    r_ids, r_dists = ref.bang_query(queries)
    ref.bang_unload()
    torch.cuda.empty_cache()
    if not (np.array_equal(ids, r_ids) and np.array_equal(dists, r_dists)):
        raise AssertionError(f"SearchServer differs from bang_query at Q={SERVER_BATCH} "
                             f"on {int((ids != r_ids).any(1).sum())} queries")
    log(f"serve inmemory L={L} batch {SERVER_BATCH}: {n} requests, ids and distances "
        f"identical to bang_query; recall@10 "
        f"{calculate_recall(gt_ids, ids, K, gt_dists):.2f}; latency ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in pct.items())
        + f"; {len(queries)} queries in {wall:.3f} s, qps {len(queries) / wall:.1f}")


def phase_warmup_serving(prefix, dev, totals):
    """Phase 12: ENABLE_CACHE_WARMUP on the three variants, the SearchServer,
    and the latency probes, each counted."""
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.formats.graph import load_graph_index
    from bang_tpu_torch.harness.serving import (
        measure_base_device_step_ms,
        measure_device_batch_latency,
    )
    from bang_tpu_torch.models.base import BaseVariantSearcher
    from bang_tpu_torch.models.index import device_index_from_files
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.graph_tools import bfs_from

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    graph = load_graph_index(prefix)
    t0 = time.perf_counter()
    reach = len(bfs_from(graph.adj, graph.medoid, max_nodes=1_000_000))
    log(f"warmup: the BFS from the medoid reaches {reach} of {graph.adj.shape[0]} "
        f"nodes (host BFS {time.perf_counter() - t0:.2f}s)")
    del graph
    for variant, launched in (("inmemory", {"frontier_lookup"}),
                              ("exactdistance", {"exact_frontier"}),
                              ("base", {"pq_lookup"})):
        touched, secs, (want, got) = counted(
            f"warmup {variant}", launched, lambda: _warmup(prefix, dev, variant, queries),
            totals)
        if touched != reach:
            raise AssertionError(f"warmup {variant}: touched {touched} nodes, the BFS "
                                 f"from the medoid reaches {reach}")
        if not (np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])):
            raise AssertionError(f"warmup {variant}: ids or distances differ from the "
                                 "call without ENABLE_CACHE_WARMUP")
        log(f"warmup {variant} L={WARMUP_L[variant]}: touched {touched} nodes; "
            f"bang_alloc {secs[0]:.3f} s without the bit, {secs[1]:.3f} s with it; "
            "ids and distances identical")

    counted("serve inmemory", {"frontier_lookup"},
            lambda: _serve(prefix, dev, queries, gt_ids, gt_dists), totals)

    for variant, launched in (("inmemory", {"frontier_lookup"}),
                              ("exactdistance", {"exact_frontier"})):
        beam, extra = _beam_extra(variant)
        params = SearchParams(L=WARMUP_L[variant], k=K, beam_width=beam,
                              extra_iters=extra)

        def probe():
            index = device_index_from_files(prefix, dev, variant)
            return measure_device_batch_latency(index, queries[:SERVER_BATCH], params,
                                                variant)

        ms = counted(f"probe {variant} batch latency", launched, probe, totals)
        log(f"probe {variant} L={WARMUP_L[variant]} Q={SERVER_BATCH}: {ms:.4f} ms a "
            "search (CUDA events over 10 searches, the host loop's gaps included)")
        torch.cuda.empty_cache()
    q_b = Q // BASE_PIPELINE
    searcher = BaseVariantSearcher(prefix, BASE_PIPELINE, mmap=False, device=dev)
    for visited_mode in ("exact", "bloom", "bloom", "exact"):
        params = SearchParams(L=WARMUP_L["base"], k=K, beam_width=BASE_BEAM,
                              extra_iters=BASE_EXTRA, visited_mode=visited_mode)
        n_chain = 17
        ms = counted(f"probe base step {visited_mode}", {"pq_lookup"},
                     lambda: measure_base_device_step_ms(searcher, queries[:q_b], params,
                                                         n_chain), totals)
        _k1_per_step(f"probe base step {visited_mode}", n_chain + 1)
        log(f"probe base step {visited_mode} Q={q_b}: {ms:.4f} ms a step (CUDA events "
            f"over {n_chain} steps)")
    del searcher
    torch.cuda.empty_cache()


def _live_recall(ids, queries, pts, live_ids, dev, alias=None):
    """recall@10 of `ids` against the exact top 10 of the live points (on
    the card, blocks of 256 queries), slot ids mapped through `alias`
    (re-inserted points land in recycled slots), as bench.py::streaming_row."""
    sub = torch.as_tensor(pts[live_ids], device=dev)
    sn = (sub * sub).sum(-1)
    live = torch.as_tensor(live_ids, device=dev)
    gt = []
    for s in range(0, len(queries), 256):
        blk = torch.as_tensor(queries[s : s + 256], device=dev)
        d = (blk * blk).sum(-1, keepdim=True) + sn[None, :] - 2.0 * (blk @ sub.T)
        gt.append(live[torch.topk(d, K, dim=1, largest=False).indices].cpu().numpy())
    gt = np.concatenate(gt)
    if alias:
        ids = np.vectorize(lambda i: alias.get(int(i), int(i)))(ids)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    return 100.0 * hits / gt.size


def phase_streaming(dev, totals):
    """Phase 13 (no kernel may launch): grow, search, churn, search."""
    def run():
        from bang_tpu_torch.formats.synthetic import make_clustered_data
        from bang_tpu_torch.models.streaming import StreamingIndex
        from bang_tpu_torch.utils.config import SearchParams

        n, q = STREAM_N, STREAM_Q
        rng = np.random.default_rng(11)
        pts = make_clustered_data(n, D, n_clusters=max(64, n // 1000), dtype=np.float32,
                                  seed=11)
        queries = (pts[rng.integers(0, n, q)]
                   + rng.normal(0, 0.05, (q, D)).astype(np.float32))
        ix = StreamingIndex(capacity=n + STREAM_CHUNK, dim=D, r=STREAM_R, l_build=32,
                            device=dev)
        t0 = time.perf_counter()
        ix.insert(pts[:STREAM_CHUNK])  # the doubling ramp, outside the timed part
        torch.cuda.synchronize()
        log(f"streaming: first {STREAM_CHUNK} inserts (the ramp) "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        for s in range(STREAM_CHUNK, n, STREAM_CHUNK):
            ix.insert(pts[s : s + STREAM_CHUNK])
        torch.cuda.synchronize()
        t_ins = time.perf_counter() - t0
        params = SearchParams(L=64, k=K, extra_iters=24, beam_width=2)
        ix.search(queries[:256], params)  # warm
        t0 = time.perf_counter()
        ids, _ = ix.search(queries, params)
        t_pre = time.perf_counter() - t0
        pre = _live_recall(ids, queries, pts, np.arange(n), dev)
        log(f"streaming: {n - STREAM_CHUNK} inserts in {t_ins:.3f} s "
            f"({(n - STREAM_CHUNK) / t_ins:.1f} inserts/s); search {q} queries "
            f"{t_pre:.4f} s (qps {q / t_pre:.1f}), recall@10 {pre:.2f}")

        victims = rng.choice(n, n // 10, replace=False).astype(np.int32)
        ix.delete(victims)
        t0 = time.perf_counter()
        repaired = ix.consolidate(batch=STREAM_CHUNK)
        t_cons = time.perf_counter() - t0
        back = victims[:STREAM_CHUNK]
        t0 = time.perf_counter()
        new_ids = ix.insert(pts[back])  # into the freed slots
        torch.cuda.synchronize()
        t_back = time.perf_counter() - t0
        if set(new_ids.tolist()) - set(victims.tolist()):
            raise AssertionError("streaming: re-inserted points outside the freed slots")
        alias = {int(s): int(o) for s, o in zip(new_ids, back)}
        t0 = time.perf_counter()
        ids, _ = ix.search(queries, params)
        t_post = time.perf_counter() - t0
        live = np.ones(n, bool)
        live[victims] = False
        live[back] = True
        post = _live_recall(ids, queries, pts, np.flatnonzero(live), dev, alias)
        log(f"streaming: delete {len(victims)}, consolidate {t_cons:.3f} s "
            f"({repaired} rows repaired), re-insert {len(back)} in {t_back:.3f} s; "
            f"search {t_post:.4f} s (qps {q / t_post:.1f}), recall@10 {post:.2f}; "
            f"n_live {ix.n_live}")
        for what, r in (("before", pre), ("after", post)):
            if r < RECALL_TARGET:
                raise AssertionError(f"streaming: recall@10 {r:.2f} {what} the churn "
                                     f"< {RECALL_TARGET}")
        if ix.n_live != n - len(victims) + len(back):
            raise AssertionError(f"streaming: n_live {ix.n_live}")

    counted("streaming", set(), run, totals)
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _shard_iters():
    """Record the iterations of every shard search in parallel/sharded (its
    run_traversal, wrapped); yields the list they are appended to."""
    from bang_tpu_torch.parallel import sharded

    iters, orig = [], sharded.run_traversal

    def recorded(*args, **kwargs):
        state = orig(*args, **kwargs)
        iters.append(state.it)
        return state

    sharded.run_traversal = recorded
    try:
        yield iters
    finally:
        sharded.run_traversal = orig


def _timed(fn):
    """(fn's result, wall s, peak GB) around one synchronised call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def _host_ids(ids):
    return ids.cpu().numpy().astype(np.int64)


def _k1_widths(dev, kern):
    """K1 against its plain version, and timed, at each code width the
    sharded paths launch it with: the chunk-sharded base's sub-batch
    (m/SHARDS chunks a shard), the dry run's base (1 chunk a shard) and
    node shards (8 chunks), on random packed tables and codes."""
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.scripts import _common as cm

    gen = torch.Generator(device=dev).manual_seed(14)
    for label, q, c, m in K1_WIDTHS:
        packed = pk.pack_tables(cm.tables(gen, q, m, dev))
        codes = torch.randint(0, 256, (q, c, m), generator=gen, device=dev,
                              dtype=torch.uint8)
        got = pk.pq_lookup(packed, codes)
        torch.cuda.synchronize()
        err = _note_err(kern, "pq_lookup", cm.dist_err(
            f"pq_lookup {label}", got, pk.lookup_packed_plain(packed, codes)))
        ms = _time_ms(lambda: pk.pq_lookup(packed, codes))
        plain = _time_ms(lambda: pk.lookup_packed_plain(packed, codes))
        bound = (packed.numel() * 4 + codes.numel() + q * c * 4) / HBM_BYTES_PER_S * 1e3
        log(f"K1 at {label} (Q={q} C={c} m={m}): max abs err {err:.3g}; {ms:.4f} ms "
            f"(plain {plain:.4f} ms), bound {bound:.4f} ms ({bound / ms:.0%} of it)")
    pk.reset_launch_counts()


def _sharded_rows(mesh, si, queries, gt, L, label, beam=BEAM_EXTRA["inmemory"][0],
                  extra=BEAM_EXTRA["inmemory"][1]):
    """search_sharded at L: (ids, dists, row) with the row's recall,
    iterations of each shard, wall and peak memory."""
    from bang_tpu_torch.parallel.sharded import search_sharded
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    params = SearchParams(L=L, k=K, beam_width=beam, extra_iters=extra)
    with _shard_iters() as iters:
        (ids, dists), wall, peak = _timed(lambda: search_sharded(mesh, si, queries,
                                                                 params))
    ids, dists = _host_ids(ids), dists.cpu().numpy()
    row = {"L": L, "recall": calculate_recall(gt[0], ids, K, gt[1]), "iters": list(iters),
           "wall_s": wall, "peak_gb": peak}
    log(f"sharded {label} L={L}: recall@10 {row['recall']:.2f}, shard iterations "
        f"{row['iters']}, wall {wall:.4f} s (qps {len(queries) / wall:.1f}), peak "
        f"{peak:.2f} GB")
    return ids, dists, row


def _merge_alone(si, queries, params, dev):
    """Each shard searched alone with search_inmemory, merged on the host
    (shard-major, stable): what search_sharded's all_gather and top-k must
    give."""
    from bang_tpu_torch.models.index import DeviceIndex
    from bang_tpu_torch.models.inmemory import search_inmemory
    from bang_tpu_torch.ops.l2 import squared_norms

    ids, dists = [], []
    for s in range(si.n_shards):
        sh = si.shard(s, dev)
        ix = DeviceIndex(adj=None, vectors=sh.vectors,
                         vector_norms=squared_norms(sh.vectors), codes=sh.codes,
                         fused_rows=sh.fused_rows, codebook=sh.codebook,
                         medoid=sh.medoid, n=si.n_local, dim=sh.vectors.shape[1])
        i, d, _ = search_inmemory(ix, queries, params)
        i = _host_ids(i)
        ids.append(np.where(i >= 0, i + sh.id_base, i))
        dists.append(d.cpu().numpy())
    flat_i = np.stack(ids, 1).reshape(len(queries), -1)
    flat_d = np.stack(dists, 1).reshape(len(queries), -1)
    order = np.argsort(flat_d, axis=1, kind="stable")[:, :K]
    return np.take_along_axis(flat_i, order, 1)


def _base_tp_rows(prefix, dev, entry_mode, single):
    """ShardedBaseSearcher on a (1, SHARDS) mesh over the bundle, at each
    L of TP_BASE_L with 8 sub-batches: recall, steps, wall, stage ms, peak;
    ids against the single-card base's at the same L (`single`: L -> ids).
    Returns (rows, K1 launches expected: SHARDS per step, plus SHARDS per
    sub-batch for the sampled entries)."""
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.parallel.base_tp import ShardedBaseSearcher
    from bang_tpu_torch.parallel.sharded import make_mesh
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    tp = ShardedBaseSearcher(prefix, make_mesh(1, SHARDS, [dev] * SHARDS),
                             n_pipeline_batches=BASE_PIPELINE, mmap=False)
    tp.timers.enabled = True
    expected, rows = 0, []
    sampled = entry_mode == "sampled"  # one lookup a shard per sub-batch's entries
    for L in TP_BASE_L:
        params = SearchParams(L=L, k=K, beam_width=BASE_BEAM, extra_iters=BASE_EXTRA,
                              entry_mode=entry_mode)
        tp.search(queries[: Q // BASE_PIPELINE], params)  # warm-up: one sub-batch
        expected += SHARDS * (tp.last_n_steps + sampled * BASE_PIPELINE)
        (ids, dists), wall, peak = _timed(lambda: tp.search(queries, params))
        expected += SHARDS * (tp.last_n_steps + sampled * BASE_PIPELINE)
        agree = float((ids == single[L]).mean())
        row = {"L": L, "recall": calculate_recall(gt_ids, ids, K, gt_dists),
               "steps": tp.last_n_steps, "agree": agree, "wall_s": wall,
               "peak_gb": peak, "stages": dict(tp.timers.ms)}
        log(f"sharded base {entry_mode} L={L}: recall@10 {row['recall']:.2f}, steps "
            f"{row['steps']}, ids equal to the single-card base's on {agree:.2%} of "
            f"slots, wall {wall:.4f} s (qps {Q / wall:.1f}), peak {peak:.2f} GB; stage "
            "ms " + ", ".join(f"{k} {v:.3f}" for k, v in row["stages"].items()))
        if agree < 0.98:
            raise AssertionError(f"sharded base {entry_mode} L={L}: ids agree with the "
                                 f"single-card base on {agree:.2%} < 98%")
        rows.append(row)
    _best(rows, f"sharded base {entry_mode}")
    codes_mb = sum(c.numel() for c in tp.codes_sharded) / 1e6
    log(f"sharded base: codes {codes_mb:.1f} MB in {SHARDS} chunk slices of "
        f"{tp.codes_sharded[0].shape[1]} chunks")
    del tp
    torch.cuda.empty_cache()
    return rows, expected


def phase_sharded(prefix, dev, totals, kern, base_rows):
    """Phase 14: the sharded paths on the bundle's data, every mesh on
    [dev] * n (one card)."""
    import dataclasses

    from bang_tpu_torch.formats import accel, synthetic
    from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
    from bang_tpu_torch.formats.graph import load_graph_index
    from bang_tpu_torch.formats.pq import load_pq
    from bang_tpu_torch.models.base import BaseVariantSearcher
    from bang_tpu_torch.models.index import device_index_from_files
    from bang_tpu_torch.models.inmemory import search_inmemory
    from bang_tpu_torch.ops import pq_kernels as pk
    from bang_tpu_torch.parallel.partition import partition_index
    from bang_tpu_torch.parallel.sharded import make_mesh, search_data_parallel
    from bang_tpu_torch.utils.config import SearchParams

    _k1_widths(dev, kern)
    queries = load_bin(prefix + "_query.bin", np.uint8)
    gt = load_truthset(prefix + "_gt.bin")
    data = load_graph_index(prefix).vectors
    pq = load_pq(prefix)
    n_loc = len(data) // SHARDS

    # the card's kNN graph against the numpy one (JAX's) on a small shard
    part = data[:KNN_CHECK_N]
    kw = dict(n_random=max(2, R // 8), seed=0)
    (a_card, _), secs = _timed(lambda: accel.build_knn_graph(part, R, dev, **kw))[:2]
    t0 = time.perf_counter()
    a_np, _ = synthetic.build_knn_graph(part, R, **kw)
    same_rows = int((a_card == a_np).all(axis=1).sum())
    same_sets = int((np.sort(a_card, 1) == np.sort(a_np, 1)).all(axis=1).sum())
    log(f"sharded: kNN graph of {len(part)} points on the card ({secs:.2f} s) and in "
        f"numpy ({time.perf_counter() - t0:.2f} s): rows identical {same_rows}, "
        f"identical as sets {same_sets} of {len(part)}")

    si, build_s, build_gb = _timed(lambda: partition_index(
        data, SHARDS, R, pq, seed=0, fused_frontier=True, device=dev))
    log(f"sharded: {SHARDS} shards of {n_loc} points (R={R}, m={M}, fused rows) built "
        f"in {build_s:.2f} s, peak {build_gb:.2f} GB")
    si_sc = dataclasses.replace(si, fused_rows=None, _placed={})
    mesh = make_mesh(1, SHARDS, [dev] * SHARDS)

    rows, fused_ids = [], {}
    for L in SHARD_L:
        ids_f, d_f, row_f = counted(f"sharded fused L={L}", {"frontier_lookup"},
                                    lambda: _sharded_rows(mesh, si, queries, gt, L,
                                                          "fused"), totals)
        ids_s, _, row_s = counted(f"sharded scattered L={L}", {"pq_lookup"},
                                  lambda: _sharded_rows(mesh, si_sc, queries, gt, L,
                                                        "scattered"), totals)
        same = (ids_f == ids_s).all(axis=1)
        if not same.all() or row_f["iters"] != row_s["iters"]:
            raise AssertionError(
                f"sharded L={L}: scattered differs from fused: ids on "
                f"{int((~same).sum())} queries, iterations {row_s['iters']} vs "
                f"{row_f['iters']}")
        _check_output(ids_f, d_f, queries, data, len(data))
        rows.append(row_f)
        fused_ids[L] = ids_f
    best = _best(rows, "sharded fused")
    log(f"sharded: fused and scattered ids and shard iterations identical at L="
        f"{list(SHARD_L)}")

    params = SearchParams(L=best["L"], k=K, beam_width=BEAM_EXTRA["inmemory"][0],
                          extra_iters=BEAM_EXTRA["inmemory"][1])
    alone = counted("sharded merge check", {"frontier_lookup"},
                    lambda: _merge_alone(si, queries, params, dev), totals)
    ids_best = fused_ids[best["L"]]
    if not np.array_equal(alone, ids_best):
        raise AssertionError(f"sharded merge: differs from each shard searched alone and "
                             f"merged on the host on "
                             f"{int((alone != ids_best).any(axis=1).sum())} queries")
    log(f"sharded L={best['L']}: the merge equals {SHARDS} shards searched alone and "
        "merged on the host, for every query")

    si_ex = dataclasses.replace(si, codes=None, codebook=None, fused_rows=None,
                                _placed={})
    ex_ids, ex_d, ex_row = counted(
        f"sharded exact L={EXACT_SHARD_L}", set(),
        lambda: _sharded_rows(mesh, si_ex, queries, gt, EXACT_SHARD_L, "exact",
                              *BEAM_EXTRA["exactdistance"]), totals)
    _check_output(ex_ids, ex_d, queries, data, len(data))
    _best([ex_row], "sharded exact")
    del si, si_sc, si_ex
    torch.cuda.empty_cache()

    def data_parallel():
        index = device_index_from_files(prefix, dev)
        (ids, _), wall, peak = _timed(lambda: search_data_parallel(
            make_mesh(2, 1, [dev] * 2), index, queries, params))
        one = search_inmemory(index, queries, params)[0]
        return _host_ids(ids), _host_ids(one), wall, peak

    dp, one, wall, peak = counted("data parallel", {"frontier_lookup"}, data_parallel,
                                  totals)
    if not np.array_equal(dp, one):
        raise AssertionError(f"data parallel: ids differ from search_inmemory on "
                             f"{int((dp != one).any(axis=1).sum())} queries")
    log(f"data parallel (2, 1) L={best['L']}: ids identical to search_inmemory on all "
        f"{len(dp)} queries; wall {wall:.4f} s, peak {peak:.2f} GB")
    torch.cuda.empty_cache()

    single = {"medoid": {r["L"]: r["ids"] for r in base_rows}}

    def single_sampled():
        searcher = BaseVariantSearcher(prefix, BASE_PIPELINE, mmap=False, device=dev)
        return {L: searcher.search(queries, SearchParams(
            L=L, k=K, beam_width=BASE_BEAM, extra_iters=BASE_EXTRA,
            entry_mode="sampled"))[0] for L in TP_BASE_L}

    single["sampled"] = counted("single base sampled", {"pq_lookup"}, single_sampled,
                                totals)
    for entry_mode in ("medoid", "sampled"):
        def run():
            rows, expected = _base_tp_rows(prefix, dev, entry_mode, single[entry_mode])
            if pk.pq_lookup.launches != expected:
                raise AssertionError(f"sharded base {entry_mode}: K1 launched "
                                     f"{pk.pq_lookup.launches} times, expected {expected}")
            log(f"sharded base {entry_mode}: K1 launches {expected} = {SHARDS} per step "
                "(and per sub-batch's sampled entries)")
            return rows

        counted(f"sharded base {entry_mode}", {"pq_lookup"}, run, totals)

    from bang_tpu_torch.entry import dryrun_multichip

    counted("dryrun_multichip", {"pq_lookup", "frontier_lookup"},
            lambda: dryrun_multichip(SHARDS, device=dev), totals)
    return best


def phase_bigbuild(dev, totals):
    """Phase 15: BlockGen, the sharded Vamana build, the int8 ground truth
    and a search over the merged graph."""
    from bang_tpu_torch.formats import accel, bigbuild, synthetic
    from bang_tpu_torch.models.index import assemble_device_index
    from bang_tpu_torch.models.inmemory import search_inmemory
    from bang_tpu_torch.ops.pq import prepare_pq_codebook
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    t = {}

    def stage(name, fn):
        out, t[name], peak = _timed(fn)
        log(f"bigbuild {name} {t[name]:.2f}s (peak {peak:.2f} GB)")
        return out

    from bang_tpu_torch.formats import vamana

    shard_peaks, build_vamana = [], vamana.build_vamana_graph

    def measured(vectors, *args, **kwargs):
        """build_vamana_graph, its peak device memory above what was held
        before it (the shard's vectors included) recorded per shard."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = build_vamana(vectors, *args, **kwargs)
        torch.cuda.synchronize()
        shard_peaks.append((vectors.shape[0], torch.cuda.max_memory_allocated() - before
                            + vectors.numel()))
        return out

    def build():
        gen = stage("blockgen", lambda: bigbuild.BlockGen(BIG_N, D, seed=0, device=dev))
        vamana.build_vamana_graph = measured
        try:
            adj, degrees, assignment = stage("sharded_vamana", lambda: (
                bigbuild.build_sharded_vamana(
                    gen, r=R, l_build=VAMANA["l_build"], n_shards=SHARDS, overlap=2,
                    batch=VAMANA["batch"], n_passes=1, alpha=VAMANA["alpha"], seed=0)))
        finally:
            vamana.build_vamana_graph = build_vamana
        centers = bigbuild.kmeans_device(gen.gen_block(0)[: 1 << 21], SHARDS, iters=12,
                                         seed=1)
        if not np.array_equal(bigbuild.assign_shards(gen, centers, 2)[0], assignment):
            raise AssertionError("bigbuild: k-means and the assignment, run again, "
                                 "differ from the build's")
        counts = [int((assignment == s).any(axis=1).sum()) for s in range(SHARDS)]
        log(f"bigbuild: assignment reproduced; members per shard {counts} (overlap 2 "
            f"over {BIG_N}); degrees "
            f"mean {degrees.mean():.2f} min {degrees.min()}; budget "
            f"{bigbuild._budget(dev) / 1e9:.1f} GB")
        for n_s, peak in shard_peaks:
            model = bigbuild.shard_build_hbm_bytes(n_s, D, R, VAMANA["batch"],
                                                   VAMANA["l_build"])
            log(f"bigbuild shard of {n_s} points: measured peak {peak / 1e9:.3f} GB, "
                f"shard_build_hbm_bytes {model / 1e9:.3f} GB ({peak / model:.2f}x)")
        return gen, adj, degrees

    gen, adj, degrees = counted("bigbuild build", set(), build, totals)
    data = stage("materialize", lambda: bigbuild.materialize_host(gen))
    rng = np.random.default_rng(1)
    queries = data[rng.integers(0, BIG_N, Q)].astype(np.float32)
    queries += rng.normal(0, 2.0, queries.shape).astype(np.float32)
    queries = np.clip(np.rint(queries), 0, 255).astype(np.uint8)
    gt_ids, gt_d = stage("groundtruth_u8", lambda: bigbuild.groundtruth_u8_streamed(
        gen, queries, K, q_block=512))
    ref_ids, ref_d = stage("groundtruth_f32", lambda: accel.compute_groundtruth(
        data, queries.astype(np.float32), K, dev))
    if not np.array_equal(gt_d, ref_d):
        raise AssertionError(f"int8 ground truth: distances differ from "
                             f"compute_groundtruth's on {int((gt_d != ref_d).sum())} slots")
    log(f"bigbuild: int8 ground truth distances equal compute_groundtruth's on all "
        f"{gt_d.size} slots; ids equal on {(gt_ids == ref_ids).mean():.4%}")
    medoid = stage("medoid", lambda: bigbuild.medoid_streamed(gen))
    pq = stage("pq_train", lambda: synthetic.train_pq(data, M, sample=PQ_SAMPLE, seed=0))
    codes = stage("pq_encode", lambda: bigbuild.encode_pq_streamed(gen, pq))
    del gen

    def search():
        cb = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, dev)
        index = assemble_device_index(adj, data, codes, cb, medoid, dev)
        rows = []
        for L in BIG_L:
            params = SearchParams(L=L, k=K, beam_width=BEAM_EXTRA["inmemory"][0],
                                  extra_iters=BEAM_EXTRA["inmemory"][1])
            (ids, dists, stats), wall, peak = _timed(
                lambda: search_inmemory(index, queries, params))
            ids = _host_ids(ids)
            _check_output(ids, dists.cpu().numpy(), queries, data, BIG_N)
            row = {"L": L, "recall": calculate_recall(gt_ids, ids, K, gt_d)}
            log(f"bigbuild search L={L}: recall@10 {row['recall']:.2f}, iters "
                f"{stats.iters}, wall {wall:.4f} s, peak {peak:.2f} GB")
            rows.append(row)
        return _best(rows, "bigbuild search")

    best = counted("bigbuild search", {"frontier_lookup"}, search, totals)
    log(f"bigbuild: stage seconds " + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    torch.cuda.empty_cache()
    return best


def counted(label, launched, fn, totals):
    """Run one search phase with every launch count zeroed just before and
    read just after; fail unless exactly the kernels named in `launched`
    ran. Adds the counts to `totals`."""
    from bang_tpu_torch.ops import pq_kernels as pk

    pk.reset_launch_counts()
    out = fn()
    counts = {k.__name__: k.launches for k in pk.KERNELS}
    log(f"{label}: launches {counts}")
    if any((c > 0) != (name in launched) for name, c in counts.items()):
        raise AssertionError(f"{label}: launches {counts}, expected only {launched}")
    for name, c in counts.items():
        totals[name] += c
    return out


def _best(rows, what):
    best = max(rows, key=lambda row: row["recall"])
    if best["recall"] < RECALL_TARGET:
        raise AssertionError(f"{what}: best recall@10 {best['recall']:.2f} "
                             f"< {RECALL_TARGET}")
    return best


def search_phases(dev, totals, kern):
    """Phases 4-15 on `dev`; adds the launch counts of 5-15 to `totals` (not
    those of the profiled calls after phases 5, 6, 7, 10 and 11, nor those
    of phase 14's K1 checks, whose errors go into `kern`)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        prefix = os.path.join(tmp, "synth1m")
        build_bundle(prefix, dev)

        fused = counted("search inmemory fused", {"frontier_lookup"},
                        lambda: run_search(prefix, dev, "inmemory", L_SWEEP), totals)
        best = _best(fused, "inmemory fused")
        profile_search(prefix, dev, "inmemory", PROFILE_L)
        scattered = counted("search inmemory scattered", {"pq_lookup"},
                            lambda: run_search(prefix, dev, "inmemory", (best["L"],),
                                               fused_frontier=False), totals)[0]
        # K1 and K2 sum the same bf16 entries in the same order
        same = (scattered["ids"] == best["ids"]).all(axis=1)
        if not same.all() or scattered["iters"] != best["iters"]:
            raise AssertionError(
                f"inmemory scattered differs from fused: ids on {int((~same).sum())} "
                f"queries, iterations {scattered['iters']} vs {best['iters']}")
        profile_search(prefix, dev, "inmemory", SCATTERED_PROFILE_L,
                       fused_frontier=False, dense=False)

        exact = counted("search exactdistance fused", {"exact_frontier"},
                        lambda: run_search(prefix, dev, "exactdistance", EXACT_L_SWEEP),
                        totals)
        best_e = _best(exact, "exactdistance fused")
        profile_search(prefix, dev, "exactdistance", EXACT_PROFILE_L)
        exact_sc = counted("search exactdistance scattered", set(),
                           lambda: run_search(prefix, dev, "exactdistance",
                                              (best_e["L"],), fused_frontier=False),
                           totals)[0]
        same = (exact_sc["ids"] == best_e["ids"]).all(axis=1)
        if not same.all():
            raise AssertionError(f"exact scattered ids differ from fused on "
                                 f"{int((~same).sum())} queries")

        # at the best L and at the sweep's smallest, where the entry matters
        samp_e = counted("search exactdistance sampled", {"exact_frontier"},
                         lambda: run_search(prefix, dev, "exactdistance",
                                            sorted({EXACT_L_SWEEP[0], best_e["L"]}),
                                            entry_mode="sampled"), totals)
        samp = counted("search inmemory sampled", {"frontier_lookup"},
                       lambda: run_search(prefix, dev, "inmemory",
                                          sorted({L_SWEEP[0], best["L"]}),
                                          entry_mode="sampled"), totals)
        for medoid_rows, rows in ((exact, samp_e), (fused, samp)):
            for row in rows:
                m = next(r for r in medoid_rows if r["L"] == row["L"])
                log(f"entry at L={row['L']}: {row['search']} recall@10 "
                    f"{row['recall']:.2f} iters {row['iters']} | medoid recall@10 "
                    f"{m['recall']:.2f} iters {m['iters']}")
            if rows[-1]["recall"] < RECALL_TARGET:
                raise AssertionError(f"{rows[-1]['search']}: recall@10 "
                                     f"{rows[-1]['recall']:.2f} < {RECALL_TARGET}")
        best_b, base_rows = phase_base(prefix, dev, totals)
        phase_bloom(prefix, dev, totals)
        phase_warmup_serving(prefix, dev, totals)
        best_s = phase_sharded(prefix, dev, totals, kern, base_rows)
    phase_streaming(dev, totals)
    best_big = phase_bigbuild(dev, totals)
    log(f"ok: inmemory best L={best['L']} recall@10 {best['recall']:.2f}, "
        f"scattered ids and iterations identical; exactdistance best "
        f"L={best_e['L']} recall@10 {best_e['recall']:.2f}, scattered ids identical; "
        f"base best L={best_b['L']} recall@10 {best_b['recall']:.2f}, pipelined ids "
        f"identical to serial; bloom, warm-up, serving and streaming checked; sharded "
        f"best L={best_s['L']} recall@10 {best_s['recall']:.2f}; sharded build best "
        f"L={best_big['L']} recall@10 {best_big['recall']:.2f}")


def main():
    smi = phase_device()
    dev = torch.device("cuda")
    import bang_tpu_torch  # noqa: F401  (TF32 off)

    phase_build()
    kern = phase_kernels(dev)
    phase_mask(dev)
    t0 = time.perf_counter()
    phase_probes(dev, kern)
    totals = dict.fromkeys(KERNEL_SOURCES, 0)
    probe_scripts(totals)
    log(f"probes {time.perf_counter() - t0:.1f}s")
    search_phases(dev, totals, kern)
    log(f"on {smi}")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "also_replaces": also, "launches": totals[name],
         **{k: kern[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}
        for name, (src, rep, also) in KERNEL_SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
