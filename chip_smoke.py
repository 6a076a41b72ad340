#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bang_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, each printing progress; any failure raises and exits non-zero:
  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), torch, CUDA and nvcc versions.
  2. build    — build the six kernels from bang_tpu_torch/csrc, one nvcc
                per source, all started together.
  3. kernels  — K1 pq_lookup, K2 frontier_lookup and K3 exact_frontier
                against their plain PyTorch versions on the card at the main
                paths' shapes and others: ids bit-exact; K1 (f32 tables) and
                K2 (bf16-pair tables, pack_tables) distances within rtol
                1e-5 plus atol 1e-5 x the row's largest distance (f32
                summation order is all that differs); K2 also with parents
                outside [0, N) (id -1, +inf), and at the main shape
                identical bit for bit to K6 row_gather + K5 frontier_packed
                on the same parents (the same sum in the same order); K3
                distances bit-exact for integer queries at D <= 128 (every
                partial sum is an integer below 2^24), else within rtol
                1e-5 plus atol 1e-5 x (||q||^2 + the row's largest norm),
                at shapes that take each of its row-copy paths (16-byte,
                4-byte, byte) and parents in groups, and with parents
                outside [0, N) (id -1, +inf). Times each at its main path's
                shape; K2's bound counts the packed tables' bytes.
  mask        — the sorted visited mask (ops/visited.exact_new_mask, plain
                PyTorch) identical to its dense form on random ids at both
                search shapes (Q=10K; C=128 L=128 MI=140 and C=64 L=100
                MI=106), INVALID_ID padding and candidates included; both
                timed.
  probes      — K4 lookup_packed, K5 frontier_packed (with and without id
                planes) and K6 row_gather, the counterparts of the six
                Pallas probes in scripts/, against their plain versions at
                the probes' shape and at R=24 m=12 beam 4 with ids up to
                2^30 (ids and gathered bytes bit-exact, distances as K1's:
                the bf16 entries are the same, only the f32 summation order
                may differ), K6 also at widths 5120, 4352 and 100 with odd
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
  6. scattered — the same bundle on the scattered-codes layout (K1) at the
                best L: recall within 0.5 points of phase 5.
  7. exact    — BANGSearch("exactdistance") on the fused exact rows (K3),
                L in {10, 16, 30, 60, 100}, beam 1, extra_iters 6: recall@10
                >= 90 at the best L; no re-rank, so the distances checked are
                K3's own. Then the L=100 profile, as phase 5's.
  8. exact scattered — the scattered exact layout (plain fetch, no kernel)
                at the best L: ids identical to phase 7 for every query.
  9. sampled  — entry_mode="sampled" at each variant's best L (K3, K2):
                recall@10 >= 90; and at its sweep's smallest L. Both printed
                beside the medoid runs.
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
EXACT_L_SWEEP = (10, 16, 30, 60, 100)
EXACT_PROFILE_L = 100  # the exact L whose fused search is profiled
VAMANA = {"l_build": 48, "batch": 4096, "alpha": 1.44, "n_passes": 2, "seed": 0}
RECALL_TARGET = 90.0
SCATTERED_RECALL_GAP = 0.5

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
# K4/K5: (label, Q, N rows, R, m, beam, ids drawn below)
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
# name -> (source, the TPU kernel it replaces, the other TPU kernels it replaces)
KERNEL_SOURCES = {
    "pq_lookup": ("bang_tpu_torch/csrc/pq_lookup.cu", "bang_tpu/ops/pq_pallas.py:74", []),
    "frontier_lookup": ("bang_tpu_torch/csrc/frontier_lookup.cu",
                        "bang_tpu/ops/pq_pallas.py:267", ["bang_tpu/ops/pq_pallas.py:411"]),
    "exact_frontier": ("bang_tpu_torch/csrc/exact_frontier.cu",
                       "bang_tpu/ops/pq_pallas.py:564", []),
    "lookup_packed": ("bang_tpu_torch/csrc/lookup_packed.cu", "scripts/exp_lookup.py:85",
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
    _build.build_libraries(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
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


def _k2_against_k6_k5(packed, rows, parents, ids, dists):
    """K2 at the main shape against K6 row_gather + K5 frontier_packed on the
    same parents and packed tables: identical bit for bit."""
    from bang_tpu_torch.ops import probe_kernels as prk
    from bang_tpu_torch.scripts._common import same

    q, beam = parents.shape
    r = ids.shape[1] // beam
    gathered = prk.row_gather(rows, parents.view(-1)).view(q, beam, rows.shape[1])
    ids5, d5 = prk.frontier_packed(packed, gathered, r, 4)
    torch.cuda.synchronize()
    same("frontier_lookup vs row_gather + frontier_packed ids", ids, ids5)
    same("frontier_lookup vs row_gather + frontier_packed dists", dists, d5)
    log("kernels K2 identical bit for bit to K6 + K5 on the same parents")


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
        got_ids, got_d = pk.frontier_lookup(packed, rows, parents)
        torch.cuda.synchronize()
        want_ids, want_d = pk.frontier_lookup_plain(packed, rows, parents)
        if not torch.equal(got_ids, want_ids) or not torch.equal(
                got_ids, ids[parents.long()].reshape(q, -1)):
            raise AssertionError(f"frontier_lookup {label}: ids differ")
        e2 = dist_err(f"frontier_lookup {label}", got_d, want_d)

        codes = torch.randint(0, 256, (q, beam * r, m), generator=gen,
                              device=dev, dtype=torch.uint8)
        got = pk.pq_lookup(tables, codes)
        torch.cuda.synchronize()
        e1 = dist_err(f"pq_lookup {label}", got, pk.pq_lookup_plain(tables, codes))
        result["pq_lookup"]["max_abs_err"] = max(result["pq_lookup"]["max_abs_err"], e1)
        result["frontier_lookup"]["max_abs_err"] = max(
            result["frontier_lookup"]["max_abs_err"], e2)
        log(f"kernels {label}: ids exact, max abs err K1 {e1:.3g} K2 {e2:.3g}")

        if i == 0:  # time at the main path's shape
            _k2_against_k6_k5(packed, rows, parents, got_ids, got_d)
            _time_pair(result, "pq_lookup", label,
                       lambda: pk.pq_lookup(tables, codes),
                       lambda: pk.pq_lookup_plain(tables, codes))
            _time_pair(result, "frontier_lookup", label,
                       lambda: pk.frontier_lookup(packed, rows, parents),
                       lambda: pk.frontier_lookup_plain(packed, rows, parents))
            c = beam * r
            _bound(result, "pq_lookup",
                   tables.numel() * 4 + codes.numel() + q * c * 4, q * c * m)
            _bound(result, "frontier_lookup",
                   packed.numel() * 4 + _unique_rows(parents) * rows.shape[1]
                   + parents.numel() * 4 + q * c * 8, q * c * m)
        del tables, packed, rows, parents, ids, codes, got_ids, got_d, want_ids, want_d, got
        torch.cuda.empty_cache()
    _k2_out_of_range(gen, dev)
    phase_exact_kernel(gen, dev, result)
    return result


def _note_err(result, name, err):
    result[name]["max_abs_err"] = max(result[name]["max_abs_err"], err)
    return err


def phase_probes(dev, result):
    """K4-K6 against their plain versions at PROBE_SHAPES and
    GATHER_WIDTHS; times each at the probes' shape."""
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
        log(f"probes {label}: ids and gathers exact, max abs err K4 {e4:.3g} "
            f"K5 {e5:.3g}")

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
               entry_mode="medoid"):
    """BANGSearch(variant) over `l_values` at bench.py's beam and
    extra_iters; one row per L (with the returned ids)."""
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
    label = f"{variant} {layout} {entry_mode}"
    log(f"bang_load {variant} {layout} layout in {time.perf_counter() - t0:.1f}s")
    rows = []
    for L in l_values:
        s.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra,
                                entry_mode=entry_mode)
        s.bang_alloc(len(queries))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, dists = s.bang_query(queries)  # host arrays: the device is done
        wall = time.perf_counter() - t0
        _check_output(ids, dists, queries, vectors, len(vectors))
        row = {"search": label, "L": L,
               "recall": calculate_recall(gt_ids, ids, K, gt_dists),
               "iters": s.last_stats.iters, "wall_s": wall,
               "qps": len(queries) / wall, "ids": ids}
        log(f"search {label} L={L} recall@10={row['recall']:.2f} "
            f"iters={row['iters']} wall={wall:.4f}s qps={row['qps']:.1f}")
        rows.append(row)
    s.bang_unload()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


# the traversal's steps whose device time profile_search reads by name:
# models/traversal's module globals, each run inside a profiler range. The
# profiler ties no kernel launched through ctypes (K2, K3) to a range: their
# times are in the per-kernel rows.
PROFILE_STAGES = ("exact_new_mask", "first_occurrence_mask_blocks", "merge_worklist",
                  "select_parents_beam")


@contextlib.contextmanager
def _traversal_stages(mask):
    """Run the traversal with `mask` as its visited mask and each of
    PROFILE_STAGES inside a torch.profiler range of its name (the kernels a
    range launches count towards its device time); restore them after."""
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


def profile_search(prefix, dev, variant, L):
    """BANGSearch(variant) at L on the fused layout, once with the sorted
    visited mask and once with its dense form (the JAX expression): each
    three timed calls, then one under torch.profiler. Prints the device ms
    of each kernel name and of each traversal stage (PROFILE_STAGES) summed
    over the call, the kernels' total against the profiled call's wall (the
    device's busy share) and the peak memory of that call."""
    from torch.profiler import ProfilerActivity, profile

    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.formats.bin_io import load_bin
    from bang_tpu_torch.ops import visited

    queries = load_bin(prefix + "_query.bin", np.uint8)
    beam, extra = BEAM_EXTRA[variant]
    s = BANGSearch(variant, device=dev)
    s.bang_load(prefix)
    s.bang_set_searchparams(K, L, beam_width=beam, extra_iters=extra)
    s.bang_alloc(len(queries))
    for mask_name, mask in (("sorted", visited.exact_new_mask),
                            ("dense", visited.exact_new_mask_dense)):
        label = f"profile {variant} L={L} {mask_name} mask"
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
        # the stage ranges also appear on the device's timeline under their
        # own names: they are spans, not kernels
        kernels = sorted(
            ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0 and e.key not in PROFILE_STAGES),
            reverse=True)
        total = sum(k[0] for k in kernels)
        log(f"{label}: {s.last_stats.iters} iterations; walls of 3 timed calls "
            + " / ".join(f"{w:.4f}" for w in walls) + f" s; profiled call {wall:.4f} s")
        for ms, count, key in kernels[:16]:
            log(f"profile {ms:10.3f} ms {count:6d} calls  {key[:100]}")
        stages = {}  # name -> [device ms of the kernels each range launched, calls]
        for e in prof.events():
            if e.name in PROFILE_STAGES and e.device_type == torch.autograd.DeviceType.CPU:
                acc = stages.setdefault(e.name, [0.0, 0])
                acc[0] += e.device_time_total / 1e3
                acc[1] += 1
        log(f"{label} stages (kernel ms): " + ", ".join(
            f"{k} {ms:.3f} ms ({n} calls)" for k, (ms, n) in stages.items()))
        log(f"{label}: kernels {total:.3f} ms in a {wall * 1e3:.3f} ms wall, busy "
            f"{total / (wall * 1e3):.1%}; peak {peak / 1e9:.2f} GB")
    s.bang_unload()
    torch.cuda.empty_cache()


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


def search_phases(dev, totals):
    """Phases 4-9 on `dev`; adds the launch counts of 5-9 to `totals` (not
    those of the profiled calls after phases 5 and 7)."""
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
        if abs(scattered["recall"] - best["recall"]) > SCATTERED_RECALL_GAP:
            raise AssertionError(f"scattered recall {scattered['recall']:.2f} vs "
                                 f"fused {best['recall']:.2f}")

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
    log(f"ok: inmemory best L={best['L']} recall@10 {best['recall']:.2f}, "
        f"scattered {scattered['recall']:.2f}; exactdistance best L={best_e['L']} "
        f"recall@10 {best_e['recall']:.2f}, scattered ids identical")


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
    search_phases(dev, totals)
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
