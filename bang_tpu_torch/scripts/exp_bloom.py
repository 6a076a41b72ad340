"""The bloom-filter visited set against the sorted exact mask at the 1M
headline point (the counterpart of scripts/exp_bloom.py).

The reference's visited set is a bloom filter: BF_ENTRIES one-byte cells a
query, two FNV-1a hashes (BANG_Inmemory/parANN.cu:964-1046). The port has
it (ops/bloom.py, visited_mode="bloom") and defaults to the exact mask
(ops/visited.exact_new_mask: a row sort of worklist and visited ids).

Protocol: the in-memory search (models/inmemory.search_inmemory; fused
rows, K2 on the card) on
the bench's headline bundle at its headline point (L=11, beam 2,
extra_iters 11, medoid entry), 10K queries, each mode through
bench._measure_point: a warm-up call, 3 timed calls, 6 in flight. Per mode:
recall@10, QPS (best of 3, median, 6 in flight), iterations and, on the
card, the peak memory of the timed calls; then the QPS ratio bloom / exact,
the recall delta and the filter's bytes (Q x (BF_ENTRIES + 1) u8 cells:
JAX's [Q, BF] and the port's trash column).

The JAX script measured this on a TPU v5e (BLOOM_r05.json); those times
are the TPU's, not the card's.

    python -m bang_tpu_torch.scripts.exp_bloom   # on the card; the bench's 1M
                                                 # bundle, built under bench_data/
                                                 # first when it is missing
"""

from __future__ import annotations

import json
import os
import sys

from bang_tpu_torch.constants import BF_ENTRIES

L, BEAM, EXTRA, NQ = 11, 2, 11, 10_000


def log(msg):
    print(f"[exp_bloom] {msg}", file=sys.stderr, flush=True)


def compare_modes(index, search, queries, gt_ids, gt_dists, L, beam, extra, dev,
                  n_reps=3, measure_pipelined=True) -> dict:
    """Each visited mode at one point through bench._measure_point, with
    the timed calls' peak memory on the card (None on the CPU); the QPS
    ratio, the recall delta and the filter's bytes."""
    import torch

    from bang_tpu_torch import bench

    out = {"L": L, "beam": beam, "extra": extra, "num_queries": int(queries.shape[0]),
           "bf_entries": BF_ENTRIES,
           "bloom_filter_bytes": int(queries.shape[0]) * (BF_ENTRIES + 1)}
    for mode in ("exact", "bloom"):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        row = bench._measure_point(index, search, queries, gt_ids, gt_dists, L, beam,
                                   extra, n_reps=n_reps,
                                   measure_pipelined=measure_pipelined,
                                   visited_mode=mode)
        row["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                          if dev.type == "cuda" else None)
        out[mode] = row
        log(f"L={L} {mode}: recall={row['recall']:.2f} qps={row['qps']:,.1f} "
            f"iters={row['iters']} peak_gb={row['peak_gb']}")
    out["qps_ratio_bloom_vs_exact"] = round(out["bloom"]["qps"] / out["exact"]["qps"], 3)
    out["recall_delta"] = round(out["bloom"]["recall"] - out["exact"]["recall"], 2)
    return out


def main(device="cuda", prefix=None, nq=NQ, L=L, beam=BEAM, extra=EXTRA,
         out=None) -> dict:
    """Both modes on the bundle at `prefix` (when None, the bench's headline
    bundle: bench.headline_bundle, built when missing); writes the result
    to `out` when given."""
    import torch

    from bang_tpu_torch import bench
    from bang_tpu_torch.device import resolve_device
    from bang_tpu_torch.models.index import device_index_from_files, free_device_index
    from bang_tpu_torch.models.inmemory import search_inmemory
    from bang_tpu_torch.scripts import bundles

    dev = resolve_device(device)
    prefix = prefix or bench.headline_bundle(dev)
    queries, gt_ids, gt_dists = bundles.load_bundle(prefix, nq)
    index = device_index_from_files(prefix, dev, "inmemory")
    try:
        res = compare_modes(index, search_inmemory, torch.as_tensor(queries, device=dev),
                            gt_ids, gt_dists, L, beam, extra, dev)
    finally:
        free_device_index(index)
    res["bundle"] = os.path.basename(prefix)
    if out:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(out=sys.argv[1] if len(sys.argv) > 1 else None)
