"""The sorted exact mask against the bloom filter at large L (the
counterpart of scripts/exp_large_l.py).

The exact mask's cost a step grows with the worklist and visited ids it
sorts, C + L + max_iters x beam; the bloom filter's is about constant but
scatters into a [Q, BF_ENTRIES + 1] u8 filter. This measures both over the
reference's range of L (up to 512), to place the crossover.

Data (the JAX script's): 200K x 64 f32 clustered points (256 clusters,
seed 3), the pruned kNN graph R=32 (seed 3), 2,048 queries = points +
N(0, 0.05) (seed 4), exact ground truth; the exactdistance search
(scattered: f32 vectors, no kernel), beam 1, extra_iters 50. Per L and mode
through bench._measure_point (a warm-up, 3 timed calls): wall QPS,
recall@10, iterations, and on the card the peak memory; the filter's bytes.

The JAX script measured this on a TPU v5e; those times are the TPU's, not
the card's.

    python -m bang_tpu_torch.scripts.exp_large_l   # on the card
"""

from __future__ import annotations

import json
import sys

import numpy as np

N, D, R, Q = 200_000, 64, 32, 2048
L_GRID = (64, 128, 256, 512)
EXTRA = 50


def main(device="cuda", n=N, d=D, r=R, q=Q, l_grid=L_GRID, extra=EXTRA,
         out=None) -> dict:
    import torch

    from bang_tpu_torch.device import resolve_device
    from bang_tpu_torch.formats import accel, synthetic
    from bang_tpu_torch.models.exactdistance import search_exact
    from bang_tpu_torch.models.index import assemble_exact_index, free_device_index
    from bang_tpu_torch.scripts.exp_bloom import compare_modes

    dev = resolve_device(device)
    data = synthetic.make_clustered_data(n, d, n_clusters=256, seed=3)
    adj, _degrees = accel.build_pruned_knn_graph(data, r, dev, seed=3)
    rng = np.random.default_rng(4)
    queries = (data[rng.integers(0, n, q)]
               + rng.normal(0, 0.05, (q, d)).astype(np.float32))
    gt_ids, gt_dists = accel.compute_groundtruth(data, queries, 10, dev)
    index = assemble_exact_index(adj, data, synthetic.medoid_of(data), dev)
    qd = torch.as_tensor(queries, device=dev)
    res = {"n": n, "d": d, "r": r, "layout": "scattered" if index.adj is not None
           else "fused", "per_L": {}}
    try:
        for L in l_grid:
            res["per_L"][str(L)] = compare_modes(index, search_exact, qd, gt_ids,
                                                 gt_dists, L, 1, extra, dev,
                                                 measure_pipelined=False)
    finally:
        free_device_index(index)
    if out:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(out=sys.argv[1] if len(sys.argv) > 1 else None)
