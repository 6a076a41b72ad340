"""Derive the tuned 10M bundle (R=32 graph, m=32 PQ) from the R=64 / m=64
source bundle of build_10m_source.py (the counterpart of
scripts/build_10m_tuned.py).

It reads the vectors out of the source's packed _disk.bin, seeds a
one-pass Vamana build at R=32 with the first R columns of each source row
(the rows keep real edges sorted by id, zeros past the degree: the kept
edges are a subset of true pruned edges, the padding becomes self ids, and
the pass prunes again), trains PQ on the first 2^19 points and encodes on
the card, and copies the queries and ground truth (same data, same truth).
Each output is skipped when it exists.

    python -m bang_tpu_torch.scripts.build_10m_tuned
"""

from __future__ import annotations

import os
import shutil
import sys
import time

import numpy as np

from bang_tpu_torch.scripts import bundles
from bang_tpu_torch.scripts.build_100m import warm_seed


def warm_init(src: str, r: int):
    """(vectors [N, D] u8, (init_adj [N, r] int32, init_deg [N] int32),
    metadata) from the source bundle's _disk.bin: the first r columns of
    each row (build_100m.warm_seed), self ids past min(degree, r)."""
    from bang_tpu_torch.formats.graph import load_metadata

    meta = load_metadata(src + "_disk_metadata.bin")
    n, d = meta.n, meta.dim
    raw = np.memmap(src + "_disk.bin", dtype=np.uint8, mode="r", shape=(n, meta.entry_len))
    data = np.ascontiguousarray(raw[:, :d])
    del raw
    adj, deg = warm_seed(src)
    init_adj = np.ascontiguousarray(adj[:, :r])
    init_deg = np.minimum(deg, r)
    del adj
    pad = np.arange(r, dtype=np.int32)[None, :] >= init_deg[:, None]
    np.copyto(init_adj, np.arange(n, dtype=np.int32)[:, None], where=pad)
    return data, (init_adj, init_deg), meta


def main(n=10_000_000, cache=bundles.CACHE, device="cuda", r=32, m=32, l_build=48,
         batch=16384) -> str:
    """Build what is missing of the tuned bundle; returns its prefix."""
    from bang_tpu_torch.formats import accel, synthetic
    from bang_tpu_torch.formats.graph import GraphIndex, save_graph_index
    from bang_tpu_torch.formats.pq import save_pq
    from bang_tpu_torch.formats.vamana import build_vamana_graph

    src = bundles.prefix_for("synth", n, 128, 64, 64, "vamana", cache)
    dst = bundles.prefix_for("synth", n, 128, r, m, "vamana", cache)
    t0 = time.time()

    def log(msg):
        print(f"[10mtuned] {msg} t={time.time() - t0:.0f}s", file=sys.stderr, flush=True)

    data, init, meta = warm_init(src, r)
    log(f"source: N={meta.n} D={meta.dim} entry_len={meta.entry_len}")
    if not os.path.exists(dst + "_disk.bin"):
        adj, degrees, medoid = build_vamana_graph(
            data, r, device, l_build=l_build, alpha=1.44, batch=batch, seed=3,
            n_passes=1, init=init, medoid=int(meta.medoid))
        log(f"graph built (medoid={medoid})")
        save_graph_index(dst, GraphIndex(data, adj, degrees, medoid))
    if not os.path.exists(dst + "_pq_compressed.bin"):
        pq = synthetic.train_pq(data[: 1 << 19], m, seed=3)
        pq.codes = accel.encode_pq(data, pq, device)
        save_pq(dst, pq)
        log("PQ saved")
    for suffix in ("_query.bin", "_gt.bin"):
        if not os.path.exists(dst + suffix):
            shutil.copyfile(src + suffix, dst + suffix)
    log(f"DONE: {dst}")
    return dst


if __name__ == "__main__":
    print(main())
