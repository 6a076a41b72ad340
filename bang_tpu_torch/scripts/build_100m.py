"""Build a large index bundle on one card with the sharded Vamana builder
(formats/bigbuild.py) and write the on-disk bundle that the base variant
reads (the counterpart of scripts/build_100m.py).

Configuration: N x 128 u8 (100M by default), R=32, PQ m=32: the base
variant keeps only the PQ codes on the card (100M x 32 = 3.2 GB) and the
packed graph (26 GB at 100M) in host RAM, the reference's billion-scale
split (bang_search.cu:311-328).

Five stages, in this order, each skipped when its output file exists, so a
run that stopped resumes where it stopped. The cheap ones come first, so
that when the long graph stage ends the bundle is minutes from complete:
  medoid  the streamed medoid (<prefix>_ckpt/medoid.npy)
  gtq     queries (block 7 of the generator + N(0, 2) noise) and their
          exact int8 ground truth (_query.bin, _gt.bin)
  pq      PQ trained on the first `pq_sample` rows of block 3 (at most
          65,536 of them, formats/synthetic.train_pq) and encoded on the
          card (_pq_pivots.bin, _pq_compressed.bin)
  graph   the sharded Vamana build (overlap 2), per-shard checkpoints in
          <prefix>_ckpt/ (_ckpt/adj.npy, _ckpt/deg.npy)
  disk    the dataset drawn again into host RAM (N x 128 bytes) and the
          packed records written (_disk.bin, _disk_metadata.bin)
At small N the query and PQ blocks lie past the dataset: the generator
draws any block, so they are points of the same distribution outside it,
as in the JAX script.

The generator's bytes are not the JAX package's (formats/bigbuild.py), so
a bundle of this script and one of the JAX script differ; the stages call
the same functions in the same order (tests/test_torch_scale_scripts.py
feeds both one array-backed generator).

    B100_N=10000000 B100_SHARDS=4 python -m bang_tpu_torch.scripts.build_100m

Environment (the JAX script's, with its defaults): B100_N (100,000,000),
B100_R (32), B100_M (32), B100_SHARDS (20), B100_LBUILD (24), B100_PASSES
(1), B100_BATCH (16384), B100_CACHE (<repo>/bench_data), B100_REUSE (a
sibling bundle's prefix: hard-link its queries, ground truth, medoid and,
at the same m, its PQ), B100_WARM (a sibling bundle's prefix: seed each
shard's build from its adjacency, read from its _disk.bin). The bundle's
prefix is printed on the last line.
"""

from __future__ import annotations

import glob
import os
import re
import sys
import time

import numpy as np

from bang_tpu_torch.formats import bigbuild
from bang_tpu_torch.scripts.bundles import CACHE

D = 128
STAGES = ("medoid", "gtq", "pq", "graph", "disk")


def bundle_prefix(n, r, m, cache=CACHE) -> str:
    """The script's bundle prefix (bundles.discover_big_base finds it)."""
    return os.path.join(cache, f"synthg_v1_n{n}_d{D}_r{r}_m{m}_shardvamana")


def link_reused(prefix: str, reuse: str, m: int) -> None:
    """Hard-link a sibling bundle's files that depend only on the data
    (N, D, block, clusters, seed), not on the graph: queries, ground truth,
    medoid, and the PQ files when the sibling has the same m. Files that
    exist are left alone."""
    same_m = re.search(r"_m(\d+)_", os.path.basename(reuse))
    same_m = same_m is not None and same_m.group(1) == str(m)
    links = [("_query.bin", True), ("_gt.bin", True), ("_pq_pivots.bin", same_m),
             ("_pq_compressed.bin", same_m), ("_ckpt/medoid.npy", True)]
    for suffix, ok in links:
        src, dst = reuse + suffix, prefix + suffix
        if ok and os.path.exists(src) and not os.path.exists(dst):
            os.link(src, dst)


def warm_seed(warm: str):
    """(adj [N, R] int32, degrees [N] int32) of a bundle, read out of its
    packed _disk.bin through a structured memmap (one sequential scan):
    each row's edges sorted by id, zeros past its degree."""
    from bang_tpu_torch.formats.graph import load_metadata

    wm = load_metadata(warm + "_disk_metadata.bin")
    rec = np.dtype([("vec", np.uint8, wm.entry_len - 4 - 4 * wm.degree),
                    ("deg", np.uint32), ("nbr", np.int32, wm.degree)])
    mm = np.memmap(warm + "_disk.bin", dtype=rec, mode="r", shape=(wm.n,))
    init_adj = np.ascontiguousarray(mm["nbr"])
    init_deg = np.minimum(mm["deg"], wm.degree).astype(np.int32)
    del mm
    return init_adj, init_deg


def main(n=100_000_000, r=32, m=32, n_shards=20, l_build=24, n_passes=1,
         batch=16384, cache=CACHE, reuse="", warm="", block=1 << 19,
         pq_sample=1 << 19, n_queries=10_000, seed=11, device="cuda"):
    """Run the stages whose files are missing; returns (prefix, {stage:
    seconds} of the stages that ran). `block` is the generator's block
    (1 << 19 keeps the ground truth's int8 table and each step's [q_block,
    block] distances in range at 100M); `pq_sample` the rows of block 3
    that PQ training sees."""
    from bang_tpu_torch.formats import synthetic
    from bang_tpu_torch.formats.bin_io import save_bin, save_truthset
    from bang_tpu_torch.formats.graph import GraphIndex, save_graph_index
    from bang_tpu_torch.formats.pq import save_pq

    prefix = bundle_prefix(n, r, m, cache)
    ckpt = prefix + "_ckpt"
    os.makedirs(ckpt, exist_ok=True)
    if reuse:
        link_reused(prefix, reuse, m)
    t0 = time.time()
    ran = {}

    def log(msg):
        print(f"[100m] {msg} t={time.time() - t0:.0f}s", file=sys.stderr, flush=True)

    def stage(name, done, fn):
        if done:
            return
        s = time.perf_counter()
        fn()
        ran[name] = time.perf_counter() - s
        log(f"stage {name} {ran[name]:.1f}s")

    gen = bigbuild.BlockGen(n, D, block=block, n_clusters=4096, seed=seed, device=device)
    med_path = ckpt + "/medoid.npy"

    def medoid():
        med = bigbuild.medoid_streamed(gen)
        np.save(med_path, med)
        log(f"medoid = {med}")

    def gtq():
        rng = np.random.default_rng(77)
        base = np.asarray(bigbuild._block(gen, 7).cpu())[:n_queries].astype(np.float32)
        queries = np.clip(np.rint(base + rng.normal(0, 2.0, base.shape)), 0,
                          255).astype(np.uint8)
        log("computing the exact int8 ground truth")
        gt_ids, gt_dists = bigbuild.groundtruth_u8_streamed(gen, queries, 100)
        save_bin(prefix + "_query.bin", queries)
        save_truthset(prefix + "_gt.bin", gt_ids, gt_dists)

    def pq():
        sample = np.asarray(bigbuild._block(gen, 3).cpu())[:pq_sample]
        log(f"training PQ on {len(sample)} generated points")
        codebook = synthetic.train_pq(sample, m, seed=seed)
        log(f"encoding {n} codes on the device")
        codebook.codes = bigbuild.encode_pq_streamed(gen, codebook)
        save_pq(prefix, codebook)

    adj_path, deg_path = ckpt + "/adj.npy", ckpt + "/deg.npy"

    def graph():
        init_adj = init_deg = None
        if warm:
            log(f"warm start: reading the adjacency of {warm}")
            init_adj, init_deg = warm_seed(warm)
        log(f"sharded build: N={n} R={r} shards={n_shards} l_build={l_build} "
            f"passes={n_passes} warm={bool(warm)}")
        adj, degrees, _assignment = bigbuild.build_sharded_vamana(
            gen, r=r, l_build=l_build, n_shards=n_shards, overlap=2, batch=batch,
            n_passes=n_passes, seed=seed, ckpt_dir=ckpt, init_adj=init_adj,
            init_deg=init_deg)
        np.save(adj_path, adj)
        np.save(deg_path, degrees)
        # the per-shard checkpoints only resume a stopped graph stage
        for f in glob.glob(ckpt + "/shard*_adj.npy"):
            os.remove(f)

    def disk():
        log(f"drawing the dataset into host RAM ({n * D / 1e9:.2f} GB)")
        data = bigbuild.materialize_host(gen, log=log)
        save_graph_index(prefix, GraphIndex(data, np.load(adj_path), np.load(deg_path),
                                            int(np.load(med_path))))

    stage("medoid", os.path.exists(med_path), medoid)
    stage("gtq", os.path.exists(prefix + "_gt.bin"), gtq)
    stage("pq", os.path.exists(prefix + "_pq_compressed.bin"), pq)
    stage("graph", os.path.exists(adj_path), graph)
    stage("disk", os.path.exists(prefix + "_disk.bin"), disk)
    log(f"DONE: {prefix}")
    return prefix, ran


def _from_env() -> dict:
    env = os.environ
    out = {key: int(env[var]) for key, var in (
        ("n", "B100_N"), ("r", "B100_R"), ("m", "B100_M"), ("n_shards", "B100_SHARDS"),
        ("l_build", "B100_LBUILD"), ("n_passes", "B100_PASSES"), ("batch", "B100_BATCH"),
    ) if var in env}
    out.update({key: env[var] for key, var in (
        ("cache", "B100_CACHE"), ("reuse", "B100_REUSE"), ("warm", "B100_WARM"),
    ) if var in env})
    return out


if __name__ == "__main__":
    print(main(**_from_env())[0])
