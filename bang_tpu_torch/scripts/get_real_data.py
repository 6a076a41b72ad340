"""The real-corpus pipeline (port of scripts/get_real_data.py): download ->
convert -> index -> search, on one CUDA card.

The reference workflow (its README.md:42-58 and ReadMe.pdf p.1-3) runs over
the public TexMex corpora (SIFT1M, GIST1M from corpus-texmex.irisa.fr).
This script takes one of them into an index with the port's own builder:

  1. download the corpus archive (`fetch`; skipped quietly when there is
     no network: every later step works from local files, and
     `--skip-download` skips the attempt);
  2. extract it, and convert the fvecs/ivecs files to DiskANN-style .bin
     (formats/texmex.py): the queries, and the ground truth as a truthset
     whose distances are the exact squared L2 of each ground-truth id,
     computed in f32 on `--device` (`_fill_gt_distances`);
  3. build the Vamana graph and the PQ codes on `--device`
     (formats/vamana.py, formats/synthetic.train_pq, formats/accel.encode_pq);
  4. run the harness driver (harness/driver.main, in this process) with
     the JAX script's arguments: the in-memory variant's auto sweep up to
     recall@10 90 against the truthset.

Unlike the JAX script, the truthset carries true distances. TexMex ground
truth is ids only, and JAX's `groundtruth_to_truthset` fills the distances
with zeros. The recall's tie expansion (utils/recall.py) then takes every
zero as a tie of the k-th, so recall@10 is scored against all 100 columns:
a result at true ranks 50-59 scores 100.0. Against the true distances it
scores 0.0. The truthset's header and ids are the bytes JAX writes.

    python3 -m bang_tpu_torch.scripts.get_real_data sift1m [--dir bench_data/real] \\
        [--skip-download] [--device cuda|cpu]

Returns (and exits with) the harness driver's return code; 0 with nothing done
when the archive is neither downloadable nor present.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tarfile
import time
import urllib.error
import urllib.request

import numpy as np

DATASETS = {
    "siftsmall": {  # 10K points: the reference's smoke-test scale (ReadMe.pdf p.3)
        "url": "ftp://ftp.irisa.fr/local/texmex/corpus/siftsmall.tar.gz",
        "base": "siftsmall/siftsmall_base.fvecs",
        "query": "siftsmall/siftsmall_query.fvecs",
        "gt": "siftsmall/siftsmall_groundtruth.ivecs",
        "r": 32, "m": 32, "L": 40,
    },
    "sift1m": {
        "url": "ftp://ftp.irisa.fr/local/texmex/corpus/sift.tar.gz",
        "base": "sift/sift_base.fvecs",
        "query": "sift/sift_query.fvecs",
        "gt": "sift/sift_groundtruth.ivecs",
        "r": 64, "m": 64, "L": 40,
    },
    "gist1m": {
        "url": "ftp://ftp.irisa.fr/local/texmex/corpus/gist.tar.gz",
        "base": "gist/gist_base.fvecs",
        "query": "gist/gist_query.fvecs",
        "gt": "gist/gist_groundtruth.ivecs",
        "r": 64, "m": 120, "L": 64,
    },
}
GT_BLOCK = 512  # queries a block of the distance recomputation


def fetch(url: str, dest: str) -> bool:
    """Download `url` to `dest` (kept when it exists); False, with a note,
    when the network is not there."""
    if os.path.exists(dest):
        return True
    print(f"[real] downloading {url}", flush=True)
    try:
        with urllib.request.urlopen(url, timeout=30) as r, open(dest + ".part", "wb") as f:
            while True:
                chunk = r.read(1 << 22)
                if not chunk:
                    break
                f.write(chunk)
        os.rename(dest + ".part", dest)
        return True
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        print(f"[real] download unavailable ({e}); skipping: rerun with network "
              f"access, or put the archive at {dest}", flush=True)
        return False


def _fill_gt_distances(gt_path: str, base: np.ndarray, queries: np.ndarray,
                       device) -> None:
    """Write into the truthset at `gt_path` (`<n><k><n*k u32 ids><n*k f32
    dists>`) the exact squared L2 distance, in f32 on `device`, of each
    query to each of its ground-truth ids, in place of the distances
    there. The ids keep the corpus's order; equal vectors get equal
    distances, so the recall's tie expansion sees them as ties."""
    import torch

    from bang_tpu_torch.device import resolve_device
    from bang_tpu_torch.formats.bin_io import load_truthset

    dev = resolve_device(device)
    ids, _ = load_truthset(gt_path)
    n, k = ids.shape
    if n > len(queries) or ids.max(initial=0) >= len(base):
        raise ValueError(f"{gt_path}: {n} x {k} ids for {len(queries)} queries over "
                         f"{len(base)} points")
    vecs = torch.as_tensor(base, device=dev)
    dists = np.empty((n, k), np.float32)
    for s in range(0, n, GT_BLOCK):
        q = torch.as_tensor(queries[s : s + GT_BLOCK], device=dev)
        rows = vecs[torch.as_tensor(ids[s : s + GT_BLOCK].astype(np.int64), device=dev)]
        dists[s : s + GT_BLOCK] = ((rows - q[:, None, :]) ** 2).sum(-1).cpu().numpy()
    with open(gt_path, "r+b") as f:
        f.seek(8 + ids.size * 4)
        f.write(dists.tobytes())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset", choices=sorted(DATASETS))
    p.add_argument("--dir", default="bench_data/real")
    p.add_argument("--skip-download", action="store_true")
    p.add_argument("--num-queries", type=int, default=1000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    cfg = DATASETS[args.dataset]
    os.makedirs(args.dir, exist_ok=True)
    archive = os.path.join(args.dir, os.path.basename(cfg["url"]))

    if not args.skip_download and not fetch(cfg["url"], archive):
        return 0  # no network: a quiet skip
    if not os.path.exists(os.path.join(args.dir, cfg["base"])):
        if not os.path.exists(archive):
            print(f"[real] archive missing: {archive}", flush=True)
            return 0
        print(f"[real] extracting {archive}", flush=True)
        with tarfile.open(archive) as t:
            t.extractall(args.dir, filter="data")

    from bang_tpu_torch.formats import accel, synthetic, texmex
    from bang_tpu_torch.formats.graph import GraphIndex, save_graph_index
    from bang_tpu_torch.formats.pq import save_pq
    from bang_tpu_torch.formats.vamana import build_vamana_graph
    from bang_tpu_torch.harness import driver

    prefix = os.path.join(args.dir, args.dataset)
    need_gt = not os.path.exists(prefix + "_gt.bin")
    need_index = not os.path.exists(prefix + "_disk.bin")
    stages = {}
    if need_gt or need_index:
        t0 = time.perf_counter()
        vectors = texmex.read_vecs(os.path.join(args.dir, cfg["base"])).astype(np.float32)
        stages["read_base"] = time.perf_counter() - t0
    if need_gt:  # a truthset with zeros for distances never takes the final name
        t0 = time.perf_counter()
        part = prefix + "_gt.bin.part"
        texmex.groundtruth_to_truthset(os.path.join(args.dir, cfg["gt"]), part)
        texmex.to_bin(os.path.join(args.dir, cfg["query"]), prefix + "_query.bin")
        stages["convert"] = time.perf_counter() - t0
        queries = texmex.read_vecs(os.path.join(args.dir, cfg["query"])).astype(np.float32)
        t0 = time.perf_counter()
        _fill_gt_distances(part, vectors, queries, args.device)
        os.replace(part, prefix + "_gt.bin")
        stages["distances"] = time.perf_counter() - t0
    if need_index:
        print(f"[real] building index over {vectors.shape}", flush=True)
        t0 = time.perf_counter()
        adj, degrees, medoid = build_vamana_graph(vectors, cfg["r"], args.device,
                                                  l_build=48, batch=4096, seed=0)
        save_graph_index(prefix, GraphIndex(vectors, adj, degrees, medoid))
        stages["graph"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pq = synthetic.train_pq(vectors, cfg["m"], seed=0)
        stages["pq_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pq.codes = accel.encode_pq(vectors, pq, args.device)
        save_pq(prefix, pq)
        stages["encode"] = time.perf_counter() - t0
    print("[real] stage seconds " + json.dumps(stages), flush=True)

    argv_driver = [
        prefix, prefix + "_query.bin", prefix + "_gt.bin",
        str(args.num_queries), "10", "float", "l2",
        "--variant", "inmemory", "--mode", "auto",
        "--target-recall", "90", "--reps", "2", "--step", "12",
        "--device", args.device,
    ]
    print("[real] harness.driver " + " ".join(argv_driver), flush=True)
    return driver.main(argv_driver)


if __name__ == "__main__":
    sys.exit(main())
