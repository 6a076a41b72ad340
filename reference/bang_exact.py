"""A plain transcription of BANG_Exactdistance's search, one query at a time.

The greedy best-first walk of BANG_Exactdistance (parANN.cu:90-998) over a
graph held as an [N, R] id array (a negative id is padding) and an [N, D]
vector array, written with no batching, no capture and no layouts, so that
it can judge the port's batched, captured search (bang_tpu_torch, its
`exactdistance` variant) on the same graph and vectors. It imports only
torch and numpy.

For each query:
  entry      the medoid, or with entry_mode "sampled" the nearest points of
             the strided sample of `entry_samples` points (the port's
             models/entry.sampled_entry_topb): the `beam_width` nearest,
             ties to the lower sample index, the best repeated where the
             sample is smaller than the beam. The entries seed the first
             slots of the worklist, already expanded or chosen, and are the
             first parents.
  worklist   L slots (distance, id, visited), sorted by exact squared L2;
             empty slots read (+inf, -1, visited).
  iteration  expand the chosen parents: every neighbor of a parent is a
             candidate unless it is in the worklist, in the visited set, or
             a neighbor of an earlier parent of this iteration (a
             neighbor twice in one row is taken twice, as the port takes
             it); merge the candidates' distances into the worklist and
             keep the best L; choose the next `beam_width` unvisited slots,
             in slot order, as parents, mark them visited and add them to
             the visited set.
  stop       when no slot is left unvisited, or after max_iters - 1
             iterations, max_iters = ceil((L + extra_iters) / beam_width)
             (utils/config.SearchParams.max_iters).
  answer     the worklist's first k slots, with no re-rank
             (parANN.cu:1273-1276), and the walk's length, counted as the
             port counts `SearchStats.iters`: 1 + the iterations made. A
             batch's `iters` is the longest walk of its queries.

Ties break as the port's merge breaks them (ops/merge.merge_worklist, one
stable sort of the worklist followed by the candidates): a candidate at the
distance of a worklist entry goes after it, and candidates at one distance
keep their order, parent by parent and, within a parent, in the order of its
row.

Distances are squared L2, sum((q - v)^2), in float32 with TF32 off. For u8
vectors and integer-valued queries every term and every partial sum is an
integer below 2^24, so each distance is exact, whatever the order of the
sum: the port's ||v||^2 - 2 q.v + ||q||^2 gives the same float32 number,
and the two walks agree bit for bit. For float vectors the two forms round
differently, and near-ties may fall the other way.

Where this departs from parANN.cu:90-998, in the port's way:
  * the visited set is exact (the worklist's ids and the parents chosen so
    far), where parANN.cu keeps a per-query bloom filter with one hash
    (:1012-1072); a node dropped from the worklist before it was expanded
    may come back, which the bloom filter forbids;
  * beam_width parents an iteration, where parANN.cu expands one;
  * the iteration budget counts iterations of the beam, ceil((L +
    extra_iters) / beam_width), where parANN.cu counts L + extra
    expansions (:53, :370);
  * the "sampled" entry is the port's; parANN.cu starts at the medoid
    (:988-999);
  * the merge's tie order is that of a stable sort (above), where
    parANN.cu's fused sort and merge (:1499-1695) sets its own;
  * distances stay squared (no square root) and are not rounded to a lower
    precision.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float("inf")


def max_iters(L: int, extra_iters: int, beam_width: int) -> int:
    """The walk's budget, as utils/config.SearchParams.max_iters defines it."""
    return -(-(L + extra_iters) // beam_width)


def _distances(vectors: torch.Tensor, ids, q: torch.Tensor) -> list:
    """Exact squared L2 of q to the rows `ids` of `vectors`, as floats."""
    if not ids:
        return []
    idx = torch.as_tensor(ids, dtype=torch.long, device=vectors.device)
    v = vectors[idx].to(torch.float32)
    return ((v - q) ** 2).sum(-1).tolist()


def _sampled_entries(vectors: torch.Tensor, q: torch.Tensor, n_samples: int, b: int):
    """The `b` nearest points of the strided sample of `n_samples` points,
    ties to the lower sample index, the best repeated past the sample's
    size: (ids, distances)."""
    n = vectors.shape[0]
    s = int(min(n_samples, n))
    stride = max(1, n // s)
    sample = [(i * stride) % n for i in range(s)]
    d = _distances(vectors, sample, q)
    order = sorted(range(s), key=lambda i: d[i])[: min(b, s)]
    ids = [sample[i] for i in order]
    dists = [d[i] for i in order]
    while len(ids) < b:
        ids.append(ids[0])
        dists.append(dists[0])
    return ids, dists


def _search_one(graph, vectors: torch.Tensor, q: torch.Tensor, medoid: int, L: int,
               k: int, beam_width: int, budget: int, entry_mode: str = "medoid",
               entry_samples: int = 1024):
    """One query's walk: (ids [k], distances [k], walk length). `graph` is
    a list of rows of ids (negative ids are padding), `q` the query as a
    float32 tensor on the vectors' device, `budget` the walk's max_iters."""
    if entry_mode == "sampled":
        entries, entry_d = _sampled_entries(vectors, q, entry_samples, beam_width)
    elif entry_mode == "medoid":
        entries, entry_d = [int(medoid)], _distances(vectors, [int(medoid)], q)
    else:
        raise ValueError(f"unknown entry_mode {entry_mode!r}")
    wl = [(INF, -1, True)] * L  # (distance, id, visited), sorted by distance
    for j, (e, d) in enumerate(zip(entries, entry_d)):
        wl[j] = (d, e, True)
    parents = list(entries)
    visited = set(entries)
    it = 1
    while it < budget and parents:
        in_wl = {i for _, i, _ in wl}
        earlier = set()  # every neighbor of this iteration's earlier parents
        new = []
        for p in parents:
            row = [int(x) for x in graph[p]]
            new += [x for x in row
                    if x >= 0 and x not in in_wl and x not in visited and x not in earlier]
            earlier.update(row)
        cand = [(d, x, False) for d, x in zip(_distances(vectors, new, q), new)]
        wl = sorted(wl + cand, key=lambda e: e[0])[:L]  # stable: the worklist first
        wl = [(d, i, vis or i < 0) for d, i, vis in wl]
        picks = [j for j, (_, _, vis) in enumerate(wl) if not vis][:beam_width]
        parents = [wl[j][1] for j in picks]
        for j in picks:
            wl[j] = (wl[j][0], wl[j][1], True)
        visited.update(parents)
        it += 1
    head = wl[:k]
    return [i for _, i, _ in head], [d for d, _, _ in head], it


def search(graph, vectors, medoid: int, queries, L: int, k: int, beam_width: int = 1,
           extra_iters: int = 50, entry_mode: str = "medoid", entry_samples: int = 1024):
    """BANG_Exactdistance's search of each query on its own.

    graph: [N, R] ids (numpy or a tensor; negative ids are padding);
    vectors: [N, D] (numpy or a tensor, on any device); queries: [Q, D].
    L, k, beam_width, extra_iters, entry_mode and entry_samples as
    utils/config.SearchParams has them. Returns (ids [Q, k] int64,
    distances [Q, k] float32, walks [Q] int64: each walk's length in the
    units of SearchStats.iters)."""
    if not 1 <= k <= L:
        raise ValueError(f"need 1 <= k <= L, got k={k}, L={L}")
    vectors = torch.as_tensor(vectors)
    rows = torch.as_tensor(graph).cpu().numpy()
    queries = torch.as_tensor(queries).to(vectors.device, torch.float32)
    budget = max_iters(L, extra_iters, beam_width)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = [_search_one(rows, vectors, q, medoid, L, k, beam_width, budget, entry_mode,
                           entry_samples)
               for q in queries]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    ids = np.array([o[0] for o in out], dtype=np.int64).reshape(len(out), k)
    dists = np.array([o[1] for o in out], dtype=np.float32).reshape(len(out), k)
    walks = np.array([o[2] for o in out], dtype=np.int64)
    return ids, dists, walks


def brute_force(vectors, queries, k: int):
    """(ids [Q, k] int64, distances [Q, k] float32) of the k nearest rows,
    by exact squared L2, ties to the lower id: the walk's answer when L >= N
    (every point then fits the worklist)."""
    vectors = torch.as_tensor(vectors)
    queries = torch.as_tensor(queries).to(vectors.device, torch.float32)
    v = vectors.to(torch.float32)
    d = torch.stack([((v - q) ** 2).sum(-1) for q in queries])
    dists, ids = torch.sort(d, dim=1, stable=True)
    return ids[:, :k].cpu().numpy(), dists[:, :k].cpu().numpy()

