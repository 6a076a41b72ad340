"""Beyond-device-memory offline index construction: DiskANN-style sharded
Vamana build (port of bang_tpu/formats/bigbuild.py).

The reference delegates billion-point graph construction to DiskANN's
`build_disk_index`, which handles datasets larger than RAM by k-means
sharding with overlapped assignment, a Vamana graph per shard, and a merge
of the per-shard edge lists (README.md:42-58). This module does the same
for datasets whose device-resident build state (vectors + adjacency +
search state) exceeds one device's memory:

  1. k-means shard centers trained on the device (Lloyd iterations);
  2. every point assigned to its `overlap` nearest centers (DiskANN uses 2:
     overlapped membership is what stitches the final graph together);
  3. per shard, its vectors assembled on the device and a Vamana graph
     built there (formats/vamana.py);
  4. per-shard adjacency downloaded, mapped to global ids and merged
     round-robin with dedup (DiskANN's merge_shards scheme) to degree R.

Also here: a deterministic dataset generator that draws any block again on
the device (instead of shipping the data over the host link), and an exact
integer ground truth for u8 data.

Port notes. JAX's `BlockGen` draws with threefry keys; the port draws each
block from a `torch.Generator` on the generator's device, seeded from
(seed, block), so any block can be drawn again but the bytes are not
JAX's, and blocks drawn on the CPU differ from blocks drawn on the card
(the two generators differ). `kmeans_device`'s initial sample differs for
the same reason. Every other function reads any generator object with
`n`, `dim`, `block`, `n_blocks`, `device` and `gen_block(b)` (a tensor or
an array) and, fed the same blocks and the same initial centers, computes
what JAX's does. Ties follow `lax.top_k`: lowest index first (stable
sorts, `argmin`).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from bang_tpu_torch.device import assert_exact_float32, resolve_device
from bang_tpu_torch.formats.accel import _encode_block, _topk_smallest

# ---------------------------------------------------------------------------
# Deterministic blocked dataset generator (on the device)
# ---------------------------------------------------------------------------


class BlockGen:
    """Deterministic clustered u8 dataset, generated block by block on
    `device`.

    Mirrors formats.synthetic.make_clustered_data's structure
    (low-intrinsic-dimension latent clusters mapped through a random linear
    map): point i of block b draws its latent cluster and noise from a
    generator seeded with (seed, b), so any block can be drawn again at any
    time. Consumers that need the data on the device call gen_block()
    again (a matmul) instead of uploading it."""

    def __init__(self, n: int, dim: int, block: int = 1 << 20,
                 n_clusters: int = 4096, intrinsic_dim: int = 16, seed: int = 0,
                 device="cuda"):
        self.n, self.dim, self.block = n, dim, block
        self.n_blocks = -(-n // block)
        self.seed = seed
        self.device = resolve_device(device)
        self.dz = intrinsic_dim
        self.n_clusters = n_clusters
        g = self._generator(1 << 32)  # the centers' and map's own stream
        self.centers_z = torch.randn(n_clusters, intrinsic_dim, generator=g,
                                     device=self.device)
        self.map_a = torch.randn(intrinsic_dim, dim, generator=g,
                                 device=self.device) / np.sqrt(intrinsic_dim)

    def _generator(self, stream: int) -> torch.Generator:
        """A generator for (seed, stream), the pair mixed by splitmix64's
        finalizer: the CPU generator keeps only the seed's low 32 bits."""
        mask = (1 << 64) - 1
        x = (self.seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + 1) & mask
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
        return torch.Generator(device=self.device).manual_seed(x ^ (x >> 31))

    def gen_block(self, b: int) -> torch.Tensor:
        """[block, dim] u8: rows [b*block, (b+1)*block) of the dataset. The
        final block is full-size; rows beyond n are padding that callers
        slice off."""
        assert_exact_float32()
        g = self._generator(b)
        dev = self.device
        ci = torch.randint(0, self.n_clusters, (self.block,), generator=g, device=dev)
        z = self.centers_z[ci] + 0.35 * torch.randn(self.block, self.dz, generator=g,
                                                    device=dev)
        x = z @ self.map_a + 0.02 * torch.randn(self.block, self.dim, generator=g,
                                                device=dev)
        return torch.clamp(torch.round(x * 28.0 + 128.0), 0, 255).to(torch.uint8)


def _block(gen, b: int) -> torch.Tensor:
    """Block b of `gen` as a tensor on gen.device."""
    return torch.as_tensor(gen.gen_block(b), device=gen.device)


def _n_valid(gen, b: int) -> int:
    return min(gen.n - b * gen.block, gen.block)


# ---------------------------------------------------------------------------
# Device k-means (shard centers)
# ---------------------------------------------------------------------------


def _kmeans_step(data_f32: torch.Tensor, centers: torch.Tensor, k: int) -> torch.Tensor:
    """One Lloyd iteration: nearest center (first on ties), then the mean
    of each non-empty cluster. The cluster sums are taken in float64 and
    rounded once to f32: for integer data they are exact whatever the order
    of the card's atomic adds (an f32 index_add_ over 1M u8 rows is not,
    and moved the shards by a few points from run to run), and below 2^24
    a coordinate they equal JAX's f32 one-hot matmul, so both packages
    give the same centers there."""
    d = (centers * centers).sum(-1)[None] - 2.0 * data_f32 @ centers.T
    assign = torch.argmin(d, dim=1)
    sums = torch.zeros(centers.shape, dtype=torch.float64, device=centers.device)
    sums = sums.index_add_(0, assign, data_f32.double()).float()
    counts = torch.bincount(assign, minlength=k).to(torch.float32)
    return torch.where(counts[:, None] > 0, sums / counts.clamp_min(1)[:, None],
                       centers)


def _initial_centers(n: int, k: int, seed: int, device) -> torch.Tensor:
    """k distinct sample rows, drawn from `seed` (JAX draws them with
    jax.random.choice; the draws differ)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randperm(n, generator=g, device=device)[:k]


def kmeans_device(sample_u8, k: int, iters: int = 12, seed: int = 1) -> torch.Tensor:
    """[k, D] f32 centers by Lloyd's on the device sample (rows of a
    tensor, or an array uploaded to the CPU)."""
    assert_exact_float32()
    data = torch.as_tensor(sample_u8).float()
    centers = data[_initial_centers(data.shape[0], k, seed, data.device)]
    for _ in range(iters):
        centers = _kmeans_step(data, centers, k)
    return centers


# ---------------------------------------------------------------------------
# Overlapped shard assignment
# ---------------------------------------------------------------------------


def _assign_block(x_u8: torch.Tensor, centers: torch.Tensor, overlap: int) -> torch.Tensor:
    """Each row's `overlap` nearest centers, nearest first, lowest index
    first on ties (a stable sort, as `lax.top_k`). [B, overlap] u8."""
    xf = x_u8.float()
    d = (centers * centers).sum(-1)[None] - 2.0 * xf @ centers.T
    return torch.sort(d, dim=1, stable=True).indices[:, :overlap].to(torch.uint8)


def assign_shards(gen, centers: torch.Tensor, overlap: int = 2):
    """Each point's `overlap` nearest shard centers (DiskANN's overlapped
    k-means assignment). Returns (host [N, overlap] u8, device
    [n_blocks, block, overlap] u8, kept resident so that shard assembly
    never uploads indices)."""
    assert_exact_float32()
    nb, blk = gen.n_blocks, gen.block
    centers = centers.to(gen.device)
    assign_dev = torch.empty((nb, blk, overlap), dtype=torch.uint8, device=gen.device)
    for b in range(nb):
        assign_dev[b] = _assign_block(_block(gen, b), centers, overlap)
    host = assign_dev.reshape(nb * blk, overlap).cpu().numpy()
    return host[: gen.n], assign_dev


# ---------------------------------------------------------------------------
# Shard vector assembly (on the device; nothing uploaded)
# ---------------------------------------------------------------------------


def gather_shard_vectors(gen, assign_dev: torch.Tensor, shard: int, n_s: int):
    """Shard `shard`'s [n_s, D] u8 vectors on the device, in ascending
    global id order (np.nonzero's order on the host copy): each block drawn
    again and its member rows appended."""
    out = torch.empty((n_s, gen.dim), dtype=torch.uint8, device=gen.device)
    offset = 0
    for b in range(gen.n_blocks):
        nv = _n_valid(gen, b)
        rows = _block(gen, b)[:nv][(assign_dev[b, :nv] == shard).any(-1)]
        if offset + rows.shape[0] > n_s:
            raise ValueError(f"shard {shard} has more than n_s={n_s} members")
        out[offset : offset + rows.shape[0]] = rows
        offset += rows.shape[0]
    if offset != n_s:
        raise ValueError(f"shard {shard} has {offset} members, not n_s={n_s}")
    return out


# ---------------------------------------------------------------------------
# Round-robin merge of per-shard adjacency (DiskANN merge_shards scheme)
# ---------------------------------------------------------------------------


def merge_shard_adj(parts: list[np.ndarray], r: int, n: int,
                    chunk: int = 2_000_000,
                    log=None) -> tuple[np.ndarray, np.ndarray]:
    """Merge `overlap` per-point candidate rows into one [N, r] graph
    (numpy, copied from the JAX package; byte-identical output).

    parts: list of [N, r] int32 arrays (self-id = empty slot / padding).
    Round-robin interleave with dedup, truncated to r — DiskANN's
    merge_shards does exactly this on its overlapped builds. Returns
    (adj [N, r] self-padded, degrees [N]).

    log: heartbeat every 10 chunks (at 100M this stage is minutes of
    host-side numpy)."""
    adj = np.empty((n, r), np.int32)
    degrees = np.empty(n, np.int32)
    o = len(parts)
    for s in range(0, n, chunk):
        if log and (s // chunk) % 10 == 0:
            log(f"merge chunk {s // chunk}/{-(-n // chunk)}")
        e = min(s + chunk, n)
        rows = np.arange(s, e, dtype=np.int32)[:, None]
        # interleave: part0[0], part1[0], part0[1], part1[1], ...
        inter = np.stack([p[s:e] for p in parts], axis=2).reshape(e - s, o * r)
        inter = np.where(inter == rows, -1, inter)  # self = empty slot
        # first-occurrence dedup (argsort trick: stable sort by value, first
        # of each equal-value group wins, scatter the keep mask back)
        order = np.argsort(inter, axis=1, kind="stable")
        sv = np.take_along_axis(inter, order, axis=1)
        is_first = np.concatenate(
            [np.ones((e - s, 1), bool), sv[:, 1:] != sv[:, :-1]], axis=1
        )
        keep = np.zeros_like(is_first)
        np.put_along_axis(keep, order, is_first & (sv >= 0), axis=1)
        # compact kept values to the front, preserving interleave order
        pos = np.argsort(~keep, axis=1, kind="stable")  # kept first
        compacted = np.take_along_axis(inter, pos, axis=1)[:, :r]
        valid = np.take_along_axis(keep, pos, axis=1)[:, :r]
        degrees[s:e] = valid.sum(1)
        adj[s:e] = np.where(valid, compacted, rows)
        del inter, order, sv, keep, pos
    return adj, degrees


# ---------------------------------------------------------------------------
# Exact integer ground truth for u8 data
# ---------------------------------------------------------------------------


def groundtruth_u8_streamed(gen, queries_u8: np.ndarray, k: int,
                            q_block: int = 128):
    """Exact top-k of u8 queries against the whole generated dataset.
    Returns (ids [Q, k] u32, dists [Q, k] f32), ties to the lower id.

    With q = a + 128 and v = b + 128 (a, b int8), ||q - v||^2 = qstat[q] +
    pstat[v] - 2 a.b, where qstat = ||q||^2 - 256 sum(q) and pstat =
    ||v||^2 - 256 sum(v) + 32768 D. Every product a_i b_i is at most 2^14
    and every sum of D <= 1024 of them below 2^24 in magnitude, so a
    float32 GEMM (TF32 off) gives a.b exactly; the three terms are summed
    in int32 and cast, as JAX's s8 x s8 -> s32 path does. The dataset is
    drawn once into a device table of shifted int8 rows."""
    assert_exact_float32()
    dev = gen.device
    nb, blk, d = gen.n_blocks, gen.block, gen.dim
    if d > 1024:
        raise ValueError(f"dim {d}: the f32 cross term is exact only up to D=1024")
    chunks = torch.empty((nb, blk, d), dtype=torch.int8, device=dev)
    pstat = torch.empty((nb, blk), dtype=torch.int32, device=dev)
    for b in range(nb):
        xi = _block(gen, b).to(torch.int32)
        pstat[b] = (xi * xi).sum(-1) - 256 * (xi - 128).sum(-1)
        chunks[b] = (xi - 128).to(torch.int8)

    q_all = torch.as_tensor(np.asarray(queries_u8, np.uint8), device=dev).to(torch.int32)
    nq = q_all.shape[0]
    a_all = (q_all - 128).float()
    qstat_all = (q_all * q_all).sum(-1) - 256 * (q_all - 128).sum(-1) - 32768 * d
    best_d = torch.full((nq, k), float("inf"), device=dev)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=dev)
    for ci in range(nb):
        bf = chunks[ci].float()  # [blk, D], exact
        valid = torch.arange(blk, device=dev) < _n_valid(gen, ci)
        for s in range(0, nq, q_block):
            ab = (a_all[s : s + q_block] @ bf.T).to(torch.int32)  # exact
            dist = (qstat_all[s : s + q_block, None] + pstat[ci][None]
                    - 2 * ab).float()
            dist = dist.masked_fill(~valid[None], float("inf"))  # padding rows
            i, dd = _topk_smallest(dist, min(k, blk))
            cat_d = torch.cat([best_d[s : s + q_block], dd], dim=1)
            cat_i = torch.cat([best_i[s : s + q_block], i + ci * blk], dim=1)
            sel, sel_d = _topk_smallest(cat_d, k)
            best_d[s : s + q_block] = sel_d
            best_i[s : s + q_block] = cat_i.gather(1, sel)
    return (best_i.cpu().numpy().astype(np.uint32), best_d.cpu().numpy())


def d2h_chunked(arr: torch.Tensor, chunk_bytes: int = 1 << 28, log=None) -> np.ndarray:
    """`arr` in host memory, copied in row chunks of about `chunk_bytes`
    (plain `.cpu()` per chunk), with a progress line per chunk when `log`
    is given."""
    n = arr.shape[0]
    row_bytes = max(1, int(np.prod(arr.shape[1:])) * arr.element_size())
    rows = max(1, chunk_bytes // row_bytes)
    out = np.empty(tuple(arr.shape), arr[:0].cpu().numpy().dtype)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        out[s:e] = arr[s:e].cpu().numpy()
        if log:
            log(f"d2h {e}/{n} rows")
    return out


# ---------------------------------------------------------------------------
# Streamed helpers: medoid, PQ encoding, host materialization
# ---------------------------------------------------------------------------


def medoid_streamed(gen) -> int:
    """Dataset medoid (the point nearest the mean), two streamed passes:
    exact integer column sums, then the f32 distance of every point to the
    f32 mean (first on ties)."""
    tot = np.zeros(gen.dim, np.int64)
    for b in range(gen.n_blocks):
        tot += _block(gen, b)[: _n_valid(gen, b)].to(torch.int64).sum(0).cpu().numpy()
    mean = torch.as_tensor((tot / gen.n).astype(np.float32), device=gen.device)
    best_d, best_i = np.inf, 0
    for b in range(gen.n_blocks):
        nv = _n_valid(gen, b)
        d = ((_block(gen, b)[:nv].float() - mean[None]) ** 2).sum(-1)
        i = int(torch.argmin(d))
        dv = float(d[i])
        if dv < best_d:
            best_d, best_i = dv, b * gen.block + i
    return best_i


_ENCODE_ROWS = 65536


def encode_pq_streamed(gen, pq) -> np.ndarray:
    """PQ-encode the generated dataset on the device, block by block and
    _ENCODE_ROWS rows at a time ([N, m] u8; formats/accel._encode_block,
    the JAX encoder's math). The row split bounds the [rows, m, 256] f32
    distances (4.3 GB at m=64, where a 2^20-row block would need 69 GB);
    JAX encodes a whole block in one program."""
    from bang_tpu_torch.ops.pq import prepare_pq_codebook

    assert_exact_float32()
    cb = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, gen.device)
    codes = np.empty((gen.n, cb.num_chunks), np.uint8)
    for b in range(gen.n_blocks):
        x = _block(gen, b)[: _n_valid(gen, b)]
        for s in range(0, x.shape[0], _ENCODE_ROWS):
            xc = x[s : s + _ENCODE_ROWS].float() - cb.centroid
            c = _encode_block(xc[:, cb.dim_idx] * cb.dim_mask, cb.piv_chunks)
            at = b * gen.block + s
            codes[at : at + c.shape[0]] = c.cpu().numpy()
    return codes


def materialize_host(gen, log=None) -> np.ndarray:
    """The whole generated dataset in host RAM ([N, D] u8), needed once to
    write the packed `_disk.bin` host-graph file; bit-identical to the
    device's blocks (the same draws)."""
    out = np.empty((gen.n, gen.dim), np.uint8)
    for b in range(gen.n_blocks):
        nv = _n_valid(gen, b)
        out[b * gen.block : b * gen.block + nv] = _block(gen, b)[:nv].cpu().numpy()
        if log and b % 10 == 0:
            log(f"materialize block {b}/{gen.n_blocks}")
    return out


# ---------------------------------------------------------------------------
# The sharded build driver
# ---------------------------------------------------------------------------


def shard_build_hbm_bytes(n_s: int, d: int, r: int, batch: int,
                          l_build: int, k_overflow: int | None = None) -> int:
    """Peak device-memory model of one shard's formats/vamana.
    build_vamana_graph call in the port: the persistent tensors plus the
    largest stage of a batch. It holds for the captured build as for the
    eager one: a pass's first batch runs eagerly (its transients freed
    between stages), and the captured insert's private pool, taken after
    the allocator's cache is emptied, reuses the freed stages' blocks
    inside the graph, so it peaks at the same largest stage (chip_smoke
    phase 15 measured 0.99x this model for each shard of both builds;
    phase 19 the same peak for the eager and the captured build).

    Persistent: the shard's u8 vectors, f32 norms, int32 adjacency and
    degrees. Stages, each f32 [rows, pool, D] for the candidate vectors
    plus two temporaries of that size in the robust prune's loop (a
    difference and its square) and the u8 gather before the cast:
      prune     batch x (max_iters + r) candidates;
      overflow  k_overflow x 2r (current edges + incoming);
      traversal batch x r per step (u8 gather, cast, square);
      norms     the [n_s, D] f32 cast and its square, once at the start.
    The JAX function models XLA's buffers, which the port does not have;
    chip_smoke.py phase 15 logs this model beside the measured peak."""
    batch = min(batch, max(256, n_s))  # build_vamana_graph's clamp
    if k_overflow is None:
        k_overflow = max(512, batch)
    max_iters = l_build + 16
    persistent = n_s * (d + 4 + 4 * r + 4)
    per_cand = d * (3 * 4 + 1)
    prune = batch * (max_iters + r) * per_cand
    ovf = k_overflow * 2 * r * per_cand
    iter_gather = batch * r * d * (1 + 4 + 4)
    norms = n_s * d * 8
    return persistent + max(prune, ovf, iter_gather, norms)


# The budget shard_build_hbm_bytes is held to: BANG_SHARD_HBM_BUDGET (bytes)
# when set, else the device's memory when the build starts (the card's total,
# or the host's RAM for a CPU build) less SHARD_HBM_MARGIN, which covers the
# CUDA context, the allocator's rounding and what the build holds besides
# the shard (the resident assignment, a generated block).
SHARD_HBM_BUDGET = (int(float(os.environ["BANG_SHARD_HBM_BUDGET"]))
                    if "BANG_SHARD_HBM_BUDGET" in os.environ else None)
SHARD_HBM_MARGIN = 4_000_000_000


def _budget(dev: torch.device) -> int:
    if SHARD_HBM_BUDGET is not None:
        return SHARD_HBM_BUDGET
    if dev.type == "cuda":
        total = torch.cuda.mem_get_info(dev)[1]
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total - SHARD_HBM_MARGIN


def _warm_rows(init_adj, init_deg, member_ids: np.ndarray):
    """The warm start's seed rows for one shard: the global seed graph's
    neighbor ids mapped to shard-local ids; edges leaving the shard become
    self-padding, and surviving edges are compacted to the row front (the
    builder's reverse-edge slot arithmetic assumes real edges first).
    Returns (local [n_s, r_in] int32, degrees [n_s] int32)."""
    n_s = len(member_ids)
    g_rows = init_adj[member_ids]  # [n_s, r_in] global ids
    if init_deg is not None:
        # padding slots (>= the true degree) hold zeros when the seed was
        # read from a packed _disk.bin; left in place they would become
        # edges to node 0 in the shards that hold it: make them self-ids,
        # which the self-edge mask below strips
        d_rows = init_deg[member_ids].astype(np.int32)
        pad = np.arange(g_rows.shape[1], dtype=np.int32)[None, :] >= d_rows[:, None]
        g_rows = np.where(pad, member_ids[:, None].astype(np.int32), g_rows)
    loc = np.searchsorted(member_ids, g_rows)
    loc = np.minimum(loc, n_s - 1).astype(np.int32)
    # a row's self-padding (its own global id) maps to a valid local id but
    # is not an edge: mask it out
    ok = (member_ids[loc] == g_rows) & (g_rows != member_ids[:, None])
    self_col = np.arange(n_s, dtype=np.int32)[:, None]
    local = np.where(ok, loc, self_col)
    order_c = np.argsort(~ok, axis=1, kind="stable")
    return (np.take_along_axis(local, order_c, axis=1),
            ok.sum(axis=1).astype(np.int32))


def build_sharded_vamana(
    gen,
    r: int = 32,
    l_build: int = 32,
    n_shards: int = 6,
    overlap: int = 2,
    batch: int = 8192,
    n_passes: int = 1,
    alpha: float = 1.44,
    kmeans_sample: int = 1 << 21,
    seed: int = 0,
    verbose: bool = True,
    ckpt_dir: str | None = None,
    init_adj: np.ndarray | None = None,
    init_deg: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DiskANN-style sharded build over a generated dataset, on gen.device.

    Returns (adj [N, r] int32 self-padded, degrees [N] int32, assignment
    [N, overlap] u8). Peak device memory is one shard's vectors, adjacency
    and build state (~N*overlap/n_shards points), not the full dataset.
    ckpt_dir: the assignment and each shard's adjacency are saved there and
    reloaded by a later call. init_adj/init_deg: a global seed graph for a
    warm start (a degree upgrade or an extra pass). Raises MemoryError
    when the largest shard's modeled build state exceeds the budget
    (SHARD_HBM_BUDGET)."""
    from bang_tpu_torch.formats.vamana import build_vamana_graph

    t0 = time.time()
    n = gen.n
    dev = gen.device
    budget = _budget(dev)

    def log(msg):
        if verbose:
            print(f"[bigbuild] {msg} t={time.time() - t0:.0f}s",
                  file=sys.stderr, flush=True)

    # an out-of-memory must be a 2-second error, not a failure deep in the
    # build: first the balanced estimate
    est = shard_build_hbm_bytes(-(-n * overlap // n_shards), gen.dim, r, batch,
                                l_build)
    if est > budget:
        raise MemoryError(
            f"balanced shard build models to {est / 1e9:.1f} GB of device memory "
            f"> budget {budget / 1e9:.1f} GB; raise n_shards or lower batch/l_build"
        )

    assign_path = f"{ckpt_dir}/assignment.npy" if ckpt_dir else None
    assign_dev = None  # uploaded when a shard that is not checkpointed needs it
    if assign_path and os.path.exists(assign_path):
        assignment = np.load(assign_path)
        log("assignment loaded from checkpoint")
    else:
        sample = _block(gen, 0)[:kmeans_sample]
        centers = kmeans_device(sample, n_shards, iters=12, seed=seed + 1)
        log(f"kmeans centers done (k={n_shards})")
        assignment, assign_dev = assign_shards(gen, centers, overlap)
        log("assignment done")
        if assign_path:
            np.save(assign_path, assignment)

    # then the exact guard: k-means clusters are unbalanced, and the largest
    # shard sets the peak
    counts = np.array([int((assignment == s).any(axis=1).sum())
                       for s in range(n_shards)])
    worst = shard_build_hbm_bytes(int(counts.max()), gen.dim, r, batch, l_build)
    log(f"shard members min/mean/max = {counts.min()}/{counts.mean():.0f}/"
        f"{counts.max()}; modeled peak {worst / 1e9:.2f} GB (budget "
        f"{budget / 1e9:.1f})")
    if worst > budget:
        raise MemoryError(
            f"largest shard ({counts.max()} members) models to {worst / 1e9:.1f} GB "
            f"of device memory > budget {budget / 1e9:.1f} GB; raise n_shards "
            f"(currently {n_shards}) or lower batch/l_build"
        )

    parts = [np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, r)).copy()
             for _ in range(overlap)]
    rows_written = np.zeros(n, np.int8)
    for s in range(n_shards):
        member_ids = np.nonzero((assignment == s).any(axis=1))[0]
        n_s = len(member_ids)
        ck = f"{ckpt_dir}/shard{s}_adj.npy" if ckpt_dir else None
        if ck is not None and os.path.exists(ck):
            adj_l = np.load(ck)
            log(f"shard {s}: {n_s} members; loaded from checkpoint")
        else:
            log(f"shard {s}: {n_s} members; assembling vectors on device")
            init = None
            if init_adj is not None:
                init = _warm_rows(init_adj, init_deg, member_ids)
            if assign_dev is None:
                # resumed run: the device copy from the host checkpoint
                nb, blk = gen.n_blocks, gen.block
                padded = np.full((nb * blk, overlap), 255, np.uint8)  # joins no shard
                padded[:n] = assignment
                assign_dev = torch.as_tensor(padded.reshape(nb, blk, overlap),
                                             device=dev)
            shard_vecs = gather_shard_vectors(gen, assign_dev, s, n_s)
            adj_dev, deg_dev, _med = build_vamana_graph(
                shard_vecs, r=r, device=dev, l_build=l_build, alpha=alpha,
                batch=batch, seed=seed + 10 + s, n_passes=n_passes,
                verbose=verbose, medoid=int(n_s // 2), return_device=True,
                init=init,
            )
            del shard_vecs
            log(f"shard {s}: graph built; downloading adjacency (chunked)")
            adj_l = d2h_chunked(adj_dev, log=log if verbose else None)
            del adj_dev, deg_dev
            if ck is not None:
                np.save(ck, adj_l)
        log(f"shard {s}: mapping to global ids")
        gids = member_ids.astype(np.int32)
        adj_g = gids[adj_l]  # local -> global (self-padding maps to self)
        # each point stores this shard's rows in its next free overlap slot
        slot = rows_written[gids]
        for o in range(overlap):
            sel = slot == o
            parts[o][gids[sel]] = adj_g[sel]
        rows_written[gids] = slot + 1
        del adj_l, adj_g
    del assign_dev
    log("all shards built; merging")
    adj, degrees = merge_shard_adj(parts, r, n, log=log)
    log("merge done")
    return adj, degrees, assignment
