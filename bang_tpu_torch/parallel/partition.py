"""Index partitioning for multi-device search (port of
bang_tpu/parallel/partition.py).

The reference is single-GPU; scaling past one device is the JAX package's
extension, kept here: the *dataset* is split contiguously over the mesh's
'model' axis, each device holds an independent sub-index (its own
navigable graph + PQ codes over a contiguous node range, sharing one PQ
codebook), every device searches its shard for its row's queries, and the
per-shard top-k lists are merged (parallel/sharded.search_sharded). Recall
matches a monolithic index when the per-shard k equals the final k, at the
cost of S searches of N/S-point graphs.

The JAX index's `nbr_codes` (neighbor-aligned code rows) is a TPU layout
the port leaves out (models/index.py); asking for it raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from bang_tpu_torch.device import resolve_device
from bang_tpu_torch.formats import accel, synthetic
from bang_tpu_torch.formats.pq import PQData
from bang_tpu_torch.models.index import _pack_blocks
from bang_tpu_torch.ops.pq import PQCodebook, prepare_pq_codebook
from bang_tpu_torch.ops.pq_kernels import pack_frontier_rows


class Shard(NamedTuple):
    """One shard's index on one device (ShardedIndex.shard)."""

    adj: torch.Tensor  # [n_loc, R] int32 local ids
    vectors: torch.Tensor  # [n_loc, D]
    codes: Optional[torch.Tensor]  # [n_loc, m] u8
    fused_rows: Optional[torch.Tensor]  # [n_loc, R*(4+m)] u8
    codebook: Optional[PQCodebook]
    medoid: int  # local id
    id_base: int  # global id of local id 0


@dataclasses.dataclass
class ShardedIndex:
    """Stacked per-shard index tensors on one device; leading axis = shard.
    `shard(s, device)` places shard s on a mesh device, once per device."""

    adj: torch.Tensor  # [S, n_loc, R] int32 (local ids, self-padded)
    vectors: torch.Tensor  # [S, n_loc, D]
    codes: Optional[torch.Tensor]  # [S, n_loc, m] uint8, None for exact shards
    codebook: Optional[PQCodebook]  # shared by all shards
    medoids: np.ndarray  # [S] int32 local medoid ids
    id_base: np.ndarray  # [S] int32 global id offset of each shard
    fused_rows: Optional[torch.Tensor] = None  # [S, n_loc, R*(4+m)] u8 —
    # per-shard fused frontier rows (local ids, offset by id_base at merge)
    _placed: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def n_shards(self) -> int:
        return self.adj.shape[0]

    @property
    def n_local(self) -> int:
        return self.adj.shape[1]

    def shard(self, s: int, device) -> Shard:
        """Shard s on `device`: views of the stacked tensors when they are
        there already, else one copy, kept for later calls."""
        dev = torch.device(device)
        key = (s, dev)
        if key not in self._placed:
            def on(t):
                return None if t is None else t[s].to(dev)

            self._placed[key] = Shard(
                adj=on(self.adj), vectors=on(self.vectors), codes=on(self.codes),
                fused_rows=on(self.fused_rows),
                codebook=None if self.codebook is None else self.codebook.to(dev),
                medoid=int(self.medoids[s]), id_base=int(self.id_base[s]),
            )
        return self._placed[key]


def build_sharded_index(
    vectors: np.ndarray,
    n_shards: int,
    r: int = 32,
    m: int | None = 16,
    seed: int = 0,
    neighbor_codes: bool = False,
    fused_frontier: bool = False,
    device="cuda",
) -> ShardedIndex:
    """Partition `vectors` contiguously into `n_shards` sub-indices on
    `device`.

    m=None skips PQ (exact-distance shards). One PQ codebook is trained on
    the full dataset on the host (formats/synthetic.train_pq, as JAX's) and
    shared across shards; the codes are encoded with numpy on the CPU (the
    JAX function's encoder) and on the card with formats/accel.encode_pq.
    neighbor_codes=True raises: `nbr_codes` is a TPU layout the port leaves
    out."""
    if neighbor_codes:
        raise ValueError(
            "neighbor_codes asks for the JAX package's nbr_codes layout, a TPU "
            "layout the port leaves out (models/index.py): use "
            "fused_frontier=True or the scattered codes"
        )
    dev = resolve_device(device)
    pq = None
    if m is not None:
        pq = synthetic.train_pq(vectors, m, seed=seed)
        pq.codes = (synthetic.encode_pq(vectors, pq) if dev.type == "cpu"
                    else accel.encode_pq(vectors, pq, dev))
    return partition_index(vectors, n_shards, r, pq, seed, fused_frontier, dev)


def partition_index(
    vectors: np.ndarray,
    n_shards: int,
    r: int,
    pq: PQData | None,
    seed: int = 0,
    fused_frontier: bool = False,
    device="cuda",
) -> ShardedIndex:
    """build_sharded_index's partitioning with a PQ codebook and codes
    already made (`pq` with `codes`; None for exact shards), as a bundle
    holds them.

    Per shard: a kNN + random-edge graph (r - max(2, r//8) nearest, the
    rest random, numpy generator from seed + s), the medoid, and with
    fused_frontier the fused rows on local ids. The kNN graph is the numpy
    formats/synthetic.build_knn_graph on the CPU, exactly as JAX's, and
    formats/accel.build_knn_graph on the card (the same contract; ties
    between equal distances may order differently)."""
    dev = resolve_device(device)
    n = vectors.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} points: pad the dataset to a multiple of "
                         f"n_shards={n_shards}")
    n_loc = n // n_shards
    n_random = max(2, r // 8)
    adj = np.empty((n_shards, n_loc, r), np.int32)
    medoids = np.empty(n_shards, np.int32)
    for s in range(n_shards):
        part = vectors[s * n_loc : (s + 1) * n_loc]
        if dev.type == "cpu":
            adj[s] = synthetic.build_knn_graph(part, r, n_random=n_random,
                                               seed=seed + s)[0]
        else:
            adj[s] = accel.build_knn_graph(part, r, dev, n_random=n_random,
                                           seed=seed + s)[0]
        medoids[s] = synthetic.medoid_of(part)

    codebook = codes = fused = None
    if pq is not None:
        if pq.codes is None:
            raise ValueError("partition_index needs the PQ codes (pq.codes)")
        codebook = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, dev)
        codes = torch.tensor(np.asarray(pq.codes, np.uint8).reshape(n_shards, n_loc, -1),
                             device=dev)
        if fused_frontier:
            m = codes.shape[2]
            fused = torch.empty((n_shards, n_loc, r * (4 + m)), dtype=torch.uint8,
                                device=dev)
            for s in range(n_shards):
                # local neighbor ids: search_sharded offsets the merged top-k
                fused[s] = _pack_blocks(
                    adj[s], r * (4 + m),
                    lambda blk, c=codes[s]: pack_frontier_rows(blk, c), dev)
    return ShardedIndex(
        adj=torch.tensor(adj, device=dev),
        vectors=torch.tensor(np.asarray(vectors).reshape(n_shards, n_loc, -1),
                             device=dev),
        codes=codes,
        codebook=codebook,
        medoids=medoids,
        id_base=np.arange(n_shards, dtype=np.int32) * n_loc,
        fused_rows=fused,
    )
