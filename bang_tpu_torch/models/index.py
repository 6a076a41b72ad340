"""Device-resident index of the in-memory variant (port of
bang_tpu/models/index.py; the reference's GPUInstance + IndexLoad,
BANG_Base/bang_search.cuh:53-135).

Two layouts, picked at load time:

  fused rows (default)  `fused_rows` [N, R*(4+m)] u8 — per node its
      neighbors' ids as byte-planes plus their PQ codes chunk-major
      (ops/pq_kernels.pack_frontier_rows). One row read per parent yields
      candidate ids and PQ distances (kernel K2). No adjacency table.
  scattered codes       `adj` [N, R] int32 + `codes` [N, m] u8 — the
      traversal gathers the adjacency row, then each candidate's m-byte
      code row, then runs kernel K1. Costs R x less memory; the only layout
      that fits at the 100M scale BANG_Inmemory targets.

The JAX package's other layouts (`nbr_codes`, `adj_planes`, the DMA-tiled
rows, `nbr_vecs`) are TPU workarounds or other variants and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bang_tpu.formats.graph import GraphIndex, load_graph_index
from bang_tpu.formats.pq import PQData, load_pq
from bang_tpu_torch.device import resolve_device
from bang_tpu_torch.ops.pq import PQCodebook, prepare_pq_codebook
from bang_tpu_torch.ops.pq_kernels import pack_frontier_rows

# Auto-budget for the fused rows on an 80 GB H100. The rows replace the
# adjacency table, so what else stays resident is small next to them: at
# N=10M, D=128 u8, m=64 the vectors and codes take 1.9 GB. A 10K-query
# batch adds transients of ~6 GB at L=512 (PQ tables 0.66 GB, the
# membership compares of exact_new_mask 1.3 GB, the re-rank gather in f32
# 2.7 GB). 48 GB of rows (10M x R=64 x m=64 is 43.5 GB) leaves over 20 GB
# of headroom; above it the scattered-codes layout is used.
FUSED_LAYOUT_BUDGET = 48_000_000_000

# Rows per block when the fused table is assembled on the device: keeps
# the [B, R, m] gathered-codes transient around 256 MB at R = m = 64.
_BUILD_BLOCK = 65_536


@dataclasses.dataclass
class DeviceIndex:
    """Device-resident search index (struct of tensors; metadata on host)."""

    adj: Optional[torch.Tensor]  # [N, R] int32, self-padded — scattered only
    vectors: torch.Tensor  # [N, D] native dtype, for the exact re-rank
    codes: torch.Tensor  # [N, m] uint8 PQ codes
    fused_rows: Optional[torch.Tensor]  # [N, R*(4+m)] u8 — fused layout only
    codebook: PQCodebook
    medoid: int
    n: int
    dim: int


def fused_layout_fits(n: int, r: int, m: int) -> bool:
    """Whether the fused rows of an (N, R, m) index fit FUSED_LAYOUT_BUDGET."""
    return n * r * (4 + m) <= FUSED_LAYOUT_BUDGET


def assemble_device_index(
    adj: np.ndarray,
    vectors: np.ndarray,
    codes: np.ndarray,
    codebook: PQCodebook,
    medoid: int,
    device,
    fused_frontier: bool | None = None,
) -> DeviceIndex:
    """Upload host arrays and build the chosen layout on `device`.

    fused_frontier: True / False force the layout; None picks fused rows
    when they fit FUSED_LAYOUT_BUDGET."""
    dev = resolve_device(device)
    n, r = adj.shape
    m = codes.shape[1]
    if fused_frontier is None:
        fused_frontier = fused_layout_fits(n, r, m)
    codes_t = torch.tensor(np.asarray(codes, np.uint8), device=dev)
    adj_t = fused = None
    if fused_frontier:
        # built on the device in row blocks: only [B, R] adjacency blocks
        # cross the host link, and the full int32 table never sits there
        fused = torch.empty((n, r * (4 + m)), dtype=torch.uint8, device=dev)
        for s in range(0, n, _BUILD_BLOCK):
            blk = torch.tensor(np.asarray(adj[s : s + _BUILD_BLOCK], np.int32),
                               device=dev)
            fused[s : s + len(blk)] = pack_frontier_rows(blk, codes_t)
    else:
        adj_t = torch.tensor(np.asarray(adj, np.int32), device=dev)
    return DeviceIndex(
        adj=adj_t,
        vectors=torch.tensor(np.asarray(vectors), device=dev),
        codes=codes_t,
        fused_rows=fused,
        codebook=codebook,
        medoid=int(medoid),
        n=int(n),
        dim=int(vectors.shape[1]),
    )


def build_device_index(
    graph: GraphIndex, pq: PQData, device, fused_frontier: bool | None = None
) -> DeviceIndex:
    """Assemble a DeviceIndex from host-side containers (GraphIndex, PQData
    with codes) on `device`."""
    if pq.codes is None:
        raise ValueError("the in-memory index needs the PQ codes")
    codebook = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, device)
    return assemble_device_index(
        graph.adj, graph.vectors, pq.codes, codebook, graph.medoid, device,
        fused_frontier,
    )


def device_index_from_files(
    prefix: str,
    device,
    variant: str = "inmemory",
    fused_frontier: bool | None = None,
) -> DeviceIndex:
    """Load an index bundle from `<prefix>_*` files onto `device`.

    fused_frontier: None auto-selects fused rows under FUSED_LAYOUT_BUDGET;
    False forces the scattered-codes layout."""
    if variant != "inmemory":
        raise NotImplementedError(
            f"variant {variant!r} is not ported yet: exactdistance is ROADMAP "
            "Queue 1 item 8, base item 14"
        )
    return build_device_index(
        load_graph_index(prefix), load_pq(prefix), device, fused_frontier
    )
