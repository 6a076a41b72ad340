"""Device-resident index of the in-memory and exact-distance variants (port
of bang_tpu/models/index.py; the reference's GPUInstance + IndexLoad,
BANG_Base/bang_search.cuh:53-135).

Every index holds the vectors [N, D] in their own dtype and their squared
norms `vector_norms` [N] f32 (computed in float64, then cast, as the JAX
package does). The layouts, picked at load time:

in-memory (PQ traversal, exact re-rank)
  fused rows (default)  `fused_rows` [N, R*(4+m)] u8 — per node its
      neighbors' ids as byte-planes plus their PQ codes chunk-major
      (ops/pq_kernels.pack_frontier_rows). One row read per parent yields
      candidate ids and PQ distances (kernel K2). No adjacency table.
  neighbor-aligned codes (`neighbor_codes=True`)  `nbr_codes` [N, R*m] u8
      + `adj_planes` [N, 4R] u8 + `codes` — per node its neighbors' code
      rows, self-padding included, so one R*m-byte row read a parent
      gives every candidate's codes (kernel K1), and the adjacency as byte
      planes (ops/adjacency.PlaneAdjacency), with no int32 table. The
      scattered `codes` stay for the entry seed, which has no parent.
  scattered codes       `adj` [N, R] int32 + `codes` [N, m] u8 — the
      traversal gathers the adjacency row, then each candidate's m-byte
      code row, then runs kernel K1. Costs R x less memory; the only layout
      that fits at the 100M scale BANG_Inmemory targets.

exact distance (exact traversal, no re-rank)
  fused exact rows (default for u8 data)  `fused_vec_rows` [N, R*(8+D)] u8
      — per node its neighbors' ids and f32 norms as byte-planes plus their
      u8 vectors (ops/l2.pack_exact_frontier_rows). Kernel K3 reads one row
      per parent and yields ids and exact distances. No adjacency table.
  scattered   `adj` — the traversal gathers the adjacency row, then each
      candidate's vector (plain PyTorch, no kernel).
  nbr_vecs (only when asked for)  `adj` + `nbr_vecs` [N, R, D] +
      `nbr_vec_norms` [N, R] — each parent's neighbors' vectors and norms
      as two contiguous rows.

The JAX package auto-selects nbr_vecs for the exact variant: its fused
exact row was a measured dead end on the v5e, where a gather of 8.7 KB u8
rows and the byte decode that followed cost more than the three gathers
they replace (bang_tpu/models/index.py:300-306). On the card K3 reads a
whole row in one pass inside the kernel and decodes it in registers, so the
fused row gives everything nbr_vecs gives plus the ids and the norms, in
one read; the port picks it whenever the vectors are u8 and the rows fit
FUSED_LAYOUT_BUDGET.

In-memory auto-select (`neighbor_codes=None`, `fused_frontier=None`): the
fused rows when they fit FUSED_LAYOUT_BUDGET, else the scattered codes.
The JAX package falls back to the neighbor-aligned codes when R is
outside {32, 64k}, where Mosaic cannot slice its fused rows; the port's
fused rows take any R, so that fallback never arises here and the
neighbor-aligned layout is built only when asked for. JAX's DMA-tiled
fused rows (`fused_frontier="dma"`, [N, s, 128] with an 8-sublane pad) are
the only rows its in-kernel DMA accepts; K2 reads each parent's flat row
in place already, so "dma" builds the flat fused rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bang_tpu_torch.device import resolve_device
from bang_tpu_torch.formats.graph import GraphIndex, load_graph_index
from bang_tpu_torch.formats.pq import PQData, load_pq
from bang_tpu_torch.models import compiled
from bang_tpu_torch.ops.adjacency import pack_adj_planes
from bang_tpu_torch.ops.l2 import pack_exact_frontier_rows
from bang_tpu_torch.ops.pq import PQCodebook, prepare_pq_codebook
from bang_tpu_torch.ops.pq_kernels import pack_frontier_rows

# Auto-budget for the fused rows of either variant on an 80 GB H100. The
# rows replace the adjacency table, so what else stays resident is small
# next to them: at N=10M, D=128 u8, m=64 the vectors and codes take 1.9 GB.
# A 10K-query batch adds transients of ~6 GB at L=512 (PQ tables 0.66 GB,
# the membership compares of exact_new_mask 1.3 GB, the re-rank gather in
# f32 2.7 GB). 48 GB of rows (10M x R=64 x m=64 PQ rows are 43.5 GB; 1M x
# R=64 x D=128 exact rows 8.70 GB, 5.5M of them 47.9 GB) leaves over 20 GB
# of headroom; above it the scattered layout is used.
FUSED_LAYOUT_BUDGET = 48_000_000_000

# Rows per block when a fused table is assembled on the device: keeps the
# gathered transient ([B, R, m] codes, [B, R, D] vectors) around 256-540 MB
# at R = m = 64, D = 128.
_BUILD_BLOCK = 65_536


@dataclasses.dataclass
class DeviceIndex:
    """Device-resident search index (struct of tensors; metadata on host)."""

    adj: Optional[torch.Tensor]  # [N, R] int32, self-padded — not in fused layouts
    vectors: torch.Tensor  # [N, D] native dtype
    vector_norms: torch.Tensor  # [N] f32 squared norms
    codes: Optional[torch.Tensor]  # [N, m] uint8 PQ codes — in-memory only
    fused_rows: Optional[torch.Tensor]  # [N, R*(4+m)] u8 — fused PQ layout
    codebook: Optional[PQCodebook]  # in-memory only
    medoid: int
    n: int
    dim: int
    nbr_vecs: Optional[torch.Tensor] = None  # [N, R, D] — exact nbr_vecs layout
    nbr_vec_norms: Optional[torch.Tensor] = None  # [N, R] f32
    fused_vec_rows: Optional[torch.Tensor] = None  # [N, R*(8+D)] u8 — fused exact
    nbr_codes: Optional[torch.Tensor] = None  # [N, R*m] u8 — neighbor-aligned codes
    adj_planes: Optional[torch.Tensor] = None  # [N, 4R] u8 — byte-plane adjacency

    def to(self, device) -> "DeviceIndex":
        """This index on `device`: a copy of every tensor (every layout's,
        the neighbor-aligned codes and planes included), or the index
        itself when it is there already (parallel/sharded.py places one
        replica per distinct device)."""
        dev = torch.device(device)
        if self.vectors.device == dev:
            return self
        moved = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for name, value in moved.items():
            if isinstance(value, (torch.Tensor, PQCodebook)):
                moved[name] = value.to(dev)
        return DeviceIndex(**moved)


def free_device_index(index: DeviceIndex) -> None:
    """Release an index's device memory now (bang_tpu/models/index.py:252):
    its captured loops and their pools are freed (models/compiled.py;
    their graphs hold the index's tensors), every tensor field, the
    codebook included, is set to None, and on a CUDA index the caching
    allocator's free blocks go back to the card, so
    a bench that loads several multi-GB indices one after another starts
    each on a clean pool. Other references to the tensors keep them alive,
    as in PyTorch anywhere. `BANGSearch.bang_unload` only drops its
    references (ROADMAP, Known differences)."""
    compiled.drop_graphs(index)
    cuda = index.vectors is not None and index.vectors.device.type == "cuda"
    for f in dataclasses.fields(index):
        if isinstance(getattr(index, f.name), (torch.Tensor, PQCodebook)):
            setattr(index, f.name, None)
    if cuda:
        torch.cuda.empty_cache()


def fused_layout_fits(n: int, r: int, m: int) -> bool:
    """Whether the fused PQ rows of an (N, R, m) index fit FUSED_LAYOUT_BUDGET."""
    return n * r * (4 + m) <= FUSED_LAYOUT_BUDGET


LAYOUT_FIELDS = ("fused_rows", "nbr_codes", "adj_planes", "adj", "fused_vec_rows",
                 "nbr_vecs")


def layout_of(index) -> tuple:
    """The layout tensors `index` holds, by name: part of a captured
    search's key (models/compiled.py), so that two layouts of one index
    never share a graph."""
    return tuple(f for f in LAYOUT_FIELDS if getattr(index, f, None) is not None)


def fused_exact_layout_fits(n: int, r: int, d: int) -> bool:
    """Whether the fused exact rows of an (N, R, D) u8 index fit
    FUSED_LAYOUT_BUDGET."""
    return n * r * (8 + d) <= FUSED_LAYOUT_BUDGET


def squared_norms_host(vectors: np.ndarray, block: int = 1_000_000) -> np.ndarray:
    """[N] f32 squared norms, summed in float64 and then cast (the JAX
    package's `vector_norms`), in row blocks to bound the float64 copy."""
    out = np.empty(vectors.shape[0], np.float32)
    for s in range(0, vectors.shape[0], block):
        v = vectors[s : s + block].astype(np.float64)
        out[s : s + block] = (v * v).sum(-1).astype(np.float32)
    return out


def neighbor_code_rows(adj_blk: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[B, R*m] u8: each node's neighbors' code rows, flat, for the
    adjacency rows `adj_blk` [B, R] (self-padding slots give the node's own
    codes, as JAX's `codes[adj]`)."""
    return codes[adj_blk.long()].reshape(adj_blk.shape[0], -1)


def _pack_blocks(adj: np.ndarray, width: int, pack, dev) -> torch.Tensor:
    """Assemble an [N, width] u8 table on `dev` from [B, R] adjacency
    blocks: only the blocks cross the host link, and the full int32 table
    never sits on the device."""
    out = torch.empty((adj.shape[0], width), dtype=torch.uint8, device=dev)
    for s in range(0, adj.shape[0], _BUILD_BLOCK):
        blk = torch.tensor(np.asarray(adj[s : s + _BUILD_BLOCK], np.int32), device=dev)
        out[s : s + len(blk)] = pack(blk)
    return out


def assemble_device_index(
    adj: np.ndarray,
    vectors: np.ndarray,
    codes: np.ndarray,
    codebook: PQCodebook,
    medoid: int,
    device,
    fused_frontier: bool | str | None = None,
    neighbor_codes: bool | None = None,
) -> DeviceIndex:
    """Upload host arrays and build the in-memory layout on `device`.

    neighbor_codes: True builds the neighbor-aligned codes (`nbr_codes`,
    `adj_planes`; no int32 table); False, the JAX meaning, asks for no
    neighbor-aligned codes and no auto-selected fused rows (the scattered
    codes, unless fused_frontier is True); None keeps the auto-select.
    fused_frontier: True (or JAX's "dma") / False force the fused rows or
    not; None picks them when they fit FUSED_LAYOUT_BUDGET. Both tables
    are built on the device in row blocks (`_pack_blocks`): only [B, R]
    adjacency blocks cross the host link, and the [B, R, m] gathered codes
    are the only transient."""
    dev = resolve_device(device)
    n, r = adj.shape
    m = codes.shape[1]
    if fused_frontier == "dma":
        fused_frontier = True  # K2 reads each parent's flat row in place
    if neighbor_codes and fused_frontier:
        raise ValueError("fused_frontier and neighbor_codes pick two layouts; "
                         "ask for one")
    if fused_frontier is None:
        fused_frontier = neighbor_codes is None and fused_layout_fits(n, r, m)
    codes_t = torch.tensor(np.asarray(codes, np.uint8), device=dev)
    adj_t = fused = nbr = planes = None
    if fused_frontier:
        fused = _pack_blocks(adj, r * (4 + m),
                             lambda blk: pack_frontier_rows(blk, codes_t), dev)
    elif neighbor_codes:
        nbr = _pack_blocks(adj, r * m, lambda blk: neighbor_code_rows(blk, codes_t), dev)
        planes = _pack_blocks(adj, 4 * r, pack_adj_planes, dev)
    else:
        adj_t = torch.tensor(np.asarray(adj, np.int32), device=dev)
    return DeviceIndex(
        adj=adj_t,
        vectors=torch.tensor(np.asarray(vectors), device=dev),
        vector_norms=torch.tensor(squared_norms_host(vectors), device=dev),
        codes=codes_t,
        fused_rows=fused,
        codebook=codebook,
        medoid=int(medoid),
        n=int(n),
        dim=int(vectors.shape[1]),
        nbr_codes=nbr,
        adj_planes=planes,
    )


def assemble_exact_index(
    adj: np.ndarray,
    vectors: np.ndarray,
    medoid: int,
    device,
    fused_frontier: bool | None = None,
    neighbor_vectors: bool | None = None,
) -> DeviceIndex:
    """Upload host arrays and build the exact-distance layout on `device`.

    fused_frontier: True forces the fused exact rows (u8 vectors only),
    False keeps the adjacency table; None picks the fused rows when the
    vectors are u8, the rows fit FUSED_LAYOUT_BUDGET and neighbor_vectors
    is not set. neighbor_vectors=True adds the nbr_vecs layout to the
    adjacency table."""
    dev = resolve_device(device)
    n, r = adj.shape
    d = vectors.shape[1]
    u8 = np.asarray(vectors).dtype == np.uint8
    if neighbor_vectors and fused_frontier:
        raise ValueError("fused_frontier and neighbor_vectors pick two layouts; "
                         "ask for one")
    if fused_frontier is None:
        fused_frontier = (not neighbor_vectors and u8
                          and fused_exact_layout_fits(n, r, d))
    if fused_frontier and not u8:
        raise ValueError(f"fused exact rows need u8 vectors, got "
                         f"{np.asarray(vectors).dtype}")
    vectors_t = torch.tensor(np.asarray(vectors), device=dev)
    norms_t = torch.tensor(squared_norms_host(vectors), device=dev)
    index = DeviceIndex(
        adj=None, vectors=vectors_t, vector_norms=norms_t, codes=None,
        fused_rows=None, codebook=None, medoid=int(medoid), n=int(n), dim=int(d),
    )
    if fused_frontier:
        index.fused_vec_rows = _pack_blocks(
            adj, r * (8 + d),
            lambda blk: pack_exact_frontier_rows(blk, vectors_t, norms_t), dev)
        return index
    index.adj = torch.tensor(np.asarray(adj, np.int32), device=dev)
    if neighbor_vectors:
        a = index.adj.long()
        index.nbr_vecs = vectors_t[a]
        index.nbr_vec_norms = norms_t[a]
    return index


def build_device_index(
    graph: GraphIndex, pq: PQData, device, fused_frontier: bool | str | None = None,
    neighbor_codes: bool | None = None,
) -> DeviceIndex:
    """Assemble an in-memory DeviceIndex from host-side containers
    (GraphIndex, PQData with codes) on `device`; fused_frontier and
    neighbor_codes as in assemble_device_index."""
    if pq.codes is None:
        raise ValueError("the in-memory index needs the PQ codes")
    codebook = prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, device)
    return assemble_device_index(
        graph.adj, graph.vectors, pq.codes, codebook, graph.medoid, device,
        fused_frontier, neighbor_codes,
    )


def device_index_from_files(
    prefix: str,
    device,
    variant: str = "inmemory",
    fused_frontier: bool | str | None = None,
    neighbor_vectors: bool | None = None,
    neighbor_codes: bool | None = None,
) -> DeviceIndex:
    """Load an index bundle from `<prefix>_*` files onto `device`.

    fused_frontier picks the fused layout of the variant: None auto-selects
    it (see above), False forces the scattered layout. neighbor_vectors
    (exactdistance only): True builds the nbr_vecs layout. neighbor_codes
    (inmemory only): True builds the neighbor-aligned codes, False the
    scattered codes (assemble_device_index)."""
    if variant == "base":
        raise ValueError("variant 'base' has no device index: its graph stays on "
                         "the host (models/base.BaseVariantSearcher)")
    if variant == "exactdistance":
        if neighbor_codes:
            raise ValueError("neighbor_codes is a layout of the inmemory variant")
        graph = load_graph_index(prefix)
        return assemble_exact_index(graph.adj, graph.vectors, graph.medoid,
                                    device, fused_frontier, neighbor_vectors)
    if variant != "inmemory":
        raise ValueError(f"unknown variant for device index: {variant!r}")
    if neighbor_vectors:
        raise ValueError("neighbor_vectors is a layout of the exactdistance variant")
    return build_device_index(
        load_graph_index(prefix), load_pq(prefix), device, fused_frontier,
        neighbor_codes,
    )
