"""Chunk-sharded (tensor-parallel) PQ distance: codes split over the mesh's
'model' axis by PQ chunk (port of bang_tpu/parallel/pq_tp.py).

At billion scale the PQ codes alone may exceed one device's memory (SIFT1B
x 74 chunks = 74 GB). Shard the *chunk* axis: device i holds codes[:,
i*m_loc:(i+1)*m_loc] and the matching slice of every query's distance
table, computes its partial lookup sum for the candidate batch, and a psum
over 'model' (parallel/sharded.psum, in shard order) yields the full PQ
distance. Communication per lookup is the [Q, C] partial sums, independent
of m and N. The data axis repeats the work in JAX; the port runs the
mesh's first row.

`pq_lookup_tp` is JAX's f32 lookup (no Pallas kernel), plain PyTorch on
any device. `partial_lookup` also takes bf16-pair tables (`pack_tables`),
and then runs K1 (ops/pq_kernels.pq_lookup): the chunk-sharded base step
on the card (parallel/base_tp.py).
"""

from __future__ import annotations

import numpy as np
import torch

from bang_tpu_torch.ops.pq import pq_lookup as pq_lookup_f32
from bang_tpu_torch.ops.pq_kernels import pq_lookup
from bang_tpu_torch.parallel.sharded import Mesh, psum


def shard_codes_by_chunk(codes: np.ndarray, n_shards: int) -> np.ndarray:
    """[N, m] codes -> [S, N, m/S] stacked chunk shards (numpy)."""
    n, m = codes.shape
    if m % n_shards:
        raise ValueError(f"m={m}: pad m to a multiple of the model axis {n_shards}")
    m_loc = m // n_shards
    return np.stack([codes[:, s * m_loc : (s + 1) * m_loc] for s in range(n_shards)])


def shard_tables_by_chunk(tables: torch.Tensor, n_shards: int) -> torch.Tensor:
    """[Q, m, W] tables (W = 256 f32 entries, or 128 int32 bf16 pairs) ->
    [S, Q, m/S, W] stacked chunk shards; each shard contiguous."""
    q, m, w = tables.shape
    if m % n_shards:
        raise ValueError(f"m={m}: pad m to a multiple of the model axis {n_shards}")
    return tables.reshape(q, n_shards, m // n_shards, w).transpose(0, 1).contiguous()


def partial_lookup(tables: torch.Tensor, codes: torch.Tensor,
                   cand: torch.Tensor) -> torch.Tensor:
    """One shard's partial PQ distances [Q, C] f32 over its chunk slice.

    tables: [Q, m_loc, 256] f32 (ops/pq.pq_lookup) or [Q, m_loc, 128]
    int32 bf16 pairs (K1, ops/pq_kernels.pq_lookup: the kernel on a CUDA
    tensor, its plain version on a CPU one); codes: [N, m_loc] u8; cand:
    [Q, C] ids; all on one device."""
    local = codes[cand.long()]  # [Q, C, m_loc]: this shard's chunk slice
    if tables.dtype == torch.int32:
        return pq_lookup(tables, local)
    return pq_lookup_f32(tables, local)


def pq_lookup_tp(mesh: Mesh, tables_sharded, codes_sharded, cand_ids) -> torch.Tensor:
    """Distributed PQ lookup: out[q, r] = full-m distance, via partial sums.

    tables_sharded: [S, Q, m/S, W] (or S tensors, one per shard);
    codes_sharded: [S, N, m/S] numpy or tensor (or S tensors); cand_ids:
    [Q, R]. Shard s runs on mesh.devices[0][s] (inputs already there are not
    copied). Returns [Q, R] f32 on mesh.home."""
    row = mesh.devices[0]
    if len(tables_sharded) != len(row) or len(codes_sharded) != len(row):
        raise ValueError(f"{len(tables_sharded)} table and {len(codes_sharded)} code "
                         f"shards for a 'model' axis of {len(row)}")
    cand = torch.as_tensor(cand_ids)
    parts = [
        partial_lookup(torch.as_tensor(t).to(dev), torch.as_tensor(c).to(dev),
                       cand.to(dev))
        for dev, t, c in zip(row, tables_sharded, codes_sharded)
    ]
    return psum(parts, mesh.home)
