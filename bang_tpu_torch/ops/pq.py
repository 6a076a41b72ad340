"""Product-Quantization ops: distance-table construction and code lookup.

Port of bang_tpu/ops/pq.py. The reference kernels it re-designs are
`populate_pqDist_par` (BANG_Base/bang_search.cu:1083-1130; here one batched
float32 matmul over all queries, via the norm expansion on zero-padded
per-chunk layouts) and the PQ path of `compute_neighborDist_par`
(:1201-1241; here `pq_lookup`, a flat per-query gather summed over chunks).

`pq_lookup` over f32 tables is the CPU's in-memory lookup (the JAX
package's `impl="auto"` route there); over `unpack_tables(packed)` it is
the plain version of the CUDA kernels that read bf16-pair tables
(`ops/pq_kernels.py`, `ops/probe_kernels.py`) and the oracle the tests hold
them against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PQCodebook:
    """Device-ready padded-chunk codebook.

    piv_chunks: [m, 256, dmax] f32 — per-chunk pivot coords, zero-padded.
    piv_norms:  [m, 256] f32 — per-chunk squared pivot norms.
    dim_idx:    [m, dmax] int64 — source dim of each padded slot (clipped).
    dim_mask:   [m, dmax] f32 — 1 for real dims, 0 for padding.
    centroid:   [D] f32.
    """

    piv_chunks: torch.Tensor
    piv_norms: torch.Tensor
    dim_idx: torch.Tensor
    dim_mask: torch.Tensor
    centroid: torch.Tensor

    @property
    def num_chunks(self) -> int:
        return self.piv_chunks.shape[0]

    def to(self, device) -> "PQCodebook":
        """This codebook on `device` (itself when it is there already)."""
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)})

    @classmethod
    def from_numpy(cls, piv_chunks, piv_norms, dim_idx, dim_mask, centroid, device):
        """Build from numpy leaves (the same five arrays the JAX codebook
        holds), placed on `device`."""
        return cls(
            piv_chunks=torch.tensor(np.asarray(piv_chunks, np.float32), device=device),
            piv_norms=torch.tensor(np.asarray(piv_norms, np.float32), device=device),
            dim_idx=torch.tensor(np.asarray(dim_idx, np.int64), device=device),
            dim_mask=torch.tensor(np.asarray(dim_mask, np.float32), device=device),
            centroid=torch.tensor(np.asarray(centroid, np.float32), device=device),
        )


def prepare_pq_codebook(
    pivots: np.ndarray, centroid: np.ndarray, chunk_offsets: np.ndarray, device
) -> PQCodebook:
    """Convert the DiskANN codebook layout ([256, D] + offsets) to padded
    chunks on `device` (same numpy math as the JAX version, so the leaves
    are bit-identical)."""
    offsets = np.asarray(chunk_offsets, dtype=np.int64)
    m = len(offsets) - 1
    sizes = offsets[1:] - offsets[:-1]
    dmax = int(sizes.max())
    dim_idx = np.minimum(
        offsets[:-1, None] + np.arange(dmax)[None, :], pivots.shape[1] - 1
    )
    dim_mask = (np.arange(dmax)[None, :] < sizes[:, None]).astype(np.float32)
    # pivots.T is [D, 256]; pivots.T[dim_idx] is [m, dmax, 256]
    piv_chunks = (
        pivots.T[dim_idx].transpose(0, 2, 1) * dim_mask[:, None, :]
    ).astype(np.float32)
    piv_norms = (piv_chunks * piv_chunks).sum(-1).astype(np.float32)
    assert piv_chunks.shape == (m, 256, dmax)
    return PQCodebook.from_numpy(
        piv_chunks, piv_norms, dim_idx, dim_mask, centroid, device
    )


def pq_distance_tables(codebook: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """Per-query PQ distance tables: [Q, m, 256] f32, contiguous.

    queries: [Q, D] (cast to float32; already MIPS-transformed if
    applicable). Full float32 (TF32 is off, see device.py). The sums are
    made in place in `cross`, so a batch holds one [Q, m, 256] temporary,
    not three; each entry is (-2 cross + piv_norm) + q_norm, the same bits
    as piv_norm - 2 cross + q_norm."""
    qc = (queries.float() - codebook.centroid)[:, codebook.dim_idx]
    qc = qc * codebook.dim_mask  # [Q, m, dmax], zero-padded
    cross = torch.einsum("qct,cjt->qcj", qc, codebook.piv_chunks)
    q_norms = (qc * qc).sum(-1)  # [Q, m]
    tables = cross.mul_(-2.0).add_(codebook.piv_norms[None]).add_(q_norms[:, :, None])
    return tables.contiguous()


def pack_tables(tables: torch.Tensor) -> torch.Tensor:
    """[Q, m, 256] f32 distance tables -> [Q, m, 128] int32 bf16 pairs, the
    table form of the JAX package's Pallas kernels (`pq_pallas.pack_tables`)
    and of kernels K1, K2 and K5 (ops/pq_kernels.py, ops/probe_kernels.py).

    f32 -> bf16 rounds to nearest even; word i of a row holds entry 2i in
    its low half-word and entry 2i + 1 in its high one. Built by viewing the
    bf16 row as int32 words (little-endian, as on the CPU and the card), so
    no shift can overflow the sign bit. Bit-identical to the JAX packing."""
    q, m, nc = tables.shape
    if nc != 256:
        raise ValueError(f"tables must be [Q, m, 256], got {tuple(tables.shape)}")
    return tables.to(torch.bfloat16).contiguous().view(torch.int32)


def unpack_tables(packed: torch.Tensor) -> torch.Tensor:
    """[Q, m, 128] int32 bf16 pairs -> [Q, m, 256] f32 (exact: every bf16
    value is an f32)."""
    return packed.contiguous().view(torch.bfloat16).float()


def pq_lookup(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Accumulate PQ distances: out[q, r] = sum_c tables[q, c, codes[q, r, c]].

    tables: [Q, m, 256] f32; codes: [Q, R, m] uint8/int (gathered per
    candidate). Returns [Q, R] f32."""
    q, m, nc = tables.shape
    r = codes.shape[1]
    flat = tables.reshape(q, m * nc)
    offs = torch.arange(m, device=codes.device, dtype=torch.int64) * nc
    idx = codes.long() + offs  # [Q, R, m]
    vals = flat.gather(1, idx.reshape(q, r * m)).reshape(q, r, m)
    return vals.sum(-1)
