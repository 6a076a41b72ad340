"""Per-query bloom-filter visited sets (port of bang_tpu/ops/bloom.py).

The reference's `neighbor_filtering_new` bloom filter
(BANG_Inmemory/parANN.cu:964-1046): each query owns BF_ENTRIES one-byte
cells, and a node is "seen" when both of its hash cells are set. The hashes
are FNV-1a over the 4 little-endian bytes of the node id with two offset
bases, the same positions as the JAX package's for every int32 id
(INVALID_ID included). Bloom semantics allow false positives, never false
negatives.

Layout: u8 [Q, BF + 1], one byte per cell, the JAX package's [Q, BF] plus
one trash column at index BF. JAX drops the inserts of masked-out lanes with
an out-of-range scatter (`mode="drop"`); PyTorch raises there, so the port
aims them at the trash column, which no query reads (the hashes are taken
modulo BF). The first BF cells of each row equal JAX's filter byte for
byte. Every insert writes the value 1, so the scatter is race-free.

The hashes are eager int64 arithmetic: `ids & 0xFFFFFFFF` is the id's
uint32 value, and after each step `(h ^ byte) * prime` is masked back to 32
bits (the product stays below 2^56). Both hashes run as one [2, ...] tensor,
which halves the launches, and a traversal step computes them once for its
query and its insert (`bloom_positions`), as XLA's common-subexpression pass
does for the JAX step. The JAX package has no kernel for the filter either;
a bit-packed filter is a later, measured question (ROADMAP).
"""

from __future__ import annotations

import torch

from bang_tpu_torch.constants import BF_ENTRIES

_FNV_PRIME = 16777619
_FNV_BASES = (2166136261, 0x9747B28C)
_U32 = 0xFFFFFFFF


def new_bloom(q: int, device, bf_entries: int = BF_ENTRIES) -> torch.Tensor:
    """An empty filter for q queries: u8 zeros [q, bf_entries + 1] (the
    last column is the trash column)."""
    return torch.zeros((q, bf_entries + 1), dtype=torch.uint8, device=device)


def bloom_positions(ids: torch.Tensor, bf_entries: int = BF_ENTRIES) -> torch.Tensor:
    """Both hash positions of each id as one int64 tensor [2, *ids.shape]
    in [0, bf_entries): the index bloom_query and bloom_insert read."""
    x = ids.long() & _U32  # the id's uint32 value
    h = torch.empty((2,) + tuple(ids.shape), dtype=torch.int64, device=ids.device)
    for row, base in zip(h, _FNV_BASES):
        row.fill_(base)
    for shift in (0, 8, 16, 24):
        h.bitwise_xor_((x >> shift) & 0xFF).mul_(_FNV_PRIME).bitwise_and_(_U32)
    return h.remainder_(bf_entries)


def bloom_hashes(ids: torch.Tensor, bf_entries: int = BF_ENTRIES):
    """Two hash positions in [0, bf_entries) for each id (int32 tensors
    shaped like `ids`), equal to the JAX package's."""
    h = bloom_positions(ids, bf_entries).to(torch.int32)
    return h[0], h[1]


def bloom_query(bloom: torch.Tensor, ids: torch.Tensor, pos=None) -> torch.Tensor:
    """seen[q, r] = both hash cells set. bloom: [Q, BF + 1] u8 (new_bloom);
    ids: [Q, R] int32; pos: their bloom_positions when already computed.
    Returns [Q, R] bool."""
    if pos is None:
        pos = bloom_positions(ids, bloom.shape[-1] - 1)
    return (bloom.gather(1, pos[0]) & bloom.gather(1, pos[1])) > 0


def bloom_insert(bloom: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                 pos=None) -> torch.Tensor:
    """Set both hash cells of the ids where `mask` [Q, R] is True, in place;
    masked-out lanes write the trash column. pos: the ids' bloom_positions
    when already computed. Returns `bloom`."""
    bf = bloom.shape[-1] - 1
    if pos is None:
        pos = bloom_positions(ids, bf)
    idx = pos.masked_fill(~mask, bf)
    return bloom.scatter_(1, torch.cat([idx[0], idx[1]], dim=1), 1)
