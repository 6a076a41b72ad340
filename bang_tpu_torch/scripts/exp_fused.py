"""The fused frontier row on gathered rows: ids and PQ distances from one
row per parent (the counterpart of scripts/exp_fused.py).

Per node, byte-contiguous: [ 4 little-endian id byte-planes of R bytes |
m chunk-major groups of R codes ] (ops/pq_kernels.pack_frontier_rows).
Each timed call gathers each query's beam parents' rows with K6
`row_gather` and decodes them with `fused_lookup` = K5 `frontier_packed`
with 4 id planes. (The search path's K2 reads the rows ungathered, with f32
tables: exp_dma_tiled holds the two side by side.) The JAX script's tile_q
sweep is a TPU grid parameter with no counterpart here.

Sizes: N=1M, R=64, m=64, Q=10K, beam 2, 20 calls per timing.

    python -m bang_tpu_torch.scripts.exp_fused         # on a CUDA card
"""

from __future__ import annotations

import torch

from bang_tpu_torch.ops.pq_kernels import pack_tables
from bang_tpu_torch.ops.probe_kernels import (
    frontier_packed,
    frontier_packed_plain,
    row_gather,
)
from bang_tpu_torch.scripts import _common as cm

N, R, M, Q, BEAM = 1_000_000, 64, 64, 10_000, 2
TAG = "exp_fused"


def fused_lookup(packed_tables, rows, m, r, beam):
    """The probe `fused_lookup`: K5 with 4 id planes over gathered fused rows
    [Q, beam, 4R + m*R]; returns (ids, dists), each [Q, beam*R]."""
    if packed_tables.shape[1] != m or rows.shape[1] != beam:
        raise ValueError(f"m={m}, beam={beam} do not match {tuple(packed_tables.shape)}"
                         f" and {tuple(rows.shape)}")
    return frontier_packed(packed_tables, rows, r, 4)


def main(device="cuda", n=N, r=R, m=M, q=Q, beam=BEAM, iters=cm.ITERS,
         seed=0) -> dict:
    dev, gen = cm.setup(device, seed)
    res = {}
    rows, adj = cm.fused_rows(gen, n, r, m, n, dev)
    packed = pack_tables(cm.tables(gen, q, m, dev))
    pars = cm.shifted(torch.randint(0, n, (q * beam,), generator=gen, device=dev,
                                    dtype=torch.int32), n, iters)

    def call(i):
        g = row_gather(rows, pars[i]).view(q, beam, (4 + m) * r)
        return fused_lookup(packed, g, m, r, beam)

    ids, dists = call(0)
    cm.same("fused_lookup ids", ids, adj[pars[0].long()].reshape(q, beam * r))
    g0 = rows[pars[0].long()].view(q, beam, (4 + m) * r)
    err = cm.dist_err("fused_lookup dists", dists,
                      frontier_packed_plain(packed, g0, r, 4)[1])
    cm.report(res, TAG, "FUSED: K6 gather + fused_lookup (K5, ids + dists)",
              cm.time_ms(call, dev, iters), err)
    return res


if __name__ == "__main__":
    main()
