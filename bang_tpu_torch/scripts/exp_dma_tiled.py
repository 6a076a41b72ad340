"""The row read behind the fused frontier kernels, on the card (the
counterpart of scripts/exp_dma_tiled.py).

Stages:
  1. `sublane_probe` = K6 `row_gather`: a dynamic row copy of Q*beam = 20K
     rows at the TPU's tiled widths, 40 and 72 sublanes of 128 bytes (the
     8-sublane pad of `_dma_sublanes`), and at the port's flat widths 4,352
     (PQ rows, R=64 m=64) and 8,704 (exact rows, R=64 D=128); every gather
     bit-exact.
  2. frontier, N=1.2M, R=64, m=64, Q=10K, beam 2: K2 `frontier_lookup`
     reading each parent's row itself against K6 + K5 `frontier_packed` on
     the gathered rows, both over the same bf16-pair tables: ids and
     distances identical bit for bit, both timed. Beside them the fused
     route's f32 decode (`frontier_decode_plain`, plain PyTorch, no kernel)
     on the f32 tables the packed ones came from. Alone, this stage times
     K2 in seconds, with no bundle to build:
       python -c "from bang_tpu_torch.scripts import exp_dma_tiled as e;
                  e.frontier_stage(*e.cm.setup('cuda', 0), {})"
  3. exact, N=800K, R=64, D=128, Q=10K, beam 2: K3 `exact_frontier`.

The JAX script's fourth stage, an end-to-end A/B of the flat fused layout
against the DMA-tiled one, has no counterpart: the port has one frontier
layout (flat rows, read in the kernel), so there are not two to compare.
Unlike the JAX script, nothing is caught: a failed stage raises.

    python -m bang_tpu_torch.scripts.exp_dma_tiled     # on a CUDA card
"""

from __future__ import annotations

import torch

from bang_tpu_torch.ops.exact_kernels import exact_frontier, exact_frontier_plain
from bang_tpu_torch.ops.l2 import decode_exact_frontier_rows
from bang_tpu_torch.ops.pq_kernels import (
    frontier_decode_plain,
    frontier_lookup,
    frontier_lookup_plain,
    pack_tables,
)
from bang_tpu_torch.ops.probe_kernels import (
    frontier_packed,
    frontier_packed_plain,
    row_gather,
    row_gather_plain,
)
from bang_tpu_torch.scripts import _common as cm

TILED_WIDTHS = (40 * 128, 72 * 128)  # the TPU's 8-sublane-padded rows
FLAT_WIDTHS = (4352, 8704)  # the port's PQ (R=64 m=64) and exact (D=128) rows
Q, BEAM = 10_000, 2
TAG = "exp_dma_tiled"


def sublane_probe(rows, par):
    """The probe `sublane_probe`: K6 over rows [n, s, 128] (the TPU's tiled
    form, returned as [P*s, 128]) or flat rows [n, S] (returned [P, S])."""
    out = row_gather(rows.reshape(rows.shape[0], -1), par)
    return out.view(-1, 128) if rows.ndim == 3 else out


def sublane_stage(dev, gen, res, n=1_000_000, tiled=TILED_WIDTHS,
                  flat_widths=FLAT_WIDTHS, p=Q * BEAM, iters=cm.ITERS):
    buf = cm.u8(gen, (n * max(tiled + flat_widths),), dev)
    for s, is_tiled in [(w, True) for w in tiled] + [(w, False) for w in flat_widths]:
        flat = buf[: n * s].view(n, s)
        rows = flat.view(n, s // 128, 128) if is_tiled else flat
        pars = cm.shifted(torch.randint(0, n, (p,), generator=gen, device=dev,
                                        dtype=torch.int32), n, iters)
        err = cm.same(f"sublane_probe S={s}", sublane_probe(rows, pars[0]).view(p, s),
                      row_gather_plain(flat, pars[0]))
        kind = f"{s // 128} sublanes x 128" if rows.ndim == 3 else "flat"
        cm.report(res, TAG, f"1: sublane_probe {p} rows of {s}B, {kind} (K6)",
                  cm.time_ms(lambda i: sublane_probe(rows, pars[i]), dev, iters), err)


def frontier_stage(dev, gen, res, n=1_200_000, r=64, m=64, q=Q, beam=BEAM,
                   iters=cm.ITERS):
    rows, adj = cm.fused_rows(gen, n, r, m, n, dev)
    tables = cm.tables(gen, q, m, dev)
    packed = pack_tables(tables)
    pars = cm.shifted(torch.randint(0, n, (q, beam), generator=gen, device=dev,
                                    dtype=torch.int32), n, iters)
    want_ids = adj[pars[0].long()].reshape(q, beam * r)

    ids2, d2 = frontier_lookup(packed, rows, pars[0])
    cm.same("K2 ids", ids2, want_ids)
    err = cm.dist_err("K2 dists", d2, frontier_lookup_plain(packed, rows, pars[0])[1])
    cm.report(res, TAG, "2: K2 frontier_lookup, rows read in-kernel",
              cm.time_ms(lambda i: frontier_lookup(packed, rows, pars[i]), dev, iters),
              err)

    def gathered(i):
        return row_gather(rows, pars[i].view(-1)).view(q, beam, (4 + m) * r)

    ids5, d5 = frontier_packed(packed, gathered(0), r, 4)
    cm.same("K5 ids", ids5, want_ids)
    cm.same("K5 dists against K2", d5, d2)  # the same sums in the same order
    g0 = rows[pars[0].long()]
    err = cm.dist_err("K5 dists", d5, frontier_packed_plain(packed, g0, r, 4)[1])
    cm.report(res, TAG, "2: K6 gather + K5 frontier_packed",
              cm.time_ms(lambda i: frontier_packed(packed, gathered(i), r, 4),
                         dev, iters), err)

    ids_f, _ = frontier_decode_plain(tables, rows, pars[0])
    cm.report(res, TAG, "2: f32 decode, plain PyTorch (ids checked)",
              cm.time_ms(lambda i: frontier_decode_plain(tables, rows, pars[i]),
                         dev, iters),
              cm.same("f32 decode ids", ids_f, want_ids))


def exact_stage(dev, gen, res, n=800_000, r=64, d=128, q=Q, beam=BEAM,
                iters=cm.ITERS):
    rows = cm.exact_rows(gen, n, r, d, n, dev)
    queries = torch.randn((q, d), generator=gen, device=dev) * 50.0
    pars = cm.shifted(torch.randint(0, n, (q, beam), generator=gen, device=dev,
                                    dtype=torch.int32), n, iters)
    ids, dists = exact_frontier(queries, rows, pars[0])
    want_ids, want_d = exact_frontier_plain(queries, rows, pars[0])
    cm.same("K3 ids", ids, want_ids)
    norms = decode_exact_frontier_rows(rows[pars[0].long()], r, d)[1]
    scale = (queries ** 2).sum(1, keepdim=True) + norms.amax(1, keepdim=True)
    err = cm.dist_err("K3 dists", dists, want_d, scale)
    cm.report(res, TAG, "3: K3 exact_frontier, rows read in-kernel",
              cm.time_ms(lambda i: exact_frontier(queries, rows, pars[i]), dev, iters),
              err)


def main(device="cuda", sublane=None, frontier=None, exact=None, iters=cm.ITERS,
         seed=0) -> dict:
    """Run the three stages; `sublane`, `frontier` and `exact` are keyword
    overrides of each stage's sizes (dicts)."""
    dev, gen = cm.setup(device, seed)
    res = {}
    for stage, sizes in ((sublane_stage, sublane), (frontier_stage, frontier),
                         (exact_stage, exact)):
        stage(dev, gen, res, iters=iters, **(sizes or {}))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    main()
