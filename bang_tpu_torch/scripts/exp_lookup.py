"""The PQ lookup at the 1M bench's operating point, K1 beside K4 (the
counterpart of scripts/exp_lookup.py).

Operating point: Q=10K queries, m=64 chunks, C=128 candidates (beam 2,
R=64). The JAX script timed its lookup kernel (v1) against `lookup_v2`, the
same lookup over raw u8 codes [Q, C, m]; both read bf16-pair tables. Here:

  v1  K1 `pq_lookup` over f32 tables [Q, m, 256] (the port's search path);
  v2  `lookup_v2` = K4 `lookup_packed` over the bf16-pair tables [Q, m, 128]
      — half the table bytes, the question this probe answers on the card;

then the script's aligned-row gather study (rows x row bytes out of a
1M-row table) through K6 `row_gather`. The JAX script's tile_q sweep is a
TPU grid parameter with no counterpart here.

    python -m bang_tpu_torch.scripts.exp_lookup        # on a CUDA card
"""

from __future__ import annotations

import torch

from bang_tpu_torch.ops.pq_kernels import (
    pack_tables,
    pq_lookup,
    pq_lookup_plain,
)
from bang_tpu_torch.ops.probe_kernels import (
    lookup_packed,
    lookup_packed_plain,
    row_gather,
    row_gather_plain,
)
from bang_tpu_torch.scripts import _common as cm

Q, M, C, N = 10_000, 64, 128, 1_000_000
GATHER_SHAPES = ((10_000, 4096), (20_000, 4096), (20_000, 2048), (40_000, 1024),
                 (10_000, 8192))
TAG = "exp_lookup"


def lookup_v2(packed_tables, codes):
    """The probe `lookup_v2`: K4 over u8 codes [Q, C, m]."""
    return lookup_packed(packed_tables, codes)


def main(device="cuda", q=Q, m=M, c=C, n=N, gather_shapes=GATHER_SHAPES,
         iters=cm.ITERS, seed=0) -> dict:
    dev, gen = cm.setup(device, seed)
    res = {}
    tables = cm.tables(gen, q, m, dev)
    packed = pack_tables(tables)
    codes = cm.u8(gen, (q, c, m), dev)

    want_f32 = pq_lookup_plain(tables, codes)
    err = cm.dist_err("v1 pq_lookup", pq_lookup(tables, codes), want_f32)
    cm.report(res, TAG, "v1 pq_lookup (K1, f32 tables)",
              cm.time_ms(lambda i: pq_lookup(tables, codes), dev, iters), err)
    got = lookup_v2(packed, codes)
    err = cm.dist_err("v2 lookup_v2", got, lookup_packed_plain(packed, codes))
    cm.report(res, TAG, "v2 lookup_v2 (K4, bf16-pair tables)",
              cm.time_ms(lambda i: lookup_v2(packed, codes), dev, iters), err)
    res["bf16_vs_f32_max_rel"] = float(
        ((got - want_f32).abs() / want_f32.abs().clamp_min(1e-30)).max())
    print(f"[{TAG}] v2 against v1's f32 sums: max relative difference "
          f"{res['bf16_vs_f32_max_rel']:.3e} (bf16 table entries)", flush=True)
    del tables, packed, codes, got, want_f32

    for rows, width in gather_shapes:
        tbl = cm.u8(gen, (n, width), dev)
        pars = cm.shifted(torch.randint(0, n, (rows,), generator=gen, device=dev,
                                        dtype=torch.int32), n, iters)
        err = cm.same(f"gather {rows}x{width}", row_gather(tbl, pars[0]),
                      row_gather_plain(tbl, pars[0]))
        cm.report(res, TAG, f"aligned gather {rows} rows x {width}B (K6)",
                  cm.time_ms(lambda i: row_gather(tbl, pars[i]), dev, iters), err)
        del tbl, pars
    return res


if __name__ == "__main__":
    main()
