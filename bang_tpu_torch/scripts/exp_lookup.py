"""The PQ lookup at the 1M bench's operating point (the counterpart of
scripts/exp_lookup.py).

Operating point: Q=10K queries, m=64 chunks, C=128 candidates (beam 2,
R=64). The JAX script timed its lookup kernel `pq_lookup_packed` (v1)
against `lookup_v2`, the same lookup over raw u8 codes [Q, C, m]; both read
bf16-pair tables. On the card both are kernel K1 (csrc/pq_lookup.cu):

  v1  K1 `pq_lookup` over the bf16-pair tables [Q, m, 128], the port's
      scattered in-memory route on the card;
  v2  `lookup_v2` = `lookup_packed`, the same kernel under the probe's name;

and, as a report, how far the bf16 entries move the sums from the f32
tables' (ops/pq.pq_lookup, the CPU's route). Then the script's aligned-row
gather study (rows x row bytes out of a 1M-row table) through K6
`row_gather`. The JAX script's tile_q sweep is a TPU grid parameter with no
counterpart here.

    python -m bang_tpu_torch.scripts.exp_lookup        # on a CUDA card
"""

from __future__ import annotations

import torch

from bang_tpu_torch.ops.pq import pq_lookup as pq_lookup_f32
from bang_tpu_torch.ops.pq_kernels import pack_tables, pq_lookup
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
    """The probe `lookup_v2`: K1 (`lookup_packed`) over u8 codes [Q, C, m]."""
    return lookup_packed(packed_tables, codes)


def main(device="cuda", q=Q, m=M, c=C, n=N, gather_shapes=GATHER_SHAPES,
         iters=cm.ITERS, seed=0) -> dict:
    dev, gen = cm.setup(device, seed)
    res = {}
    tables = cm.tables(gen, q, m, dev)
    packed = pack_tables(tables)
    codes = cm.u8(gen, (q, c, m), dev)

    want = lookup_packed_plain(packed, codes)
    got = pq_lookup(packed, codes)
    err = cm.dist_err("v1 pq_lookup", got, want)
    cm.report(res, TAG, "v1 pq_lookup (K1, bf16-pair tables)",
              cm.time_ms(lambda i: pq_lookup(packed, codes), dev, iters), err)
    err = cm.dist_err("v2 lookup_v2", lookup_v2(packed, codes), want)
    cm.report(res, TAG, "v2 lookup_v2 (K1 as lookup_packed)",
              cm.time_ms(lambda i: lookup_v2(packed, codes), dev, iters), err)
    want_f32 = pq_lookup_f32(tables, codes)
    res["bf16_vs_f32_max_rel"] = float(
        ((got - want_f32).abs() / want_f32.abs().clamp_min(1e-30)).max())
    print(f"[{TAG}] v1 against the f32 tables' sums: max relative difference "
          f"{res['bf16_vs_f32_max_rel']:.3e} (bf16 table entries)", flush=True)
    del tables, packed, codes, got, want, want_f32

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
