"""The flat neighbor-codes layout: gather, then lookup (the counterpart of
scripts/exp_flat_lookup.py).

Each node keeps its R neighbors' codes, R*m bytes. The JAX script asked
whether a flat [N, R*m] table beats the lane-padded [N, R, m] one on the TPU
and what a gather costs by itself. On the card [N, R, m] and [N, R*m] are
the same bytes, so its variants A and B are one pipeline here:

  A/B  K6 `row_gather` of each query's beam parents' rows, then
       `lookup_flat` = `lookup_packed` (K1) over the flat [Q, C*m] codes;
  B2   the gather alone;
  C    a 1,000-row gather and C2 the same 1,000 rows 20 times (the fixed
       cost of a gather against its rows).

Sizes: N=1M, R=64, m=64, Q=10K, beam 2, 20 calls per timing.

    python -m bang_tpu_torch.scripts.exp_flat_lookup   # on a CUDA card
"""

from __future__ import annotations

import torch

from bang_tpu_torch.ops.pq_kernels import pack_tables
from bang_tpu_torch.ops.probe_kernels import (
    lookup_packed,
    lookup_packed_plain,
    row_gather,
    row_gather_plain,
)
from bang_tpu_torch.scripts import _common as cm

N, R, M, Q, BEAM = 1_000_000, 64, 64, 10_000, 2
SMALL = 1_000
TAG = "exp_flat_lookup"


def lookup_flat(packed_tables, flat_codes, m):
    """The probe `lookup_flat`: K1 (`lookup_packed`) over flat codes
    [Q, C*m]."""
    q = packed_tables.shape[0]
    return lookup_packed(packed_tables, flat_codes.view(q, -1, m))


def main(device="cuda", n=N, r=R, m=M, q=Q, beam=BEAM, small=SMALL,
         iters=cm.ITERS, seed=0) -> dict:
    dev, gen = cm.setup(device, seed)
    res = {}
    codes_flat = cm.u8(gen, (n, r * m), dev)
    packed = pack_tables(cm.tables(gen, q, m, dev))
    pars = cm.shifted(torch.randint(0, n, (q * beam,), generator=gen, device=dev,
                                    dtype=torch.int32), n, iters)

    def gathered(i):
        return row_gather(codes_flat, pars[i]).view(q, beam * r * m)

    want = lookup_packed_plain(
        packed, row_gather_plain(codes_flat, pars[0]).view(q, beam * r, m))
    err = cm.dist_err("lookup_flat", lookup_flat(packed, gathered(0), m), want)
    cm.report(res, TAG, "A/B: K6 flat gather + lookup_flat (K1)",
              cm.time_ms(lambda i: lookup_flat(packed, gathered(i), m), dev, iters),
              err)
    err = cm.same("flat gather", gathered(0).view(q * beam, -1),
                  row_gather_plain(codes_flat, pars[0]))
    cm.report(res, TAG, "B2: K6 flat gather only",
              cm.time_ms(gathered, dev, iters), err)

    few = cm.shifted(torch.randint(0, n, (small,), generator=gen, device=dev,
                                   dtype=torch.int32), n, iters)
    for name, p in ((f"C: {small}-row x {r * m}B gather (K6)", few),
                    (f"C2: {20 * small}-row x {r * m}B gather (K6)",
                     [x.repeat(20) for x in few])):
        err = cm.same(name, row_gather(codes_flat, p[0]),
                      row_gather_plain(codes_flat, p[0]))
        cm.report(res, TAG, name,
                  cm.time_ms(lambda i, p=p: row_gather(codes_flat, p[i]), dev, iters),
                  err)
    return res


if __name__ == "__main__":
    main()
