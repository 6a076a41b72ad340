"""Flat and chunk-major code layouts after a gather (the counterpart of
scripts/exp_flat2.py).

The JAX script asked which in-kernel restructure of flat codes Mosaic
supports and what each costs. On the card none is needed; the variants keep
their names and run on rows that K6 `row_gather` fetches:

  V5  the flat rows viewed as [Q, C, m], then `lookup_packed` (K1);
  V6  `v6` = K1 over the flat [Q, C*m] rows (the same bytes as V5);
  V7  `v7` = K5 `frontier_packed` without id planes over chunk-major rows
      [Q, beam, m*R] (each node's codes transposed to chunk-major).

Sizes: N=1M, R=64, m=64, Q=10K, beam 2, 20 calls per timing.

    python -m bang_tpu_torch.scripts.exp_flat2         # on a CUDA card
"""

from __future__ import annotations

import torch

from bang_tpu_torch.ops.pq_kernels import pack_tables
from bang_tpu_torch.ops.probe_kernels import (
    frontier_packed,
    lookup_packed,
    lookup_packed_plain,
    row_gather,
    row_gather_plain,
)
from bang_tpu_torch.scripts import _common as cm

N, R, M, Q, BEAM = 1_000_000, 64, 64, 10_000, 2
TAG = "exp_flat2"


def v6(packed_tables, flat_codes):
    """The probe `v6`: K1 (`lookup_packed`) over flat codes [Q, C*m]."""
    q, m, _ = packed_tables.shape
    return lookup_packed(packed_tables, flat_codes.view(q, -1, m))


def v7(packed_tables, flat_cm):
    """The probe `v7`: K5 without id planes over chunk-major codes
    [Q, beam, m*R]; returns the distances [Q, beam*R]."""
    m = packed_tables.shape[1]
    return frontier_packed(packed_tables, flat_cm, flat_cm.shape[2] // m, 0)[1]


def main(device="cuda", n=N, r=R, m=M, q=Q, beam=BEAM, iters=cm.ITERS,
         seed=0) -> dict:
    dev, gen = cm.setup(device, seed)
    res = {}
    c = beam * r
    codes_flat = cm.u8(gen, (n, r * m), dev)
    codes_cm = codes_flat.view(n, r, m).transpose(1, 2).reshape(n, m * r)
    packed = pack_tables(cm.tables(gen, q, m, dev))
    pars = cm.shifted(torch.randint(0, n, (q * beam,), generator=gen, device=dev,
                                    dtype=torch.int32), n, iters)
    want = lookup_packed_plain(
        packed, row_gather_plain(codes_flat, pars[0]).view(q, c, m))

    def v5_call(i):
        return lookup_packed(packed, row_gather(codes_flat, pars[i]).view(q, c, m))

    def v6_call(i):
        return v6(packed, row_gather(codes_flat, pars[i]).view(q, c * m))

    def v7_call(i):
        return v7(packed, row_gather(codes_cm, pars[i]).view(q, beam, m * r))

    for name, fn in (("V5: K6 flat gather + view + lookup_packed (K1)", v5_call),
                     ("V6: K6 flat gather + v6 (K1)", v6_call),
                     ("V7: K6 chunk-major gather + v7 (K5, no ids)", v7_call)):
        err = cm.dist_err(name, fn(0), want)
        cm.report(res, TAG, name, cm.time_ms(fn, dev, iters), err)
    return res


if __name__ == "__main__":
    main()
