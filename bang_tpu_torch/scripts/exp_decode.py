"""The exact distance path on f32 vectors against the same vectors
stored as u8 bit views (the counterpart of scripts/exp_decode.py).

A u8 [N, 4D] view of an f32 [N, D] table gathers the same bytes; the
question is what the decode back to f32 (ops/l2.decode_row_gather) costs
on top of the gather and the distances (ops/l2.l2_distance_to_candidates).
Four paths, each a full distance computation of Q=10K queries, D=128:

  scattered  C=64 candidates a query, one row each, at N=1M and N=10M:
             f32 rows, then packed u8 rows + decode;
  aligned    one [64, 128] row block a query (the nbr_vecs analog) from a
             [250K, 64, 128] table: f32, then packed u8 + decode.

The packed path's distances are held bit for bit against the f32 path's
(the decode is a view: the same floats reach the same sums). The JAX
script measured the decode's relayout on the v5e; on the card the decode
is a view of the gathered bytes. CUDA events around 20 calls after 3
warm-ups, the ids shifted by the call's index (scripts/_common.time_ms);
`main("cpu", ...)` with tiny sizes runs each once and times nothing.

    python -m bang_tpu_torch.scripts.exp_decode       # on a CUDA card
"""

from __future__ import annotations

import json

import torch

from bang_tpu_torch.ops.l2 import decode_row_gather, l2_distance_to_candidates
from bang_tpu_torch.scripts import _common as cm

Q, C, D = 10_000, 64, 128
SCATTERED_N = (1_000_000, 10_000_000)
ALIGNED_N, ALIGNED_R = 250_000, 64
TAG = "exp_decode"


def _pair(res, dev, label, f32_table, ids, queries, iters):
    """Time the f32 path and the packed path on one table (`ids`: the
    calls' row ids); hold the packed distances to the f32 ones."""
    d = queries.shape[1]
    packed = f32_table.view(torch.uint8)  # [..., 4D]: the same bytes

    def f32_path(i):
        return l2_distance_to_candidates(queries, f32_table[ids[i].long()].reshape(
            queries.shape[0], -1, d))

    def packed_path(i):
        rows = packed[ids[i].long()].reshape(queries.shape[0], -1, 4 * d)
        return l2_distance_to_candidates(queries, decode_row_gather(rows, d))

    err = cm.same(f"{label} packed against f32", packed_path(0), f32_path(0))
    cm.report(res, TAG, f"{label} f32 gather + l2", cm.time_ms(f32_path, dev, iters), 0.0)
    cm.report(res, TAG, f"{label} packed-u8 gather + decode + l2",
              cm.time_ms(packed_path, dev, iters), err)


def main(device="cuda", q=Q, c=C, d=D, scattered_n=SCATTERED_N, aligned_n=ALIGNED_N,
         aligned_r=ALIGNED_R, iters=cm.ITERS, seed=0) -> dict:
    dev, gen = cm.setup(device, seed)
    res = {"shapes": {"q": q, "c": c, "d": d, "scattered_n": list(scattered_n),
                      "aligned_n": aligned_n, "aligned_r": aligned_r}}
    queries = torch.randn((q, d), generator=gen, device=dev)
    for n in scattered_n:
        vecs = torch.randn((n, d), generator=gen, device=dev)
        ids = cm.shifted(torch.randint(0, n, (q, c), generator=gen, device=dev,
                                       dtype=torch.int32), n, iters)
        _pair(res, dev, f"scattered N={n}", vecs, ids, queries, iters)
        del vecs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    blocks = torch.randn((aligned_n, aligned_r, d), generator=gen, device=dev)
    parents = cm.shifted(torch.randint(0, aligned_n, (q,), generator=gen, device=dev,
                                       dtype=torch.int32), aligned_n, iters)
    _pair(res, dev, f"aligned [{aligned_n},{aligned_r},{d}]", blocks, parents, queries,
          iters)
    del blocks
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    print(json.dumps(main()))
