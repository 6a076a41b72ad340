"""K2 at R=32 against the neighbor-aligned codes' two-gather path (the
counterpart of scripts/exp_fused32.py).

The JAX script validated and timed `_frontier_kernel_r32`, the lane-
rotation body its Mosaic needed for 32-wide rows; K2 (`frontier_lookup`,
csrc/frontier_lookup.cu) takes every R, so here it is K2 at R=32.

  check     K2 at R=32, m=32 over N=1.2M fused rows of random ids below N
            (ids past 2^16 and 2^20 exercise byte planes 2 and 3's low
            bits), Q=512, beam 2 and 4: ids bit-exact against the f32
            decode `frontier_decode_plain`, distances within the probes'
            tolerance of K2's plain version over the same packed tables;
            the largest error against the f32 decode (the bf16 rounding of
            the entries) is reported beside it.
  time_10m  the tuned-10M op point: N=10M, R=32, m=32, beam 2, Q=10K.
            (a) K2 on the fused rows [10M, 1152] u8 (11.5 GB), each
            parent's row read in the kernel; (b) the neighbor-aligned path
            the JAX bundle ran: the byte-plane adjacency gather and decode
            (ops/adjacency.PlaneAdjacency, [10M, 128] u8), the code-row
            gather nbr_codes[parents] ([10M, 1024] u8, 10.2 GB), then K1
            (`pq_lookup`). The tables are made one after the other, each
            freed before the next. K2's bound and share of it, and the
            speedup of (a) over (b), are reported.

Timing: CUDA events around 20 calls after 3 warm-ups, the parents shifted
by the call's index (scripts/_common.time_ms). On the CPU, `main("cpu",
check={...}, time={...})` with tiny sizes runs the plain versions (the
wrappers on CPU tensors) once and times nothing. Nothing is caught: a
mismatch raises.

    python -m bang_tpu_torch.scripts.exp_fused32      # on a CUDA card
"""

from __future__ import annotations

import json

import torch

from bang_tpu_torch.bench import HBM_BYTES_PER_S
from bang_tpu_torch.ops.adjacency import PlaneAdjacency
from bang_tpu_torch.ops.pq_kernels import (
    frontier_decode_plain,
    frontier_lookup,
    frontier_lookup_plain,
    pack_tables,
    pq_lookup,
)
from bang_tpu_torch.ops.probe_kernels import lookup_packed_plain
from bang_tpu_torch.scripts import _common as cm

TAG = "exp_fused32"


def k2_bound_ms(q: int, beam: int, r: int, m: int) -> float:
    """K2's floor: the parents' rows, the packed tables and the ids and
    distances over the card's memory rate (bench.HBM_BYTES_PER_S)."""
    nbytes = q * beam * r * (4 + m) + q * m * 512 + q * beam * r * 8
    return nbytes / HBM_BYTES_PER_S * 1e3


def check(dev, gen, res, n=1_200_000, r=32, m=32, q=512, beams=(2, 4)):
    rows, adj = cm.fused_rows(gen, n, r, m, n, dev)
    tables = cm.tables(gen, q, m, dev)
    packed = pack_tables(tables)
    out = {"n": n, "r": r, "m": m, "q": q, "max_id": int(adj.max())}
    for beam in beams:
        parents = torch.randint(0, n, (q, beam), generator=gen, device=dev,
                                dtype=torch.int32)
        ids, dists = frontier_lookup(packed, rows, parents)
        want_ids, want_f32 = frontier_decode_plain(tables, rows, parents)
        cm.same(f"K2 R={r} beam {beam} ids", ids, want_ids)
        cm.same(f"K2 R={r} beam {beam} ids against the adjacency", ids,
                adj[parents.long()].reshape(q, beam * r))
        err = cm.dist_err(f"K2 R={r} beam {beam} dists", dists,
                          frontier_lookup_plain(packed, rows, parents)[1])
        out[f"beam{beam}_ids_exact"] = True
        out[f"beam{beam}_dist_maxerr"] = err
        out[f"beam{beam}_dist_maxerr_vs_f32"] = float((dists - want_f32).abs().max())
    print(f"[{TAG}] check: {json.dumps(out)}", flush=True)
    res["check_r32"] = out
    del rows, adj


def time_10m(dev, gen, res, n=10_000_000, r=32, m=32, beam=2, q=10_000,
             iters=cm.ITERS):
    packed = pack_tables(cm.tables(gen, q, m, dev))
    pars = cm.shifted(torch.randint(0, n, (q, beam), generator=gen, device=dev,
                                    dtype=torch.int32), n, iters)
    out = {"n": n, "r": r, "m": m, "beam": beam, "q": q}

    fused = cm.u8(gen, (n, r * (4 + m)), dev)  # (a): random ids are only decoded
    ids, dists = frontier_lookup(packed, fused, pars[0])
    want_ids, want_d = frontier_lookup_plain(packed, fused, pars[0])
    cm.same("K2 10M ids", ids, want_ids)
    err = cm.dist_err("K2 10M dists", dists, want_d)
    out["fused_ms"] = cm.time_ms(lambda i: frontier_lookup(packed, fused, pars[i]),
                                 dev, iters)
    cm.report(res, TAG, f"(a) K2 on fused rows, R={r} m={m}, N={n}", out["fused_ms"], err)
    del fused, ids, dists, want_ids, want_d
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    nbr_codes = cm.u8(gen, (n, r * m), dev)
    adj = PlaneAdjacency(cm.u8(gen, (n, 4 * r), dev))

    def nbr_path(i):
        ids = adj(pars[i])  # [Q, beam*R]
        codes = nbr_codes[pars[i].long()].reshape(q, beam * r, m)
        return ids, pq_lookup(packed, codes)

    ids, dists = nbr_path(0)
    codes0 = nbr_codes[pars[0].long()].reshape(q, beam * r, m)
    err = cm.dist_err("nbr_codes path dists", dists, lookup_packed_plain(packed, codes0))
    out["nbr_codes_ms"] = cm.time_ms(nbr_path, dev, iters)
    cm.report(res, TAG, "(b) planes gather + decode, nbr_codes gather, K1",
              out["nbr_codes_ms"], err)
    del nbr_codes, adj, codes0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["k2_bound_ms"] = k2_bound_ms(q, beam, r, m)
    if out["fused_ms"] is not None:
        out["k2_share_of_bound"] = out["k2_bound_ms"] / out["fused_ms"]
        out["speedup_vs_nbr_codes"] = out["nbr_codes_ms"] / out["fused_ms"]
    print(f"[{TAG}] tuned-10M op point: {json.dumps(out)}", flush=True)
    res["tuned10m_op"] = out


def main(device="cuda", check_sizes=None, time_sizes=None, iters=cm.ITERS,
         seed=0) -> dict:
    """`check` then `time_10m`; check_sizes and time_sizes are keyword
    overrides of their sizes (dicts). Returns the results."""
    dev, gen = cm.setup(device, seed)
    res = {"iters": iters}
    check(dev, gen, res, **(check_sizes or {}))
    time_10m(dev, gen, res, iters=iters, **(time_sizes or {}))
    return res


if __name__ == "__main__":
    print(json.dumps(main()))
