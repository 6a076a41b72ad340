"""Chunk-sharded base variant: host-RAM graph + PQ codes split across
devices (port of bang_tpu/parallel/base_tp.py).

For code matrices too large for one device (SIFT1B x m=74: 74 GB of
codes). The base design stays as it is — the graph in host RAM, the native
host gather, the pipelined sub-batches (models/base.py) — and the PQ
**chunk axis** is split over the mesh's 'model' axis: device i holds
codes[:, i*m/S:(i+1)*m/S] and the matching slice of each sub-batch's
tables; each step computes its partial lookup there and one psum over
'model' (in shard order, on the searcher's device) yields the full
distances (parallel/pq_tp.py). Everything else (the visited filter, the
worklist merge, the parent selection) is models/base._step_core, run once
on mesh.home; the data axis, which JAX replicates, is not used.

Each shard's partial lookup runs K1 (ops/pq_kernels.pq_lookup) on its
packed chunk slice when the tables are packed, and the f32 lookup
otherwise: `pq_impl` picks as in the base searcher (models/traversal.
packs_tables: "auto" packs on the card, "pallas" everywhere, "xla" never;
JAX's "pallas_interp" is K1's plain version on CPU tensors). A chunk axis that S does not divide is padded with zero codes
and zero tables: the padded chunks add 0.
"""

from __future__ import annotations

import numpy as np
import torch

from bang_tpu_torch.models.base import BaseVariantSearcher, _step_core
from bang_tpu_torch.models.traversal import packs_tables
from bang_tpu_torch.ops.pq import pack_tables, pq_distance_tables
from bang_tpu_torch.parallel.pq_tp import pq_lookup_tp, shard_tables_by_chunk
from bang_tpu_torch.parallel.sharded import Mesh


def make_base_step_tp(mesh: Mesh):
    """The chunk-sharded device step for `mesh`: `step_tp(state, nbrs,
    parent_vecs, queries_f32, tables_sharded, codes_sharded, beam)`, the
    psum'd partial lookups of the S shards (tables and codes: one per shard,
    on mesh.devices[0][s]) and then the shared step core on mesh.home.
    Returns what models/base._step_core returns."""

    def step_tp(state, nbrs, parent_vecs, queries_f32, tables_sharded,
                codes_sharded, beam):
        raw = pq_lookup_tp(mesh, tables_sharded, codes_sharded, nbrs)
        return _step_core(state, nbrs, parent_vecs, queries_f32, raw, beam)

    return step_tp


def make_sampled_entry_tp(mesh: Mesh):
    """The chunk-sharded sampled-entry selector (models/base.
    _sampled_entry_base for code matrices that do not fit one device):
    `entry_tp(tables_sharded, codes_sharded, n_samples, b)` -> [Q, B] int32
    on mesh.home.

    Ranking a strided sample by PQ distance is a PQ lookup, so the selector
    runs the step's lookup (partial sums over each shard's chunk slice, one
    psum) on the sample, then the top-B: an argmin for B=1, else a stable
    ascending sort (lowest sample first among ties, as `lax.top_k`)."""

    def entry_tp(tables_sharded, codes_sharded, n_samples, b):
        n = codes_sharded[0].shape[0]
        q = tables_sharded[0].shape[0]
        s_n = int(min(n_samples, n))
        stride = max(1, n // s_n)
        ids = (torch.arange(s_n, device=mesh.home) * stride) % n
        d = pq_lookup_tp(mesh, tables_sharded, codes_sharded,
                         ids[None, :].expand(q, s_n))
        if b == 1:
            idx = torch.argmin(d, dim=1, keepdim=True)
        else:
            idx = torch.sort(d, dim=1, stable=True).indices[:, : min(b, s_n)]
        out = ids[idx].to(torch.int32)
        if b > out.shape[1]:
            out = torch.cat([out, out[:, :1].expand(-1, b - out.shape[1])], dim=1)
        return out

    return entry_tp


def one_device(devices, home) -> bool:
    """Whether every device of `devices` is `home` (a CUDA device without
    an index is the current one)."""
    def canonical(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return all(canonical(d) == canonical(home) for d in devices)


class ShardedBaseSearcher(BaseVariantSearcher):
    """BaseVariantSearcher with the codes and tables chunk-sharded over the
    'model' axis of `mesh`.

    Drop-in: the same search() host loop, pipelining, timers and finish;
    only the tables, the device step and the sampled entries differ. The
    searcher's device (its traversal state, the psum) is mesh.home. The
    [N, m] codes never go whole to one device: they stay in host RAM until
    each shard's chunk slice is copied to its own device.

    When every device of the row is mesh.home (the shards take turns on
    one card), each sub-batch's prologue and step are captured as in the
    base searcher, the S shards' K1 launches and the psum inside the step's
    graph: `captured` is True. A row that spans several devices keeps the
    eager step (`captured` False): one CUDA graph cannot span devices, and
    a graph a shard joined by events waits for a multi-device host (ROADMAP
    Queue 1 item 18)."""

    def __init__(self, prefix: str, mesh: Mesh, **kwargs):
        if "device" in kwargs:
            raise ValueError("the searcher runs on mesh.home; pass no device")
        super().__init__(prefix, keep_codes_on_host=True, device=mesh.home, **kwargs)
        self.mesh = mesh
        row = mesh.devices[0]
        self.captured = one_device(row, mesh.home)
        s = len(row)
        codes = self.codes_np
        self.codes_np = None  # the host copy is not needed after the split
        m = codes.shape[1]
        self._m_padded = -(-m // s) * s
        m_loc = self._m_padded // s
        self.codes_sharded = []
        for i, dev in enumerate(row):
            part = np.zeros((codes.shape[0], m_loc), np.uint8)  # padded chunks: 0
            lo, hi = i * m_loc, min((i + 1) * m_loc, m)
            if hi > lo:
                part[:, : hi - lo] = codes[:, lo:hi]
            self.codes_sharded.append(torch.tensor(part, device=dev))
        self._step = make_base_step_tp(mesh)
        self._entry = make_sampled_entry_tp(mesh)

    def _prepare_tables(self, sub_queries):
        """The sub-batch's tables split by chunk, shard s on
        mesh.devices[0][s]: bf16 pairs (`pack_tables`, read by K1) when
        `self.pq_impl` packs them (on the card by default), else f32; padded
        chunks all zero. "pallas_dma" runs "auto", as in the base
        searcher."""
        t = pq_distance_tables(self.codebook, sub_queries)  # [Q, m, 256]
        pad = self._m_padded - t.shape[1]
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        impl = "auto" if self.pq_impl == "pallas_dma" else self.pq_impl
        if packs_tables(impl, t.device):
            t = pack_tables(t)  # [Q, m, 128] int32
        row = self.mesh.devices[0]
        stacked = shard_tables_by_chunk(t, len(row))
        return [stacked[i].to(dev) for i, dev in enumerate(row)]

    def _run_step(self, state, nbrs, parent_vecs, queries_f32, tables, beam):
        return self._step(state, nbrs, parent_vecs, queries_f32, tables,
                          self.codes_sharded, beam)

    def _select_entries(self, sub_queries, tables, params, beam):
        if params.entry_mode != "sampled":
            return super()._select_entries(sub_queries, tables, params, beam)
        return self._entry(tables, self.codes_sharded, params.entry_samples, beam)
