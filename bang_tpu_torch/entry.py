"""The multi-device dry run (the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`).

JAX fixes its platform and device count when its backend starts, so the
JAX dry run re-executes itself in a subprocess with n virtual CPU devices.
Torch fixes nothing at import: this one runs in-process, on a mesh whose
every position is `device` (the single-controller mesh of
parallel/sharded.py, which may repeat a device).

    python -c "from bang_tpu_torch.entry import dryrun_multichip as d; d(8, 'cpu')"
"""

from __future__ import annotations

import tempfile

import numpy as np


def _tiny_problem(n: int, d: int, q: int, seed: int):
    """Clustered f32 data and queries near data points (JAX's
    `_tiny_problem`)."""
    from bang_tpu_torch.formats import synthetic

    data = synthetic.make_clustered_data(n, d, n_clusters=16, seed=seed)
    rng = np.random.default_rng(seed + 1)
    queries = (data[rng.integers(0, n, q)].astype(np.float32)
               + rng.normal(0, 0.05, (q, d)).astype(np.float32))
    return data, queries


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Build an n_devices (data x model) mesh on `device` and run, on tiny
    shapes: the node-sharded search with beam 2 (scattered codes: K1 on the
    card), the fused-row sharded search at R=64 (K2), and the chunk-sharded
    base variant with sampled entry (K1 on each chunk slice). Prints
    `dryrun_multichip ok: ...`; raises on a wrong shape."""
    from bang_tpu_torch.formats import synthetic
    from bang_tpu_torch.formats.bin_io import load_bin
    from bang_tpu_torch.parallel.base_tp import ShardedBaseSearcher
    from bang_tpu_torch.parallel.partition import build_sharded_index
    from bang_tpu_torch.parallel.sharded import make_mesh, search_sharded
    from bang_tpu_torch.utils.config import SearchParams

    data_ax = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    model_ax = n_devices // data_ax
    mesh = make_mesh(data_ax, model_ax, [device] * n_devices)

    data, queries = _tiny_problem(n=256 * model_ax, d=32, q=8 * data_ax, seed=7)
    params = SearchParams(L=16, k=4, extra_iters=8, beam_width=2)
    si = build_sharded_index(data, n_shards=model_ax, r=12, m=8, seed=7,
                             device=mesh.home)
    ids, _ = search_sharded(mesh, si, queries, params)
    if tuple(ids.shape) != (queries.shape[0], 4):
        raise AssertionError(f"sharded ids {tuple(ids.shape)}")

    si_f = build_sharded_index(data, n_shards=model_ax, r=64, m=8, seed=7,
                               fused_frontier=True, device=mesh.home)
    ids_f, _ = search_sharded(mesh, si_f, queries, params)
    if tuple(ids_f.shape) != (queries.shape[0], 4):
        raise AssertionError(f"fused sharded ids {tuple(ids_f.shape)}")

    with tempfile.TemporaryDirectory() as td:
        prefix = f"{td}/ix"
        synthetic.build_synthetic_index(prefix, n=1024, dim=16, r=8, m=model_ax,
                                        n_queries=8, k=4, seed=8)
        tp = ShardedBaseSearcher(prefix, mesh, n_pipeline_batches=1)
        q2 = load_bin(prefix + "_query.bin", np.float32)
        ids2, _ = tp.search(q2, SearchParams(L=8, k=4, entry_mode="sampled",
                                             entry_samples=64))
    if ids2.shape != (8, 4):
        raise AssertionError(f"chunk-sharded base ids {ids2.shape}")
    print(f"dryrun_multichip ok: mesh=(data={data_ax}, model={model_ax}) on "
          f"{mesh.home}, ids={tuple(ids.shape)}, first row={ids[0].tolist()}, "
          f"fused ids={tuple(ids_f.shape)}, base_tp ids={ids2.shape}", flush=True)
