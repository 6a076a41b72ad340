"""The port's device index (bang_tpu_torch.models.index, convert) against the
JAX package: fused rows byte-identical, layouts chosen alike, and a JAX
index carried over by convert.index_from_jax equal to loading the files."""

import numpy as np
import pytest
import torch

from bang_tpu.formats import synthetic
from bang_tpu.formats.graph import GraphIndex, load_graph_index
from bang_tpu.formats.pq import load_pq
from bang_tpu.models.index import build_device_index as jax_build
from bang_tpu.models.index import device_index_from_files as jax_from_files
from bang_tpu.ops.pq_pallas import pack_frontier_rows as jax_pack
from bang_tpu_torch.convert import index_from_jax
from bang_tpu_torch.models import index as tindex
from bang_tpu_torch.ops.pq_kernels import pack_frontier_rows


def _graph_pq(n, dim, r, m, seed):
    data = synthetic.make_clustered_data(n, dim, n_clusters=8, dtype=np.uint8, seed=seed)
    adj, degrees = synthetic.build_knn_graph(data, r, n_random=4, seed=seed)
    pq = synthetic.train_pq(data, m, kmeans_iters=3, seed=seed)
    pq.codes = synthetic.encode_pq(data, pq)
    return GraphIndex(data, adj, degrees, synthetic.medoid_of(data)), pq


def test_fused_rows_match_jax_build_device_index():
    """R=64: the port's on-device row build equals JAX's
    build_device_index(fused_frontier=True) byte for byte."""
    graph, pq = _graph_pq(1500, 16, 64, 8, seed=1)
    jx = jax_build(graph=graph, pq=pq, fused_frontier=True)
    pt = tindex.build_device_index(graph, pq, "cpu", fused_frontier=True)
    np.testing.assert_array_equal(pt.fused_rows.numpy(), np.asarray(jx.fused_rows))
    assert pt.adj is None and pt.fused_rows.shape == (1500, 64 * (4 + 8))


@pytest.mark.parametrize("r", [32, 64])
def test_pack_frontier_rows_matches_jax(r):
    """Random ids over N > 65,536 rows, so byte plane 2 is non-zero."""
    rng = np.random.default_rng(r)
    n, m = 70_000, 4
    adj = rng.integers(0, n, size=(2000, r), dtype=np.int32)
    codes = rng.integers(0, 256, size=(n, m), dtype=np.uint8)
    want = jax_pack(adj, codes)
    got = pack_frontier_rows(torch.from_numpy(adj), torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, 2 * r : 3 * r].any()


def test_index_from_jax_matches_files(tiny_index):
    """tiny_index (R=24): JAX holds it as adj_planes + nbr_codes; convert
    decodes the ids and builds the same port index as loading the files."""
    prefix = tiny_index["prefix"]
    jx = jax_from_files(prefix)
    assert jx.adj is None and jx.adj_planes is not None and jx.nbr_codes is not None
    from_files = tindex.device_index_from_files(prefix, "cpu")
    converted = index_from_jax(jx, "cpu")
    for name in ("adj", "vectors", "codes", "fused_rows"):
        a, b = getattr(from_files, name), getattr(converted, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    for name in ("piv_chunks", "piv_norms", "dim_idx", "dim_mask", "centroid"):
        assert torch.equal(getattr(from_files.codebook, name),
                           getattr(converted.codebook, name)), name
    assert (from_files.medoid, from_files.n, from_files.dim) == (
        converted.medoid, converted.n, converted.dim)
    # the scattered layout keeps the decoded table itself
    scattered = index_from_jax(jx, "cpu", fused_frontier=False)
    np.testing.assert_array_equal(
        scattered.adj.numpy(), load_graph_index(prefix).adj
    )


@pytest.mark.parametrize("layout", [True, "dma"])
def test_index_from_jax_fused_layouts(layout):
    """A JAX index whose ids live only in fused rows (flat, or DMA-tiled to
    [N, s, 128]) converts to the port's index built from the graph itself."""
    graph, pq = _graph_pq(1500, 16, 64, 8, seed=2)
    jx = jax_build(graph=graph, pq=pq, fused_frontier=layout)
    assert jx.adj is None and jx.fused_rows.ndim == (3 if layout == "dma" else 2)
    want = tindex.build_device_index(graph, pq, "cpu", fused_frontier=False)
    got = index_from_jax(jx, "cpu", fused_frontier=False)
    assert torch.equal(got.adj, want.adj) and torch.equal(got.codes, want.codes)
    fused = index_from_jax(jx, "cpu")
    flat = np.asarray(jx.fused_rows).reshape(1500, -1)[:, : 64 * (4 + 8)]
    np.testing.assert_array_equal(fused.fused_rows.numpy(), flat)


def test_layout_auto_selection_and_budget(tiny_index, monkeypatch, tmp_path):
    prefix = tiny_index["prefix"]
    g, pq = load_graph_index(prefix), load_pq(prefix)
    assert tindex.fused_layout_fits(g.n, g.r, pq.num_chunks)
    # 1M x 64 x (4+64) B = 4.35 GB fits the 80 GB card's budget; 100M does not
    assert tindex.fused_layout_fits(1_000_000, 64, 64)
    assert not tindex.fused_layout_fits(100_000_000, 64, 64)
    # the exact variant's fused rows: 1M x 64 x (8+128) B = 8.70 GB fit
    assert tindex.fused_exact_layout_fits(1_000_000, 64, 128)
    assert not tindex.fused_exact_layout_fits(10_000_000, 64, 128)
    monkeypatch.setattr(tindex, "FUSED_LAYOUT_BUDGET", 1000)
    ix = tindex.device_index_from_files(prefix, "cpu")
    assert ix.fused_rows is None and ix.adj.dtype == torch.int32
    assert ix.adj.shape == (g.n, g.r)
    # base keeps its graph on the host (models/base.py): no device index
    with pytest.raises(ValueError, match="BaseVariantSearcher"):
        tindex.device_index_from_files(prefix, "cpu", variant="base")
    # over the budget, u8 data falls back to the scattered exact layout
    u8 = synthetic.build_synthetic_index(str(tmp_path / "u8"), n=600, dim=8, r=8, m=2,
                                         n_queries=4, dtype=np.uint8, seed=2)
    ex = tindex.device_index_from_files(u8["prefix"], "cpu", variant="exactdistance")
    assert ex.fused_vec_rows is None and ex.adj.shape == (600, 8)
    monkeypatch.undo()
    ex = tindex.device_index_from_files(u8["prefix"], "cpu", variant="exactdistance")
    assert ex.adj is None and ex.fused_vec_rows.shape == (600, 8 * (8 + 8))
