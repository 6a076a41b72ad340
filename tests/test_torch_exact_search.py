"""The exact-distance search slice end to end: the port's
BANGSearch("exactdistance") against the JAX package's search_exact.

JAX runs on the CPU and keeps its auto-selected nbr_vecs layout. Bars:
  * tiny_uint8_index (u8 vectors and queries): every distance is an
    integer below 2^24, exact in f32 in any summation order, and ties break
    alike, so ids, distances, `iters` and `n_dist_comps` are identical for
    each of the port's three layouts (fused exact rows, scattered,
    nbr_vecs), medoid and sampled entries, beam 1 and 2;
  * tiny_index (f32): near-ties may flip with the summation order, so
    >= 99% of query rows identical, `iters` within 1, recall@10 within 0.5
    points, distances of identical rows within rtol 1e-5 plus atol
    1e-5 x ||q||^2.
"""

import numpy as np
import pytest
import torch

from bang_tpu.formats.bin_io import load_bin_auto, load_truthset
from bang_tpu.models.exactdistance import search_exact as jax_search
from bang_tpu.models.index import build_device_index as jax_build
from bang_tpu.models.index import device_index_from_files as jax_index_from_files
from bang_tpu.models.inmemory import search_inmemory as jax_search_inmemory
from bang_tpu.formats.graph import load_graph_index
from bang_tpu.utils.config import SearchParams
from bang_tpu.utils.recall import calculate_recall
from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.convert import index_from_jax
from bang_tpu_torch.models import entry
from bang_tpu_torch.models.exactdistance import search_exact
from bang_tpu_torch.models.index import device_index_from_files

LAYOUTS = {
    "fused": {},
    "scattered": {"fused_frontier": False},
    "nbr_vecs": {"neighbor_vectors": True},
}


def _bundle(info):
    prefix = info["prefix"]
    queries = load_bin_auto(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return prefix, queries, gt_ids, gt_dists


def _jax(prefix, queries, params):
    ids, d, stats = jax_search(jax_index_from_files(prefix, "exactdistance"), queries, params)
    return np.asarray(ids), np.asarray(d), stats


@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_api_identical_to_jax_on_uint8(tiny_uint8_index, layout, beam):
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_uint8_index)
    params = SearchParams(L=32, k=10, beam_width=beam, extra_iters=12)
    j_ids, j_d, j_stats = _jax(prefix, queries, params)

    s = BANGSearch("exactdistance", device="cpu")
    s.bang_load(prefix, **LAYOUTS[layout])
    ix = s._index
    assert (ix.fused_vec_rows is not None) == (layout == "fused")
    assert (ix.nbr_vecs is not None) == (layout == "nbr_vecs")
    assert (ix.adj is None) == (layout == "fused")
    s.bang_set_searchparams(10, 32, beam_width=beam, extra_iters=12)
    t_ids, t_d = s.bang_query(queries)
    assert t_ids.dtype == np.int64
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_d, j_d)
    assert s.last_stats.iters == j_stats.iters
    assert s.last_stats.n_dist_comps == j_stats.n_dist_comps
    assert s.last_stats.n_expanded == j_stats.n_expanded
    assert calculate_recall(gt_ids, t_ids, 10, gt_dists) > 80.0


@pytest.mark.parametrize("beam", [1, 2])
def test_search_matches_jax_on_float_index(tiny_index, beam):
    """tiny_index (f32): the port scatters (no fused rows for f32 data),
    JAX keeps nbr_vecs."""
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_index)
    params = SearchParams(L=32, k=10, beam_width=beam, extra_iters=12)
    j_ids, j_d, j_stats = _jax(prefix, queries, params)
    index = device_index_from_files(prefix, "cpu", "exactdistance")
    assert index.fused_vec_rows is None and index.adj is not None
    t_ids, t_d, t_stats = search_exact(index, queries, params)
    t_ids, t_d = t_ids.numpy(), t_d.numpy()
    assert abs(t_stats.iters - j_stats.iters) <= 1
    same = (t_ids == j_ids).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    qn = (queries.astype(np.float64) ** 2).sum(1, keepdims=True)
    err = np.abs(t_d - j_d)[same]
    assert (err <= 1e-5 * np.abs(j_d[same]) + 1e-5 * qn[same]).all(), err.max()
    r_t = calculate_recall(gt_ids, t_ids, 10, gt_dists)
    r_j = calculate_recall(gt_ids, j_ids, 10, gt_dists)
    assert abs(r_t - r_j) <= 0.5 and r_t >= 95.0, (r_t, r_j)


@pytest.mark.parametrize("beam", [1, 2])
def test_sampled_entry_exact_identical_to_jax(tiny_uint8_index, beam):
    """entry_mode="sampled" on the exact variant: identical to JAX, and no
    more iterations than the medoid start at no less recall - 1."""
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_uint8_index)
    samp = SearchParams(L=32, k=10, beam_width=beam, entry_mode="sampled",
                        entry_samples=256)
    j_ids, j_d, j_stats = _jax(prefix, queries, samp)
    index = device_index_from_files(prefix, "cpu", "exactdistance")
    t_ids, t_d, t_stats = search_exact(index, queries, samp)
    np.testing.assert_array_equal(t_ids.numpy(), j_ids)
    np.testing.assert_array_equal(t_d.numpy(), j_d)
    assert (t_stats.iters, t_stats.n_dist_comps) == (j_stats.iters, j_stats.n_dist_comps)
    m_ids, _, m_stats = search_exact(index, queries, SearchParams(L=32, k=10, beam_width=beam))
    r_s = calculate_recall(gt_ids, t_ids.numpy(), 10, gt_dists)
    r_m = calculate_recall(gt_ids, m_ids.numpy(), 10, gt_dists)
    assert r_s >= r_m - 1.0 and t_stats.iters <= m_stats.iters, (r_s, r_m)


def test_sampled_entry_inmemory_matches_jax(tiny_index):
    """entry_mode="sampled" on the in-memory variant (beam 2: the top-2
    sampled entries seed both beam slots) against JAX: PQ distances steer
    the walk, so the in-memory bar holds (>= 99% rows, iters within 1)."""
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_index)
    samp = SearchParams(L=32, k=10, entry_mode="sampled", entry_samples=256,
                        beam_width=2)
    j_ids, _, j_stats = jax_search_inmemory(jax_index_from_files(prefix), queries, samp)
    s = BANGSearch("inmemory", device="cpu")
    s.bang_load(prefix)
    s.bang_set_searchparams(10, 32, entry_mode="sampled", entry_samples=256, beam_width=2)
    t_ids, _ = s.bang_query(queries)
    assert abs(s.last_stats.iters - j_stats.iters) <= 1
    assert (t_ids == np.asarray(j_ids)).all(axis=1).mean() >= 0.99
    assert calculate_recall(gt_ids, t_ids, 10, gt_dists) >= 90.0


def test_sampled_entry_topb_ties_and_padding():
    """Tied sample distances keep the lowest sample index first (argmin and
    the stable sort both); a sample smaller than B repeats the best."""
    vectors = torch.tensor([[0, 0], [2, 0], [0, 2], [2, 2], [4, 4], [1, 1]],
                           dtype=torch.uint8)
    norms = (vectors.float() ** 2).sum(-1)
    q = torch.tensor([[1.0, 1.0], [2.0, 1.0]])
    # n_samples=6: stride 1, the sample is every point
    ids, d = entry.sampled_entry_topb(q, vectors, norms, 6, 4)
    assert ids.tolist() == [[5, 0, 1, 2], [1, 3, 5, 0]]
    assert d.tolist() == [[0.0, 2.0, 2.0, 2.0], [1.0, 1.0, 1.0, 5.0]]
    assert entry.sampled_entry_ids(q, vectors, norms, 6).tolist() == [5, 1]
    # n_samples=3: stride 2, samples 0, 2, 4; B=5 pads with the best
    ids, d = entry.sampled_entry_topb(q, vectors, norms, 3, 5)
    assert ids.tolist() == [[0, 2, 4, 0, 0], [0, 2, 4, 0, 0]]
    assert d.tolist() == [[2.0, 2.0, 18.0, 2.0, 2.0], [5.0, 5.0, 13.0, 5.0, 5.0]]


def test_sampled_entry_matches_jax_on_random_data():
    import jax.numpy as jnp

    from bang_tpu.models.entry import sampled_entry_topb as jax_topb

    rng = np.random.default_rng(0)
    vecs = rng.integers(0, 8, size=(500, 6), dtype=np.uint8)  # many ties
    qs = rng.integers(0, 8, size=(40, 6)).astype(np.float32)
    norms = (vecs.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    for b in (1, 3):
        j_ids, j_d = jax_topb(jnp.asarray(qs), jnp.asarray(vecs), jnp.asarray(norms), 64, b)
        t_ids, t_d = entry.sampled_entry_topb(torch.from_numpy(qs), torch.from_numpy(vecs),
                                              torch.from_numpy(norms), 64, b)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


@pytest.mark.parametrize("jax_layout", ["nbr_vecs", "fused", "fused_only"])
def test_index_from_jax_exact(tiny_uint8_index, jax_layout):
    """A JAX exact index (nbr_vecs from the files, or fused exact rows, also
    with its adjacency dropped) converts to the port's index from the
    files, and searches alike."""
    prefix, queries, _, _ = _bundle(tiny_uint8_index)
    if jax_layout == "nbr_vecs":
        jx = jax_index_from_files(prefix, "exactdistance")
        assert jx.nbr_vecs is not None
    else:
        jx = jax_build(graph=load_graph_index(prefix), fused_exact_frontier=True)
        if jax_layout == "fused_only":
            jx = jx._replace(adj=None)
    want = device_index_from_files(prefix, "cpu", "exactdistance")
    got = index_from_jax(jx, "cpu")
    for name in ("adj", "vectors", "vector_norms", "fused_vec_rows", "nbr_vecs"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert (want.medoid, want.n, want.dim) == (got.medoid, got.n, got.dim)
    scattered = index_from_jax(jx, "cpu", fused_frontier=False)
    np.testing.assert_array_equal(scattered.adj.numpy(), load_graph_index(prefix).adj)
    params = SearchParams(L=24, k=10)
    a = search_exact(got, queries[:16], params)[0]
    b = search_exact(scattered, queries[:16], params)[0]
    assert torch.equal(a, b)


def test_layout_options_and_refusals(tiny_uint8_index, tiny_index):
    prefix = tiny_uint8_index["prefix"]
    with pytest.raises(ValueError, match="one"):
        device_index_from_files(prefix, "cpu", "exactdistance", fused_frontier=True,
                                neighbor_vectors=True)
    with pytest.raises(ValueError, match="u8"):
        device_index_from_files(tiny_index["prefix"], "cpu", "exactdistance",
                                fused_frontier=True)
    with pytest.raises(ValueError, match="exactdistance"):
        device_index_from_files(prefix, "cpu", "inmemory", neighbor_vectors=True)
    index = device_index_from_files(prefix, "cpu", "exactdistance")
    queries = load_bin_auto(prefix + "_query.bin", np.float32)[:4]
    with pytest.raises(NotImplementedError, match="item 15"):
        search_exact(index, queries, SearchParams(L=16, visited_mode="bloom"))
    with pytest.raises(ValueError, match="pq_impl"):
        search_exact(index, queries, SearchParams(L=16, pq_impl="pallas_dma"))
    # "default" is a TPU matrix-unit setting: the port computes full f32
    a = search_exact(index, queries, SearchParams(L=16, traversal_precision="default"))
    b = search_exact(index, queries, SearchParams(L=16))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
