"""The in-memory search slice end to end: the port's BANGSearch("inmemory")
against the JAX package's search_inmemory on the same bundle.

JAX runs on the CPU with pq_impl="auto" (its XLA path). Bar, per batch:
iteration counts within 1; ids identical for >= 99% of query rows;
recall@10 within 0.5 points; re-ranked distances of identical rows within
rtol 1e-5 plus atol 1e-5 x ||q||^2 (exact-L2 summation order only, on
terms of that size). The PQ distances that steer the
walk are f32 sums in a different order, which can flip a near-tie; that
is why ids are held per row at 99% and not bit-exact.

The device picks the port's fused route, as JAX's pq_impl="auto" does:
the f32 decode on the CPU (what the JAX comparison runs), K2 over bf16-pair
tables on the card. K2's plain version, called here on the CPU in the f32
decode's place, keeps recall@10 within 1.0 point of it (bf16 entries move
PQ sums by ~0.2%).
"""

import numpy as np
import pytest
import torch

from bang_tpu.formats import synthetic
from bang_tpu.formats.bin_io import load_bin_auto, load_truthset
from bang_tpu.models.index import device_index_from_files as jax_index_from_files
from bang_tpu.models.inmemory import search_inmemory as jax_search
from bang_tpu.utils.config import SearchParams
from bang_tpu.utils.recall import calculate_recall
from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.models.index import device_index_from_files
from bang_tpu_torch.models.inmemory import search_inmemory
from bang_tpu_torch.models.entry import entry_points
from bang_tpu_torch.models.traversal import make_pq_distance_fn, rerank_topk, run_traversal
from bang_tpu_torch.ops import pq_kernels as pk
from bang_tpu_torch.ops.pq import pq_distance_tables


@pytest.fixture(scope="module")
def fused64_index(tmp_path_factory):
    """u8 bundle at R=64: the JAX package picks fused rows for it too."""
    prefix = str(tmp_path_factory.mktemp("fused64") / "f64")
    return synthetic.build_synthetic_index(
        prefix, n=3000, dim=32, r=64, m=8, n_queries=96, k=10,
        dtype=np.uint8, seed=7,
    )


def _bundle(info):
    prefix = info["prefix"]
    queries = load_bin_auto(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return prefix, queries, gt_ids, gt_dists


def _compare(info, beam, L):
    prefix, queries, gt_ids, gt_dists = _bundle(info)
    params = SearchParams(L=L, k=10, beam_width=beam, extra_iters=12)
    j_ids, j_d, j_stats = jax_search(jax_index_from_files(prefix), queries, params)
    j_ids, j_d = np.asarray(j_ids), np.asarray(j_d)

    s = BANGSearch("inmemory", device="cpu")
    s.bang_load(prefix)
    s.bang_set_searchparams(10, L, beam_width=beam, extra_iters=12)
    t_ids, t_d = s.bang_query(queries)

    assert abs(s.last_stats.iters - j_stats.iters) <= 1
    same = (t_ids == j_ids).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    # the norm expansion cancels terms of size ||q||^2: rtol 1e-5 on the
    # distance plus atol 1e-5 x ||q||^2 (exact for u8 data either way)
    qn = (queries.astype(np.float64) ** 2).sum(1, keepdims=True)
    err = np.abs(t_d - j_d)[same]
    assert (err <= 1e-5 * np.abs(j_d[same]) + 1e-5 * qn[same]).all(), err.max()
    r_t = calculate_recall(gt_ids, t_ids, 10, gt_dists)
    r_j = calculate_recall(gt_ids, j_ids, 10, gt_dists)
    assert abs(r_t - r_j) <= 0.5, (r_t, r_j)
    assert r_t > 80.0
    return s


@pytest.mark.parametrize("beam", [1, 2])
def test_search_matches_jax_on_tiny_index(tiny_index, beam):
    """tiny_index (R=24, f32): the JAX package keeps its nbr_codes layout,
    the port its fused rows."""
    s = _compare(tiny_index, beam, L=32)
    assert s._index.fused_rows is not None


@pytest.mark.parametrize("beam", [1, 2])
def test_search_matches_jax_on_fused_r64(fused64_index, beam):
    _compare(fused64_index, beam, L=24)


def test_scattered_layout_matches_fused(fused64_index):
    """The scattered-codes layout (K1 path) returns what the fused rows (K2
    path) return: the same PQ distances, only the fetch differs."""
    prefix, queries, _, _ = _bundle(fused64_index)
    params = SearchParams(L=24, k=10, beam_width=2, extra_iters=12)
    fused = device_index_from_files(prefix, "cpu")
    scattered = device_index_from_files(prefix, "cpu", fused_frontier=False)
    assert fused.adj is None and scattered.fused_rows is None
    a_ids, a_d, a_st = search_inmemory(fused, queries, params)
    b_ids, b_d, b_st = search_inmemory(scattered, queries, params)
    assert torch.equal(a_ids, b_ids) and torch.equal(a_d, b_d)
    assert a_st.iters == b_st.iters and a_st.n_dist_comps == b_st.n_dist_comps


def test_bf16_fused_route_recall_matches_f32(tiny_index):
    """The walk steered by K2 (its plain version, on CPU tensors) over the
    packed tables, as on the card, in place of the CPU's f32 decode:
    recall@10 within 1.0 point, the iteration count within 1."""
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_index)
    index = device_index_from_files(prefix, "cpu")
    assert index.fused_rows is not None
    params = SearchParams(L=32, k=10, beam_width=2, extra_iters=12)
    f32_ids, _, f32_stats = search_inmemory(index, queries, params)

    q = torch.as_tensor(queries).float()
    fn = make_pq_distance_fn(q, index.codebook, index.codes, index.fused_rows)
    packed = pk.pack_tables(pq_distance_tables(index.codebook, q))
    fn.frontier_fn = lambda parents: pk.frontier_lookup(packed, index.fused_rows, parents)
    entry_ids, entry_dists = entry_points(index, q, params)
    final = run_traversal(index.adj, fn, index.medoid, q.shape[0], params.L,
                          params.max_iters, params.beam_width, q.device,
                          entry_ids=entry_ids, entry_dists=entry_dists)
    bf16_ids, _ = rerank_topk(q, index.vectors, final.visited_ids, params.k)

    r_f32 = calculate_recall(gt_ids, f32_ids.numpy(), 10, gt_dists)
    r_bf16 = calculate_recall(gt_ids, bf16_ids.numpy(), 10, gt_dists)
    assert abs(r_bf16 - r_f32) <= 1.0, (r_bf16, r_f32)
    assert abs(final.it - f32_stats.iters) <= 1, (final.it, f32_stats.iters)
    assert r_bf16 > 80.0


def test_cpu_fused_route_is_f32_decode_and_pq_impl_auto_only(fused64_index):
    """On the CPU the fused frontier is the f32 decode and K1 stays callable;
    every pq_impl but "auto" names a JAX kernel and raises."""
    prefix, queries, _, _ = _bundle(fused64_index)
    index = device_index_from_files(prefix, "cpu")
    q = torch.as_tensor(queries[:6]).float()
    parents = torch.tensor([[0, 5], [7, 7], [1, 2], [3, 4], [9, 8], [6, 0]],
                           dtype=torch.int32)
    tables = pq_distance_tables(index.codebook, q)
    want = pk.frontier_decode_plain(tables, index.fused_rows, parents)
    fn = make_pq_distance_fn(q, index.codebook, index.codes, index.fused_rows)
    got = fn.frontier_fn(parents)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(fn(want[0], parents), want[1])
    for impl in ("pallas", "xla", "pallas_dma"):
        with pytest.raises(ValueError, match="pq_impl"):
            search_inmemory(index, queries[:2], SearchParams(L=16, pq_impl=impl))


def test_api_returns_int64_and_rejects_unported(fused64_index):
    prefix, queries, _, _ = _bundle(fused64_index)
    s = BANGSearch("inmemory", device="cpu")
    s.bang_load(prefix)
    s.bang_set_searchparams(10, 16, beam_width=2)
    s.bang_alloc(8)
    ids, dists = s.bang_query(queries[:5])
    assert ids.dtype == np.int64 and ids.shape == (5, 10)
    assert dists.dtype == np.float32 and np.isfinite(dists).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BANGSearch("base", device="cpu")
    assert BANGSearch("exactdistance", device="cpu").variant == "exactdistance"
    with pytest.raises(ValueError, match="unknown variant"):
        BANGSearch("exact", device="cpu")
    s.bang_set_searchparams(10, 16, visited_mode="bloom")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.bang_query(queries[:2])
    s.bang_set_searchparams(10, 16, entry_mode="sampled")
    assert s.bang_query(queries[:2])[0].shape == (2, 10)


def test_rerank_topk_breaks_ties_lowest_index_first():
    """Equal exact distances keep expansion order, as lax.top_k does."""
    vectors = torch.tensor([[0, 0], [1, 0], [0, 1], [2, 0], [1, 1]], dtype=torch.uint8)
    q = torch.zeros((1, 2))
    visited = torch.tensor([[3, 2, 1, 4, 0, -1]], dtype=torch.int32)
    ids, d = rerank_topk(q, vectors, visited, 4)
    assert ids.tolist() == [[0, 2, 1, 4]]  # 2 and 1 tie at 1.0: 2 came first
    assert d.tolist() == [[0.0, 1.0, 1.0, 2.0]]
