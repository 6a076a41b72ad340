"""The bloom visited set (ops/bloom.py) and the three variants' walks in
`visited_mode="bloom"`: the port against the JAX package on the CPU.

Bars:
  * hashes and filter cells bit-identical to JAX's (the port's filter has
    one more column, the trash column, which no query reads);
  * exactdistance on u8 data: ids, distances, `iters` and `n_dist_comps`
    identical on every layout (every distance is an integer below 2^24);
  * inmemory (f32 PQ tables on both sides): >= 99% of rows identical,
    `iters` within 1, recall@10 within 0.5 points, the distances of
    identical rows within rtol 1e-5 plus atol 1e-5 x ||q||^2;
  * base: as tests/test_torch_base.py::test_search_matches_jax holds exact
    mode (steps within the sub-batch count, >= 99% rows identical,
    distances bit-exact on u8, recall within 0.5);
  * walks steered as on the card (K2's and K1's plain versions over the
    bf16-pair tables) keep recall@10 within 1.0 point of the f32 route.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bang_tpu.constants import BF_ENTRIES as JAX_BF
from bang_tpu.formats.bin_io import load_bin_auto, load_truthset
from bang_tpu.models.base import BaseVariantSearcher as JaxBase
from bang_tpu.models.exactdistance import search_exact as jax_search_exact
from bang_tpu.models.index import device_index_from_files as jax_index_from_files
from bang_tpu.models.inmemory import search_inmemory as jax_search_inmemory
from bang_tpu.ops import bloom as jbloom
from bang_tpu.utils.config import SearchParams
from bang_tpu.utils.recall import calculate_recall
from bang_tpu_torch.constants import BF_ENTRIES
from bang_tpu_torch.models.base import BaseVariantSearcher
from bang_tpu_torch.models.entry import entry_points
from bang_tpu_torch.models.exactdistance import search_exact
from bang_tpu_torch.models.index import device_index_from_files
from bang_tpu_torch.models.inmemory import search_inmemory
from bang_tpu_torch.models.traversal import make_pq_distance_fn, rerank_topk, run_traversal
from bang_tpu_torch.ops import bloom as tbloom
from bang_tpu_torch.ops import pq_kernels as pk
from bang_tpu_torch.ops.pq import pq_distance_tables


def _bundle(info):
    prefix = info["prefix"]
    queries = load_bin_auto(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return prefix, queries, gt_ids, gt_dists


# -- the filter ----------------------------------------------------------------


@pytest.mark.parametrize("bf", [BF_ENTRIES, 101])
def test_bloom_hashes_bit_identical(bf):
    rng = np.random.default_rng(0)
    ids = rng.integers(-2**31, 2**31, 10_000, dtype=np.int64).astype(np.int32)
    ids = np.concatenate([ids, [-1, 0, 2**31 - 1, -2**31]]).astype(np.int32).reshape(-1, 4)
    j1, j2 = jbloom.bloom_hashes(jnp.asarray(ids), bf)
    t1, t2 = tbloom.bloom_hashes(torch.from_numpy(ids), bf)
    assert t1.dtype == torch.int32 and t1.shape == ids.shape
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    assert BF_ENTRIES == JAX_BF


@pytest.mark.parametrize("bf", [BF_ENTRIES, 101])
def test_bloom_cells_and_query_identical(bf):
    """Three masked inserts, with ids repeated within and across rows and
    masked-out lanes: the first BF cells equal JAX's filter byte for byte,
    and the query agrees with JAX's on inserted and fresh ids."""
    rng = np.random.default_rng(1)
    q, r = 16, 40
    jb = jnp.zeros((q, bf), jnp.uint8)
    tb = tbloom.new_bloom(q, "cpu", bf)
    assert tb.shape == (q, bf + 1) and tb.dtype == torch.uint8
    for _ in range(3):
        ids = rng.integers(-1, 300, (q, r)).astype(np.int32)
        ids[:, 5] = ids[:, 4]  # duplicates within a row
        mask = rng.random((q, r)) < 0.6
        jb = jbloom.bloom_insert(jb, jnp.asarray(ids), jnp.asarray(mask))
        out = tbloom.bloom_insert(tb, torch.from_numpy(ids), torch.from_numpy(mask))
        assert out is tb  # in place
        np.testing.assert_array_equal(tb[:, :bf].numpy(), np.asarray(jb))
    probe = rng.integers(-1, 600, (q, 64)).astype(np.int32)
    seen = tbloom.bloom_query(tb, torch.from_numpy(probe))
    np.testing.assert_array_equal(seen.numpy(),
                                  np.asarray(jbloom.bloom_query(jb, jnp.asarray(probe))))
    assert seen.any() and not seen.all()


def test_bloom_false_positive_rate():
    """JAX's bar (tests/test_ops.py): 500 ids in, 5000 fresh ids probed,
    under 1% false positives; no false negative."""
    rng = np.random.default_rng(4)
    inserted = torch.from_numpy(rng.choice(10**6, 500, replace=False)[None, :].astype(np.int32))
    bloom = tbloom.bloom_insert(tbloom.new_bloom(1, "cpu"), inserted,
                                torch.ones((1, 500), dtype=torch.bool))
    assert tbloom.bloom_query(bloom, inserted).all()
    probe = torch.from_numpy(rng.integers(10**6, 2 * 10**6, 5000)[None, :].astype(np.int32))
    fp = tbloom.bloom_query(bloom, probe).float().mean().item()
    assert fp < 0.01, fp


# -- the walks -----------------------------------------------------------------

EXACT_LAYOUTS = {"fused": {}, "scattered": {"fused_frontier": False},
                 "nbr_vecs": {"neighbor_vectors": True}}


@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("layout", sorted(EXACT_LAYOUTS))
def test_exact_bloom_walk_identical_to_jax(tiny_uint8_index, layout, beam):
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_uint8_index)
    params = SearchParams(L=32, k=10, beam_width=beam, extra_iters=12,
                          visited_mode="bloom")
    j_ids, j_d, j_stats = jax_search_exact(
        jax_index_from_files(prefix, "exactdistance"), queries, params)
    index = device_index_from_files(prefix, "cpu", "exactdistance", **EXACT_LAYOUTS[layout])
    t_ids, t_d, t_stats = search_exact(index, queries, params)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
    assert t_stats.iters == j_stats.iters
    assert t_stats.n_dist_comps == j_stats.n_dist_comps
    assert t_stats.n_expanded == j_stats.n_expanded
    assert calculate_recall(gt_ids, t_ids.numpy(), 10, gt_dists) > 80.0


@pytest.mark.parametrize("beam", [1, 2])
def test_inmemory_bloom_matches_jax(tiny_index, beam):
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_index)
    params = SearchParams(L=32, k=10, beam_width=beam, extra_iters=12,
                          visited_mode="bloom")
    j_ids, j_d, j_stats = jax_search_inmemory(jax_index_from_files(prefix), queries, params)
    j_ids, j_d = np.asarray(j_ids), np.asarray(j_d)
    t_ids, t_d, t_stats = search_inmemory(device_index_from_files(prefix, "cpu"),
                                          queries, params)
    t_ids, t_d = t_ids.numpy(), t_d.numpy()
    assert abs(t_stats.iters - j_stats.iters) <= 1
    same = (t_ids == j_ids).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    qn = (queries.astype(np.float64) ** 2).sum(1, keepdims=True)
    err = np.abs(t_d - j_d)[same]
    assert (err <= 1e-5 * np.abs(j_d[same]) + 1e-5 * qn[same]).all(), err.max()
    r_t = calculate_recall(gt_ids, t_ids, 10, gt_dists)
    r_j = calculate_recall(gt_ids, j_ids, 10, gt_dists)
    assert abs(r_t - r_j) <= 0.5 and r_t > 80.0, (r_t, r_j)


@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_base_bloom_matches_jax(tiny_index, tiny_uint8_index, kind, beam):
    info = tiny_index if kind == "f32" else tiny_uint8_index
    prefix, queries, gt_ids, gt_dists = _bundle(info)
    params = SearchParams(L=48, k=10, beam_width=beam, visited_mode="bloom")
    nb = 2
    jax_s = JaxBase(prefix, n_pipeline_batches=nb)
    j_ids, j_d = jax_s.search(queries, params)
    port = BaseVariantSearcher(prefix, n_pipeline_batches=nb, device="cpu")
    t_ids, t_d = port.search(queries, params)
    assert abs(port.last_n_steps - jax_s.last_n_steps) <= nb
    same = (t_ids == j_ids).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    if kind == "u8":
        np.testing.assert_array_equal(t_d[same], j_d[same])
    else:
        qn = (queries.astype(np.float64) ** 2).sum(1, keepdims=True)
        err = np.abs(t_d - j_d)[same]
        assert (err <= 1e-5 * np.abs(j_d[same]) + 1e-5 * qn[same]).all(), err.max()
    r_t = calculate_recall(gt_ids, t_ids, 10, gt_dists)
    r_j = calculate_recall(gt_ids, j_ids, 10, gt_dists)
    assert abs(r_t - r_j) <= 0.5 and r_t > 85.0, (r_t, r_j)


def _card_route_inmemory(index, queries, params):
    """The in-memory walk as on the card, in bloom mode: packed tables read
    by K2's plain version (fused rows) or K1's (scattered codes)."""
    q = torch.as_tensor(queries).float()
    fn = make_pq_distance_fn(q, index.codebook, index.codes, index.fused_rows)
    packed = pk.pack_tables(pq_distance_tables(index.codebook, q))
    if index.fused_rows is not None:
        fn.frontier_fn = lambda parents: pk.frontier_lookup(packed, index.fused_rows,
                                                            parents)
        walk_fn = fn
    else:
        def walk_fn(cand_ids, parents=None):
            return pk.pq_lookup(packed, index.codes[cand_ids.long()])

        walk_fn.seed_fn = fn.seed_fn
    entry_ids, entry_dists = entry_points(index, q, params)
    final = run_traversal(index.adj, walk_fn, index.medoid, q.shape[0], params.L,
                          params.max_iters, params.beam_width, q.device,
                          entry_ids=entry_ids, entry_dists=entry_dists, use_bloom=True)
    assert final.bloom is not None
    return rerank_topk(q, index.vectors, final.visited_ids, params.k)[0]


class _CardRouteBase(BaseVariantSearcher):
    """Base as on the card: packed tables read by K1's plain version."""

    def _prepare_tables(self, sub_queries):
        packed = pk.pack_tables(pq_distance_tables(self.codebook, sub_queries))

        def distance_fn(cand_ids, parents=None):
            return pk.pq_lookup(packed, self.codes[cand_ids.long()])

        return distance_fn


@pytest.mark.parametrize("route", ["inmemory fused K2", "inmemory scattered K1",
                                   "base K1"])
def test_card_route_bloom_walk_recall_matches_f32(tiny_index, route):
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_index)
    params = SearchParams(L=32, k=10, beam_width=2, extra_iters=12, visited_mode="bloom")
    if route.startswith("inmemory"):
        index = device_index_from_files(prefix, "cpu",
                                        fused_frontier="fused" in route)
        f32_ids = search_inmemory(index, queries, params)[0].numpy()
        card_ids = _card_route_inmemory(index, queries, params).numpy()
    else:
        f32_ids = BaseVariantSearcher(prefix, 2, device="cpu").search(queries, params)[0]
        card_ids = _CardRouteBase(prefix, 2, device="cpu").search(queries, params)[0]
    r_f32 = calculate_recall(gt_ids, f32_ids, 10, gt_dists)
    r_card = calculate_recall(gt_ids, card_ids, 10, gt_dists)
    assert abs(r_card - r_f32) <= 1.0 and r_card > 80.0, (r_card, r_f32)


def test_bloom_blocks_reentry_the_exact_mask_allows(tiny_uint8_index):
    """The two visited sets differ as they do in the JAX package: the bloom
    walk computes no more distances than the exact one (evicted nodes do not
    come back), on the same index and queries."""
    prefix, queries, _, _ = _bundle(tiny_uint8_index)
    index = device_index_from_files(prefix, "cpu", "exactdistance")
    exact = search_exact(index, queries, SearchParams(L=16, k=10, extra_iters=12))[2]
    bloom = search_exact(index, queries, SearchParams(L=16, k=10, extra_iters=12,
                                                      visited_mode="bloom"))[2]
    assert bloom.n_dist_comps <= exact.n_dist_comps
