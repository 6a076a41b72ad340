"""The JAX package's last search options in the port, against the JAX
package on the CPU: the neighbor-aligned code layout (`nbr_codes` +
`adj_planes`), every `pq_impl`, the ranked merge, `first_occurrence_mask`,
`decode_row_gather`, the sharded `nbr_codes` index, and the three layout
probes' CPU runs.

Bars. Tables: byte-identical. u8 bundles: ids, iterations and distance
computations identical to JAX's (every exact distance an integer below
2^24; the PQ sums of both packages reach the same walk on these bundles),
re-ranked distances within tests/test_torch_search.py's rtol 1e-5 plus
atol 1e-5 x ||q||^2. "pallas" and "pallas_dma" run JAX's kernels in
interpret mode, as JAX's own tests run them, against the port's kernels'
plain versions over the same bf16-pair tables. The merges: bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bang_tpu.formats import synthetic as jsyn
from bang_tpu.formats.bin_io import load_bin_auto, load_truthset
from bang_tpu.formats.graph import GraphIndex as JaxGraph
from bang_tpu.formats.graph import load_graph_index as jax_load_graph
from bang_tpu.formats.pq import PQData as JaxPQ
from bang_tpu.formats.pq import load_pq as jax_load_pq
from bang_tpu.models.base import BaseVariantSearcher as JaxBase
from bang_tpu.models.exactdistance import search_exact as jax_search_exact
from bang_tpu.models.index import build_device_index as jax_build
from bang_tpu.models.index import device_index_from_files as jax_index_from_files
from bang_tpu.models.inmemory import search_inmemory as jax_search
from bang_tpu.ops import adjacency as jax_adjacency
from bang_tpu.ops import l2 as jax_l2
from bang_tpu.ops import merge as jax_merge
from bang_tpu.ops import pq_pallas as jax_pallas
from bang_tpu.ops import visited as jax_visited
from bang_tpu.parallel import partition as jax_partition
from bang_tpu.parallel import sharded as jax_sharded
from bang_tpu.utils.config import SearchParams as JaxParams
from bang_tpu_torch.convert import index_from_jax
from bang_tpu_torch.formats.graph import GraphIndex
from bang_tpu_torch.formats.pq import PQData
from bang_tpu_torch.models import index as index_mod
from bang_tpu_torch.models.base import BaseVariantSearcher
from bang_tpu_torch.models.exactdistance import search_exact
from bang_tpu_torch.models.index import build_device_index, device_index_from_files
from bang_tpu_torch.models.inmemory import search_inmemory
from bang_tpu_torch.ops import adjacency, l2, merge, visited
from bang_tpu_torch.parallel import partition, sharded
from bang_tpu_torch.scripts import exp_decode, exp_fused32, exp_gather
from bang_tpu_torch.utils.config import SearchParams


@pytest.fixture(scope="module")
def r64_index(tmp_path_factory):
    """A u8 bundle at R=64, m=8: the JAX package builds its fused rows, and
    its DMA-tiled rows (`fused_frontier="dma"`: R == 64, m even), for it."""
    prefix = str(tmp_path_factory.mktemp("r64") / "r64")
    return jsyn.build_synthetic_index(prefix, n=1200, dim=16, r=64, m=8, n_queries=16,
                                      k=10, dtype=np.uint8, seed=9)


def _queries(info):
    return load_bin_auto(info["prefix"] + "_query.bin", np.float32)


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, as JAX's own tests run them
    on the CPU (make_pq_distance_fn and _base_step import them at trace)."""
    for name in ("pq_lookup_packed", "frontier_lookup", "frontier_lookup_dma"):
        monkeypatch.setattr(jax_pallas, name,
                            functools.partial(getattr(jax_pallas, name), interpret=True))


def _close(label, got, want, queries):
    """Port against JAX: ids and iterations identical, distances within
    rtol 1e-5 + atol 1e-5 x ||q||^2."""
    ids, dists, st = got
    j_ids, j_d, j_st = want
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids), err_msg=label)
    assert st.iters == j_st.iters, (label, st.iters, j_st.iters)
    qn = (queries.astype(np.float64) ** 2).sum(1, keepdims=True)
    err = np.abs(dists.numpy() - np.asarray(j_d))
    assert (err <= 1e-5 * np.abs(np.asarray(j_d)) + 1e-5 * qn).all(), (label, err.max())


def _same(a, b):
    """Two port searches' results bit for bit, counters included."""
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[2].iters, a[2].n_dist_comps) == (b[2].iters, b[2].n_dist_comps)


def test_neighbor_tables_match_jax(monkeypatch):
    """nbr_codes [N, R*m] and adj_planes [N, 4R] byte-identical to JAX's.
    At R=64 JAX builds in blocks of 32,768 rows, so N=40,000 takes its
    overlapping last block; the port's blocks (shrunk here) end short."""
    rng = np.random.default_rng(4)
    n, r, m, d = 40_000, 64, 4, 8
    adj = rng.integers(0, n, (n, r), dtype=np.int32)
    adj[:, -3:] = np.arange(n, dtype=np.int32)[:, None]  # self-padding slots
    vectors = rng.integers(0, 256, (n, d), dtype=np.uint8)
    offsets = np.arange(0, d + 1, d // m, dtype=np.uint32)
    pivots = rng.normal(size=(256, d)).astype(np.float32)
    centroid = np.zeros(d, np.float32)
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    degrees = np.full(n, r, np.int32)
    jix = jax_build(graph=JaxGraph(vectors, adj, degrees, 0),
                    pq=JaxPQ(pivots, centroid, offsets, codes), neighbor_codes=True)
    monkeypatch.setattr(index_mod, "_BUILD_BLOCK", 9_999)
    ix = build_device_index(GraphIndex(vectors, adj, degrees, 0),
                            PQData(pivots, centroid, offsets, codes), "cpu",
                            neighbor_codes=True)
    assert ix.adj is None and ix.fused_rows is None and jix.adj is None
    np.testing.assert_array_equal(ix.nbr_codes.numpy(), np.asarray(jix.nbr_codes))
    np.testing.assert_array_equal(ix.adj_planes.numpy(), np.asarray(jix.adj_planes))
    np.testing.assert_array_equal(adjacency.pack_adj_planes_np(adj),
                                  jax_adjacency.pack_adj_planes_np(adj))
    planes = adjacency.PlaneAdjacency(ix.adj_planes)
    parents = torch.tensor([[0, n - 1], [7, 39_999 - 17]], dtype=torch.int32)
    want = jax_adjacency.PlaneAdjacency(jix.adj_planes)(jnp.asarray(parents.numpy()))
    np.testing.assert_array_equal(planes(parents).numpy(), np.asarray(want))
    assert planes.r == r and adjacency.FrontierOnlyAdj(r).r == r


@pytest.mark.parametrize("beam", [1, 2])
def test_inmemory_neighbor_codes_matches_jax(tiny_uint8_index, beam):
    """The neighbor-aligned in-memory search against JAX's in the same
    layout, and identical to the port's fused and scattered layouts (on
    the CPU all three sum the same f32 entries)."""
    prefix = tiny_uint8_index["prefix"]
    queries = _queries(tiny_uint8_index)
    params = SearchParams(L=32, k=10, beam_width=beam, extra_iters=12)
    jix = jax_index_from_files(prefix, neighbor_codes=True)
    ix = device_index_from_files(prefix, "cpu", neighbor_codes=True)
    np.testing.assert_array_equal(ix.nbr_codes.numpy(), np.asarray(jix.nbr_codes))
    np.testing.assert_array_equal(ix.adj_planes.numpy(), np.asarray(jix.adj_planes))
    got = search_inmemory(ix, queries, params)
    _close("nbr_codes", got, jax_search(jix, queries, JaxParams(
        L=32, k=10, beam_width=beam, extra_iters=12)), queries)
    for kw in ({}, {"fused_frontier": False}):
        _same(got, search_inmemory(device_index_from_files(prefix, "cpu", **kw),
                                   queries, params))
    carried = index_from_jax(jix, "cpu", neighbor_codes=True)
    np.testing.assert_array_equal(carried.nbr_codes.numpy(), ix.nbr_codes.numpy())
    _same(got, search_inmemory(carried, queries, params))


def test_layout_arguments(tiny_uint8_index):
    prefix = tiny_uint8_index["prefix"]
    with pytest.raises(ValueError, match="one"):
        device_index_from_files(prefix, "cpu", fused_frontier=True, neighbor_codes=True)
    with pytest.raises(ValueError, match="inmemory"):
        device_index_from_files(prefix, "cpu", "exactdistance", neighbor_codes=True)
    scattered = device_index_from_files(prefix, "cpu", neighbor_codes=False)
    assert scattered.adj is not None and scattered.fused_rows is None
    dma = device_index_from_files(prefix, "cpu", fused_frontier="dma")
    assert dma.fused_rows is not None and dma.fused_rows.ndim == 2
    assert index_mod.layout_of(dma) == ("fused_rows",)
    moved = device_index_from_files(prefix, "cpu", neighbor_codes=True).to("meta")
    assert moved.nbr_codes.is_meta and moved.adj_planes.is_meta


@pytest.mark.parametrize("impl", ["pallas", "pallas_dma", "xla"])
def test_inmemory_pq_impl_matches_jax(r64_index, impl, interpret):
    """Each pq_impl against JAX's at R=64, where JAX builds fused rows
    (and for "pallas_dma" its DMA-tiled rows); the port's fused rows serve
    all three. "pallas" and "pallas_dma" sum bf16 entries in both packages
    and equal the port's "auto" on the card's route; "xla" is its "auto"."""
    prefix = r64_index["prefix"]
    queries = _queries(r64_index)
    kw = dict(L=24, k=10, beam_width=2, extra_iters=8, pq_impl=impl)
    jix = (jax_build(graph=jax_load_graph(prefix), pq=jax_load_pq(prefix),
                     fused_frontier="dma")
           if impl == "pallas_dma" else jax_index_from_files(prefix))
    assert jix.fused_rows is not None
    ix = device_index_from_files(prefix, "cpu")
    got = search_inmemory(ix, queries, SearchParams(**kw))
    _close(impl, got, jax_search(jix, queries, JaxParams(**kw)), queries)
    if impl != "xla":
        _same(got, search_inmemory(device_index_from_files(prefix, "cpu", neighbor_codes=True),
                                   queries, SearchParams(**{**kw, "pq_impl": "pallas"})))
    else:
        _same(got, search_inmemory(ix, queries, SearchParams(**{**kw, "pq_impl": "auto"})))


def test_pallas_dma_needs_fused_rows(tiny_uint8_index):
    """Without fused rows "pallas_dma" raises in both packages and both
    variants, with JAX's message; the exact variant's "pallas" and "xla"
    (no PQ to pick) and its "pallas_dma" on fused exact rows run as "auto"."""
    prefix = tiny_uint8_index["prefix"]
    queries = _queries(tiny_uint8_index)[:8]
    dma = SearchParams(L=16, pq_impl="pallas_dma")
    jdma = JaxParams(L=16, pq_impl="pallas_dma")
    for search, jsearch, variant, kw in (
            (search_inmemory, jax_search, "inmemory", {"neighbor_codes": True}),
            (search_exact, jax_search_exact, "exactdistance", {"fused_frontier": False})):
        with pytest.raises(ValueError) as want:
            jsearch(jax_index_from_files(prefix, variant, neighbor_codes=True,
                                         neighbor_vectors=False), queries, jdma)
        with pytest.raises(ValueError) as got:
            search(device_index_from_files(prefix, "cpu", variant, **kw), queries, dma)
        assert str(got.value) == str(want.value)
    ix = device_index_from_files(prefix, "cpu", "exactdistance")
    auto = search_exact(ix, queries, SearchParams(L=16))
    for impl in ("pallas", "pallas_dma", "xla"):
        _same(auto, search_exact(ix, queries, SearchParams(L=16, pq_impl=impl)))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_base_pq_impl_matches_jax(tiny_uint8_index, impl, interpret):
    """Base: "pallas" is K1 over the packed tables (its plain version
    here) and "xla" the f32 lookup, against JAX's _base_step in each;
    "pallas_dma" (no fused rows in base) runs "auto"."""
    prefix = tiny_uint8_index["prefix"]
    queries = _queries(tiny_uint8_index)[:16]
    kw = dict(L=24, k=10, beam_width=2, extra_iters=8)
    s = BaseVariantSearcher(prefix, n_pipeline_batches=2, device="cpu")
    ids, dists = s.search(queries, SearchParams(**kw, pq_impl=impl))
    j_ids, j_d = JaxBase(prefix, n_pipeline_batches=2).search(
        queries, JaxParams(**kw, pq_impl=impl))
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_allclose(dists, np.asarray(j_d), rtol=1e-5, atol=1e-3)
    if impl == "xla":
        auto = s.search(queries, SearchParams(**kw))
        dma = s.search(queries, SearchParams(**kw, pq_impl="pallas_dma"))
        for a, b in ((auto, (ids, dists)), (dma, auto)):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def _merge_case(seed, q=6, l=24, c=20, levels=5):
    """A sorted worklist and candidates with many ties, +inf slots and
    INVALID_ID (-1) ids on both sides."""
    rng = np.random.default_rng(seed)
    wl = rng.integers(0, levels, (q, l)).astype(np.float32)
    wl[rng.random((q, l)) < 0.25] = np.inf
    wl.sort(axis=1)
    wl_ids = rng.integers(-1, 60, (q, l)).astype(np.int32)
    wl_ids[np.isinf(wl)] = -1
    wl_vis = rng.random((q, l)) < 0.5
    cd = rng.integers(0, levels, (q, c)).astype(np.float32)
    cd[rng.random((q, c)) < 0.3] = np.inf
    ci = rng.integers(-1, 60, (q, c)).astype(np.int32)
    return wl, wl_ids, wl_vis, cd, ci


@pytest.mark.parametrize("seed", range(6))
def test_ranked_merge_bit_identical(seed, monkeypatch):
    case = _merge_case(seed, c=4 + 6 * seed)
    t = [torch.as_tensor(x) for x in case]
    ranked = merge.merge_worklist_ranked(*t)
    want = jax_merge.merge_worklist_ranked(*map(jnp.asarray, case))
    for got, w, s in zip(ranked, want, merge.merge_worklist(*t, impl="sort")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert torch.equal(got, s)
    monkeypatch.setenv("BANG_MERGE_IMPL", "ranked")
    assert merge.merge_impl() == "ranked"
    assert all(torch.equal(a, b) for a, b in zip(merge.merge_worklist(*t), ranked))
    monkeypatch.setenv("BANG_MERGE_IMPL", "anything else")
    assert merge.merge_impl() == "sort"


def test_ranked_merge_search_identical(tiny_uint8_index, monkeypatch):
    """BANG_MERGE_IMPL=ranked: the in-memory and exact searches return
    what the sort merge returns, counters included."""
    prefix = tiny_uint8_index["prefix"]
    queries = _queries(tiny_uint8_index)
    params = SearchParams(L=32, k=10, beam_width=2, extra_iters=12)
    for search, variant in ((search_inmemory, "inmemory"), (search_exact, "exactdistance")):
        ix = device_index_from_files(prefix, "cpu", variant)
        want = search(ix, queries, params)
        monkeypatch.setenv("BANG_MERGE_IMPL", "ranked")
        _same(search(ix, queries, params), want)
        monkeypatch.delenv("BANG_MERGE_IMPL")


def test_first_occurrence_and_decode_match_jax():
    rng = np.random.default_rng(2)
    cand = rng.integers(-1, 12, (5, 48)).astype(np.int32)
    got = visited.first_occurrence_mask(torch.as_tensor(cand))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_visited.first_occurrence_mask(cand)))
    blocks = np.stack([rng.permutation(40)[:12] for _ in range(10)]).reshape(5, 24)
    np.testing.assert_array_equal(  # rows duplicate-free within each beam block
        visited.first_occurrence_mask(torch.as_tensor(blocks)).numpy(),
        visited.first_occurrence_mask_blocks(torch.as_tensor(blocks), 2).numpy())
    vecs = rng.normal(size=(7, 3, 16)).astype(np.float32)
    raw = vecs.view(np.uint8)  # [7, 3, 64]
    for x, d in ((raw, 16), (raw, 8), (vecs, 16)):
        want = np.asarray(jax_l2.decode_row_gather(jnp.asarray(x), d))
        np.testing.assert_array_equal(l2.decode_row_gather(torch.as_tensor(x), d).numpy(),
                                      want)


def test_sharded_neighbor_codes_match_jax():
    """build_sharded_index(neighbor_codes=True): each shard's codes[adj]
    byte-identical to JAX's, and search_sharded over it against JAX's (the
    bars of tests/test_torch_parallel.py), identical to the scattered
    shards' search."""
    data = jsyn.make_clustered_data(1024, 16, n_clusters=12, seed=3)
    queries = data[:16].astype(np.float32) + 0.05
    jsi = jax_partition.build_sharded_index(data, 4, r=16, m=8, seed=2,
                                            neighbor_codes=True)
    si = partition.build_sharded_index(data, 4, r=16, m=8, seed=2, neighbor_codes=True,
                                       device="cpu")
    np.testing.assert_array_equal(si.nbr_codes.numpy(), np.asarray(jsi.nbr_codes))
    want, want_d = jax_sharded.search_sharded(jax_sharded.make_mesh(1, 4), jsi, queries,
                                              JaxParams(L=24, k=10))
    mesh = sharded.make_mesh(1, 4, [torch.device("cpu")] * 4)
    params = SearchParams(L=24, k=10)
    ids, dists = sharded.search_sharded(mesh, si, queries, params)
    assert (ids.numpy() == np.asarray(want)).mean() >= 0.98
    np.testing.assert_allclose(dists.numpy(), np.asarray(want_d), rtol=1e-4, atol=1e-2)
    plain = partition.build_sharded_index(data, 4, r=16, m=8, seed=2, device="cpu")
    p_ids, p_d = sharded.search_sharded(mesh, plain, queries, params)
    assert torch.equal(ids, p_ids) and torch.equal(dists, p_d)


def test_layout_probes_on_cpu():
    """The three probes' plain runs: ids and bytes checked, no time."""
    r = exp_fused32.main("cpu", check_sizes=dict(n=70_000, q=8),
                         time_sizes=dict(n=4000, q=8), iters=2)
    assert r["check_r32"]["max_id"] >= 1 << 16 and r["check_r32"]["beam4_ids_exact"]
    assert r["tuned10m_op"]["fused_ms"] is None and r["tuned10m_op"]["k2_bound_ms"] > 0
    g = exp_gather.main("cpu", n=3000, q=8, c=8, aligned_n=100, iters=2)
    assert len(g) == 8 and all(v["ms"] is None for k, v in g.items() if k != "shapes")
    d = exp_decode.main("cpu", q=8, c=8, d=16, scattered_n=(300, 600), aligned_n=40,
                        aligned_r=8, iters=2)
    assert len(d) == 7 and all(v["max_abs_err"] == 0.0 for k, v in d.items()
                               if k != "shapes")
