"""The base variant (graph in host RAM, PQ codes on the device, native host
gather): the port against the JAX package on the CPU.

The native gather equals both plain numpy versions (the port's and JAX's
`gather_parents_numpy`) bit for bit. The search runs the port's
BaseVariantSearcher(device="cpu") against JAX's on the same bundle, both on
f32 PQ tables (JAX's `pq_impl="auto"` on the CPU). Bar, per batch: device
steps within n_pipeline_batches; ids identical on >= 99% of rows; the
distances of identical rows within rtol 1e-5 plus atol 1e-5 x ||q||^2 (the
exact L2 of f32 data, summed in another order), bit-exact on u8 data (every
partial sum is an integer below 2^24); recall@10 within 0.5 points.
"""

import numpy as np
import pytest
import torch

from bang_tpu.formats.bin_io import load_bin_auto, load_truthset
from bang_tpu.models.base import BaseVariantSearcher as JaxBase
from bang_tpu.models.base import _sampled_entry_base as jax_sampled_entry
from bang_tpu.native import gather_parents_numpy as jax_gather_numpy
from bang_tpu.ops.pq import prepare_pq_codebook as jax_codebook
from bang_tpu.utils.config import SearchParams
from bang_tpu.utils.recall import calculate_recall
from bang_tpu_torch import native
from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.constants import ENABLE_CACHE_WARMUP, ENABLE_GPU_STATS
from bang_tpu_torch.formats.pq import load_pq
from bang_tpu_torch.models.base import BaseVariantSearcher, _sampled_entry_base
from bang_tpu_torch.ops import pq_kernels as pk
from bang_tpu_torch.ops.pq import pq_distance_tables, prepare_pq_codebook

STAGES = {"host_gather", "d2h_parents", "dispatch", "wall"}


def _bundle(info):
    prefix = info["prefix"]
    queries = load_bin_auto(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return prefix, queries, gt_ids, gt_dists


@pytest.fixture(scope="module", params=["f32", "u8"])
def bundle(request, tiny_index, tiny_uint8_index):
    info = tiny_index if request.param == "f32" else tiny_uint8_index
    return (request.param, *_bundle(info))


# -- the native gather ---------------------------------------------------------


def _gather_args(searcher):
    m = searcher.meta
    return (searcher.raw, m.entry_len, searcher.vec_bytes, m.dim, m.degree,
            m.dtype_code)


@pytest.mark.parametrize("raw_vecs", [False, True], ids=["f32", "raw"])
def test_native_gather_matches_both_plain_versions(bundle, raw_vecs):
    _, prefix, _, _, _ = bundle
    searcher = BaseVariantSearcher(prefix, device="cpu")
    args = _gather_args(searcher)
    q, r = 300, searcher.meta.degree  # 300 parents: two gather threads
    parents = np.random.default_rng(0).integers(0, searcher.meta.n, q).astype(np.int32)
    nbrs, vecs = native.gather_parents(*args, parents, n_threads=4, raw_vecs=raw_vecs)
    code = native.RAW_MODE if raw_vecs else searcher.meta.dtype_code
    vec_shape = (q, searcher.vec_bytes) if raw_vecs else (q, searcher.meta.dim)
    vec_dtype = np.uint8 if raw_vecs else np.float32
    for plain in (native.gather_parents_numpy, jax_gather_numpy):
        want_n = np.empty((q, r), np.int32)
        want_v = np.empty(vec_shape, vec_dtype)
        plain(args[0], *args[1:5], code, parents, want_n, want_v)
        np.testing.assert_array_equal(nbrs, want_n)
        assert vecs.dtype == vec_dtype
        np.testing.assert_array_equal(vecs.view(np.uint8), want_v.view(np.uint8))


def _records(n, d, r, degrees, seed):
    """Packed f32 records [N, 4d + 4 + 4r] with the given degrees (one past
    R: the native gather's corrupt-record guard clips it)."""
    rng = np.random.default_rng(seed)
    vec = rng.normal(size=(n, d)).astype(np.float32)
    adj = rng.integers(0, n, (n, r)).astype("<i4")
    recs = np.zeros((n, 4 * d + 4 + 4 * r), np.uint8)
    recs[:, : 4 * d] = vec.view(np.uint8)
    recs[:, 4 * d : 4 * d + 4] = np.asarray(degrees, "<u4")[:, None].view(np.uint8)
    recs[:, 4 * d + 4 :] = adj.view(np.uint8)
    return recs


def test_native_gather_pads_with_the_parent_id():
    n, d, r = 40, 3, 6
    degrees = np.arange(n) % (r + 2)  # 0..R, and R+1 (clipped to R)
    recs = _records(n, d, r, degrees, seed=1)
    args = (recs, recs.shape[1], 4 * d, d, r, 2)
    parents = np.arange(n, dtype=np.int32)[::-1].copy()
    nbrs, vecs = native.gather_parents(*args, parents)
    want_n = np.empty((n, r), np.int32)
    want_v = np.empty((n, d), np.float32)
    jax_gather_numpy(*args, parents, want_n, want_v)
    np.testing.assert_array_equal(nbrs, want_n)
    np.testing.assert_array_equal(vecs, want_v)
    for i, p in enumerate(parents):
        deg = min(degrees[p], r)
        assert (nbrs[i, deg:] == p).all()
        assert nbrs[i, :deg].tolist() == recs[p, 4 * d + 4 : 4 * d + 4 + 4 * deg].view(
            "<i4").tolist()


def test_native_gather_writes_caller_buffers(tiny_uint8_index):
    searcher = BaseVariantSearcher(tiny_uint8_index["prefix"], device="cpu")
    args = _gather_args(searcher)
    m = searcher.meta
    parents = np.arange(0, 2 * 37, 2, dtype=np.int32)
    # the pipeline's staging: torch tensors, written through their numpy views
    nbrs_t = torch.full((37, 2 * m.degree), -7, dtype=torch.int32)
    vecs_t = torch.zeros((37, 2, searcher.vec_bytes), dtype=torch.uint8)
    out_n = nbrs_t.numpy()[:, : m.degree]  # the right shape, strided
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_parents(*args, parents, raw_vecs=True, out_nbrs=out_n)
    out_n = nbrs_t.numpy().reshape(-1, m.degree)[:37]
    out_v = vecs_t.numpy().reshape(-1, searcher.vec_bytes)[:37]
    got_n, got_v = native.gather_parents(*args, parents, raw_vecs=True,
                                         out_nbrs=out_n, out_vecs=out_v)
    assert got_n is out_n and got_v is out_v
    want_n, want_v = native.gather_parents(*args, parents, raw_vecs=True)
    np.testing.assert_array_equal(out_n, want_n)
    np.testing.assert_array_equal(out_v, want_v)
    assert (nbrs_t.reshape(-1, m.degree)[37:] == -7).all()  # nothing past them
    with pytest.raises(ValueError, match="out_vecs"):
        native.gather_parents(*args, parents, out_vecs=out_v)  # f32 mode
    with pytest.raises(ValueError, match="parents"):
        native.gather_parents(*args, np.array([0, m.n], np.int32))


def test_native_build_failure_raises(monkeypatch):
    """No fallback: a build that cannot run raises with the command."""
    monkeypatch.setattr(native, "CXX", "/nonexistent/bin/g++")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.library_path().exists()
    with pytest.raises(RuntimeError, match="host gather build failed.*nonexistent"):
        native.load_library()


# -- the search against JAX ----------------------------------------------------


@pytest.mark.parametrize("L", [48, 64])
@pytest.mark.parametrize("beam", [1, 2, 4])
def test_search_matches_jax(bundle, beam, L):
    kind, prefix, queries, gt_ids, gt_dists = bundle
    params = SearchParams(L=L, k=10, beam_width=beam)
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
    assert abs(r_t - r_j) <= 0.5, (r_t, r_j)
    assert r_t > 85.0
    assert (np.diff(t_d, axis=1) >= 0).all()


@pytest.mark.parametrize("nb", [2, 3])
def test_sub_batch_splits_give_identical_ids(bundle, nb):
    """Queries are independent: one sub-batch, two, or an uneven three give
    the same ids and distances."""
    _, prefix, queries, _, _ = bundle
    params = SearchParams(L=48, k=10, beam_width=2)
    one = BaseVariantSearcher(prefix, n_pipeline_batches=1, device="cpu")
    split = BaseVariantSearcher(prefix, n_pipeline_batches=nb, device="cpu")
    a_ids, a_d = one.search(queries[:100], params)
    b_ids, b_d = split.search(queries[:100], params)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_d, b_d)
    # each outer iteration waits once, then steps every live sub-batch; the
    # wait that finds a sub-batch finished dispatches nothing for it
    assert one.last_n_d2h <= one.last_n_steps <= one.last_n_d2h + 1
    assert split.last_n_d2h < split.last_n_steps <= nb * (split.last_n_d2h + 1)


@pytest.mark.parametrize("b", [1, 2, 4])
def test_sampled_entry_matches_jax(bundle, b):
    _, prefix, queries, _, _ = bundle
    pq = load_pq(prefix)
    codes = pq.codes
    j = np.asarray(jax_sampled_entry(
        queries, codes, jax_codebook(pq.pivots, pq.centroid, pq.chunk_offsets), 256, b))
    t = _sampled_entry_base(
        torch.from_numpy(queries), torch.from_numpy(codes),
        prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, "cpu"), 256, b)
    assert t.dtype == torch.int32 and t.shape == (len(queries), b)
    same = (t.numpy() == j).all(axis=1)
    assert same.mean() >= 0.99, same.mean()


def test_sampled_entry_search_recall(bundle):
    """Sampled entry: recall within 0.5 points of JAX's sampled search and
    within 1.5 of the medoid start, with no more device steps."""
    _, prefix, queries, gt_ids, gt_dists = bundle
    port = BaseVariantSearcher(prefix, n_pipeline_batches=2, device="cpu")
    medoid = SearchParams(L=48, k=10, beam_width=2)
    sampled = SearchParams(L=48, k=10, beam_width=2, entry_mode="sampled",
                           entry_samples=256)
    r_m = calculate_recall(gt_ids, port.search(queries, medoid)[0], 10, gt_dists)
    steps_m = port.last_n_steps
    r_s = calculate_recall(gt_ids, port.search(queries, sampled)[0], 10, gt_dists)
    steps_s = port.last_n_steps
    j_ids, _ = JaxBase(prefix, n_pipeline_batches=2).search(queries, sampled)
    r_j = calculate_recall(gt_ids, j_ids, 10, gt_dists)
    assert abs(r_s - r_j) <= 0.5, (r_s, r_j)
    assert r_s >= r_m - 1.5, (r_m, r_s)
    assert steps_s <= steps_m, (steps_m, steps_s)


class _CardRouteSearcher(BaseVariantSearcher):
    """The walk the card takes, on the CPU: bf16-pair tables packed once per
    sub-batch, read by K1's wrapper on CPU tensors (its plain version)."""

    def _prepare_tables(self, sub_queries):
        packed = pk.pack_tables(pq_distance_tables(self.codebook, sub_queries))

        def distance_fn(cand_ids, parents=None):
            return pk.pq_lookup(packed, self.codes[cand_ids.long()])

        return distance_fn


@pytest.mark.parametrize("beam", [1, 2])
def test_card_route_walk_recall_matches_f32(bundle, beam):
    """The walk steered by K1's plain version on packed tables keeps
    recall@10 within 1.0 point of the CPU's f32 route (bf16 entries move
    PQ sums by ~0.2%), its device steps within 10%."""
    _, prefix, queries, gt_ids, gt_dists = bundle
    params = SearchParams(L=48, k=10, beam_width=beam)
    f32 = BaseVariantSearcher(prefix, n_pipeline_batches=2, device="cpu")
    card = _CardRouteSearcher(prefix, n_pipeline_batches=2, device="cpu")
    r_f32 = calculate_recall(gt_ids, f32.search(queries, params)[0], 10, gt_dists)
    r_card = calculate_recall(gt_ids, card.search(queries, params)[0], 10, gt_dists)
    assert abs(r_card - r_f32) <= 1.0, (r_card, r_f32)
    assert abs(card.last_n_steps - f32.last_n_steps) <= 0.1 * f32.last_n_steps
    assert r_card > 85.0


# -- the facade ----------------------------------------------------------------


def test_api_base_lifecycle_and_stage_timers(tiny_index):
    prefix, queries, gt_ids, gt_dists = _bundle(tiny_index)
    s = BANGSearch("base", device="cpu")
    assert s.bang_load(prefix, mmap=False, n_pipeline_batches=3)
    assert s._searcher.n_pipeline_batches == 3 and not isinstance(s._searcher.raw,
                                                                  np.memmap)
    s.bang_set_searchparams(10, 64, beam_width=2)
    s.bang_alloc(64)
    s.bang_init()
    ids, dists = s.bang_query(queries[:64])
    assert ids.dtype == np.int64 and ids.shape == (64, 10)
    assert dists.dtype == np.float32 and np.isfinite(dists).all()
    assert calculate_recall(gt_ids[:64], ids, 10, gt_dists[:64]) >= 88.0
    assert s.last_stats is None and not s._searcher.timers.ms  # timers off
    s.bang_set_searchparams(10, 64, beam_width=2, capabilities=ENABLE_GPU_STATS)
    ids2, _ = s.bang_query(queries[:64])
    np.testing.assert_array_equal(ids2, ids)
    ms = s._searcher.timers.ms
    assert set(ms) == STAGES and all(v > 0 for v in ms.values()), dict(ms)
    assert ms["host_gather"] < ms["wall"]
    assert s._searcher.last_n_d2h > 0 and s._searcher.last_n_steps > 2 * s._searcher.last_n_d2h
    s.bang_free()
    s.bang_unload()
    assert s._searcher is None
    assert isinstance(BANGSearch("base", device="cpu"), BANGSearch)
    mm = BANGSearch("base", device="cpu")
    mm.bang_load(prefix)  # the JAX defaults: mmap, 4 sub-batches
    assert isinstance(mm._searcher.raw, np.memmap) and mm._searcher.n_pipeline_batches == 4
    with pytest.raises(ValueError, match="layouts"):
        mm.bang_load(prefix, fused_frontier=False)


def test_api_base_refusals_name_roadmap(tiny_index):
    """Bloom (ROADMAP item 15), ENABLE_CACHE_WARMUP (item 11) and the JAX
    kernel names in pq_impl, once refused, are served: "pallas" walks on
    the packed tables as the card does (K1's plain version here, the walk
    of _CardRouteSearcher), "xla" on the f32 tables, the CPU's "auto"; the
    card without a card still raises."""
    prefix, queries, _, _ = _bundle(tiny_index)
    s = BANGSearch("base", device="cpu")
    s.bang_load(prefix)
    s.bang_set_searchparams(10, 16, visited_mode="bloom")
    ids, dists = s.bang_query(queries[:2])
    assert ids.shape == (2, 10) and np.isfinite(dists).all()
    s.bang_set_searchparams(10, 16, capabilities=ENABLE_CACHE_WARMUP)
    s.bang_alloc(4)
    assert s.warmup_touched > 0.99 * len(s._searcher.raw)
    assert s.bang_query(queries[:2])[0].shape == (2, 10)
    s.bang_set_searchparams(10, 16)
    auto = s.bang_query(queries[:8])
    params = SearchParams(L=16, k=10)
    card = _CardRouteSearcher(prefix, device="cpu").search(queries[:8], params)
    for impl, want in (("pallas", card), ("xla", auto)):
        s.bang_set_searchparams(10, 16, pq_impl=impl)
        got = s.bang_query(queries[:8])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            BaseVariantSearcher(prefix)  # the card by default
