"""The streaming index (models/streaming.py): the port against the JAX
package's StreamingIndex on the CPU.

On u8 data every distance the index computes is an integer below 2^24,
exact in f32 in any order, and ties break lowest index first on both sides,
so the two indexes go through the same operations to the same state: after
each insert, delete, consolidate and re-insert, `adj`, `degrees`,
`deleted`, `free`, `hwm`, the medoid and the repaired count are identical,
and so are the search ids and distances. The medoid election after a
consolidate that frees the medoid is an argmin over a float centroid; it
agrees here, and the test says so if it ever does not. On f32 data the JAX
tests' own pins hold: recall@10 >= 85, the capacity guard, INVALID_ID
padding when k exceeds the live count.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bang_tpu.constants import INVALID_ID
from bang_tpu.formats.vamana import _insert_batch as jax_insert_batch
from bang_tpu.formats.vamana import build_vamana_graph as jax_build_vamana
from bang_tpu.models.streaming import StreamingIndex as JaxStreaming
from bang_tpu.utils.config import SearchParams
from bang_tpu_torch.formats import vamana as tvamana
from bang_tpu_torch.formats.synthetic import make_clustered_data
from bang_tpu_torch.models.streaming import StreamingIndex, _elect_medoid

N, DIM, R = 3000, 24, 16
PARAMS = SearchParams(L=32, k=10, extra_iters=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small eager ops on one intra-op thread: under a parallel
    test run, a thread pool per worker oversubscribes the cores and makes
    these walks many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def u8_data():
    pts = make_clustered_data(N, DIM, n_clusters=30, dtype=np.uint8, seed=7)
    rng = np.random.default_rng(1)
    queries = np.clip(pts[rng.integers(0, N, 100)].astype(np.float32)
                      + np.rint(rng.normal(0, 2.0, (100, DIM))), 0, 255)
    return pts, queries.astype(np.float32)


def _assert_same(jix, tix, queries, what):
    cap = jix.capacity
    np.testing.assert_array_equal(tix.adj[:cap].numpy(), np.asarray(jix.adj), what)
    np.testing.assert_array_equal(tix.degrees[:cap].numpy(), np.asarray(jix.degrees), what)
    np.testing.assert_array_equal(tix.deleted[:cap].numpy(), np.asarray(jix.deleted), what)
    assert bool(tix.deleted[cap])  # the trash row is never live
    assert (tix.free, tix.hwm, tix.n_live) == (jix.free, jix.hwm, jix.n_live), what
    j_ids, j_d = jix.search(queries, PARAMS)
    t_ids, t_d = tix.search(queries, PARAMS)
    assert t_ids.dtype == np.int32
    np.testing.assert_array_equal(t_ids, j_ids, what)
    np.testing.assert_array_equal(t_d, j_d, what)


def _churn(jix, tix, pts, queries, victims):
    """Delete `victims` (the medoid among them), consolidate, re-insert 100
    of them into the freed slots: identical after each step."""
    jix.delete(victims)
    tix.delete(victims)
    _assert_same(jix, tix, queries, "delete")
    medoid = jix.medoid
    j_rep, t_rep = jix.consolidate(batch=512), tix.consolidate(batch=512)
    assert t_rep == j_rep and t_rep > 0
    assert sorted(tix.free) == sorted(victims.tolist())
    if tix.medoid != jix.medoid:  # an argmin over a float centroid
        v = tix.vectors[: jix.capacity].float()
        live = ~tix.deleted[: jix.capacity]
        c = v[live].mean(0)
        d = ((v - c) ** 2).sum(1)
        assert torch.isclose(d[tix.medoid], d[jix.medoid], rtol=1e-5), (
            "medoid elections differ beyond a near-tie")
        warnings.warn(f"the medoid elections split a near-tie ({tix.medoid} vs "
                      f"{jix.medoid}); the states are not comparable after it")
        return
    assert medoid in victims and tix.medoid not in victims
    _assert_same(jix, tix, queries, "consolidate")
    back = victims[:100]
    np.testing.assert_array_equal(tix.insert(pts[back]), jix.insert(pts[back]))
    _assert_same(jix, tix, queries, "re-insert")


def test_identical_to_jax_from_empty(u8_data):
    pts, queries = u8_data
    jix = JaxStreaming(capacity=N + 64, dim=DIM, r=R, l_build=24, dtype=np.uint8)
    tix = StreamingIndex(capacity=N + 64, dim=DIM, r=R, l_build=24, dtype=np.uint8,
                         device="cpu")
    for s in range(0, 2000, 500):
        np.testing.assert_array_equal(tix.insert(pts[s : s + 500]),
                                      jix.insert(pts[s : s + 500]))
    _assert_same(jix, tix, queries, "insert")
    rng = np.random.default_rng(3)
    victims = rng.choice(2000, 300, replace=False).astype(np.int32)
    victims[0] = jix.medoid
    _churn(jix, tix, pts, queries, np.unique(victims))


def test_identical_to_jax_from_built(u8_data):
    pts, queries = u8_data
    adj, deg, medoid = jax_build_vamana(pts[:2000], r=R, l_build=24, batch=500,
                                        verbose=False)
    jix = JaxStreaming.from_built(pts[:2000], adj, deg, medoid, capacity=N, l_build=24)
    tix = StreamingIndex.from_built(pts[:2000], adj, deg, medoid, capacity=N,
                                    l_build=24, device="cpu")
    _assert_same(jix, tix, queries, "from_built")
    for s in range(2000, 2500, 250):
        ids = tix.insert(pts[s : s + 250])
        np.testing.assert_array_equal(ids, jix.insert(pts[s : s + 250]))
        assert ids.tolist() == list(range(s, s + 250))  # contiguous growth
    _assert_same(jix, tix, queries, "insert")
    rng = np.random.default_rng(5)
    victims = rng.choice(2500, 250, replace=False).astype(np.int32)
    victims[0] = jix.medoid
    _churn(jix, tix, pts, queries, np.unique(victims))


def test_elect_medoid_is_the_live_point_nearest_the_centroid():
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.integers(0, 256, (40, 8)).astype(np.uint8))
    norms = (v.float() ** 2).sum(1)
    deleted = torch.from_numpy(rng.random(40) < 0.3)
    got = _elect_medoid(v, norms, deleted)
    live = (~deleted).nonzero().view(-1)
    c = v[live].double().mean(0)
    d = ((v[live].double() - c) ** 2).sum(1)
    assert got in live.tolist() and d[live.tolist().index(got)] <= d.min() + 1e-6


# -- the JAX tests' pins on f32 data --------------------------------------------


@pytest.fixture(scope="module")
def f32_data():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(30, DIM)) * 4.0
    pts = centers[rng.integers(0, 30, N)] + rng.normal(size=(N, DIM))
    queries = centers[rng.integers(0, 30, 200)] + rng.normal(size=(200, DIM))
    return pts.astype(np.float32), queries.astype(np.float32)


def test_insert_from_empty_recall(f32_data):
    pts, queries = f32_data
    ix = StreamingIndex(capacity=N + 64, dim=DIM, r=R, l_build=24, device="cpu")
    for s in range(0, N, 500):
        ix.insert(pts[s : s + 500])
    assert ix.n_live == N
    ids, dists = ix.search(queries, PARAMS)
    d = ((queries[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    assert 100.0 * hits / gt.size >= 85.0
    np.testing.assert_allclose(dists[:, 0], ((queries - pts[ids[:, 0]]) ** 2).sum(-1),
                               rtol=1e-4)


def test_capacity_guard(f32_data):
    pts, _ = f32_data
    ix = StreamingIndex(capacity=100, dim=DIM, r=8, l_build=16, device="cpu")
    ix.insert(pts[:100])
    with pytest.raises(ValueError, match="capacity"):
        ix.insert(pts[100:101])
    with pytest.raises(ValueError, match="capacity"):
        StreamingIndex.from_built(pts[:10], np.zeros((10, 8), np.int32),
                                  np.zeros(10, np.int32), 0, capacity=5, device="cpu")


def test_invalid_padding_when_k_exceeds_live(f32_data):
    pts, _ = f32_data
    ix = StreamingIndex(capacity=64, dim=DIM, r=8, l_build=16, device="cpu")
    ix.insert(pts[:5])
    ids, dists = ix.search(pts[:2], SearchParams(L=16, k=10, extra_iters=16))
    assert (ids != INVALID_ID).sum(axis=1).max() <= 5
    assert (ids[:, 5:] == INVALID_ID).all() and np.isinf(dists[:, 5:]).all()


# -- _insert_batch's extra candidates --------------------------------------------


@pytest.mark.parametrize("extra", [False, True])
def test_insert_batch_extra_cand_identical_to_jax(u8_data, extra):
    """One `_insert_batch` on a random start graph, with and without extra
    candidates: the adjacency, degrees and dropped count equal JAX's."""
    pts, _ = u8_data
    n, r = 1000, 8
    v = pts[:n]
    rng = np.random.default_rng(9)
    adj0 = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, r)).copy()
    adj0[:, : r // 2] = rng.integers(0, n, (n, r // 2))
    deg0 = np.full(n, r // 2, np.int32)
    p_ids = rng.choice(n, 128, replace=False).astype(np.int32)
    ec = rng.integers(0, n, (128, 6)).astype(np.int32) if extra else None
    norms = (v.astype(np.float32) ** 2).sum(-1)
    kw = dict(r=r, alpha=1.2, l=16, max_iters=32, k_overflow=256, max_in=r)

    j_adj, j_deg, j_drop = jax_insert_batch(
        jnp.asarray(adj0), jnp.asarray(deg0), jnp.asarray(v), jnp.asarray(norms),
        jnp.asarray(p_ids), jnp.int32(7), extra_cand=None if ec is None else jnp.asarray(ec),
        **kw)
    t_adj = torch.empty((n + 1, r), dtype=torch.int32)
    t_adj[:n] = torch.from_numpy(adj0)
    t_adj[n] = n
    t_deg = torch.zeros(n + 1, dtype=torch.int32)
    t_deg[:n] = torch.from_numpy(deg0)
    t_drop = tvamana._insert_batch(
        t_adj, t_deg, torch.from_numpy(v), torch.from_numpy(norms),
        torch.from_numpy(p_ids), 7, extra_cand=None if ec is None else torch.from_numpy(ec),
        **kw)
    np.testing.assert_array_equal(t_adj[:n].numpy(), np.asarray(jax.device_get(j_adj)))
    np.testing.assert_array_equal(t_deg[:n].numpy(), np.asarray(j_deg))
    assert int(t_drop) == int(j_drop)
