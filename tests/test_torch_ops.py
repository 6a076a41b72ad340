"""The port's tensor ops (bang_tpu_torch.ops) against the JAX package.

Inputs are made from a seed with numpy and fed to both packages; JAX runs on
the CPU as the rest of the suite runs it. Tolerances:
  * float ops (PQ tables, PQ lookup, exact L2): rtol 1e-5 plus an atol of
    1e-5 x the row's magnitude — the two packages sum float32 terms in a
    different order, nothing else differs;
  * visited filters, worklist merge and parent selection: bit-identical,
    on inputs with distance ties and rows with fewer than `beam` unvisited
    slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bang_tpu.formats import synthetic
from bang_tpu.ops import l2 as jl2
from bang_tpu.ops import merge as jmerge
from bang_tpu.ops import pq as jpq
from bang_tpu.ops import visited as jvisited
from bang_tpu_torch.ops import l2 as tl2
from bang_tpu_torch.ops import merge as tmerge
from bang_tpu_torch.ops import pq as tpq
from bang_tpu_torch.ops import visited as tvisited

INVALID = -1


def _close(got, want, rtol=1e-5):
    """rtol 1e-5 with atol 1e-5 x the largest magnitude in the row."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = rtol * np.abs(want) + 1e-5 * np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max err {err.max()} (worst excess {(err - tol).max()})"


@pytest.mark.parametrize("dim,m", [(48, 12), (30, 8)])
def test_pq_tables_and_lookup_match_jax(dim, m):
    """Tables and the gather+sum lookup (the plain version of both kernels)
    agree with JAX, uneven chunk sizes included (dim=30, m=8)."""
    data = synthetic.make_clustered_data(2000, dim, n_clusters=8, seed=1)
    pq = synthetic.train_pq(data, m, kmeans_iters=4, seed=1)
    rng = np.random.default_rng(2)
    queries = data[rng.integers(0, 2000, 16)] + rng.normal(0, 0.1, (16, dim)).astype(np.float32)
    codes = rng.integers(0, 256, size=(16, 40, m), dtype=np.uint8)

    jcb = jpq.prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets)
    tcb = tpq.prepare_pq_codebook(pq.pivots, pq.centroid, pq.chunk_offsets, "cpu")
    for a, b in zip(jcb, (tcb.piv_chunks, tcb.piv_norms, tcb.dim_idx,
                          tcb.dim_mask, tcb.centroid)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    jt = jpq.pq_distance_tables(jcb, jnp.asarray(queries))
    tt = tpq.pq_distance_tables(tcb, torch.from_numpy(queries))
    assert tt.shape == (16, m, 256) and tt.is_contiguous()
    _close(tt.reshape(16, -1), np.asarray(jt).reshape(16, -1))

    jl = jpq.pq_lookup(jt, jnp.asarray(codes))
    tl = tpq.pq_lookup(torch.from_numpy(np.array(jt)), torch.from_numpy(codes))
    _close(tl, jl)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_l2_distance_matches_jax(dtype):
    rng = np.random.default_rng(3)
    if dtype == np.uint8:
        vecs = rng.integers(0, 256, size=(8, 30, 32), dtype=np.uint8)
        q = rng.integers(0, 256, size=(8, 32)).astype(np.float32)
    else:
        vecs = rng.normal(size=(8, 30, 32)).astype(np.float32)
        q = rng.normal(size=(8, 32)).astype(np.float32)
    want = np.asarray(jl2.l2_distance_to_candidates(jnp.asarray(q), jnp.asarray(vecs)))
    got = tl2.l2_distance_to_candidates(torch.from_numpy(q), torch.from_numpy(vecs))
    if dtype == np.uint8:  # integer distances below 2^24: exact in f32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got, want)
    norms = tl2.squared_norms(torch.from_numpy(vecs[0]))
    _close(norms, jl2.squared_norms(jnp.asarray(vecs[0])))


def _ids(rng, shape, hi=50):
    return rng.integers(0, hi, size=shape).astype(np.int32)


@pytest.mark.parametrize("q,c,l,mi,case", [
    (16, 24, 20, 12, "tails"),
    (4, 128, 128, 140, "tails"),  # the fused in-memory search's L=128 shape
    (8, 64, 100, 106, "tails"),  # the exact search's L=100 shape
    (16, 24, 20, 12, "no worklist tail"),
    (16, 24, 20, 12, "duplicates"),
    (16, 24, 20, 12, "visited all invalid"),
])
def test_exact_new_mask_bit_identical(q, c, l, mi, case):
    """The sorted mask against JAX's dense `exact_new_mask` and against the
    port's `exact_new_mask_dense`, with INVALID_ID candidates among the
    candidates and, unless the case says otherwise, INVALID_ID tails in the
    worklist and the visited list."""
    rng = np.random.default_rng(4 + c + l)
    hi = 30 if case == "duplicates" else 2 * (l + mi)
    cand = _ids(rng, (q, c), hi)
    cand[rng.random((q, c)) < 0.1] = INVALID
    wl = _ids(rng, (q, l), hi)
    vis = _ids(rng, (q, mi), hi)
    if case != "no worklist tail":
        wl[:, 3 * l // 4 :] = INVALID
    vis[:, mi // 2 :] = INVALID
    if case == "visited all invalid":
        vis[:] = INVALID
    if case == "duplicates":
        wl[:, 1] = wl[:, 0]
        vis[:, 1] = vis[:, 0] = wl[:, 0]
        assert (cand == wl[:, :1]).any()
    want = jvisited.exact_new_mask(jnp.asarray(cand), jnp.asarray(wl), jnp.asarray(vis))
    args = tuple(map(torch.from_numpy, (cand, wl, vis)))
    got = tvisited.exact_new_mask(*args)
    assert got.dtype == torch.bool and got.shape == (q, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tvisited.exact_new_mask_dense(*args))
    assert 0 < got.sum() < got.numel()
    assert not got[torch.from_numpy(cand == INVALID)].any()  # INVALID is never new


@pytest.mark.parametrize("caps", [0, 1, 2, 3, 4])
def test_check_params_refuses_capabilities(caps):
    """ENABLE_GPU_STATS (1) and ENABLE_CACHE_WARMUP (2) are served, alone
    and together, as in the JAX package; a bit past them (4) raises, naming
    the known ones. Both visited modes pass."""
    from bang_tpu_torch.models.traversal import check_params
    from bang_tpu_torch.utils.config import SearchParams

    params = SearchParams(L=16, capabilities=caps)
    if caps <= 3:
        check_params(params)
        check_params(SearchParams(L=16, capabilities=caps, visited_mode="bloom"))
        return
    with pytest.raises(ValueError, match="capabilities=0x4.*ENABLE_CACHE_WARMUP"):
        check_params(params)


@pytest.mark.parametrize("beam", [2, 4])
def test_first_occurrence_mask_blocks_bit_identical(beam):
    rng = np.random.default_rng(5 + beam)
    cand = _ids(rng, (16, beam * 8), hi=30)  # small id range: many duplicates
    want = jvisited.first_occurrence_mask_blocks(jnp.asarray(cand), beam)
    got = tvisited.first_occurrence_mask_blocks(torch.from_numpy(cand), beam)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.all()


def _worklist(rng, q, l):
    """A sorted worklist with integer-valued distances (ties) and an
    INVALID/+inf tail, as merge_worklist keeps it."""
    d = np.sort(rng.integers(0, 20, size=(q, l)).astype(np.float32), axis=1)
    ids = _ids(rng, (q, l), hi=1000)
    vis = rng.random((q, l)) < 0.5
    n_valid = rng.integers(0, l + 1, size=q)
    tail = np.arange(l)[None, :] >= n_valid[:, None]
    d[tail] = np.inf
    ids[tail] = INVALID
    vis[tail] = True
    return d, ids, vis


def test_merge_worklist_bit_identical():
    rng = np.random.default_rng(6)
    wd, wi, wv = _worklist(rng, 32, 16)
    cd = rng.integers(0, 20, size=(32, 24)).astype(np.float32)
    cd[rng.random((32, 24)) < 0.3] = np.inf  # filtered lanes
    ci = _ids(rng, (32, 24), hi=1000)
    want = jmerge.merge_worklist(*map(jnp.asarray, (wd, wi, wv, cd, ci)), impl="sort")
    got = tmerge.merge_worklist(*map(torch.from_numpy, (wd, wi, wv, cd, ci)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("beam", [1, 3])
def test_select_parents_beam_bit_identical(beam):
    rng = np.random.default_rng(7 + beam)
    wd, wi, wv = _worklist(rng, 32, 12)
    wv[:4] = True  # rows with no unvisited slot at all
    wv[4:8] = True
    wv[4:8, 5] = False  # rows with one unvisited slot, fewer than beam=3
    want = jmerge.select_parents_beam(*map(jnp.asarray, (wd, wi, wv)), beam)
    got = tmerge.select_parents_beam(*map(torch.from_numpy, (wd, wi, wv)), beam)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[2][:4].any() and got[2][4:8].all()


def test_tf32_stays_off_after_import():
    import importlib

    import bang_tpu_torch
    from bang_tpu_torch.device import assert_exact_float32

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            assert_exact_float32()
        importlib.reload(bang_tpu_torch)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert_exact_float32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def test_cuda_device_without_card_raises(monkeypatch):
    from bang_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
