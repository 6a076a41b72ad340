"""K3 of the port (bang_tpu_torch.ops.exact_kernels) and the fused exact rows
(bang_tpu_torch.ops.l2) against the JAX package, on the CPU.

Here the wrapper takes its plain version (the tensors lie on the CPU); the
CUDA kernel itself is compared with the same plain version on the card by
chip_smoke.py. Bars:
  * rows byte-identical to JAX's `pack_exact_frontier_rows`, with ids above
    2^16 so that byte plane 2 is in play;
  * ids bit-exact everywhere; distances bit-exact for integer-valued
    queries (u8 vectors, D <= 128: every partial sum is an integer below
    2^24, exact in f32 in any order), else within rtol 1e-5 plus atol
    1e-5 x (||q||^2 + the row's largest norm), summation order only;
  * against the Pallas kernel `exact_frontier_dma` in interpret mode, at the
    one shape it takes (R=64, D=128, DMA-tiled rows), and against the JAX
    XLA path at a shape it does not take (R=24, D=20, beam 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bang_tpu.ops import l2 as jl2
from bang_tpu.ops.pq_pallas import exact_frontier_dma, pack_exact_frontier_rows_tiled
from bang_tpu_torch.ops import _build
from bang_tpu_torch.ops import exact_kernels as ek
from bang_tpu_torch.ops import l2 as tl2
from bang_tpu_torch.ops import pq_kernels as pk


def _table(rng, n, r, d):
    """u8 vectors [n, d], their f32 norms (float64 sum, then cast, as JAX's
    index), and a random adjacency [n, r] over all n ids."""
    vectors = rng.integers(0, 256, size=(n, d), dtype=np.uint8)
    norms = (vectors.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    adj = rng.integers(0, n, size=(n, r), dtype=np.int32)
    return vectors, norms, adj


def _torch_rows(adj, vectors, norms):
    return tl2.pack_exact_frontier_rows(
        torch.from_numpy(adj), torch.from_numpy(vectors), torch.from_numpy(norms))


def _queries(rng, q, d, integer):
    if integer:
        return rng.integers(0, 256, size=(q, d)).astype(np.float32)
    return (rng.normal(size=(q, d)) * 80).astype(np.float32)


def _assert_dists(got, want, queries, norms, integer):
    got, want = np.asarray(got), np.asarray(want)
    if integer:
        np.testing.assert_array_equal(got, want)
        return
    scale = (queries.astype(np.float64) ** 2).sum(1, keepdims=True) + norms.max(1, keepdims=True)
    err = np.abs(got - want)
    assert (err <= 1e-5 * np.abs(want) + 1e-5 * scale).all(), err.max()


def test_exact_rows_byte_identical_to_jax_and_decode():
    """pack_exact_frontier_rows equals JAX's byte for byte; the decode
    returns the ids, norms and vectors of every parent's neighbors."""
    rng = np.random.default_rng(7)
    n, r, d = 70_000, 8, 16
    vectors, norms, adj = _table(rng, n, r, d)
    want = np.asarray(jl2.pack_exact_frontier_rows(
        jnp.asarray(adj), jnp.asarray(vectors), jnp.asarray(norms), n_blocks=4))
    got = _torch_rows(adj, vectors, norms)
    assert got.shape == (n, 8 * r + r * d)
    np.testing.assert_array_equal(got.numpy(), want)

    parents = rng.integers(0, n, size=(32, 2), dtype=np.int32)
    ids, dn, vecs = tl2.decode_exact_frontier_rows(got[torch.from_numpy(parents).long()], r, d)
    want_ids = adj[parents].reshape(32, 2 * r)
    assert want_ids.max() > 1 << 16  # byte plane 2 in play
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(dn.numpy(), norms[want_ids])
    np.testing.assert_array_equal(vecs.numpy(), vectors[want_ids])
    j_ids, j_dn, j_vecs = jl2.decode_exact_frontier_rows(jnp.asarray(want)[parents], r, d)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(dn.numpy(), np.asarray(j_dn))
    np.testing.assert_array_equal(vecs.numpy(), np.asarray(j_vecs))


def test_pack_exact_rows_rejects_float_vectors():
    with pytest.raises(ValueError, match="u8"):
        tl2.pack_exact_frontier_rows(torch.zeros((2, 4), dtype=torch.int32),
                                     torch.zeros((8, 3)), torch.zeros(8))


@pytest.mark.parametrize("beam", [1, 2])
def test_plain_matches_pallas_interpret(beam):
    """Against the Pallas kernel in interpret mode at its one shape: R=64,
    D=128, Q=8, tile_q=8; ids up to N > 2^16; integer queries."""
    rng = np.random.default_rng(10 + beam)
    n, r, d, q = 70_000, 64, 128, 8
    vectors, norms, adj = _table(rng, n, r, d)
    queries = _queries(rng, q, d, integer=True)
    parents = rng.integers(0, n, size=(q, beam), dtype=np.int32)
    tiled = pack_exact_frontier_rows_tiled(
        jnp.asarray(adj), jnp.asarray(vectors), jnp.asarray(norms))
    want_ids, want_d = exact_frontier_dma(
        jnp.asarray(queries), jnp.asarray(tiled), jnp.asarray(parents),
        r=r, d=d, beam=beam, tile_q=8, interpret=True,
    )
    rows = _torch_rows(adj, vectors, norms)
    got_ids, got_d = ek.exact_frontier(torch.from_numpy(queries), rows,
                                       torch.from_numpy(parents))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("integer", [True, False])
def test_plain_matches_jax_xla_path(integer):
    """Against the JAX XLA path (gather + decode_exact_frontier_rows +
    l2_distance_to_candidates) at R=24, D=20, beam 3."""
    _against_jax_xla_path(np.random.default_rng(20 + integer), integer, 24, 20, 3)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("r,d,beam", [(20, 13, 3), (15, 9, 2)])
def test_plain_matches_jax_xla_path_at_unaligned_rows(integer, r, d, beam):
    """As above at the row widths of the kernel's 4-byte (R=20, D=13: 420 B)
    and byte (R=15, D=9: 255 B) row copies."""
    _against_jax_xla_path(np.random.default_rng(30 + d + integer), integer, r, d, beam)


def _against_jax_xla_path(rng, integer, r, d, beam):
    n, q = 5000, 12
    vectors, norms, adj = _table(rng, n, r, d)
    queries = _queries(rng, q, d, integer)
    parents = rng.integers(0, n, size=(q, beam), dtype=np.int32)
    flat = jl2.pack_exact_frontier_rows(jnp.asarray(adj), jnp.asarray(vectors),
                                        jnp.asarray(norms))
    j_ids, j_norms, j_vecs = jl2.decode_exact_frontier_rows(flat[parents], r, d)
    want_d = jl2.l2_distance_to_candidates(jnp.asarray(queries), j_vecs, j_norms)
    got_ids, got_d = ek.exact_frontier(
        torch.from_numpy(queries), _torch_rows(adj, vectors, norms),
        torch.from_numpy(parents))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(j_ids))
    _assert_dists(got_d, want_d, queries, np.asarray(j_norms), integer)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(1)
    vectors, norms, adj = _table(rng, 300, 8, 12)
    rows = _torch_rows(adj, vectors, norms)
    queries = torch.from_numpy(_queries(rng, 5, 12, integer=False))
    parents = torch.from_numpy(rng.integers(0, 300, size=(5, 2), dtype=np.int32))
    pk.reset_launch_counts()
    got = ek.exact_frontier(queries, rows, parents)
    want = ek.exact_frontier_plain(queries, rows, parents)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ek.exact_frontier in pk.KERNELS and ek.exact_frontier.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    queries = torch.zeros((4, 16))
    rows = torch.zeros((10, 8 * (8 + 16)), dtype=torch.uint8)
    parents = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        ek.exact_frontier(queries.double(), rows, parents)
    with pytest.raises(ValueError, match="int32"):
        ek.exact_frontier(queries, rows, parents.long())
    with pytest.raises(ValueError, match="contiguous"):
        ek.exact_frontier(queries, rows, torch.zeros((2, 4), dtype=torch.int32).T)
    with pytest.raises(ValueError, match="not R"):
        ek.exact_frontier(queries, rows[:, :-1].contiguous(), parents)
    with pytest.raises(ValueError, match="not R"):
        ek.exact_frontier(queries, torch.zeros((10, 65 * 24), dtype=torch.uint8), parents)
    with pytest.raises(ValueError, match="beam"):
        ek.exact_frontier(queries, rows, torch.zeros((4, 17), dtype=torch.int32))
    with pytest.raises(ValueError, match="beam"):
        ek.exact_frontier(queries, rows, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, 60_000))
        ek.exact_frontier(big, torch.zeros((1, 60_008), dtype=torch.uint8),
                          torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        ek.exact_frontier(queries.numpy(), rows, parents)


def test_wrapper_takes_a_beam_whose_rows_exceed_shared_memory():
    """Only the query and one parent row must fit a block's shared memory:
    the kernel takes a wide beam's parents in groups. Here 16 rows of
    R=64, D=240 (15,872 B each, 254 KB) exceed it."""
    rng = np.random.default_rng(2)
    r, d, beam = 64, 240, 16
    assert beam * r * (8 + d) + 4 * d > _build.MAX_SHARED_BYTES
    vectors, norms, adj = _table(rng, 100, r, d)
    queries = torch.from_numpy(_queries(rng, 3, d, integer=True))
    parents = torch.from_numpy(rng.integers(0, 100, size=(3, beam), dtype=np.int32))
    ids, dists = ek.exact_frontier(queries, _torch_rows(adj, vectors, norms), parents)
    np.testing.assert_array_equal(ids.numpy(), adj[parents.numpy()].reshape(3, beam * r))
    assert dists.shape == (3, beam * r) and torch.isfinite(dists).all()


def test_build_knows_the_exact_kernel():
    assert "exact_frontier" in _build.SIGNATURES
    assert (_build.SRC_DIR / "exact_frontier.cu").exists()
    src = (_build.SRC_DIR / "exact_frontier.cu").read_text()
    assert "extern \"C\" int exact_frontier_launch" in src
    assert "cublas" not in src.lower()
