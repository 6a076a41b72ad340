"""The sharded (beyond device memory) build: the port's formats/bigbuild.py
against the JAX package's on the CPU.

JAX's BlockGen draws with threefry, the port's with a torch generator, so
the two cannot draw the same bytes. Every other function reads any object
with n, dim, block, n_blocks and gen_block(b): one array-backed generator
feeds both packages the same blocks, and k-means starts from JAX's initial
sample in both. Bars: bytes and ids identical (u8 data gives exact integer
distances everywhere); the ground truth also equal to float64 brute force.
"""

import jax
import numpy as np
import pytest
import torch

from bang_tpu.formats import bigbuild as jbb
from bang_tpu_torch.formats import bigbuild as bb
from bang_tpu_torch.formats import synthetic

N, DIM, BLOCK = 2400, 24, 1024  # three blocks, the last one partial


class ArrayGen:
    """One u8 dataset served block by block (numpy) to both packages; rows
    past n are zero padding, as a generator's last block has padding."""

    device = torch.device("cpu")

    def __init__(self, data, block):
        self.n, self.dim = data.shape
        self.block = block
        self.n_blocks = -(-self.n // block)
        self._rows = np.zeros((self.n_blocks * block, self.dim), np.uint8)
        self._rows[: self.n] = data

    def gen_block(self, b):
        return self._rows[b * self.block : (b + 1) * self.block]


@pytest.fixture(scope="module")
def data():
    return synthetic.make_clustered_data(N, DIM, n_clusters=16, dtype=np.uint8, seed=5)


@pytest.fixture(scope="module")
def gen(data):
    return ArrayGen(data, BLOCK)


def _jax_initial(n, k, seed):
    """JAX's k-means initial sample (bigbuild.kmeans_device's draw)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False))


@pytest.fixture()
def jax_initial_centers(monkeypatch):
    """The port's k-means starts from JAX's initial sample."""
    monkeypatch.setattr(bb, "_initial_centers",
                        lambda n, k, seed, device: torch.tensor(_jax_initial(n, k, seed)))


@pytest.fixture(scope="module")
def centers(gen):
    return np.asarray(jbb.kmeans_device(gen.gen_block(0), 3, iters=12, seed=1))


@pytest.mark.parametrize("case", ["hand", "random"])
def test_merge_shard_adj_matches_jax(case):
    if case == "hand":  # tests/test_bigbuild.py's case
        n, r = 6, 4
        p0 = np.array([[1, 2, 3, 0], [0, 2, 1, 1], [3, 3, 2, 2],
                       [4, 5, 3, 3], [5, 0, 4, 4], [0, 1, 5, 5]], np.int32)
        p1 = np.array([[2, 4, 0, 0], [3, 0, 1, 1], [1, 2, 2, 2],
                       [3, 3, 3, 3], [2, 3, 4, 4], [4, 2, 5, 5]], np.int32)
        parts, chunk = [p0, p1], 4
    else:  # duplicates, self ids, three overlap slots, several chunks
        n, r = 500, 16
        rng = np.random.default_rng(3)
        parts = [rng.integers(0, 60, (n, r)).astype(np.int32) % n for _ in range(3)]
        parts[1][::7] = np.arange(n, dtype=np.int32)[::7, None]
        chunk = 128
    adj, deg = bb.merge_shard_adj(parts, r, n, chunk=chunk)
    want_adj, want_deg = jbb.merge_shard_adj(parts, r, n, chunk=chunk)
    assert adj.tobytes() == want_adj.tobytes() and deg.tobytes() == want_deg.tobytes()
    if case == "hand":
        np.testing.assert_array_equal(adj[0], [1, 2, 4, 3])
        np.testing.assert_array_equal(adj[3], [4, 5, 3, 3])
        assert deg[0] == 4 and deg[3] == 2


def test_kmeans_matches_jax(gen, centers, jax_initial_centers):
    sample = gen.gen_block(0)
    data = torch.as_tensor(sample).float()
    init = torch.as_tensor(sample[_jax_initial(len(sample), 3, 1)]).float()
    step = bb._kmeans_step(data, init, 3)
    want = np.asarray(jbb._kmeans_step(jax.numpy.asarray(sample, jax.numpy.float32),
                                       jax.numpy.asarray(init.numpy()), 3))
    np.testing.assert_array_equal(step.numpy(), want)
    np.testing.assert_array_equal(bb.kmeans_device(sample, 3, iters=12, seed=1).numpy(),
                                  centers)


def test_assign_and_gather_match_jax(gen, centers):
    host, dev = bb.assign_shards(gen, torch.as_tensor(centers), overlap=2)
    want_host, want_dev = jbb.assign_shards(gen, jax.numpy.asarray(centers), overlap=2)
    np.testing.assert_array_equal(host, want_host)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(want_dev))
    assert (host[:, 0] != host[:, 1]).all()
    for s in range(3):
        n_s = int((host == s).any(axis=1).sum())
        got = bb.gather_shard_vectors(gen, dev, s, n_s)
        want = jbb.gather_shard_vectors(gen, want_dev, s, n_s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        members = np.nonzero((host == s).any(axis=1))[0]
        np.testing.assert_array_equal(got.numpy(), gen._rows[members])
    with pytest.raises(ValueError, match="members"):
        bb.gather_shard_vectors(gen, dev, 0, 5)


def test_medoid_pq_and_groundtruth_match_jax(gen, data):
    assert bb.medoid_streamed(gen) == jbb.medoid_streamed(gen)
    np.testing.assert_array_equal(bb.materialize_host(gen), data)
    pq = synthetic.train_pq(data, 8, seed=0)
    codes = bb.encode_pq_streamed(gen, pq)
    np.testing.assert_array_equal(codes, jbb.encode_pq_streamed(gen, pq))

    rng = np.random.default_rng(0)
    queries = data[rng.integers(0, N, 48)]
    ids, dists = bb.groundtruth_u8_streamed(gen, queries, 10, q_block=32)
    want_ids, want_d = jbb.groundtruth_u8_streamed(gen, queries, 10, q_block=48)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(dists, want_d)
    assert ids.dtype == np.uint32 and dists.dtype == np.float32
    brute = ((queries.astype(np.float64)[:, None] - data.astype(np.float64)[None]) ** 2
             ).sum(-1)
    order = np.argsort(brute, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids, order)
    np.testing.assert_array_equal(dists, np.take_along_axis(brute, order, 1))


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_build_sharded_vamana_matches_jax(gen, data, start, jax_initial_centers):
    kw = dict(l_build=16, n_shards=2, overlap=2, batch=512, n_passes=1, verbose=False)
    init = {}
    if start == "warm":  # a degree upgrade from a cold R=12 graph
        adj12, deg12, _ = bb.build_sharded_vamana(gen, r=12, **kw)
        init = dict(init_adj=adj12, init_deg=deg12)
    adj, deg, assignment = bb.build_sharded_vamana(gen, r=16, **kw, **init)
    want_adj, want_deg, want_assign = jbb.build_sharded_vamana(gen, r=16, **kw, **init)
    np.testing.assert_array_equal(assignment, want_assign)
    np.testing.assert_array_equal(adj, want_adj)
    np.testing.assert_array_equal(deg, want_deg)
    assert adj.shape == (N, 16) and ((adj >= 0) & (adj < N)).all()
    in_prefix = np.arange(16)[None, :] < deg[:, None]
    assert (adj[in_prefix] != np.broadcast_to(np.arange(N)[:, None], adj.shape)[in_prefix]).all()


def test_blockgen_deterministic():
    g = bb.BlockGen(5000, 24, block=2048, n_clusters=32, seed=5, device="cpu")
    a, b = g.gen_block(2), g.gen_block(2)
    assert a.dtype == torch.uint8 and a.shape == (2048, 24) and g.n_blocks == 3
    assert torch.equal(a, b)
    assert not torch.equal(a, g.gen_block(1))
    g2 = bb.BlockGen(5000, 24, block=2048, n_clusters=32, seed=5, device="cpu")
    assert torch.equal(g2.gen_block(2), a)  # any block drawn again, in any order
    assert not torch.equal(bb.BlockGen(5000, 24, block=2048, n_clusters=32, seed=6,
                                       device="cpu").gen_block(2), a)
    assert 20 < a.float().std() < 80  # spread over the u8 range, not saturated


def test_memory_guard(gen, monkeypatch):
    """A shard build whose model exceeds the budget raises before any work,
    in both packages; the model grows with the shard."""
    assert (bb.shard_build_hbm_bytes(2_000_000, 128, 64, 4096, 48)
            > bb.shard_build_hbm_bytes(1_000_000, 128, 64, 4096, 48))
    monkeypatch.setattr(bb, "SHARD_HBM_BUDGET", 10_000)
    monkeypatch.setattr(jbb, "SHARD_HBM_BUDGET", 10_000)
    kw = dict(r=16, l_build=16, n_shards=2, batch=512, verbose=False)
    with pytest.raises(MemoryError, match="budget"):
        bb.build_sharded_vamana(gen, **kw)
    with pytest.raises(MemoryError, match="budget"):
        jbb.build_sharded_vamana(gen, **kw)


def test_d2h_chunked():
    x = torch.as_tensor(np.random.default_rng(2).integers(0, 1 << 30, (1000, 7)),
                        dtype=torch.int32)
    out = bb.d2h_chunked(x, chunk_bytes=256)  # many partial chunks
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, x.numpy())


def test_sharded_build_end_to_end_on_blockgen():
    """The port's own generator through the whole build: the merged graph
    is navigable (exact search recall@10 >= 80, JAX's bar at toy scale) and
    the int8 ground truth agrees with float64 brute force."""
    from bang_tpu_torch.models.index import assemble_exact_index
    from bang_tpu_torch.models.exactdistance import search_exact
    from bang_tpu_torch.utils.config import SearchParams
    from bang_tpu_torch.utils.recall import calculate_recall

    g = bb.BlockGen(6000, 24, block=2048, n_clusters=64, seed=5, device="cpu")
    adj, deg, assignment = bb.build_sharded_vamana(g, r=16, l_build=24, n_shards=3,
                                                   overlap=2, batch=1024, verbose=False)
    assert adj.shape == (6000, 16) and assignment.shape == (6000, 2)
    data = bb.materialize_host(g)
    queries = data[np.random.default_rng(1).integers(0, 6000, 64)]
    gt_ids, gt_d = bb.groundtruth_u8_streamed(g, queries, 10, q_block=32)
    brute = ((queries.astype(np.float64)[:, None] - data.astype(np.float64)[None]) ** 2
             ).sum(-1)
    np.testing.assert_array_equal(gt_d, np.sort(brute, 1)[:, :10])
    index = assemble_exact_index(adj, data, bb.medoid_streamed(g), "cpu")
    ids, _, _ = search_exact(index, queries.astype(np.float32), SearchParams(L=48, k=10))
    assert calculate_recall(gt_ids, ids.numpy(), 10, gt_d) >= 80.0
