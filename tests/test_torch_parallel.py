"""Multi-device search: the port's parallel/ against the JAX package's on
the CPU.

The JAX side runs on tests/conftest.py's 8 virtual CPU devices, the port on
a mesh that repeats the CPU 8 times (parallel/sharded.py's single-controller
mesh). Both search the same shards: the JAX ShardedIndex is carried over by
convert.sharded_index_from_jax. Bars (tests/test_parallel.py's): ids
agreeing on >= 98% of slots, distances within rtol 1e-4 (atol 1e-2), and
JAX's recall bars; exact agreement where the two compute the same sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bang_tpu.formats import synthetic as jsyn
from bang_tpu.formats.bin_io import load_bin, load_truthset
from bang_tpu.formats.graph import GraphIndex as JaxGraph
from bang_tpu.models.base import BaseVariantSearcher as JaxBase
from bang_tpu.models.index import build_device_index as jax_device_index
from bang_tpu.ops.pq import pq_lookup as jax_pq_lookup
from bang_tpu.ops.pq_pallas import pack_tables as jax_pack_tables
from bang_tpu.ops.pq_pallas import pq_lookup_packed as jax_lookup_packed
from bang_tpu.parallel import base_tp as jax_base_tp
from bang_tpu.parallel import partition as jax_partition
from bang_tpu.parallel import pq_tp as jax_pq_tp
from bang_tpu.parallel import sharded as jax_sharded
from bang_tpu.utils.config import SearchParams as JaxParams
from bang_tpu.utils.recall import calculate_recall
from bang_tpu_torch.convert import index_from_jax, sharded_index_from_jax
from bang_tpu_torch.entry import dryrun_multichip
from bang_tpu_torch.harness.serving import measure_base_device_step_ms
from bang_tpu_torch.models.base import BaseVariantSearcher
from bang_tpu_torch.models.inmemory import search_inmemory
from bang_tpu_torch.ops.pq import pack_tables
from bang_tpu_torch.parallel import base_tp, partition, pq_tp, sharded
from bang_tpu_torch.utils.config import SearchParams

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small eager ops on one intra-op thread: under a parallel
    test run a thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset():
    data = jsyn.make_clustered_data(2048, 32, n_clusters=24, seed=11)
    rng = np.random.default_rng(12)
    queries = (data[rng.integers(0, len(data), 48)].astype(np.float32)
               + rng.normal(0, 0.05, (48, 32)).astype(np.float32))
    gt_ids, gt_dists = jsyn.compute_groundtruth(data, queries, 10)
    return data, queries, gt_ids, gt_dists


def test_make_mesh():
    mesh = sharded.make_mesh(2, 4, CPU8)
    assert mesh.shape == dict(jax_sharded.make_mesh(2, 4).shape) == {"data": 2, "model": 4}
    assert mesh.home == torch.device("cpu") and len(mesh.devices[1]) == 4
    assert sharded.make_mesh(1, 3, CPU8).shape == {"data": 1, "model": 3}
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        sharded.make_mesh(4, 4, CPU8)
    if not torch.cuda.is_available():  # devices=None: every CUDA device
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            sharded.make_mesh(1, 1)


# name -> (r, m, fused, rerank, recall bar)
SHARDED = {
    "pq": (24, 16, False, True, 90.0),
    "fused_r64": (64, 16, True, True, 90.0),
    "fused_r32": (32, 16, True, True, 90.0),
    "exact": (24, None, False, True, 92.0),
    "pq_no_rerank": (24, 16, False, False, 70.0),
}


@pytest.mark.parametrize("name", list(SHARDED))
def test_search_sharded_matches_jax(dataset, name):
    data, queries, gt_ids, gt_dists = dataset
    r, m, fused, rerank, bar = SHARDED[name]
    jsi = jax_partition.build_sharded_index(data, n_shards=4, r=r, m=m, seed=7,
                                            fused_frontier=fused)
    want_ids, want_d = jax_sharded.search_sharded(
        jax_sharded.make_mesh(2, 4), jsi, queries, JaxParams(L=48, k=10, rerank=rerank))
    want_ids, want_d = np.asarray(want_ids), np.asarray(want_d)

    si = sharded_index_from_jax(jsi, "cpu")
    assert (si.fused_rows is not None) == fused
    ids, dists = sharded.search_sharded(sharded.make_mesh(2, 4, CPU8), si, queries,
                                        SearchParams(L=48, k=10, rerank=rerank))
    assert ids.dtype == torch.int32 and ids.shape == (48, 10)
    ids, dists = ids.numpy(), dists.numpy()
    assert (ids == want_ids).mean() >= 0.98, (ids[:2], want_ids[:2])
    np.testing.assert_allclose(dists, want_d, rtol=1e-4, atol=1e-2)
    recall = calculate_recall(gt_ids, ids, 10, gt_dists)
    assert recall >= bar, recall
    if rerank:  # exact squared L2 of the returned global ids
        want = ((queries[:, None, :] - data[ids]) ** 2).sum(-1)
        np.testing.assert_allclose(dists, want, rtol=1e-3, atol=1e-2)

    # the port's own build makes JAX's shards on the CPU
    own = partition.build_sharded_index(data, n_shards=4, r=r, m=m, seed=7,
                                        fused_frontier=fused, device="cpu")
    for field in ("adj", "vectors", "codes", "fused_rows"):
        a, b = getattr(own, field), getattr(si, field)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), field
    np.testing.assert_array_equal(own.medoids, si.medoids)
    np.testing.assert_array_equal(own.id_base, jsi.id_base)


def test_merge_is_the_stable_topk():
    """Shard-major candidates, ties to the lower position (lax.top_k's
    order), not torch.topk's."""
    all_ids = torch.tensor([[[5, 6, 7]], [[105, 106, 107]]], dtype=torch.int32)
    all_d = torch.tensor([[[1.0, 2.0, 2.0]], [[1.0, 2.0, 3.0]]])
    ids, d = sharded.merge_topk(all_ids, all_d, 4)
    assert ids.tolist() == [[5, 105, 6, 7]] and d.tolist() == [[1.0, 1.0, 2.0, 2.0]]


def test_invalid_ids_survive_the_offset(dataset):
    """A shard that expands fewer nodes than k returns INVALID_ID (-1)
    slots; they stay -1 after the id_base offset, and real ids move."""
    data, queries, _, _ = dataset
    si = partition.build_sharded_index(data, n_shards=4, r=24, m=16, seed=7,
                                       device="cpu")
    sh = si.shard(2, "cpu")
    ids, dists = sharded._local_search(
        sh.adj, sh.vectors, sh.codes, sh.fused_rows, sh.codebook, sh.medoid,
        sh.id_base, torch.as_tensor(queries), l=4, k=10, max_iters=6,
        use_bloom=False)
    invalid = ids == -1
    assert invalid.any() and torch.isinf(dists[invalid]).all()
    assert ((ids[~invalid] >= 1024) & (ids[~invalid] < 1536)).all()


def test_neighbor_codes_refused(dataset):
    data = dataset[0]
    with pytest.raises(ValueError, match="nbr_codes"):
        partition.build_sharded_index(data, 4, r=24, m=16, neighbor_codes=True,
                                      device="cpu")
    jsi = jax_partition.build_sharded_index(data[:512], 4, r=8, m=4, neighbor_codes=True)
    with pytest.raises(ValueError, match="nbr_codes"):
        sharded_index_from_jax(jsi, "cpu")


def test_search_data_parallel_matches_jax(dataset):
    data, queries, _, _ = dataset
    adj, degrees = jsyn.build_knn_graph(data, 24, n_random=4, seed=3)
    pq = jsyn.train_pq(data, 16, seed=3)
    pq.codes = jsyn.encode_pq(data, pq)
    jindex = jax_device_index(graph=JaxGraph(data, adj, degrees, jsyn.medoid_of(data)),
                              pq=pq)
    want, _ = jax_sharded.search_data_parallel(jax_sharded.make_mesh(8, 1), jindex,
                                               queries, JaxParams(L=48, k=10))
    index = index_from_jax(jindex, "cpu", fused_frontier=False)
    params = SearchParams(L=48, k=10)
    ids, dists = sharded.search_data_parallel(sharded.make_mesh(8, 1, CPU8), index,
                                              queries, params)
    one, one_d, _ = search_inmemory(index, queries, params)
    assert torch.equal(ids, one) and torch.equal(dists, one_d)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="split evenly"):
        sharded.search_data_parallel(sharded.make_mesh(8, 1, CPU8), index,
                                     queries[:44], params)


@pytest.mark.parametrize("fn", ["search_sharded", "search_data_parallel"])
def test_sharded_searches_refuse_sampled_entry(dataset, fn):
    """JAX's sharded searches enter at the medoid whatever entry_mode says;
    the port refuses sampled entry rather than answer otherwise."""
    data, queries, _, _ = dataset
    params = SearchParams(L=48, k=10, entry_mode="sampled")
    if fn == "search_sharded":
        index = partition.build_sharded_index(data, 4, r=24, m=16, seed=7, device="cpu")
        mesh = sharded.make_mesh(2, 4, CPU8)
    else:
        adj, degrees = jsyn.build_knn_graph(data, 24, n_random=4, seed=3)
        pq = jsyn.train_pq(data, 16, seed=3)
        pq.codes = jsyn.encode_pq(data, pq)
        index = index_from_jax(jax_device_index(
            graph=JaxGraph(data, adj, degrees, jsyn.medoid_of(data)), pq=pq), "cpu",
            fused_frontier=False)
        mesh = sharded.make_mesh(8, 1, CPU8)
    with pytest.raises(ValueError, match="entry_mode='sampled'"):
        getattr(sharded, fn)(mesh, index, queries, params)


class _HostReads:
    """Counts host reads of tensors (bool(), .item(), .tolist()) while on."""

    def __init__(self, monkeypatch):
        self.on, self.n = False, 0
        for name in ("__bool__", "item", "tolist"):
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._counted(orig))

    def _counted(self, orig):
        def read(t, *args):
            self.n += self.on
            return orig(t, *args)
        return read

    def during(self, fn, reads):
        """fn, wrapped: its host reads appended to `reads`."""
        def wrapped(*args, **kwargs):
            self.on, n0 = True, self.n
            try:
                return fn(*args, **kwargs)
            finally:
                self.on = False
                reads.append(self.n - n0)
        return wrapped


def _expected_reads(iters, max_iters):
    """traverse: one read before each step and one that ends the walk,
    unless max_iters ends it."""
    return iters - (iters == max_iters)


# name -> (r, m, fused, visited mode, L, extra_iters)
TOGETHER = {
    "pq": (24, 16, False, "exact", 48, 50),
    "fused": (32, 16, True, "exact", 48, 50),
    "exact": (24, None, False, "exact", 48, 50),
    "pq_bloom": (24, 16, False, "bloom", 48, 50),
    "capped": (24, 16, True, "exact", 48, 2),  # every walk ends at max_iters
}


@pytest.mark.parametrize("name", list(TOGETHER))
def test_search_sharded_steps_shards_together(dataset, name, monkeypatch):
    """The shards step in rounds with one host read per round, and give the
    per-shard loop's ids, distances and iterations bit for bit."""
    data, queries, _, _ = dataset
    r, m, fused, mode, L, extra = TOGETHER[name]
    si = partition.build_sharded_index(data, 4, r=r, m=m, seed=7, fused_frontier=fused,
                                       device="cpu")
    mesh = sharded.make_mesh(2, 4, CPU8)
    params = SearchParams(L=L, k=10, visited_mode=mode, extra_iters=extra)
    reads = _HostReads(monkeypatch)

    want_ids, want_d, alone_iters, alone_reads = [], [], [], []
    orig_traverse = sharded.traverse

    def traverse(step, state, max_iters):
        final = orig_traverse(step, state, max_iters)
        alone_iters.append(final.it)
        return final

    monkeypatch.setattr(sharded, "traverse", reads.during(traverse, alone_reads))
    for qs in torch.as_tensor(queries).chunk(2):
        parts = [sharded._local_search(
            sh.adj, sh.vectors, sh.codes, sh.fused_rows, sh.codebook, sh.medoid,
            sh.id_base, qs, l=L, k=10, max_iters=params.max_iters,
            use_bloom=mode == "bloom") for sh in (si.shard(s, "cpu") for s in range(4))]
        i, d = sharded.merge_topk(torch.stack([p[0] for p in parts]),
                                  torch.stack([p[1] for p in parts]), 10)
        want_ids.append(i)
        want_d.append(d)

    together_iters, together_reads = [], []
    orig_together = sharded.traverse_together

    def together(walks, max_iters, home):
        finals = orig_together(walks, max_iters, home)
        together_iters.extend(f.it for f in finals)
        return finals

    monkeypatch.setattr(sharded, "traverse_together",
                        reads.during(together, together_reads))
    ids, dists = sharded.search_sharded(mesh, si, queries, params)
    # the iteration counters live on the device: read after the counted runs
    alone_iters = [int(it) for it in alone_iters]
    together_iters = [int(it) for it in together_iters]
    assert torch.equal(ids, torch.cat(want_ids)) and torch.equal(dists, torch.cat(want_d))
    assert together_iters == alone_iters and len(alone_iters) == 8
    if name == "capped":
        assert set(alone_iters) == {params.max_iters}
    else:
        assert len(set(alone_iters)) > 1, alone_iters  # some walks end early
    mi = params.max_iters
    assert alone_reads == [_expected_reads(it, mi) for it in alone_iters]
    # one read of the stacked flags per round (the first before any step)
    assert together_reads == [_expected_reads(max(alone_iters), mi)]


def test_search_data_parallel_steps_rows_together(dataset, monkeypatch):
    """The data rows step in rounds, one host read a round, and equal
    search_inmemory on each row's queries, iterations included."""
    data, queries, _, _ = dataset
    adj, degrees = jsyn.build_knn_graph(data, 24, n_random=4, seed=3)
    pq = jsyn.train_pq(data, 16, seed=3)
    pq.codes = jsyn.encode_pq(data, pq)
    index = index_from_jax(jax_device_index(
        graph=JaxGraph(data, adj, degrees, jsyn.medoid_of(data)), pq=pq), "cpu")
    params = SearchParams(L=48, k=10, beam_width=2)
    rows = [search_inmemory(index, qs, params) for qs in torch.as_tensor(queries).chunk(4)]
    reads, counted, iters = _HostReads(monkeypatch), [], []
    orig = sharded.traverse_together

    def together(walks, max_iters, home):
        finals = orig(walks, max_iters, home)
        iters.extend(f.it for f in finals)
        return finals

    monkeypatch.setattr(sharded, "traverse_together", reads.during(together, counted))
    ids, dists = sharded.search_data_parallel(sharded.make_mesh(4, 1, CPU8), index,
                                              queries, params)
    iters = [int(it) for it in iters]  # device counters, read after the counted run
    assert torch.equal(ids, torch.cat([r[0] for r in rows]))
    assert torch.equal(dists, torch.cat([r[1] for r in rows]))
    assert iters == [r[2].iters for r in rows]
    assert counted == [_expected_reads(max(iters), params.max_iters)]


def test_pq_lookup_tp_matches_jax():
    rng = np.random.default_rng(0)
    q, r, m, n, shards = 16, 8, 32, 500, 8
    tables = rng.normal(size=(q, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    cand = rng.integers(0, n, (q, r)).astype(np.int32)
    want = np.asarray(jax_pq_tp.pq_lookup_tp(
        jax_sharded.make_mesh(1, shards),
        jax_pq_tp.shard_tables_by_chunk(jnp.asarray(tables), shards),
        jnp.asarray(jax_pq_tp.shard_codes_by_chunk(codes, shards)), jnp.asarray(cand)))
    cs = pq_tp.shard_codes_by_chunk(codes, shards)
    np.testing.assert_array_equal(cs, jax_pq_tp.shard_codes_by_chunk(codes, shards))
    ts = pq_tp.shard_tables_by_chunk(torch.as_tensor(tables), shards)
    assert ts.shape == (shards, q, m // shards, 256) and ts[3].is_contiguous()
    got = pq_tp.pq_lookup_tp(sharded.make_mesh(1, shards, CPU8), ts, cs, cand)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    single = np.asarray(jax_pq_lookup(jnp.asarray(tables), jnp.asarray(codes)[cand]))
    np.testing.assert_allclose(got.numpy(), single, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m_loc", [16, 8, 3, 1])
def test_packed_chunk_slice_lookup_matches_pallas(m_loc):
    """The card's per-shard lookup (K1 on a packed chunk slice), through
    K1's plain version, against JAX's pq_lookup_packed in interpret mode,
    at the chunk widths of K1's copy paths (16-, 4- and 1-byte code reads)."""
    rng = np.random.default_rng(m_loc)
    q, c, n, shards = 4, 40, 300, 4
    m = m_loc * shards
    tables = rng.normal(size=(q, m, 256)).astype(np.float32) * 100
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    cand = rng.integers(0, n, (q, c)).astype(np.int32)
    packed = pack_tables(torch.as_tensor(tables))
    slices = pq_tp.shard_tables_by_chunk(packed, shards)
    jpacked = jax_pack_tables(jnp.asarray(tables))
    for s in range(shards):
        lo = s * m_loc
        got = pq_tp.partial_lookup(slices[s], torch.as_tensor(codes[:, lo : lo + m_loc]),
                                   torch.as_tensor(cand))
        want = np.asarray(jax_lookup_packed(
            jpacked[:, lo : lo + m_loc], jnp.asarray(codes[:, lo : lo + m_loc])[cand],
            interpret=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def base_bundle(tiny_index):
    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)[:64]
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    return prefix, queries, gt_ids[:64], gt_dists[:64]


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)], ids=["m3", "padded"])
def test_sharded_base_matches_jax_and_single(base_bundle, mesh_shape):
    """tiny_index has m=12: four shards of 3 chunks, or eight of 2 with the
    chunk axis padded to 16."""
    prefix, queries, gt_ids, gt_dists = base_bundle
    jmesh = jax_sharded.make_mesh(*mesh_shape)
    jtp = jax_base_tp.ShardedBaseSearcher(prefix, jmesh, n_pipeline_batches=1)
    want, want_d = jtp.search(queries, JaxParams(L=32, k=10, pq_impl="xla"))

    params = SearchParams(L=32, k=10)
    tp = base_tp.ShardedBaseSearcher(prefix, sharded.make_mesh(*mesh_shape, CPU8),
                                     n_pipeline_batches=2)
    assert tp.codes is None and tp.codes_np is None
    assert [c.shape[1] for c in tp.codes_sharded] == [12 // mesh_shape[1]] * mesh_shape[1] \
        if 12 % mesh_shape[1] == 0 else [2] * 8
    ids, dists = tp.search(queries, params)
    single, single_d = BaseVariantSearcher(prefix, n_pipeline_batches=2,
                                           device="cpu").search(queries, params)
    for other, other_d in ((want, want_d), (single, single_d)):
        assert (ids == other).mean() > 0.98, (ids[:2], other[:2])
        np.testing.assert_allclose(dists, other_d, rtol=1e-4, atol=1e-2)
    assert calculate_recall(gt_ids, ids, 10, gt_dists) >= 85.0
    # the latency probe drives the chunk-sharded step as the single one's
    assert measure_base_device_step_ms(tp, queries[:16], params, n_chain=3) > 0


def test_sharded_base_sampled_entry(base_bundle):
    prefix, queries, gt_ids, gt_dists = base_bundle
    queries = queries[:48]
    jmesh = jax_sharded.make_mesh(2, 4)
    jtp = jax_base_tp.ShardedBaseSearcher(prefix, jmesh, n_pipeline_batches=1)
    jtables = jtp._prepare_tables(jnp.asarray(queries), "xla")
    want = np.asarray(jax_base_tp.make_sampled_entry_tp(jmesh, "xla")(
        jtables, jtp.codes_sharded, 256, 2))

    mesh = sharded.make_mesh(2, 4, CPU8)
    tp = base_tp.ShardedBaseSearcher(prefix, mesh, n_pipeline_batches=1)
    tables = tp._prepare_tables(torch.as_tensor(queries))
    got = base_tp.make_sampled_entry_tp(mesh)(tables, tp.codes_sharded, 256, 2)
    assert got.dtype == torch.int32 and got.shape == (48, 2)
    assert (got.numpy() == want).mean() >= 0.98, (got[:3], want[:3])

    params = SearchParams(L=32, k=10, entry_mode="sampled", entry_samples=256,
                          beam_width=2)
    ids, _ = tp.search(queries, params)
    jids, _ = jtp.search(queries, JaxParams(L=32, k=10, pq_impl="xla",
                                            entry_mode="sampled", entry_samples=256,
                                            beam_width=2))
    single, _ = BaseVariantSearcher(prefix, n_pipeline_batches=1,
                                    device="cpu").search(queries, params)
    assert (ids == jids).mean() > 0.98 and (ids == single).mean() > 0.95
    assert calculate_recall(gt_ids[:48], ids, 10, gt_dists[:48]) >= 85.0


def test_dryrun_multichip_cpu(capsys):
    dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh=(data=2, model=4)" in out
