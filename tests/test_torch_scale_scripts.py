"""The port's large-bundle scripts (bang_tpu_torch/scripts/{bundles,
build_100m, build_10m_*, run_eval}.py) against the JAX package's on the CPU.

bundles.build_bundle writes the bytes bench.build_bundle writes, held to
tests/test_torch_builders.py's bar: every file identical but the PQ codes,
whose rows may differ on a rare f32 near-tie (>= 99.9% identical). The
build_100m script's BlockGen draws other bytes than JAX's (formats/
bigbuild.py), so one array-backed generator, with rows past the dataset
as the generator has, feeds both: the port's script against JAX's stage
functions called in the script's order, with k-means started from JAX's
initial sample (tests/test_torch_bigbuild.py's bar: every file identical).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import bench
from bang_tpu.formats import bigbuild as jbb
from bang_tpu.formats import synthetic as jsyn
from bang_tpu.formats.bin_io import save_bin as jax_save_bin
from bang_tpu.formats.bin_io import save_truthset as jax_save_truthset
from bang_tpu.formats.graph import GraphIndex as JaxGraph
from bang_tpu.formats.graph import save_graph_index as jax_save_graph
from bang_tpu.formats.pq import save_pq as jax_save_pq
from bang_tpu.models.base import BaseVariantSearcher as JaxBase
from bang_tpu.utils.config import SearchParams as JaxParams
from bang_tpu_torch.formats import bigbuild as bb
from bang_tpu_torch.formats.bin_io import load_bin, load_truthset
from bang_tpu_torch.formats.graph import load_graph_index, load_metadata
from bang_tpu_torch.models.base import BaseVariantSearcher
from bang_tpu_torch.scripts import (
    build_10m_source,
    build_10m_tuned,
    build_10m_tuned_direct,
    build_100m,
    bundles,
    run_eval,
)
from bang_tpu_torch.utils.config import SearchParams
from bang_tpu_torch.utils.recall import calculate_recall

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's eager ops on one intra-op thread: under a parallel test
    run a thread pool per worker oversubscribes the cores and makes the
    builds many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FILES = ("_disk.bin", "_disk_metadata.bin", "_pq_pivots.bin", "_pq_compressed.bin",
         "_query.bin", "_gt.bin")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("graph", ["vamana", "knn"])
def test_build_bundle_writes_bench_bytes(tmp_path, graph):
    args = (1500, 32, 16, 8, graph, 40)
    kw = dict(l_build=16, build_batch=512)
    want = str(tmp_path / "jax" / "b")
    os.makedirs(os.path.dirname(want))
    bench.build_bundle(want, *args, **kw)
    got = bundles.prefix_for("synth", 1500, 32, 16, 8, graph, cache=str(tmp_path / "port"))
    t = bundles.build_bundle(got, *args, **kw, device="cpu")
    assert set(t) == {"data", "groundtruth", "graph", "pq_train", "pq_encode", "save",
                      "total"}
    assert got.endswith(f"synth_v2_n1500_d32_r16_m8_{graph}")
    for suffix in FILES:
        if suffix != "_pq_compressed.bin":
            assert _bytes(got + suffix) == _bytes(want + suffix), suffix
    rows = lambda p: np.fromfile(p + "_pq_compressed.bin", np.uint8)[8:].reshape(-1, 8)
    assert (rows(got) == rows(want)).all(axis=1).mean() >= 0.999


def test_mips_bundle_matches_bench(tmp_path):
    """A float MIPS bundle: the inner-product ground truth (ids identical,
    -ip within f32 rounding) and the +1-dimension data and queries."""
    args = (1200, 24, 16, 8, "knn", 40)
    kw = dict(dtype=np.float32, mips=True)
    want = str(tmp_path / "jax" / "b")
    os.makedirs(os.path.dirname(want))
    bench.build_bundle(want, *args, **kw)
    got = str(tmp_path / "port" / "b")
    bundles.build_bundle(got, *args, **kw, device="cpu")
    g_ids, g_d = load_truthset(got + "_gt.bin")
    w_ids, w_d = load_truthset(want + "_gt.bin")
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_allclose(g_d, w_d, rtol=1e-5, atol=1e-4)
    for suffix in ("_query.bin", "_disk.bin"):
        assert _bytes(got + suffix) == _bytes(want + suffix), suffix
    assert load_graph_index(got).vectors.shape == (1200, 25)


def test_load_and_discover_bundles(tmp_path, tiny_uint8_index):
    prefix = tiny_uint8_index["prefix"]
    queries, gt_ids, gt_dists = bundles.load_bundle(prefix, 20)
    want_q, want_ids, want_d = bench.load_bundle(prefix, 20)
    np.testing.assert_array_equal(queries, np.asarray(want_q))
    assert queries.dtype == np.float32 and queries.shape == (20, 32)
    np.testing.assert_array_equal(gt_ids, want_ids)
    np.testing.assert_array_equal(gt_dists, want_d)
    cache = str(tmp_path)
    for n, r, done in ((1000, 32, True), (5000, 16, True), (5000, 32, True),
                       (9000, 32, False)):
        p = build_100m.bundle_prefix(n, r, 8, cache)
        open(p + "_disk.bin", "wb").close()
        if done:
            open(p + "_gt.bin", "wb").close()
    assert bundles.discover_big_base(cache) == bench.discover_big_base(cache)
    assert [(n, r) for n, r, _ in bundles.discover_big_base(cache)] == [
        (5000, 32), (5000, 16), (1000, 32)]


class BlockRows:
    """One u8 dataset of n rows served block by block to both packages, with
    `n_blocks_drawn` blocks of rows in all: blocks past the dataset hold
    points of the same distribution, as a generator draws any block."""

    device = torch.device("cpu")

    def __init__(self, n, dim, block, n_blocks_drawn, seed=5):
        self.n, self.dim, self.block = n, dim, block
        self.n_blocks = -(-n // block)
        self._rows = jsyn.make_clustered_data(n_blocks_drawn * block, dim, n_clusters=16,
                                              dtype=np.uint8, seed=seed)
        self._rows[self.n : self.n_blocks * block] = 0  # the last block's padding

    def gen_block(self, b):
        return self._rows[b * self.block : (b + 1) * self.block]


N100, BLOCK = 4096, 1024
KW100 = dict(n=N100, r=16, m=16, n_shards=2, l_build=16, n_passes=1, batch=512,
             block=BLOCK, pq_sample=2048, n_queries=64, seed=11, device="cpu")


def _jax_initial(n, k, seed):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False))


@pytest.fixture(scope="module")
def built_100m(tmp_path_factory):
    """build_100m.main at N=4,096 on a BlockRows generator (queries from block
    7 and the PQ sample from block 3, both past the dataset), the port's
    k-means started from JAX's initial sample; then JAX's stage functions in
    the script's order on the same generator. Returns (prefix, stages that
    ran, stages of a second call, JAX's prefix, the generator)."""
    gen = BlockRows(N100, 128, BLOCK, 8)
    cache = str(tmp_path_factory.mktemp("b100"))
    mp = pytest.MonkeyPatch()
    mp.setattr(bb, "BlockGen", lambda n, dim, block, n_clusters, seed, device: gen)
    mp.setattr(bb, "_initial_centers",
               lambda n, k, seed, device: torch.tensor(_jax_initial(n, k, seed)))
    try:
        prefix, ran = build_100m.main(cache=cache, **KW100)
        again = build_100m.main(cache=cache, **KW100)
    finally:
        mp.undo()

    want = str(tmp_path_factory.mktemp("jax") / "b")
    medoid = jbb.medoid_streamed(gen)
    rng = np.random.default_rng(77)
    base = np.asarray(gen.gen_block(7))[:64].astype(np.float32)
    queries = np.clip(np.rint(base + rng.normal(0, 2.0, base.shape)), 0,
                      255).astype(np.uint8)
    gt_ids, gt_dists = jbb.groundtruth_u8_streamed(gen, queries, 100)
    jax_save_bin(want + "_query.bin", queries)
    jax_save_truthset(want + "_gt.bin", gt_ids, gt_dists)
    pq = jsyn.train_pq(np.asarray(gen.gen_block(3))[:2048], 16, seed=11)
    pq.codes = jbb.encode_pq_streamed(gen, pq)
    jax_save_pq(want, pq)
    adj, degrees, _ = jbb.build_sharded_vamana(gen, r=16, l_build=16, n_shards=2,
                                               overlap=2, batch=512, n_passes=1,
                                               seed=11, verbose=False)
    jax_save_graph(want, JaxGraph(jbb.materialize_host(gen), adj, degrees, medoid))
    return prefix, ran, again, want, gen


def test_build_100m_writes_jax_stage_bytes(built_100m):
    prefix, ran, _again, want, gen = built_100m
    assert list(ran) == list(build_100m.STAGES)
    assert prefix.endswith("synthg_v1_n4096_d128_r16_m16_shardvamana")
    for suffix in FILES:
        assert _bytes(prefix + suffix) == _bytes(want + suffix), suffix
    queries = load_bin(prefix + "_query.bin", np.uint8)
    assert queries.shape == (64, 128)
    # block 7 lies past the dataset: the queries are no dataset points
    assert not (queries[:, None] == gen._rows[:N100][None]).all(-1).any()


def test_build_100m_second_call_runs_no_stage(built_100m):
    prefix, _ran, (prefix2, ran2), _want, _gen = built_100m
    assert prefix2 == prefix and ran2 == {}


def test_base_search_on_the_port_bundle_matches_jax(built_100m):
    prefix = built_100m[0]
    queries = load_bin(prefix + "_query.bin", np.uint8).astype(np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    params = dict(L=48, k=10, beam_width=2, extra_iters=24)
    j_ids, j_d = JaxBase(prefix, n_pipeline_batches=2).search(queries, JaxParams(**params))
    for mmap in (True, False):
        ids, dists = BaseVariantSearcher(prefix, n_pipeline_batches=2, mmap=mmap,
                                         device="cpu").search(queries, SearchParams(**params))
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_array_equal(dists, j_d)
    assert calculate_recall(gt_ids, ids, 10, gt_dists) >= 90.0


def test_warm_seed_reads_the_saved_adjacency(built_100m):
    prefix = built_100m[0]
    init_adj, init_deg = build_100m.warm_seed(prefix)
    g = load_graph_index(prefix)
    np.testing.assert_array_equal(init_deg, g.degrees)
    pad = np.arange(16)[None, :] >= init_deg[:, None]
    np.testing.assert_array_equal(np.where(pad, np.arange(N100)[:, None], init_adj), g.adj)
    assert (init_adj[pad] == 0).all()
    # the checkpointed graph, each row's edges sorted by id
    ck = np.load(prefix + "_ckpt/adj.npy")
    for i in range(0, N100, 97):
        assert sorted(ck[i, : init_deg[i]]) == list(init_adj[i, : init_deg[i]])


def test_link_reused(built_100m, tmp_path):
    src = built_100m[0]
    for m, pq_linked in ((16, True), (32, False)):
        dst = build_100m.bundle_prefix(N100, 32, m, str(tmp_path / str(m)))
        os.makedirs(dst + "_ckpt")
        build_100m.link_reused(dst, src, m)
        for suffix in ("_query.bin", "_gt.bin", "_ckpt/medoid.npy"):
            assert os.path.samefile(src + suffix, dst + suffix)
        for suffix in ("_pq_pivots.bin", "_pq_compressed.bin"):
            assert os.path.exists(dst + suffix) == pq_linked


def test_blockgen_draws_blocks_past_the_dataset():
    g = bb.BlockGen(3000, 16, block=1024, n_clusters=32, seed=5, device="cpu")
    assert g.n_blocks == 3
    past = g.gen_block(7)
    assert past.shape == (1024, 16) and torch.equal(past, g.gen_block(7))
    assert all(not torch.equal(past, g.gen_block(b)) for b in range(3))


def test_build_10m_scripts_run_small(tmp_path):
    """The source bundle; the tuned bundle derived from it (warm seed, R=32
    graph, m=32 PQ, the source's queries and truth), which searches well;
    the direct route to the same bundle, on the same data."""
    n, cache = 400, str(tmp_path)
    src = build_10m_source.main(n=n, cache=cache, device="cpu")
    src_g = load_graph_index(src)
    data, (init_adj, init_deg), _ = build_10m_tuned.warm_init(src, 32)
    np.testing.assert_array_equal(data, src_g.vectors)
    np.testing.assert_array_equal(init_deg, np.minimum(src_g.degrees, 32))
    pad = np.arange(32)[None, :] >= init_deg[:, None]
    assert (init_adj[pad] == np.broadcast_to(np.arange(n)[:, None], pad.shape)[pad]).all()
    assert (init_adj[~pad] == src_g.adj[:, :32][~pad]).all()

    dst = build_10m_tuned.main(n=n, cache=cache, device="cpu", batch=512)
    meta = load_metadata(dst + "_disk_metadata.bin")
    assert (meta.n, meta.degree, meta.dim) == (n, 32, 128)
    queries = load_bin(dst + "_query.bin", np.uint8).astype(np.float32)[:200]
    gt_ids, gt_dists = load_truthset(dst + "_gt.bin")
    ids, _ = BaseVariantSearcher(dst, n_pipeline_batches=1, device="cpu").search(
        queries, SearchParams(L=32, k=10, beam_width=2))
    assert calculate_recall(gt_ids[:200], ids, 10, gt_dists[:200]) >= 90.0

    direct = build_10m_tuned_direct.main(n=n, cache=cache, device="cpu")
    assert direct == dst  # the two routes name (and write) one bundle
    for suffix in ("_gt.bin", "_query.bin"):
        assert _bytes(direct + suffix) == _bytes(src + suffix)
    np.testing.assert_array_equal(load_graph_index(direct).vectors, src_g.vectors)


@pytest.mark.parametrize("variant", ["base", "inmemory"])
def test_run_eval_on_the_cpu(built_100m, tmp_path, variant):
    prefix = built_100m[0]
    common = ["--prefix", prefix, "--variant", variant, "--grid", "16", "48", "--nq",
              "64", "--device", "cpu"]
    if variant == "base":
        rows = [run_eval.main(common + ["--n-pipeline", "2", mode, "--out",
                                        str(tmp_path / f"{mode}.json")]
                              + (["--probe-sampled-entry"] if mode == "--mmap" else []))
                for mode in ("--mmap", "--no-mmap")]
        row = rows[0]
        assert row["mmap"] is True and rows[1]["mmap"] is False
        assert [p["recall"] for p in row["points"]] == [
            p["recall"] for p in rows[1]["points"]]
        assert [p["n_device_steps"] for p in row["points"]] == [
            p["n_device_steps"] for p in rows[1]["points"]]
        assert set(row["stage_ms"]) == {"host_gather", "d2h_parents", "dispatch", "wall"}
        assert row["device_step_ms"] is None  # no device time on the CPU
        assert row["wall_serial_s"] > 0 and "sampled_entry" in row
        assert row["sampled_entry"]["recall"] >= 90.0
        out = tmp_path / "--mmap.json"
    else:
        row = run_eval.main(common + ["--out", str(tmp_path / "im.json")])
        assert row["layout"] == "fused" and len(row["rep_s"]) == 5
        out = tmp_path / "im.json"
    assert [p["L"] for p in row["points"]] == [16, 48]
    assert row["recall"] >= 90.0 and row["L"] == next(
        p["L"] for p in row["points"] if p["recall"] >= 90.0)
    assert (row["n_points"], row["graph_degree"], row["num_queries"]) == (N100, 16, 64)
    assert row["device"]["name"] == "cpu" and row["device"]["power_limit"] is None
    assert json.loads(out.read_text())["bundle"] == os.path.basename(prefix)


def test_run_eval_refusals(built_100m, tmp_path):
    """--refine on base raises; --neighbor-codes, once refused, loads the
    in-memory index in the neighbor-aligned layout (the JAX runner's flag)
    and gives the fused layout's points, and raises on another variant."""
    base = ["--prefix", built_100m[0], "--device", "cpu", "--out", str(tmp_path / "x")]
    with pytest.raises(ValueError, match="refine"):
        run_eval.main(base + ["--variant", "base", "--refine"])
    with pytest.raises(ValueError, match="inmemory"):
        run_eval.main(base + ["--variant", "exactdistance", "--neighbor-codes"])
    grid = ["--variant", "inmemory", "--grid", "16", "--nq", "32"]
    nbr = run_eval.main(base + grid + ["--neighbor-codes"])
    fused = run_eval.main(base + grid)
    assert (nbr["layout"], fused["layout"]) == ("nbr_codes", "fused")
    assert [(p["recall"], p["iters"]) for p in nbr["points"]] == [
        (p["recall"], p["iters"]) for p in fused["points"]]
