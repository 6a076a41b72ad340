"""The port's exact-distance search against reference/bang_exact.py, the
plain one-query-at-a-time transcription of BANG_Exactdistance's walk.

BANGSearch("exactdistance", device="cpu") and the reference read the same
bundle's graph (self-padded, as the port loads it) and vectors. Bars:
  * u8 vectors and queries, over a seeded random graph of out-degree R and
    over the port's own Vamana graph: every distance is an integer below
    2^24, exact in float32 in any summation order, and ties break alike, so
    ids and distances are identical row for row in each of the port's
    three layouts (fused exact rows, scattered, nbr_vecs), beam 1 and 2,
    medoid and sampled entries, and `SearchStats.iters` is the longest of
    the reference's walks;
  * f32 vectors: the port's ||v||^2 - 2 q.v + ||q||^2 and the reference's
    sum((q - v)^2) round differently and near-ties may flip, so >= 99% of
    the rows identical, `iters` within 1 of the longest walk, distances of
    identical rows within rtol 1e-5 plus atol 1e-5 x ||q||^2 (the
    expansion's cancellation), as tests/test_torch_exact_search.py holds
    the port to the JAX package.
The reference's own sanity: at L >= N its walk reaches every point, and it
answers what a brute-force k-NN answers.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.formats import synthetic, vamana
from bang_tpu_torch.formats.graph import GraphIndex, load_graph_index, save_graph_index
from reference import bang_exact

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {
    "fused": {"fused_frontier": True},
    "scattered": {"fused_frontier": False},
    "nbr_vecs": {"neighbor_vectors": True},
}
N, DIM, R, NQ = 2000, 32, 16, 128
L, EXTRA, SAMPLES = 24, 8, 256


def _random_graph(n, r, seed):
    """A seeded graph of out-degree r: each row r distinct ids, not its own."""
    rng = np.random.default_rng(seed)
    adj = np.empty((n, r), np.int32)
    for i in range(n):
        row = rng.choice(n - 1, size=r, replace=False)
        adj[i] = row + (row >= i)
    return adj


def _bundle(path, data, graph, seed):
    if graph == "random":
        adj = _random_graph(len(data), R, seed)
        degrees = np.full(len(data), R, np.int32)
        medoid = synthetic.medoid_of(data)
    else:
        adj, degrees, medoid = vamana.build_vamana_graph(
            data, R, "cpu", l_build=32, batch=512, seed=seed, verbose=False)
    prefix = str(path / graph)
    save_graph_index(prefix, GraphIndex(vectors=data, adj=adj, degrees=degrees,
                                        medoid=medoid))
    return prefix


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(prefix by graph, queries) on u8 data, and (prefix, queries) on f32."""
    path = tmp_path_factory.mktemp("exact_ref")
    u8 = synthetic.make_clustered_data(N + NQ, DIM, n_clusters=16, dtype=np.uint8, seed=21)
    f32 = synthetic.make_clustered_data(N + NQ, DIM, n_clusters=16, dtype=np.float32,
                                        seed=22)
    return {
        "u8": ({g: _bundle(path, u8[:N], g, 23) for g in ("random", "vamana")}, u8[N:]),
        "f32": (_bundle(tmp_path_factory.mktemp("exact_ref_f32"), f32[:N], "vamana", 24),
                f32[N:]),
    }


def _port(prefix, queries, layout, beam, entry):
    s = BANGSearch("exactdistance", device="cpu")
    s.bang_load(prefix, **LAYOUTS[layout])
    ix = s._index
    assert (ix.fused_vec_rows is not None) == (layout == "fused")
    assert (ix.nbr_vecs is not None) == (layout == "nbr_vecs")
    s.bang_set_searchparams(10, L, beam_width=beam, extra_iters=EXTRA, entry_mode=entry,
                            entry_samples=SAMPLES)
    ids, dists = s.bang_query(queries)
    return ids, dists, s.last_stats.iters


def _reference(prefix, queries, beam, entry):
    g = load_graph_index(prefix)
    return bang_exact.search(g.adj, g.vectors, g.medoid, queries, L, 10, beam_width=beam,
                             extra_iters=EXTRA, entry_mode=entry, entry_samples=SAMPLES)


@pytest.mark.parametrize("entry", ["medoid", "sampled"])
@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("graph", ["random", "vamana"])
def test_identical_to_the_reference_on_uint8(bundles, graph, layout, beam, entry):
    prefixes, queries = bundles["u8"]
    ids, dists, iters = _port(prefixes[graph], queries, layout, beam, entry)
    r_ids, r_dists, walks = _reference(prefixes[graph], queries, beam, entry)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(dists, r_dists)
    assert iters == walks.max()
    assert walks.max() > 2 and (r_ids >= 0).all()


@pytest.mark.parametrize("entry", ["medoid", "sampled"])
@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("layout", ["nbr_vecs", "scattered"])
def test_matches_the_reference_on_float32(bundles, layout, beam, entry):
    prefix, queries = bundles["f32"]
    ids, dists, iters = _port(prefix, queries, layout, beam, entry)
    r_ids, r_dists, walks = _reference(prefix, queries, beam, entry)
    assert abs(iters - walks.max()) <= 1
    same = (ids == r_ids).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    qn = (queries.astype(np.float64) ** 2).sum(1, keepdims=True)
    err = np.abs(dists - r_dists)[same]
    assert (err <= 1e-5 * np.abs(r_dists[same]) + 1e-5 * qn[same]).all(), err.max()


@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_reference_at_full_worklist_is_brute_force(dtype, beam):
    """At L >= N, over a connected graph, the walk reaches every point: its
    answer is the exact k-NN (distances identical; ids up to ties)."""
    n, k = 300, 10
    data = synthetic.make_clustered_data(n + 16, 12, n_clusters=4, dtype=dtype, seed=31)
    base, queries = data[:n], data[n:]
    graph = _random_graph(n, 8, 32)
    ids, dists, walks = bang_exact.search(graph, base, 0, queries, L=n, k=k,
                                          beam_width=beam, extra_iters=n)
    b_ids, b_dists = bang_exact.brute_force(base, queries, k)
    np.testing.assert_array_equal(dists, b_dists)
    v = torch.as_tensor(base).float()
    for q, row, d in zip(torch.as_tensor(queries).float(), ids, dists):
        assert len(set(row.tolist())) == k
        np.testing.assert_array_equal(((v[row] - q) ** 2).sum(-1).numpy(), d)
    assert (walks < bang_exact.max_iters(n, n, beam)).all()


def test_reference_imports_only_torch_and_numpy():
    code = ("import sys; import reference.bang_exact; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'bang_tpu', 'bang_tpu_torch'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured search and K3 run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_identical_to_the_reference_on_the_card_at_sift1m(card, tmp_path):
    """The benchmark's exact configuration as it stands
    (gpubench/configs/sift1m-exact.json: SIFT1M's shape, u8, D=128, N=1M,
    R=64, L=10, beam 1, extra 6, fused rows): 256 rows of the last of
    several back-to-back 10K-query calls, taken after bang_alloc(10000),
    against the reference on the card over the same graph and vectors."""
    import json

    from bang_tpu_torch.device import set_exact_float32
    from gpubench.corpus import clustered

    set_exact_float32()
    with open(os.path.join(ROOT, "gpubench", "configs", "sift1m-exact.json")) as f:
        cfg = json.load(f)
    seed = 2_100_000_021
    base_t, pool_t = clustered.make(cfg, seed, card)
    base, pool = base_t.cpu().numpy(), pool_t.cpu().numpy().astype(np.float32)
    adj, degrees, medoid = vamana.build_vamana_graph(
        base, cfg["R"], card, l_build=cfg["L_build"], alpha=cfg["alpha"],
        batch=cfg["build_batch"], seed=seed, n_passes=cfg["build_passes"], verbose=False)
    prefix = str(tmp_path / "index")
    save_graph_index(prefix, GraphIndex(vectors=base, adj=adj, degrees=degrees,
                                        medoid=medoid))
    s = BANGSearch("exactdistance", device=card)
    s.bang_load(prefix, **cfg["load"])
    assert s._index.fused_vec_rows is not None
    s.bang_set_searchparams(cfg["k"], cfg["L"], **cfg["search"])
    s.bang_alloc(len(pool))
    for _ in range(8):
        ids, dists = s.bang_query(pool)
    iters = s.last_stats.iters
    rows = np.random.default_rng(seed).choice(len(pool), 256, replace=False)
    g = load_graph_index(prefix)
    r_ids, r_dists, walks = bang_exact.search(
        g.adj, torch.as_tensor(g.vectors, device=card), g.medoid, pool[rows], cfg["L"],
        cfg["k"], **cfg["search"])
    np.testing.assert_array_equal(ids[rows], r_ids)
    np.testing.assert_array_equal(dists[rows], r_dists)
    assert iters >= walks.max() > 2, (iters, walks.max())
