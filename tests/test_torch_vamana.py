"""The port's graph builders (bang_tpu_torch.formats.vamana.build_vamana_graph,
formats.accel.build_knn_graph) against the JAX builders on u8 data.

With u8 vectors every squared distance, norm and occlusion test is an exact
integer computation in f32, distance ties break lowest index first on both
sides, and both builders draw the start graph, the shuffles and the random
edges from the same numpy generator in the same order. So the bar is
identity: the same adjacency, degrees and medoid.
"""

import numpy as np
import pytest
import torch

from bang_tpu.formats import synthetic
from bang_tpu.formats.accel import build_knn_graph_jax
from bang_tpu.formats.vamana import build_vamana_graph as jax_vamana
from bang_tpu_torch.formats import accel
from bang_tpu_torch.formats import vamana
from bang_tpu_torch.models.exactdistance import search_exact
from bang_tpu_torch.models.index import assemble_exact_index
from bang_tpu.utils.config import SearchParams
from bang_tpu.utils.recall import calculate_recall

N, D = 2000, 32


@pytest.fixture(scope="module")
def data():
    return synthetic.make_clustered_data(N, D, n_clusters=12, dtype=np.uint8, seed=4)


@pytest.fixture(scope="module")
def cold(data):
    """(JAX build, port build) at r=16, l_build=32, batch=512, seed 0."""
    kw = dict(l_build=32, batch=512, seed=0, verbose=False)
    return jax_vamana(data, r=16, **kw), vamana.build_vamana_graph(data, 16, "cpu", **kw)


def test_vamana_identical_to_jax(cold, data):
    (j_adj, j_deg, j_med), (t_adj, t_deg, t_med) = cold
    assert t_adj.dtype == np.int32 and t_adj.shape == (N, 16)
    assert t_med == j_med
    np.testing.assert_array_equal(t_deg, j_deg)
    np.testing.assert_array_equal(t_adj, j_adj)
    # self-padded past each degree, real edges before it
    pad = np.arange(16)[None, :] >= t_deg[:, None]
    assert (t_adj[pad] == np.broadcast_to(np.arange(N)[:, None], (N, 16))[pad]).all()
    assert (t_adj[~pad] != np.broadcast_to(np.arange(N)[:, None], (N, 16))[~pad]).all()


def test_vamana_graph_searches_well(cold, data):
    """The port's exact search on the port's graph: recall@10 >= 95."""
    _, (adj, _, medoid) = cold
    rng = np.random.default_rng(5)
    q = np.clip(np.rint(data[rng.integers(0, N, 64)] + rng.normal(0, 2.0, (64, D))),
                0, 255).astype(np.float32)
    gt_ids, gt_dists = synthetic.compute_groundtruth(data, q, 10)
    index = assemble_exact_index(adj, data, medoid, "cpu")
    ids, _, _ = search_exact(index, q, SearchParams(L=48, k=10))
    assert calculate_recall(gt_ids, ids.numpy(), 10, gt_dists) >= 95.0


def test_vamana_warm_start_identical_to_jax(cold, data):
    """init=: seed an r=12 build with the first 12 columns of the r=16
    graph, one pass, explicit medoid; also return_device."""
    (j_adj, j_deg, medoid), _ = cold
    init = (j_adj[:, :12].copy(), np.minimum(j_deg, 12))
    kw = dict(l_build=16, batch=512, seed=2, n_passes=1, init=init, medoid=medoid,
              verbose=False)
    w_adj, w_deg, _ = jax_vamana(data, r=12, **kw)
    t_adj, t_deg, t_med = vamana.build_vamana_graph(data, 12, "cpu", return_device=True, **kw)
    assert isinstance(t_adj, torch.Tensor) and t_med == medoid
    np.testing.assert_array_equal(t_adj.numpy(), w_adj)
    np.testing.assert_array_equal(t_deg.numpy(), w_deg)


def test_vamana_device_vectors_need_medoid(data):
    with pytest.raises(ValueError, match="medoid"):
        vamana.build_vamana_graph(torch.from_numpy(data), 8, "cpu", verbose=False)
    with pytest.raises(ValueError, match="init degree"):
        vamana.build_vamana_graph(data, 8, "cpu", verbose=False,
                                  init=(np.zeros((N, 12), np.int32), np.zeros(N, np.int32)))


def test_unique_padded_is_jnp_unique():
    import jax.numpy as jnp

    x = np.array([5, 3, 9, 3, 9, 9, 1, 9], np.int32)
    for size in (2, 4, 8, 12):
        want = np.asarray(jnp.unique(jnp.asarray(x), size=size, fill_value=9))
        got = vamana._unique_padded(torch.from_numpy(x), size, 9)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r,n_random", [(16, 4), (12, 0)])
def test_knn_graph_identical_to_jax(data, r, n_random):
    j_adj, j_deg = build_knn_graph_jax(data, r, n_random=n_random, seed=3, block=512)
    t_adj, t_deg = accel.build_knn_graph(data, r, "cpu", n_random=n_random, seed=3,
                                         block=512)
    assert t_adj.dtype == np.int32
    np.testing.assert_array_equal(t_adj, j_adj)
    np.testing.assert_array_equal(t_deg, j_deg)
