"""The port's offline builders (bang_tpu_torch.formats.accel) against the JAX
builders on one 20K-point u8 bundle.

u8 data gives integer squared distances, exact in float32 on both sides,
so ground-truth ids must be identical: that holds only if distance ties
break lowest index first in both. PQ codes and pruned-graph rows are held
at >= 99.9% identical rows: their float32 sums (centered PQ chunks, the
occlusion test) may round differently, flipping a rare near-tie.
"""

import numpy as np
import pytest
import torch

from bang_tpu.formats import synthetic
from bang_tpu.formats.accel import (
    build_pruned_knn_graph_jax,
    compute_groundtruth_jax,
    encode_pq_jax,
)
from bang_tpu_torch.formats import accel

N, D, R, M = 20_000, 32, 32, 16


@pytest.fixture(scope="module")
def data():
    return synthetic.make_clustered_data(N, D, n_clusters=20, dtype=np.uint8, seed=0)


def test_groundtruth_ids_identical_to_jax(data):
    rng = np.random.default_rng(1)
    q = data[rng.integers(0, N, 300)].astype(np.float32)
    q = np.clip(np.rint(q + rng.normal(0, 2.0, q.shape)), 0, 255).astype(np.float32)
    j_ids, j_d = compute_groundtruth_jax(data, q, 20, block=128)
    t_ids, t_d = accel.compute_groundtruth(data, q, 20, "cpu", block=128)
    assert t_ids.dtype == np.uint32 and t_d.dtype == np.float32
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_d, j_d)


def test_encode_pq_matches_jax(data):
    pq = synthetic.train_pq(data, M, kmeans_iters=4, seed=2)
    j = encode_pq_jax(data, pq, block=8192)
    t = accel.encode_pq(data, pq, "cpu", block=8192)
    assert t.dtype == np.uint8 and t.shape == (N, M)
    assert (t == j).all(axis=1).mean() >= 0.999


def test_pruned_knn_graph_matches_jax(data):
    j_adj, j_deg = build_pruned_knn_graph_jax(data, R, n_random=R // 8, seed=3, block=2048)
    t_adj, t_deg = accel.build_pruned_knn_graph(data, R, "cpu", n_random=R // 8,
                                                seed=3, block=2048)
    assert t_adj.dtype == np.int32 and t_adj.shape == (N, R)
    np.testing.assert_array_equal(t_deg, j_deg)
    assert (t_adj == j_adj).all(axis=1).mean() >= 0.999


def test_topk_ties_break_lowest_index_first():
    d = torch.tensor([[3.0, 1.0, 2.0, 1.0, 1.0, 0.0],
                      [5.0, 5.0, 5.0, 5.0, 4.0, 5.0]])
    ids, vals = accel._topk_smallest(d, 3)
    assert ids.tolist() == [[5, 1, 3], [4, 0, 1]]
    assert vals.tolist() == [[0.0, 1.0, 1.0], [4.0, 5.0, 5.0]]
