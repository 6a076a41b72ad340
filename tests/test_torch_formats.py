"""The port's own copies of the JAX package's numpy layers, against bang_tpu.

Files are the contract between the two packages: on a seeded bundle made by
bang_tpu, the port's `formats` copies write graph, PQ, `.bin` and truthset
files byte-identical to bang_tpu's, and each package loads the other's files
equal. The port's data, PQ and graph helpers give bang_tpu's arrays for one
seed; `calculate_recall`, `SearchParams` and the constants agree.
"""

import filecmp

import numpy as np
import pytest

from bang_tpu import constants as jconst
from bang_tpu.formats import bin_io as jbin
from bang_tpu.formats import graph as jgraph
from bang_tpu.formats import pq as jpq
from bang_tpu.formats import synthetic as jsyn
from bang_tpu.formats.preprocess import preprocess_queries_mips as j_mips
from bang_tpu.utils.config import SearchParams as JParams
from bang_tpu.utils.recall import calculate_recall as j_recall
from bang_tpu_torch import constants as tconst
from bang_tpu_torch.formats import bin_io as tbin
from bang_tpu_torch.formats import graph as tgraph
from bang_tpu_torch.formats import pq as tpq
from bang_tpu_torch.formats import synthetic as tsyn
from bang_tpu_torch.formats.preprocess import preprocess_queries_mips as t_mips
from bang_tpu_torch.utils.config import SearchParams as TParams
from bang_tpu_torch.utils.logging import log_message
from bang_tpu_torch.utils.recall import calculate_recall as t_recall

SUFFIXES = ("_disk.bin", "_disk_metadata.bin", "_pq_pivots.bin",
            "_pq_compressed.bin", "_query.bin", "_gt.bin")
BUNDLE = dict(n=1500, dim=16, r=16, m=4, n_queries=8, seed=1)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A seeded bundle written by bang_tpu: its prefix."""
    prefix = str(tmp_path_factory.mktemp("jax_bundle") / "b")
    jsyn.build_synthetic_index(prefix, dtype=np.uint8, **BUNDLE)
    return prefix


def _same_files(a, b, suffixes):
    for suf in suffixes:
        assert filecmp.cmp(a + suf, b + suf, shallow=False), suf


def _assert_graph_equal(x, y):
    for f in ("vectors", "adj", "degrees"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        assert getattr(x, f).dtype == getattr(y, f).dtype, f
    assert x.medoid == y.medoid


def _assert_pq_equal(x, y):
    for f in ("pivots", "centroid", "chunk_offsets", "codes"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        assert getattr(x, f).dtype == getattr(y, f).dtype, f


# kind -> (suffixes, (bang_tpu's load, save), (the port's load, save), equal)
FILE_KINDS = {
    "graph": (("_disk.bin", "_disk_metadata.bin"),
              (jgraph.load_graph_index, jgraph.save_graph_index),
              (tgraph.load_graph_index, tgraph.save_graph_index), _assert_graph_equal),
    "pq": (("_pq_pivots.bin", "_pq_compressed.bin"),
           (jpq.load_pq, jpq.save_pq), (tpq.load_pq, tpq.save_pq), _assert_pq_equal),
    "query_bin": (("_query.bin",),
                  (lambda p: jbin.load_bin(p + "_query.bin", np.uint8),
                   lambda p, x: jbin.save_bin(p + "_query.bin", x)),
                  (lambda p: tbin.load_bin(p + "_query.bin", np.uint8),
                   lambda p, x: tbin.save_bin(p + "_query.bin", x)),
                  np.testing.assert_array_equal),
    "truthset": (("_gt.bin",),
                 (lambda p: jbin.load_truthset(p + "_gt.bin"),
                  lambda p, x: jbin.save_truthset(p + "_gt.bin", *x)),
                 (lambda p: tbin.load_truthset(p + "_gt.bin"),
                  lambda p, x: tbin.save_truthset(p + "_gt.bin", *x)),
                 lambda x, y: [np.testing.assert_array_equal(a, b) for a, b in zip(x, y)]),
}


@pytest.mark.parametrize("kind", sorted(FILE_KINDS))
def test_port_writes_the_same_bytes_and_reads_jax_files(kind, bundle, tmp_path):
    suffixes, (j_load, j_save), (t_load, t_save), same = FILE_KINDS[kind]
    via_port, via_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    t_save(via_port, t_load(bundle))  # port reads bang_tpu's file, writes its own
    j_save(via_jax, j_load(bundle))
    _same_files(via_port, bundle, suffixes)
    _same_files(via_jax, bundle, suffixes)
    same(t_load(via_jax), j_load(via_port))  # each reads the other's file
    same(t_load(bundle), j_load(bundle))


def test_port_builds_the_same_bundle(bundle, tmp_path):
    prefix = str(tmp_path / "b")
    info = tsyn.build_synthetic_index(prefix, dtype=np.uint8, **BUNDLE)
    assert info["prefix"] == prefix
    _same_files(prefix, bundle, SUFFIXES)


def _data():
    return jsyn.make_clustered_data(3000, 24, n_clusters=12, dtype=np.uint8, seed=4)


def _pq_case(syn):
    pq = syn.train_pq(_data(), 6, kmeans_iters=4, sample=2000, seed=3)
    return pq.pivots, pq.centroid, pq.chunk_offsets


SAME_FOR_ONE_SEED = {
    "make_clustered_data_u8": lambda s: s.make_clustered_data(
        2000, 32, n_clusters=8, dtype=np.uint8, seed=7),
    "make_clustered_data_f32": lambda s: s.make_clustered_data(
        500, 20, n_clusters=5, seed=8, intrinsic_dim=6),
    "train_pq": _pq_case,
    "encode_pq": lambda s: s.encode_pq(
        _data(), s.train_pq(_data(), 6, kmeans_iters=3, seed=5), block=700),
    "medoid_of": lambda s: s.medoid_of(_data(), block=1000),
    "dedup_rows_self": lambda s: s._dedup_rows_self(
        np.random.default_rng(2).integers(0, 40, (300, 12), dtype=np.int32)),
    "default_chunk_offsets": lambda s: s.default_chunk_offsets(100, 7),
    "build_knn_graph": lambda s: s.build_knn_graph(_data()[:600], 12, n_random=3, seed=2),
}


@pytest.mark.parametrize("case", sorted(SAME_FOR_ONE_SEED))
def test_synthetic_helpers_match_jax(case):
    want = SAME_FOR_ONE_SEED[case](jsyn)
    got = SAME_FOR_ONE_SEED[case](tsyn)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("with_dists", [True, False])
def test_recall_matches_jax_on_tied_u8_truth(with_dists):
    """u8 data: integer distances, many ties at the k-th place."""
    rng = np.random.default_rng(6)
    data = rng.integers(0, 4, (400, 3), dtype=np.uint8)
    queries = rng.integers(0, 4, (30, 3), dtype=np.uint8).astype(np.float32)
    gt_ids, gt_dists = jsyn.compute_groundtruth(data, queries, 40)
    assert (gt_dists[:, 9] == gt_dists[:, 10]).mean() > 0.5  # tie-heavy
    result = np.where(rng.random((30, 10)) < 0.6, gt_ids[:, 5:15],
                      rng.integers(0, 400, (30, 10))).astype(np.int64)
    d = gt_dists if with_dists else None
    assert t_recall(gt_ids, result, 10, d) == j_recall(gt_ids, result, 10, d)


INVALID_PARAMS = [
    {"L": 0}, {"L": 513}, {"L": 8, "k": 9}, {"visited_mode": "hash"},
    {"pq_impl": "triton"}, {"traversal_precision": "tf32"}, {"beam_width": 0},
    {"beam_width": 17}, {"entry_mode": "random"}, {"entry_samples": 0},
]


@pytest.mark.parametrize("kwargs", INVALID_PARAMS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_search_params_reject_what_jax_rejects(kwargs):
    with pytest.raises(ValueError) as want:
        JParams(**kwargs)
    with pytest.raises(ValueError) as got:
        TParams(**kwargs)
    assert str(got.value) == str(want.value)


def test_search_params_fields_and_defaults_match_jax():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(TParams)] == [
        (f.name, f.default) for f in dataclasses.fields(JParams)]
    for kw in ({}, {"L": 100, "extra_iters": 7, "beam_width": 3}):
        assert TParams(**kw).max_iters == JParams(**kw).max_iters


@pytest.mark.parametrize("name", [
    "MAX_R", "MAX_L", "DEFAULT_EXTRA_ITERS", "PQ_NUM_CENTERS", "ENUM_DIST_L2",
    "ENUM_DIST_MIPS", "INVALID_ID", "DTYPE_CODE_TO_NUMPY", "NUMPY_TO_DTYPE_CODE"])
def test_constants_match_jax(name):
    assert getattr(tconst, name) == getattr(jconst, name)


def test_mips_queries_and_log_line(capsys):
    q = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    q[2] = 0.0
    np.testing.assert_array_equal(t_mips(q), j_mips(q))
    log_message("hello")
    out = capsys.readouterr().out
    assert out.endswith("] hello\n") and out.startswith("[")
