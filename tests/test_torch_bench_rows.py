"""The bench's breadth bundles through both packages' searches on the CPU:
an int8 bundle (spacev_int8's kind, narrowed), an f32 bundle of gist960's
kind narrowed from D=960 to 192 (8 dimensions a PQ chunk, as at m=120) and
a MIPS bundle (glove200_mips's kind: ground truth by inner product, the
vectors in the +1-dimension L2 space), each built once by the port's
builder (scripts/bundles.build_bundle) with a pruned R=32 graph.

Bars: the exact variant's ids identical to JAX's on every bundle (the JAX
package keeps its nbr_vecs layout, the port scatters); the in-memory
variant's recall@10 within 1.0 point of JAX's (tests/test_torch_search.py's
bar) and its iterations within 1.
"""

import numpy as np
import pytest
import torch

from bang_tpu.models.exactdistance import search_exact as jax_search_exact
from bang_tpu.models.index import device_index_from_files as jax_index_from_files
from bang_tpu.models.inmemory import search_inmemory as jax_search_inmemory
from bang_tpu.utils.config import SearchParams as JaxParams
from bang_tpu_torch.formats.bin_io import load_bin
from bang_tpu_torch.formats.graph import load_graph_index
from bang_tpu_torch.models.exactdistance import search_exact
from bang_tpu_torch.models.index import device_index_from_files
from bang_tpu_torch.models.inmemory import search_inmemory
from bang_tpu_torch.scripts import bundles
from bang_tpu_torch.utils.config import SearchParams
from bang_tpu_torch.utils.recall import calculate_recall

# kind -> (n, d, m, dtype, mips)
KINDS = {
    "int8": (2000, 40, 20, np.int8, False),
    "f32_d192": (2000, 192, 24, np.float32, False),
    "mips": (2000, 24, 0, np.float32, True),
}
NQ = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's eager ops on one intra-op thread: under a parallel test
    run a thread pool per worker oversubscribes the cores and makes the
    builds many times slower (as tests/test_torch_scale_scripts.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """kind -> (prefix, queries, gt_ids, gt_dists), each bundle built once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            n, d, m, dtype, mips = KINDS[kind]
            prefix = str(tmp_path_factory.mktemp(kind) / kind)
            bundles.build_bundle(prefix, n, d, 32, m, "pruned", NQ, dtype=dtype,
                                 mips=mips, device="cpu")
            cache[kind] = (prefix, *bundles.load_bundle(prefix, NQ))
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bundle_files(built, kind):
    prefix, queries, gt_ids, _ = built(kind)
    n, d, _m, dtype, mips = KINDS[kind]
    g = load_graph_index(prefix)
    width = d + 1 if mips else d
    assert g.vectors.dtype == (np.float32 if mips else dtype)
    assert g.vectors.shape == (n, width) and queries.shape == (NQ, width)
    assert queries.dtype == np.float32  # f32 queries in a 4-byte file
    assert load_bin(prefix + "_query.bin", np.float32).shape == (NQ, width)
    assert gt_ids.shape == (NQ, 100)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_exact_ids_identical_to_jax(built, kind):
    prefix, queries, gt_ids, gt_dists = built(kind)
    ix = device_index_from_files(prefix, "cpu", "exactdistance")
    ids, _d, stats = search_exact(ix, queries, SearchParams(L=32, k=10, extra_iters=6))
    j_ids, _jd, j_stats = jax_search_exact(
        jax_index_from_files(prefix, "exactdistance"), queries,
        JaxParams(L=32, k=10, extra_iters=6))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    assert stats.iters == j_stats.iters
    assert calculate_recall(gt_ids, ids.numpy(), 10, gt_dists) >= 90.0


@pytest.mark.parametrize("kind", [k for k in sorted(KINDS) if KINDS[k][2]])
def test_inmemory_recall_matches_jax(built, kind):
    """The bundles with PQ (the MIPS row is searched exactly, as the bench's)."""
    prefix, queries, gt_ids, gt_dists = built(kind)
    params = dict(L=32, k=10, beam_width=2, extra_iters=11)
    ix = device_index_from_files(prefix, "cpu", "inmemory")
    assert ix.fused_rows is not None
    ids, _d, stats = search_inmemory(ix, torch.as_tensor(queries), SearchParams(**params))
    j_ids, _jd, j_stats = jax_search_inmemory(
        jax_index_from_files(prefix, "inmemory"), queries, JaxParams(**params))
    rec = calculate_recall(gt_ids, ids.numpy(), 10, gt_dists)
    j_rec = calculate_recall(gt_ids, np.asarray(j_ids), 10, gt_dists)
    assert abs(rec - j_rec) <= 1.0, (rec, j_rec)
    assert abs(stats.iters - j_stats.iters) <= 1
    assert rec >= 90.0
