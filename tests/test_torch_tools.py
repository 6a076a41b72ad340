"""The numpy index tools and the cache warm-up: the port's
utils/graph_tools.py, utils/validate.py and formats/texmex.py against the
JAX package's on the CPU, and ENABLE_CACHE_WARMUP through BANGSearch.

The BFS orders are identical array for array; `warmup_touch` touches as
many nodes as JAX's on every index kind (in-memory and exact, fused and
scattered, and base, whose BFS walks the host records); `validate_index`
reports the same fields; the TexMex converters write the same bytes.
"""

import dataclasses
import shutil

import numpy as np
import pytest

from bang_tpu.formats import texmex as jtexmex
from bang_tpu.formats.bin_io import load_bin_auto
from bang_tpu.models.base import BaseVariantSearcher as JaxBase
from bang_tpu.models.index import device_index_from_files as jax_index_from_files
from bang_tpu.utils import graph_tools as jgt
from bang_tpu.utils.validate import validate_index as jax_validate
from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.constants import ENABLE_CACHE_WARMUP, ENABLE_GPU_STATS
from bang_tpu_torch.formats import texmex as ttexmex
from bang_tpu_torch.formats.graph import load_graph_index
from bang_tpu_torch.models.base import BaseVariantSearcher
from bang_tpu_torch.models.index import device_index_from_files
from bang_tpu_torch.utils import graph_tools as tgt
from bang_tpu_torch.utils.validate import validate_index


def _ring(n, r=2):
    adj = np.empty((n, r), np.int32)
    adj[:, 0] = (np.arange(n) + 1) % n
    adj[:, 1] = (np.arange(n) - 1) % n
    return adj


@pytest.mark.parametrize("case", ["ring", "capped", "disconnected"])
def test_bfs_identical_to_jax(case):
    adj = _ring(100 if case == "capped" else 10)
    start, cap = (5, 7) if case == "capped" else (0, None)
    if case == "disconnected":
        adj[4] = [3, 3]  # cut the ring both ways
        adj[6] = [7, 7]
    got = tgt.bfs_from(adj, start, max_nodes=cap)
    np.testing.assert_array_equal(got, jgt.bfs_from(adj, start, max_nodes=cap))
    assert got[0] == start and len(got) == (7 if case == "capped" else len(got))
    assert tgt.reachable_fraction(adj, start) == jgt.reachable_fraction(adj, start)
    if case == "disconnected":
        assert 0 < tgt.reachable_fraction(adj, 0) < 1.0


# (variant, port layout kwargs, bundle): the five index kinds
KINDS = {
    "inmemory fused": ("inmemory", {}, "f32"),
    "inmemory scattered": ("inmemory", {"fused_frontier": False}, "f32"),
    "exact fused": ("exactdistance", {}, "u8"),
    "exact scattered": ("exactdistance", {"fused_frontier": False}, "u8"),
    "base": ("base", None, "f32"),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_warmup_touch_counts_equal_jax(tiny_index, tiny_uint8_index, kind):
    variant, layout, data = KINDS[kind]
    prefix = (tiny_index if data == "f32" else tiny_uint8_index)["prefix"]
    if variant == "base":
        port, jax_obj = (BaseVariantSearcher(prefix, device="cpu"), JaxBase(prefix))
    else:
        port = device_index_from_files(prefix, "cpu", variant, **layout)
        jax_obj = jax_index_from_files(prefix, variant=variant)
        fused = port.fused_rows is not None or port.fused_vec_rows is not None
        assert fused == ("fused" in kind) and (port.adj is None) == fused
    counts = [tgt.warmup_touch(port, n_nodes=cap) for cap in (300, 1_000_000)]
    assert counts == [jgt.warmup_touch(jax_obj, n_nodes=cap) for cap in (300, 1_000_000)]
    assert counts[0] == 300 and counts[1] > 0.99 * 3000
    if variant != "base":  # the decoded fused ids are the graph's adjacency
        np.testing.assert_array_equal(
            tgt.device_adjacency(port),
            device_index_from_files(prefix, "cpu", variant, fused_frontier=False).adj.numpy())


@pytest.mark.parametrize("variant", ["base", "inmemory", "exactdistance"])
def test_cache_warmup_capability_served(tiny_index, variant):
    """ENABLE_CACHE_WARMUP (with and without ENABLE_GPU_STATS) runs the
    warm-up in bang_alloc and leaves the ids as they are without it."""
    prefix = tiny_index["prefix"]
    queries = load_bin_auto(prefix + "_query.bin", np.float32)[:16]
    s = BANGSearch(variant, device="cpu")
    s.bang_load(prefix)
    s.bang_set_searchparams(10, 24, beam_width=2)
    s.bang_alloc(16)
    assert s.warmup_touched is None
    want = s.bang_query(queries)
    graph = load_graph_index(prefix)
    reach = len(tgt.bfs_from(graph.adj, graph.medoid))
    assert 0.99 * tiny_index["n"] <= reach <= tiny_index["n"]
    for caps in (ENABLE_CACHE_WARMUP, ENABLE_CACHE_WARMUP | ENABLE_GPU_STATS):
        s.bang_set_searchparams(10, 24, beam_width=2, capabilities=caps)
        s.bang_alloc(16)
        assert s.warmup_touched == reach  # the BFS count from the medoid
        got = s.bang_query(queries)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _report(rep):
    return dataclasses.asdict(rep)


def test_validate_index_reports_as_jax(tiny_index, tmp_path):
    prefix = tiny_index["prefix"]
    good = validate_index(prefix)
    assert good.ok and good.n == tiny_index["n"] and good.chunks == tiny_index["m"]
    assert good.reachable_fraction > 0.99
    assert _report(good) == _report(jax_validate(prefix))
    assert _report(validate_index(prefix, with_pq=False, reach_cap=0)) == _report(
        jax_validate(prefix, with_pq=False, reach_cap=0))
    bad = str(tmp_path / "bad")
    for suffix in ("_disk.bin", "_disk_metadata.bin", "_pq_pivots.bin",
                   "_pq_compressed.bin"):
        shutil.copy(prefix + suffix, bad + suffix)
    with open(bad + "_disk.bin", "r+b") as f:
        f.truncate(1000)
    rep = validate_index(bad)
    assert not rep.ok and any("size" in e for e in rep.errors)
    assert _report(rep) == _report(jax_validate(bad))
    missing = str(tmp_path / "nope")
    assert not validate_index(missing).ok
    assert _report(validate_index(missing)) == _report(jax_validate(missing))


def _write_vecs(path, arr):
    with open(path, "wb") as f:
        for row in arr:
            np.asarray([arr.shape[1]], "<i4").tofile(f)
            row.tofile(f)


@pytest.mark.parametrize("dtype,ext", [
    (np.float32, ".fvecs"), (np.uint8, ".bvecs"), (np.int32, ".ivecs"),
])
def test_texmex_reads_and_converts_as_jax(tmp_path, dtype, ext):
    rng = np.random.default_rng(0)
    if dtype == np.float32:
        arr = rng.normal(size=(37, 12)).astype(dtype)
    else:
        arr = rng.integers(0, 100, (37, 12)).astype(dtype)
    src = str(tmp_path / f"x{ext}")
    _write_vecs(src, arr)
    np.testing.assert_array_equal(ttexmex.read_vecs(src), arr)
    np.testing.assert_array_equal(ttexmex.read_vecs(src, count=5, offset=30),
                                  jtexmex.read_vecs(src, count=5, offset=30))
    assert ttexmex.read_vecs(src, count=3, offset=100).shape == (0, 12)
    a, b = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    assert ttexmex.to_bin(src, a, count=30, block=7) == jtexmex.to_bin(src, b, count=30,
                                                                        block=7)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_groundtruth_conversion_writes_jax_bytes(tmp_path):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 10_000, (50, 10)).astype(np.int32)
    dists = np.sort(rng.normal(size=(50, 10)).astype(np.float32) ** 2, axis=1)
    iv, fv = str(tmp_path / "gt.ivecs"), str(tmp_path / "gt_dists.fvecs")
    _write_vecs(iv, ids)
    _write_vecs(fv, dists)
    for extra in ((fv,), ()):
        a, b = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
        ttexmex.groundtruth_to_truthset(iv, a, *extra)
        jtexmex.groundtruth_to_truthset(iv, b, *extra)
        assert open(a, "rb").read() == open(b, "rb").read()
    bad = str(tmp_path / "x.vecs")
    with open(bad, "wb") as f:
        f.write(b"\x04\x00\x00\x00")
    with pytest.raises(ValueError, match="extension"):
        ttexmex.read_vecs(bad)
