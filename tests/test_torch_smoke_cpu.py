"""The port stands without JAX and without bang_tpu, and chip_smoke.py
refuses to run without a CUDA card.

The H100 host has no JAX, and the port keeps its own copies of what it
needs of the JAX package's numpy layers, so bang_tpu_torch and chip_smoke.py
import nothing of `jax` or `bang_tpu`. A subprocess with
`sys.modules["jax"] = sys.modules["bang_tpu"] = None` makes any such import
fail.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_NO_JAX_SEARCH = r"""
import importlib, pathlib, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any JAX import now raises ImportError
sys.modules["bang_tpu"] = None  # and so does any import of the JAX package
import numpy as np
import bang_tpu_torch
for mod in pkgutil.walk_packages(bang_tpu_torch.__path__, "bang_tpu_torch."):
    importlib.import_module(mod.name)
from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.formats import synthetic
from bang_tpu_torch.formats.bin_io import load_bin
with tempfile.TemporaryDirectory() as tmp:
    info = synthetic.build_synthetic_index(tmp + "/b", n=1500, dim=16, r=16, m=4,
                                           n_queries=8, seed=1)
    s = BANGSearch("inmemory", device="cpu")
    s.bang_load(info["prefix"])
    s.bang_set_searchparams(10, 16, beam_width=2)
    ids, dists = s.bang_query(load_bin(info["prefix"] + "_query.bin", np.float32))
    assert ids.dtype == np.int64 and ids.shape == (8, 10), ids.shape
    data = synthetic.make_clustered_data(800, 8, n_clusters=4, dtype=np.uint8, seed=2)
    from bang_tpu_torch.formats.graph import GraphIndex, save_graph_index
    from bang_tpu_torch.formats.vamana import build_vamana_graph
    adj, degrees, medoid = build_vamana_graph(data, 8, "cpu", l_build=16,
                                              batch=256, verbose=False)
    save_graph_index(tmp + "/v", GraphIndex(data, adj, degrees, medoid))
    e = BANGSearch("exactdistance", device="cpu")
    e.bang_load(tmp + "/v")
    assert e._index.fused_vec_rows is not None
    e.bang_set_searchparams(5, 16)
    ids, dists = e.bang_query(data[:3].astype(np.float32))
    assert ids[:, 0].tolist() == [0, 1, 2] and (dists[:, 0] == 0).all(), ids
    # base: the native host gather built here from its source, then searched
    from bang_tpu_torch import native
    native.BUILD_DIR = pathlib.Path(tmp) / "build"
    b = BANGSearch("base", device="cpu")
    b.bang_load(info["prefix"], n_pipeline_batches=3)
    b.bang_set_searchparams(10, 16, beam_width=2, capabilities=1)
    b.bang_alloc(8)
    ids, dists = b.bang_query(load_bin(info["prefix"] + "_query.bin", np.float32)[:5])
    assert ids.dtype == np.int64 and ids.shape == (5, 10), ids.shape
    assert native.library_path().parent == native.BUILD_DIR and native.library_path().exists()
    assert b._searcher.timers.ms["host_gather"] > 0
    # bloom on base and inmemory, the BFS warm-up, one streaming insert + search
    queries = load_bin(info["prefix"] + "_query.bin", np.float32)
    for engine in (b, s):
        engine.bang_set_searchparams(10, 16, beam_width=2, visited_mode="bloom")
        assert engine.bang_query(queries)[0].shape == (8, 10)
    from bang_tpu_torch.utils.graph_tools import warmup_touch
    assert warmup_touch(s._index) == warmup_touch(b._searcher) > 0.99 * 1500
    from bang_tpu_torch.models.streaming import StreamingIndex
    from bang_tpu_torch.utils.config import SearchParams
    st = StreamingIndex(capacity=300, dim=8, r=8, l_build=16, dtype=np.uint8, device="cpu")
    assert st.insert(data[:200]).tolist() == list(range(200))
    ids, dists = st.search(data[:3].astype(np.float32), SearchParams(L=16, k=5))
    assert ids[:, 0].tolist() == [0, 1, 2] and (dists[:, 0] == 0).all(), ids
# the sharded paths on a mesh of 4 CPU positions, a sharded build, the converter
from bang_tpu_torch.entry import dryrun_multichip
dryrun_multichip(4, device="cpu")
from bang_tpu_torch.formats import bigbuild
gen = bigbuild.BlockGen(3000, 16, block=1024, n_clusters=16, seed=1, device="cpu")
adj, deg, assignment = bigbuild.build_sharded_vamana(gen, r=8, l_build=16, n_shards=2,
                                                     batch=512, verbose=False)
assert adj.shape == (3000, 8) and assignment.shape == (3000, 2)
from bang_tpu_torch.formats import preprocess
assert preprocess.preprocess_data_mips(np.ones((3, 2), np.float32)).shape == (3, 3)
# the large-bundle builder's five stages at a tiny N, then run_eval's base branch
from bang_tpu_torch.scripts import build_100m, run_eval
with tempfile.TemporaryDirectory() as tmp:
    prefix, ran = build_100m.main(n=3000, r=8, m=8, n_shards=2, l_build=16, batch=512,
                                  cache=tmp, block=1024, pq_sample=1024, n_queries=16,
                                  device="cpu")
    assert list(ran) == list(build_100m.STAGES), ran
    row = run_eval.main(["--prefix", prefix, "--grid", "16", "--nq", "16", "--mmap",
                         "--n-pipeline", "2", "--device", "cpu", "--out", tmp + "/e.json"])
    assert row["n_points"] == 3000 and row["points"][0]["L"] == 16, row
# the bench's merge of two result lines and its refinement on a scripted search
from bang_tpu_torch import bench
from bang_tpu_torch.scripts import merge_bench_json
merged, carried = merge_bench_json.merge({"a": {"error": "e"}}, {"a": {"L": 1}}, "e.json")
assert carried == ["a"] and merged["a"] == {"L": 1, "carried_from": "e.json"}, merged
bench._measure_point = lambda *a, **k: {"L": a[5], "beam": a[6], "extra": a[7],
                                        "entry": k["entry_mode"], "qps": 1e4 / a[5],
                                        "recall": 95.0}
best = bench._refine_knee(None, None, None, None, None, 10, {"L": 16, "beam": 2,
                                                            "extra": 4, "qps": 1.0})
assert best["frontier"] and best["L"] == 11, best
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m.split(".")[0] in ("jax", "bang_tpu") for m in loaded), loaded
for new in ("ops.bloom", "utils.graph_tools", "harness.serving", "models.streaming",
            "utils.validate", "formats.texmex", "scripts.exp_dma_tiled",
            "parallel.sharded", "parallel.partition", "parallel.pq_tp",
            "parallel.base_tp", "formats.bigbuild", "formats.preprocess", "entry",
            "scripts.bundles", "scripts.build_100m", "scripts.run_eval", "bench",
            "scripts.merge_bench_json", "scripts.exp_bloom", "scripts.exp_large_l",
            "scripts.profile_base_step", "scripts.exp_iter_profile"):
    assert "bang_tpu_torch." + new in loaded, new
print("no-jax search ok")
"""


def _env():
    env = dict(os.environ)
    env.pop("BANG_FORCE_CPU", None)  # bang_tpu/__init__ would import JAX
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_searches_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _NO_JAX_SEARCH], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "no-jax search ok" in res.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    """Here torch has no CUDA device: chip_smoke.py must exit non-zero and
    print no result line, in the repo and in a directory holding only it."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the CUDA-less exit")
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd, env = tmp_path, {k: v for k, v in _env().items() if k != "PYTHONPATH"}
    else:
        cwd, env = REPO, _env()
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_port_sources_never_import_jax():
    """No `jax` and no `bang_tpu` or `bang_tpu.*` import (bang_tpu_torch is
    the port itself) in the port, its scripts/ and chip_smoke.py."""
    sources = list((REPO / "bang_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    assert REPO / "bang_tpu_torch" / "scripts" / "exp_dma_tiled.py" in sources
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0].rstrip(",")
                assert top not in ("jax", "bang_tpu"), f"{path}: {line}"
