"""The port stands without JAX, and chip_smoke.py refuses to run without a
CUDA card.

The H100 host has no JAX, so bang_tpu_torch and chip_smoke.py may import
only torch and the numpy layers of bang_tpu. A subprocess with
`sys.modules["jax"] = None` makes any JAX import fail.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_NO_JAX_SEARCH = r"""
import importlib, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any JAX import now raises ImportError
import numpy as np
import bang_tpu_torch
for mod in pkgutil.walk_packages(bang_tpu_torch.__path__, "bang_tpu_torch."):
    importlib.import_module(mod.name)
from bang_tpu.formats import synthetic
from bang_tpu.formats.bin_io import load_bin
from bang_tpu_torch.api import BANGSearch
with tempfile.TemporaryDirectory() as tmp:
    info = synthetic.build_synthetic_index(tmp + "/b", n=1500, dim=16, r=16, m=4,
                                           n_queries=8, seed=1)
    s = BANGSearch("inmemory", device="cpu")
    s.bang_load(info["prefix"])
    s.bang_set_searchparams(10, 16, beam_width=2)
    ids, dists = s.bang_query(load_bin(info["prefix"] + "_query.bin", np.float32))
    assert ids.dtype == np.int64 and ids.shape == (8, 10), ids.shape
    data = synthetic.make_clustered_data(800, 8, n_clusters=4, dtype=np.uint8, seed=2)
    from bang_tpu.formats.graph import GraphIndex, save_graph_index
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
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
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
    sources = list((REPO / "bang_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] != "jax", f"{path}: {line}"
                assert not words[1].startswith("bang_tpu.models"), f"{path}: {line}"
                assert not words[1].startswith("bang_tpu.ops"), f"{path}: {line}"
