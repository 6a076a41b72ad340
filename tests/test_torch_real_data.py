"""The real-corpus pipeline (bang_tpu_torch/scripts/get_real_data.py)
against the JAX script (scripts/get_real_data.py) on one fabricated TexMex
corpus, offline.

The corpus is siftsmall's layout at a small size: 3,000 x 32 f32 base
vectors with integer values (as SIFT's are), 100 queries, top-100 ground
truth ids. With integer-valued vectors every squared distance and norm is
an exact integer in f32, so both builders make the same graph, and the
PQ files are the same bytes. Bars: every file of the bundle byte-identical
to the JAX script's, except the truthset's distance block, which holds
the true f32 distances (float64 recomputation within 1e-5 relative) where
JAX's holds zeros; the port's recall@10 >= 90 and equal to
`calculate_recall` over those distances; and the zero distances' fault:
tie expansion over zeros scores recall@10 against all 100 columns.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from bang_tpu_torch.formats.bin_io import load_truthset
from bang_tpu_torch.formats.synthetic import compute_groundtruth, make_clustered_data
from bang_tpu_torch.harness import driver
from bang_tpu_torch.scripts import get_real_data
from bang_tpu_torch.utils.recall import calculate_recall

REPO = Path(__file__).resolve().parents[1]
N, DIM, NQ, GT_K = 3000, 32, 100, 100
FILES = ("siftsmall_base.fvecs", "siftsmall_query.fvecs", "siftsmall_groundtruth.ivecs")


def _write_vecs(path, arr):
    rec = np.empty((arr.shape[0], 1 + arr.shape[1]), "<i4")
    rec[:, 0] = arr.shape[1]
    rec[:, 1:] = arr.view("<i4")
    rec.tofile(path)


def _corpus(root: Path):
    """siftsmall's three files under root/siftsmall; returns (base, queries)."""
    rng = np.random.default_rng(9)
    base = make_clustered_data(N, DIM, n_clusters=16, dtype=np.uint8, seed=9)
    base = base.astype(np.float32)
    queries = np.clip(np.rint(base[rng.integers(0, N, NQ)]
                              + rng.normal(0, 2.0, (NQ, DIM))), 0, 255).astype(np.float32)
    gt_ids, _ = compute_groundtruth(base, queries, GT_K)
    (root / "siftsmall").mkdir(parents=True)
    for name, arr in zip(FILES, (base, queries, gt_ids.astype(np.int32))):
        _write_vecs(root / "siftsmall" / name, arr)
    return base, queries


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX script's bundle and the port's, each from its own copy of the
    corpus: (jax_dir, port_dir, base, queries, port's stdout, the ids the
    harness driver scored at each call, urlopen's calls during the port's run)."""
    root = tmp_path_factory.mktemp("real")
    jax_dir, port_dir = root / "jax", root / "port"
    base, queries = _corpus(jax_dir)
    shutil.copytree(jax_dir, port_dir)
    env = dict(os.environ, BANG_FORCE_CPU="1")  # the JAX side on the CPU
    jax_run = subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "get_real_data.py"), "siftsmall",
         "--dir", str(jax_dir), "--skip-download", "--num-queries", str(NQ)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    scored, opened = [], []

    def recall(gt_ids, ids, k, gt_dists):
        scored.append(np.asarray(ids).copy())
        return calculate_recall(gt_ids, ids, k, gt_dists)

    def urlopen(*args, **kwargs):
        opened.append(args)
        raise urllib.error.URLError("no network")

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "calculate_recall", recall)
        mp.setattr(urllib.request, "urlopen", urlopen)
        n = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            with contextlib.redirect_stdout(out):
                rc = get_real_data.main(["siftsmall", "--dir", str(port_dir),
                                         "--skip-download", "--device", "cpu",
                                         "--num-queries", str(NQ)])
        finally:
            torch.set_num_threads(n)
    assert rc == 0
    stdout, stderr = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, stderr[-3000:]
    return jax_dir, port_dir, base, queries, out.getvalue(), scored, opened


def _best_rows(stdout):
    """(L, recall) of the harness driver's `best` rows."""
    rows = [line.split("\t") for line in stdout.splitlines()]
    return [(int(r[0]), float(r[3])) for r in rows if len(r) == 5 and r[4] == "best"]


def test_bundle_bytes_identical_to_jax(runs):
    jax_dir, port_dir, *_ = runs
    names = sorted(p.name for p in jax_dir.glob("siftsmall_*"))
    assert names == sorted(p.name for p in port_dir.glob("siftsmall_*"))
    for suffix in ("_query.bin", "_disk.bin", "_disk_metadata.bin", "_pq_pivots.bin",
                   "_pq_compressed.bin"):
        assert "siftsmall" + suffix in names, names
    for name in names:
        if name == "siftsmall_gt.bin":
            continue
        assert (jax_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    j_gt = (jax_dir / "siftsmall_gt.bin").read_bytes()
    t_gt = (port_dir / "siftsmall_gt.bin").read_bytes()
    ids_end = 8 + NQ * GT_K * 4
    assert len(j_gt) == len(t_gt) == ids_end + NQ * GT_K * 4
    assert j_gt[:ids_end] == t_gt[:ids_end]  # the header and the ids
    assert not np.frombuffer(j_gt[ids_end:], "<f4").any()  # JAX: zeros


def test_truthset_distances_are_true(runs):
    _, port_dir, base, queries, *_ = runs
    ids, dists = load_truthset(port_dir / "siftsmall_gt.bin")
    want = ((base[ids.astype(np.int64)].astype(np.float64)
             - queries[:, None, :].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(dists, want, rtol=1e-5)
    assert (np.diff(dists, axis=1) >= 0).all()  # the corpus's order is by distance


def test_recall_over_true_distances(runs):
    _, port_dir, base, queries, stdout, scored, _ = runs
    best = _best_rows(stdout)
    assert best and best[-1][1] >= 90.0, stdout[-2000:]
    assert "[real] stage seconds" in stdout
    ids, dists = load_truthset(port_dir / "siftsmall_gt.bin")
    want = ((base[ids.astype(np.int64)].astype(np.float64)
             - queries[:, None, :].astype(np.float64)) ** 2).sum(-1).astype(np.float32)
    # two reps an L: the best row reports the second (the first warms up)
    assert len(scored) == 2 * len(best)
    assert f"{best[-1][1]:.2f}" == f"{calculate_recall(ids, scored[-1], 10, want):.2f}"
    assert calculate_recall(ids, scored[-1], 10, dists) == calculate_recall(
        ids, scored[-1], 10, want)


def test_zero_distances_inflate_recall(runs):
    """Fault I: JAX's zero-filled truthset expands every tie to all 100
    columns, so the same ids score at least as high against it, and
    results at true ranks 50-59 score 100.0 there and 0.0 against the
    true distances (or against ids alone)."""
    jax_dir, port_dir, _b, _q, _o, scored, _ = runs
    ids, dists = load_truthset(port_dir / "siftsmall_gt.bin")
    j_ids, j_dists = load_truthset(jax_dir / "siftsmall_gt.bin")
    got = scored[-1]
    assert calculate_recall(j_ids, got, 10, j_dists) >= calculate_recall(ids, got, 10,
                                                                         dists)
    far = ids[:50, 50:60]
    assert calculate_recall(j_ids[:50], far, 10, j_dists[:50]) == 100.0
    assert calculate_recall(ids[:50], far, 10, dists[:50]) == 0.0
    assert calculate_recall(ids[:50], far, 10, None) == 0.0


def test_no_download(runs, tmp_path, monkeypatch):
    """--skip-download never reaches the network; without it and with no
    archive, the run skips quietly and returns 0."""
    *_, opened = runs
    assert opened == []
    calls = []

    def urlopen(*args, **kwargs):
        calls.append(args)
        raise urllib.error.URLError("no network")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = get_real_data.main(["siftsmall", "--dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0 and len(calls) == 1, out.getvalue()
    assert "download unavailable" in out.getvalue()
    assert not any(tmp_path.iterdir())  # no partial archive left behind
