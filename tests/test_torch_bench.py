"""The port's bench (bang_tpu_torch/bench.py) and merge_bench_json against
the root bench.py and scripts/merge_bench_json.py, and
models/index.free_device_index, on the CPU.

  * `_refine_knee`: both benches' `_measure_point` replaced by one scripted
    recall and QPS surface; the same (L, beam, extra, entry) probes in the
    same order and the same chosen point, over several surfaces;
  * `_traversal_gather_bytes_per_iter`: equal to JAX's on the fused and the
    scattered index of both HBM variants of one tiny bundle;
  * `main`: a tiny drive on the CPU prints one JSON line holding the root
    bench's headline keys (`device` in place of `backend`) and exits 0; a
    forced row failure keeps the line and exits 1;
  * `run_eval --refine`: its row is the point `_refine_knee` picks;
  * `merge_bench_json`: byte for byte the JAX script's output;
  * `free_device_index`: no tensor left on the index.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import bench as jax_bench
from bang_tpu.models.index import build_device_index as jax_build
from bang_tpu.models.index import device_index_from_files as jax_index_from_files
from bang_tpu.formats.graph import load_graph_index as jax_load_graph
from bang_tpu_torch import bench
from bang_tpu_torch.models.index import device_index_from_files, free_device_index
from bang_tpu_torch.ops.pq import PQCodebook
from bang_tpu_torch.scripts import bundles, merge_bench_json, run_eval

REPO = pathlib.Path(__file__).resolve().parent.parent
# the subprocesses' torch and BLAS on one thread, as the fixture below
ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


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
def bundle(tmp_path_factory):
    """A tiny u8 bundle made by the port's builder: R=32 and m=8, so that
    the JAX package picks its fused in-memory rows too."""
    prefix = str(tmp_path_factory.mktemp("bench") / "b")
    bundles.build_bundle(prefix, 1500, 16, 32, 8, "pruned", 64, device="cpu")
    return prefix


def _surface(kind):
    """recall(L, beam, extra, entry) of one scripted search; its QPS falls
    with L, extra_iters and a narrow beam, so every step of the refinement
    has a faster point to find."""
    def recall(L, beam, extra, entry):
        if kind == "knee":  # the target first met between the grid points
            r = 70 + L + 0.5 * extra - 4 * abs(beam - 2)
        elif kind == "flat":  # every point passes
            r = 99.0
        elif kind == "extra_cliff":  # fewer extra_iters fail at once
            r = 95.0 if extra >= 11 else 80.0
        elif kind == "wide_beam":  # beam 4 passes and is fastest
            r = 80 + L / 2 + 3 * beam
        else:  # "sampled": only sampled entry passes below L=24
            r = 92.0 if entry == "sampled" or L >= 24 else 85.0
        return float(min(100.0, r))

    def qps(L, beam, extra, entry):
        return round(1e6 / (L * (1 + extra / 10)) * (1 + beam / 8)
                     * (1.05 if entry == "sampled" else 1.0), 1)

    return recall, qps


@pytest.mark.parametrize("kind", ["knee", "flat", "extra_cliff", "wide_beam", "sampled"])
def test_refine_knee_probes_and_picks_as_jax(kind, monkeypatch):
    recall, qps = _surface(kind)
    runs = {}
    for name, mod in (("jax", jax_bench), ("port", bench)):
        probes = []

        def measure(index, search, queries, gt_ids, gt_dists, L, beam, extra,
                    n_reps=3, measure_pipelined=False, entry_mode="medoid", **kw):
            probes.append((L, beam, extra, entry_mode, n_reps))
            return {"L": L, "beam": beam, "extra": extra, "entry": entry_mode,
                    "qps": qps(L, beam, extra, entry_mode),
                    "recall": recall(L, beam, extra, entry_mode)}

        monkeypatch.setattr(mod, "_measure_point", measure)
        point = measure(None, None, None, None, None, 24, 2, 11)
        probes.clear()
        best = mod._refine_knee(None, None, None, None, None, 16, dict(point))
        runs[name] = (probes, best)
    assert runs["port"] == runs["jax"]
    assert len(runs["port"][0]) >= 4 and runs["port"][1]["frontier"] is True


LAYOUTS = {  # (variant, the port's device_index_from_files kwargs, the JAX index)
    "inmemory fused": ("inmemory", {}, lambda p: jax_index_from_files(p, "inmemory")),
    "inmemory scattered": ("inmemory", {"fused_frontier": False},
                           lambda p: jax_index_from_files(p, "inmemory",
                                                          neighbor_codes=False)),
    "exactdistance fused": ("exactdistance", {}, lambda p: jax_build(
        graph=jax_load_graph(p), fused_exact_frontier=True)),
    "exactdistance scattered": ("exactdistance", {"fused_frontier": False},
                                lambda p: jax_index_from_files(p, "exactdistance",
                                                               neighbor_vectors=False)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_traversal_gather_bytes_equal_jax(bundle, layout):
    variant, kw, jax_index = LAYOUTS[layout]
    ix = device_index_from_files(bundle, "cpu", variant, **kw)
    jix = jax_index(bundle)
    fused = ix.fused_rows is not None or ix.fused_vec_rows is not None
    assert fused == layout.endswith("fused")
    assert fused == (getattr(jix, "fused_rows", None) is not None
                     or getattr(jix, "fused_vec_rows", None) is not None)
    for q, beam in ((64, 1), (10_000, 2)):
        got = bench._traversal_gather_bytes_per_iter(ix, variant, q, beam)
        assert got == jax_bench._traversal_gather_bytes_per_iter(jix, variant, q, beam)
        assert got > 0


def _jax_headline_keys():
    """The keys of the root bench's headline line: its `result.update({...})`."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "update"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no result.update({...}) in bench.py")


_TINY = {"BENCH_N": "2000", "BENCH_D": "16", "BENCH_R": "16", "BENCH_M": "8",
         "BENCH_Q": "64", "BENCH_FAST": "1"}


def _run_bench(cache, patch=""):
    code = ("import sys\nimport bang_tpu_torch.bench as b\n"
            f"b.CACHE = {str(cache)!r}\n{patch}\nb.main(['--device', 'cpu'])\n")
    env = {**os.environ, **_TINY, **ONE_THREAD, "PYTHONPATH": str(REPO)}
    env.pop("BANG_FORCE_CPU", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout[-2000:] + res.stderr[-3000:]
    return res.returncode, json.loads(lines[0]), res.stderr


@pytest.fixture(scope="module")
def bench_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_cache")


def test_bench_main_on_the_cpu(bench_cache):
    rc, line, err = _run_bench(bench_cache)
    assert rc == 0, err[-3000:]
    want = _jax_headline_keys()
    assert {"metric", "value", "unit", "vs_baseline", "recall", "variant", "L",
            "variants", "backend"} <= want
    assert want - {"backend"} | {"device"} <= set(line)
    assert line["metric"] == "QPS_pipelined@0.9recall10_synth2K_1chip"
    assert line["unit"] == "qps" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / bench.BASELINE_QPS, 4)
    assert line["device"]["name"] == "cpu" and line["num_queries"] == 64
    assert set(line["variants"]) == {"exactdistance", "inmemory"}
    for variant, row in line["variants"].items():
        assert row["variant"] == variant and row["frontier"] is True
        assert row["recall"] >= bench.TARGET_RECALL and len(row["rep_s"]) == 5
        assert row["device_ms_full_batch"] is None  # no device time on the CPU
        assert row["p99_batch128_ms"] > 0 and row["qps_pipelined"] > 0
    assert "error" not in line and "failed_rows" not in line


def test_bench_failed_row_exits_nonzero(bench_cache):
    patch = ("orig = b.sweep_variant\n"
             "def sweep(prefix, variant, *a, **k):\n"
             "    if variant == 'exactdistance':\n"
             "        raise RuntimeError('forced row failure')\n"
             "    return orig(prefix, variant, *a, **k)\n"
             "b.sweep_variant = sweep\n")
    rc, line, err = _run_bench(bench_cache, patch)
    assert rc == 1
    assert line["variants"]["exactdistance"] == {
        "error": "RuntimeError('forced row failure')"}
    assert line["failed_rows"] == ["exactdistance"]
    assert line["variant"] == "inmemory" and line["value"] > 0
    assert "forced row failure" in err


def test_run_eval_refine_returns_the_refined_point(bundle, tmp_path, monkeypatch):
    picked = []
    refine = bench._refine_knee

    def spy(*args, **kwargs):
        picked.append(refine(*args, **kwargs))
        return picked[-1]

    monkeypatch.setattr(bench, "_refine_knee", spy)
    row = run_eval.main(["--prefix", bundle, "--variant", "inmemory", "--grid", "11",
                         "16", "32", "--nq", "64", "--refine", "--device", "cpu",
                         "--out", str(tmp_path / "r.json")])
    (best,) = picked
    assert best["frontier"] is True and best["recall"] >= run_eval.TARGET_RECALL
    assert row["refined"] == best and row["frontier"] is True
    assert (row["L"], row["beam"], row["extra"], row["entry"]) == (
        best["L"], best["beam"], best["extra"], best["entry"])
    assert row["recall"] == pytest.approx(best["recall"], abs=0.01)
    first = next(p for p in row["points"] if p["recall"] >= run_eval.TARGET_RECALL)
    assert best["L"] <= first["L"]
    with pytest.raises(ValueError, match="refine"):
        run_eval.main(["--prefix", bundle, "--variant", "base", "--refine", "--device",
                       "cpu", "--out", str(tmp_path / "x.json")])


_MERGE_CASES = {
    "carried": (
        {"metric": "m", "value": 1.0, "gist960": {"error": "boom"}, "streaming": 3},
        {"metric": "old", "value": 2.0, "gist960": {"L": 20, "recall": 95.0},
         "glove200_mips": {"error": "x"}, "spacev_int8": {"L": 11}, "note": "text",
         "streaming": {"n": 1}},
    ),
    "nothing": (
        {"metric": "m", "value": 1.0, "variants": {"inmemory": {"L": 11}}},
        {"metric": "old", "variants": {"exactdistance": {"L": 10}},
         "gist960": {"error": "e"}},
    ),
    "again": (  # an earlier merged line carries its own record
        {"metric": "m", "spacev_int8": {"error": "e"}},
        {"metric": "x", "spacev_int8": {"L": 2, "carried_from": "a.json"},
         "carried_sections": {"from": "a.json", "keys": ["spacev_int8"], "note": "n"}},
    ),
}


@pytest.mark.parametrize("case", sorted(_MERGE_CASES))
def test_merge_bench_json_bytes_equal_jax(case, tmp_path, monkeypatch):
    fresh, earlier = _MERGE_CASES[case]
    monkeypatch.chdir(tmp_path)
    with open("fresh.json", "w") as f:
        f.write("[bench] a log line\n" + json.dumps(fresh) + "\n")
    with open("earlier.json", "w") as f:
        f.write(json.dumps(earlier) + "\n")
    jax_run = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "merge_bench_json.py"), "fresh.json",
         "earlier.json", "jax.json"], capture_output=True, text=True, timeout=60)
    assert jax_run.returncode == 0, jax_run.stderr
    port_run = subprocess.run(
        [sys.executable, "-m", "bang_tpu_torch.scripts.merge_bench_json", "fresh.json",
         "earlier.json", "port.json"], capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert port_run.returncode == 0, port_run.stderr
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert port_run.stdout.replace("port.json", "jax.json") == jax_run.stdout
    merged, carried = merge_bench_json.merge(fresh, earlier, "earlier.json")
    assert json.dumps(merged) + "\n" == (tmp_path / "port.json").read_text()
    assert merge_bench_json.main(["fresh.json", "earlier.json", "again.json"]) == merged
    assert bool(carried) == (case != "nothing")


@pytest.mark.parametrize("variant,kw", [("inmemory", {}),
                                        ("inmemory", {"fused_frontier": False}),
                                        ("exactdistance", {}),
                                        ("exactdistance", {"neighbor_vectors": True})])
def test_free_device_index_leaves_no_tensor(bundle, variant, kw):
    ix = device_index_from_files(bundle, "cpu", variant, **kw)
    held = [f for f, v in vars(ix).items() if isinstance(v, (torch.Tensor, PQCodebook))]
    assert "vectors" in held and len(held) >= 3
    free_device_index(ix)
    assert not [f for f, v in vars(ix).items()
                if isinstance(v, (torch.Tensor, PQCodebook))]
    assert all(getattr(ix, f) is None for f in held)
    assert ix.n == 1500 and ix.dim == 16  # the scalars stay
