"""The harness on the CPU: cells found by name, the seeded corpus, the
reference, the metric arithmetic, the import boundary, and one tiny run of
each mix through BANGSearch(device="cpu")."""

import ast
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import cell_names
from gpubench import generator, run
from gpubench.corpus import clustered
from gpubench.metrics import _kernel_bytes
from gpubench.reference import l2_knn

ROOT = run.ROOT
HERE = run.HERE
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SMALL = dict(n=3000, dim=32, query_pool=100, n_clusters=8, latent_dim=16, cluster_sigma=0.35,
             ambient_sigma=0.02, scale=28.0, offset=128.0, dtype="uint8")


# -- discovery -----------------------------------------------------------------

@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(cell):
    c = run.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c["config"]["name"] == entry["config"]
    assert os.path.exists(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(run._reader(m["name"]))
        assert m["moves"] in names
    if c["traffic"]["loop"] == "open":
        assert c["traffic"]["rate_per_s"] > 0


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    files = set()
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith(tuple(BENCH["paths"]))
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["file"] not in files
        files.add(c["file"])
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert len(json.dumps(BENCH)) < 64 * 1024


# -- corpus ----------------------------------------------------------------------

def test_corpus_same_seed_same_bytes_other_seed_differs():
    big = 2**31 + 977
    a_base, a_q = clustered.make(SMALL, big, "cpu")
    b_base, b_q = clustered.make(SMALL, big, "cpu")
    c_base, c_q = clustered.make(SMALL, big + 1, "cpu")
    assert a_base.dtype == torch.uint8 and a_base.shape == (3000, 32)
    assert a_q.shape == (100, 32)
    assert torch.equal(a_base, b_base) and torch.equal(a_q, b_q)
    assert not torch.equal(a_base, c_base) and not torch.equal(a_q, c_q)
    # held-out draws, not base rows
    d = l2_knn.exact_knn(a_base, a_q, 1)[1]
    assert (d > 0).float().mean() > 0.9


def test_float32_corpus_and_its_exact_reference():
    spec = dict(SMALL, dtype="float32", scale=1.0, offset=0.0)
    base, queries = clustered.make(spec, 2**31 + 5, "cpu")
    again, _ = clustered.make(spec, 2**31 + 5, "cpu")
    assert base.dtype == torch.float32 and torch.equal(base, again)
    assert not torch.equal(base, base.round())  # not quantized
    ids, dists = l2_knn.exact_knn(base, queries, 10, block=33)
    d = ((queries.double()[:, None, :] - base.double()[None]) ** 2).sum(-1)
    bd, bi = d.sort(dim=1, stable=True)
    assert torch.equal(ids, bi[:, :10])
    true = l2_knn.true_distances(base, queries, ids)
    assert torch.allclose(true, bd[:, :10], rtol=1e-12, atol=0)
    assert torch.allclose(dists.double(), true, rtol=1e-6, atol=1e-6)


def test_the_config_names_its_corpus_module():
    cfg = dict(SMALL, corpus="clustered")
    assert all(torch.equal(x, y) for x, y in
               zip(run.make_corpus(cfg, 7, "cpu"), clustered.make(SMALL, 7, "cpu")))
    with pytest.raises(ModuleNotFoundError):
        run.make_corpus(dict(cfg, corpus="no_such_corpus"), 7, "cpu")


def test_corpus_chunks_do_not_change_the_bytes(monkeypatch):
    whole = clustered.make(SMALL, 5, "cpu")
    monkeypatch.setattr(clustered, "CHUNK", 700)
    cut = clustered.make(SMALL, 5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(whole, cut))


# -- reference -------------------------------------------------------------------

def _brute(base, queries, k):
    d = ((queries.long()[:, None, :] - base.long()[None]) ** 2).sum(-1)
    return d.sort(dim=1, stable=True)


def test_exact_knn_is_exact_on_u8():
    base, queries = clustered.make(SMALL, 3, "cpu")
    ids, dists = l2_knn.exact_knn(base, queries, 20, block=33)
    bd, bi = _brute(base, queries, 20)
    assert torch.equal(dists.double(), bd[:, :20].double())
    true = l2_knn.true_distances(base, queries, ids)
    assert torch.equal(true, dists.double())


def test_recall_is_the_programs_arithmetic():
    from bang_tpu_torch.utils.recall import calculate_recall

    base, queries = clustered.make(SMALL, 4, "cpu")
    gold_ids, gold_d = l2_knn.exact_knn(base, queries, l2_knn.GOLD)
    rng = np.random.default_rng(0)
    res = gold_ids[:, :10].numpy().copy()
    swap = rng.random(res.shape) < 0.3
    res[swap] = rng.integers(0, 3000, int(swap.sum()))
    res[0, 1] = res[0, 0]  # a duplicate counts once
    gold_d_ties = gold_d.clone()
    gold_d_ties[5, 9:14] = gold_d_ties[5, 9]  # a tie past k widens the gold set
    res[5, 9] = int(gold_ids[5, 12])
    judge = l2_knn.Judge(base, queries, gold_ids, gold_d_ties, 10)
    judge.add(np.arange(100), res, np.zeros(res.shape, np.float32))
    want = calculate_recall(gold_ids.numpy(), res, 10, gold_d_ties.numpy())
    assert math.isclose(judge.recall(), want, rel_tol=1e-12)


def test_dist_gap_reads_wrong_distances_and_ids():
    base, queries = clustered.make(SMALL, 6, "cpu")
    gold_ids, gold_d = l2_knn.exact_knn(base, queries, l2_knn.GOLD)
    ids, dists = gold_ids[:, :10].numpy(), gold_d[:, :10].numpy()
    j = l2_knn.Judge(base, queries, gold_ids, gold_d, 10)
    j.add(np.arange(100), ids, dists)
    assert j.gap == 0.0 and j.recall() == 100.0
    bad = dists.copy()
    bad[3, 4] += 1.0
    j.add(np.arange(100), ids, bad)
    assert j.gap > 0
    oob = ids.copy()
    oob[7, 2] = 3000
    j.add(np.arange(100), oob, dists)
    assert j.gap == math.inf


def test_the_judges_decision():
    j = l2_knn.Judge(None, None, None, None, 10)
    cfg = {"recall_limit": 90.0, "dist_gap_limit": 0.0}
    assert not j.correct(cfg)  # nothing answered
    j.answered, j.hits = 10, 90
    assert j.correct(cfg) and j.checks(cfg) == {
        "recall": {"value": 90.0, "limit": 90.0}, "dist_gap": {"value": 0.0, "limit": 0.0}}
    j.gap = 1e-9
    assert not j.correct(cfg)
    j.gap, j.hits = 0.0, 89
    assert not j.correct(cfg)


# -- the config's settings reach the program -------------------------------------

def test_load_and_search_settings_pass_through(tiny, tmp_path):
    """Every key of a config's `load` and `search` reaches bang_load and
    SearchParams unchanged: here the bloom visited set, the scattered
    layout and a pq_impl, none of which the harness names."""
    from bang_tpu_torch.models.index import layout_of

    cfg = dict(tiny("sift1m-inmemory.batch10k")["config"])
    base, _ = run.make_corpus(cfg, 3, "cpu")
    prefix = str(tmp_path / "index")
    run._build_index(cfg, base.numpy(), 3, prefix, torch.device("cpu"),
                     lambda name, fn: fn())
    for load, search in (({"fused_frontier": True}, {"beam_width": 2}),
                         ({"fused_frontier": False},
                          {"visited_mode": "bloom", "pq_impl": "xla", "extra_iters": 3})):
        cfg.update(load=load, search=search)
        call, srv = run._open_system(cfg, {"entry": "bang_query", "batch": 16}, prefix,
                                     torch.device("cpu"))
        try:
            for key, value in search.items():
                assert getattr(srv.params, key) == value
            assert ("fused" in " ".join(layout_of(srv.engine._index))) == load["fused_frontier"]
            ids, dists = call(np.zeros((16, cfg["dim"]), np.float32))
            assert ids.shape == (16, cfg["k"])
        finally:
            run.close_system(srv)
    with pytest.raises(SystemExit):
        run._open_system(cfg, {"entry": "no_such_entry", "batch": 16}, prefix,
                         torch.device("cpu"))


# -- metric arithmetic ---------------------------------------------------------

def test_whole_window_rate_and_percentile_over_all_requests():
    rec = run.Record(kind="cpu", config={}, batch=4, setup={})
    rec.sizes = [10000] * 7 + [5000]
    rec.window_s = 2.5
    rec.latencies = list(np.linspace(0.01, 0.2, 20))
    assert run._end_to_end("qps", rec, 0.0, 0.0) == 75000 / 2.5
    assert run._end_to_end("p95_ms", rec, 0.0, 0.0) == pytest.approx(
        1e3 * np.percentile(rec.latencies, 95))


def test_open_loop_schedule_same_work_every_seed():
    params = {"rate_per_s": 50.0, "size_min": 128, "size_max": 4096}
    a = generator.open_schedule(params, 10000, 1, 20.0)
    b = generator.open_schedule(params, 10000, 2**31 + 7, 20.0)
    assert len(a) == len(b) == 1000
    assert sorted(len(r.idx) for r in a) == sorted(len(r.idx) for r in b)
    for s in (a, b):
        due = np.array([r.due for r in s])
        assert np.all(np.diff(due) > 0) and 0 < due[0] and due[-1] < 20.0
        assert due[-1] == pytest.approx(20.0 * 999.5 / 1000)
        assert all(len(np.unique(r.idx)) == len(r.idx) for r in s)
    sizes = np.array([len(r.idx) for r in a])
    assert sizes.min() >= 128 and sizes.max() <= 4096
    assert [len(r.idx) for r in a] != [len(r.idx) for r in b]


def test_closed_loop_sends_the_whole_pool():
    reqs = generator.closed_requests({"request_size": 50}, 50, 3)
    assert all(np.array_equal(next(reqs).idx, np.arange(50)) for _ in range(3))


def test_roofline_bytes_from_shapes():
    # the kernel table's shapes (PERF.md): K2 at Q=10K, m=64, R=64, beam 2,
    # every parent valid: 327.68 MB of tables + 87.04 of rows + 10.24 out
    # + 0.08 of parents
    k2 = _kernel_bytes.frontier_lookup(10000, 2, 64, 64, 1, 20000)
    assert k2 == 10000 * (64 * 512 + 8 + 1024) + 20000 * 64 * 68
    assert k2 / 1e6 == pytest.approx(425.04, abs=0.01)
    # K3 at Q=10K, beam 1, R=64, D=128: 87.04 MB of rows + 5.12 of queries
    k3 = _kernel_bytes.exact_frontier(10000, 1, 64, 128, 1, 10000)
    assert k3 / 1e6 == pytest.approx(97.32, abs=0.01)
    # invalid parents read no row
    assert _kernel_bytes.exact_frontier(10000, 1, 64, 128, 1, 0) == 10000 * (512 + 4 + 512)


def test_roofline_silent_without_trace_or_when_counts_disagree():
    from bang_tpu_torch.utils.config import SearchParams
    from gpubench.trace import Timeline

    rec = run.Record(kind="NVIDIA H100 80GB HBM3", config={"R": 64, "dim": 128},
                     params=SearchParams(L=10, beam_width=1), batch=10000, setup={})
    read = run._reader("exact_frontier_roofline.batch")
    assert read(rec) is None
    rec.timeline = Timeline(1.0, [("void exact_frontier_kernel<16, 4>", 0.0, 5e-5)] * 2, [], [])
    rec.launches = {"exact_frontier": 3}
    rec.slice_calls = range(1)
    rec.expanded = [20000]
    assert read(rec) is None
    rec.launches = {"exact_frontier": 2}
    nbytes = _kernel_bytes.exact_frontier(10000, 1, 64, 128, 2, 20000)
    assert read(rec) == pytest.approx(100 * nbytes / 3.35e12 / 1e-4)


def test_timeline_busy_idle_and_gaps():
    from gpubench.trace import Timeline

    tl = Timeline(1.0, [("a", 0.0, 0.2), ("b", 0.1, 0.3), ("c", 0.5, 0.6)],
                  [("Memcpy HtoD", 0.6, 0.7)],
                  [("gpubench.request", 0.0, 0.7), ("aten::copy_", 0.35, 0.45)])
    assert tl.busy_s() == pytest.approx(0.5)
    assert tl.idle_gaps() == [["aten::copy_", pytest.approx(0.2)]]
    assert tl.top_ops()[0][0] == "a"
    # idle and host time against the untraced calls' wall: 2 traced calls
    # (0.25 s busy each) inside the slice, 2 untraced of 0.4 s outside it
    rec = run.Record(kind="x", config={}, batch=1, setup={}, timeline=tl,
                     walls=[0.4, 0.9, 0.9, 0.4], slice_calls=range(1, 3))
    assert run._reader("device_idle_pct.batch")(rec) == pytest.approx(37.5)
    assert run._reader("call_host_ms.batch")(rec) == pytest.approx(150.0)
    for silent in (dict(timeline=None), dict(slice_calls=range(0)),
                   dict(walls=[0.9, 0.9], slice_calls=range(0, 2))):
        other = run.Record(**{**rec.__dict__, **silent})
        assert run._reader("device_idle_pct.batch")(other) is None
        assert run._reader("call_host_ms.batch")(other) is None


# -- the import boundary -------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "bang_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        if os.sep + "tests" in dirpath:
            continue
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    refs = [p for p in _sources("reference")]
    assert refs
    for path in refs:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "bang_tpu_torch" not in tops, path


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {os.path.join(HERE, 'tests')!r})\n"
        "from conftest import tiny_cell\n"
        "from gpubench import run\n"
        "out = run.execute(tiny_cell('sift1m-exact.batch10k'), 9, 0.5, False, 'cpu')\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules} & set(run.FORBIDDEN))\n"
        "print(json.dumps({'correct': out['correct'], 'tops': tops}))\n")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "tops": []}
    assert not os.listdir(tmp_path)  # the index files are gone


def test_no_result_without_the_card_or_the_program(tmp_path):
    """The CLI prints nothing on stdout and exits non-zero without a CUDA
    device (here), and in a directory that holds only the benchmark."""
    p = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and not p.stdout.strip()
    import shutil

    shutil.copytree(HERE, tmp_path / "gpubench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; from gpubench import run; "
            "sys.exit(run.execute(run.load_cell(sys.argv[1]), 1, 1.0, False, 'cpu') and 0)")
    p = subprocess.run([sys.executable, "-c", code, BENCH["workloads"][0]["name"]],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and not p.stdout.strip()


# -- tiny runs of each mix -------------------------------------------------------

@pytest.mark.parametrize("cell", cell_names())
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_the_contracts_line(tiny, cell, trace):
    c = tiny(cell)
    out = run.execute(c, 2**31 + 11, 1.0, bool(trace), "cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["platform"] == "cpu" and out["device"]["memory_peak_bytes"] is None
    assert "busy_s" not in out["device"] and "breakdown" not in out
    names = set(out["metrics"])
    if trace:
        want = {m["name"] for m in c["per_layer"] if m["source"] != "device_trace"}
        assert names == want
    else:
        assert names == {m["name"] for m in c["end_to_end"]}
        assert out["metrics"]["recall_at_10"]["value"] >= 80
    assert all(isinstance(v["value"], float) and math.isfinite(v["value"])
               for v in out["metrics"].values())
    json.dumps(out)


@pytest.mark.card
def test_one_short_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cell = BENCH["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", cell, "--seed",
                        "2147483659", "--seconds", "3", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0


def test_slice_keeps_only_the_marked_events(monkeypatch):
    """One session from before the capture; stop() keeps what falls in the
    marked slice (on the CPU the profiler records host ranges only)."""
    import time

    from gpubench.trace import Slice

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    s = Slice(torch.device("cpu"))
    s.open()
    with torch.profiler.record_function("before.slice"):
        torch.ones(64).sum()
    assert not s.recording
    s.mark(time.perf_counter)
    assert s.recording
    with torch.profiler.record_function("gpubench.request"):
        torch.ones(64).mul(2)
    tl = s.stop()
    assert not s.recording and tl.window_s > 0
    names = {h[0] for h in tl.host}
    assert "gpubench.request" in names and "before.slice" not in names
    assert "gpubench.slice" not in names
