"""The port's facade and harness CLI for all three variants on the CPU,
mirroring tests/test_api_harness.py: the driver's modes and output, batch
shapes at the API (a batch smaller than bang_alloc's is padded, a larger
one split), ENABLE_GPU_STATS, the stage timers, and the copied numpy
helpers the CLI reads (load_bin_auto, DATASET_PRESETS)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from bang_tpu.formats.bin_io import load_bin_auto as jax_load_bin_auto
from bang_tpu.utils.config import DATASET_PRESETS as JAX_PRESETS
from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.constants import ENABLE_GPU_STATS
from bang_tpu_torch.formats.bin_io import load_bin_auto, save_bin
from bang_tpu_torch.harness import driver
from bang_tpu_torch.ops.stage_clock import STAGES
from bang_tpu_torch.utils import timer
from bang_tpu_torch.utils.config import DATASET_PRESETS

VARIANTS = ["base", "inmemory", "exactdistance"]


def _argv(prefix, n, *extra):
    """The CLI's arguments on the CPU; base keeps 2 sub-batches in flight
    (the HBM variants ignore --pipeline, as in the JAX harness)."""
    return [prefix, prefix + "_query.bin", prefix + "_gt.bin", str(n), "10", "float",
            "l2", "--device", "cpu", "--pipeline", "2", *extra]


@pytest.mark.parametrize("variant", VARIANTS)
def test_driver_single_mode(tiny_index, capsys, variant):
    prefix = tiny_index["prefix"]
    rc = driver.main(_argv(prefix, 64, "--variant", variant, "--mode", "single",
                           "--L", "48", "--reps", "2", "--json", "--stats"))
    assert rc == 0
    out = capsys.readouterr().out
    assert "L\twall_ms\tQPS\trecall\trep" in out
    best = [ln for ln in out.splitlines() if ln.endswith("best")]
    assert len(best) == 1 and best[0].startswith("48\t")
    assert float(best[0].split("\t")[3]) >= 85.0
    row = json.loads(next(ln for ln in out.splitlines() if ln.startswith("{")))
    assert row["L"] == 48 and row["variant"] == variant and row["device"] == "cpu"
    assert out.count("# stage timers:") == 2
    assert all(s in out for s in ("query", "unpack"))
    if variant == "base":
        assert all(s in out for s in ("host_gather", "d2h_parents", "dispatch", "wall"))
    else:
        assert out.count("# stats: iters=") == 2
        assert all(s in out for s in ("dev.graph", "dev.frontier", "readback",
                                      "host_waits"))


def test_driver_dataset_preset_and_pipeline(tiny_index, capsys, monkeypatch):
    """--dataset wires DATASET_PRESETS (dim and dtype mismatches warn);
    --pipeline reaches the base searcher."""
    from bang_tpu_torch.models import base

    seen = []
    init = base.BaseVariantSearcher.__init__

    def spy(self, prefix, n_pipeline_batches=4, **kw):
        seen.append(n_pipeline_batches)
        init(self, prefix, n_pipeline_batches=n_pipeline_batches, **kw)

    monkeypatch.setattr(base.BaseVariantSearcher, "__init__", spy)
    prefix = tiny_index["prefix"]
    rc = driver.main(_argv(prefix, 32, "--variant", "base", "--mode", "single",
                           "--L", "48", "--reps", "1", "--dataset", "sift10k",
                           "--beam", "2"))
    assert rc == 0
    out = capsys.readouterr().out
    assert "WARNING: index dim 48 != preset sift10k dim 128" in out
    assert seen == [2]
    with pytest.raises(SystemExit):
        driver.main(_argv(prefix, 32, "--dataset", "nope"))


def test_driver_auto_sweep_target(tiny_index, capsys):
    rc = driver.main(_argv(tiny_index["prefix"], 32, "--variant", "exactdistance",
                           "--mode", "auto", "--reps", "1", "--step", "24",
                           "--max-L", "64", "--target-recall", "95.0"))
    assert rc == 0
    assert capsys.readouterr().out.count("best") >= 1


def test_driver_interactive_mode(tiny_index, capsys, monkeypatch):
    inputs = iter(["32", "q"])
    monkeypatch.setattr("builtins.input", lambda _: next(inputs))
    rc = driver.main(_argv(tiny_index["prefix"], 32, "--variant", "base",
                           "--mode", "interactive", "--reps", "1"))
    assert rc == 0
    assert capsys.readouterr().out.count("best") == 1


def test_driver_profile_dir_writes_a_chrome_trace(tiny_index, tmp_path, capsys):
    rc = driver.main(_argv(tiny_index["prefix"], 16, "--variant", "inmemory",
                           "--mode", "single", "--L", "16", "--reps", "2",
                           "--profile-dir", str(tmp_path / "prof")))
    assert rc == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_driver_defaults_to_the_card(tiny_index):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the CUDA-less refusal")
    with pytest.raises(RuntimeError, match="is_available"):
        driver.main(_argv(tiny_index["prefix"], 8)[:7])  # no --device


def _engine(prefix, variant, L=32, **params):
    s = BANGSearch(variant, device="cpu")
    s.bang_load(prefix, n_pipeline_batches=2)  # base only
    s.bang_set_searchparams(10, L, beam_width=2, **params)
    return s


@pytest.mark.parametrize("variant", VARIANTS)
def test_partial_and_oversized_batches(tiny_index, variant):
    """bang_alloc(Q) records Q: a smaller batch is padded to Q, a larger one
    split into batches of Q (the last padded), so each returns what the
    unpadded calls of those batches return."""
    prefix = tiny_index["prefix"]
    queries = load_bin_auto(prefix + "_query.bin", np.float32)
    s = _engine(prefix, variant)
    s.bang_alloc(32)
    full_ids, full_d = s.bang_query(queries[:32])  # Q = 32: no padding
    ids, d = s.bang_query(queries[:17])
    assert ids.shape == (17, 10) and ids.dtype == np.int64
    np.testing.assert_array_equal(ids, full_ids[:17])
    np.testing.assert_array_equal(d, full_d[:17])
    big_ids, big_d = s.bang_query(queries[:80])  # 32 + 32 + 16 padded to 32
    assert big_ids.shape == (80, 10) and big_d.shape == (80, 10)
    np.testing.assert_array_equal(big_ids[:32], full_ids)
    np.testing.assert_array_equal(big_ids[32:64], s.bang_query(queries[32:64])[0])
    np.testing.assert_array_equal(big_ids[64:], s.bang_query(queries[64:80])[0])
    # without bang_alloc the batch runs as it is
    s.bang_set_searchparams(10, 32, beam_width=2)
    assert s.bang_query(queries[:5])[0].shape == (5, 10)


@pytest.mark.parametrize("variant", VARIANTS)
def test_gpu_stats_capability_served(tiny_index, variant):
    """ENABLE_GPU_STATS works for every variant, as in the JAX package: base
    fills its stage timers, the HBM variants report last_stats and, on the
    eager loop, every device stage (the plain stage clock), each >= 0,
    summing to dev.graph, no more than the call's `query` span; the host
    waits are the loop's flag reads and the readback. Answers are
    bit-identical with the stats off, which records nothing."""
    prefix = tiny_index["prefix"]
    queries = load_bin_auto(prefix + "_query.bin", np.float32)[:16]
    s = _engine(prefix, variant, capabilities=ENABLE_GPU_STATS)
    s.bang_alloc(16)
    ids, dists = s.bang_query(queries)
    plain = _engine(prefix, variant)
    p_ids, p_dists = plain.bang_query(queries)
    np.testing.assert_array_equal(ids, p_ids)
    np.testing.assert_array_equal(dists, p_dists)
    assert not plain.timers.ms and not plain.timers.counts
    ms = s.timers.ms
    assert {"query", "pad", "unpack"} <= set(ms)
    if variant == "base":
        assert s.last_stats is None
        assert set(s._searcher.timers.ms) == {"host_gather", "d2h_parents", "dispatch",
                                              "wall"}
        assert not any(name.startswith("dev.") for name in ms)
    else:
        st = s.last_stats
        assert st.iters > 1 and st.n_expanded > 0
        dev = {name: ms[f"dev.{name}"] for name in STAGES}
        assert all(v >= 0 for v in dev.values()) and "readback" in ms
        assert sum(dev.values()) == pytest.approx(ms["dev.graph"])
        assert ms["dev.graph"] <= ms["query"]
        assert s.timers.counts["host_waits"] == 1 + st.host_reads
        assert st.host_reads in (st.iters, st.iters - 1)
        assert not any(name.startswith("dev.") for name in plain.timers.ms)


@pytest.mark.parametrize("variant", ["inmemory", "exactdistance"])
def test_stats_spans_nest_in_a_profiler_range(tiny_index, variant, monkeypatch):
    """Under a running torch.profiler each span of bang_query is a
    `bang.<span>` range inside `bang.query`; without one no range opens."""
    from torch.profiler import ProfilerActivity, profile

    prefix = tiny_index["prefix"]
    queries = load_bin_auto(prefix + "_query.bin", np.float32)[:12]
    s = _engine(prefix, variant, capabilities=ENABLE_GPU_STATS)
    s.bang_alloc(16)
    opened = []
    rf = torch.profiler.record_function

    def counted(name, *args):
        opened.append(name)
        return rf(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    s.bang_query(queries)
    assert opened == [] and s.timers.ms["query"] > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.bang_query(queries)
    spans = {e.name: e.time_range for e in prof.events() if e.name.startswith("bang.")}
    assert {"bang.query", "bang.pad", "bang.readback", "bang.unpack"} <= set(spans)
    outer = spans.pop("bang.query")
    assert all(outer.start <= r.start and r.end <= outer.end for r in spans.values())


def test_stage_waits_on_a_cuda_event():
    """The stage timers: a disabled timer records nothing and opens no span
    (its `stage` is one shared null context, so a span that would wait on
    the card costs nothing); an enabled one adds each span's ms, nested
    spans inside their outer one, and reports its spans, counters and
    set-up records, of which `clear` keeps only the set-up."""
    off = timer.StageTimers(enabled=False)
    assert off.stage("step") is off.stage("other")
    with off.stage("step"):
        pass
    assert not off.ms and not off.counts and off.report() == ""
    t = timer.StageTimers()
    with t.stage("outer"):
        with t.stage("inner"):
            sum(range(1000))
        with t.stage("inner"):
            pass
    assert set(t.ms) == {"outer", "inner"} and 0 <= t.ms["inner"] <= t.ms["outer"]
    t.counts["host_waits"] += 1
    t.setup = {"capture_s": 0.5, "graph_bytes": 4096}
    report = t.report()
    assert all(k in report for k in ("outer", "inner", "host_waits", "capture_s",
                                     "graph_bytes"))
    t.clear()
    assert not t.ms and not t.counts and t.setup["graph_bytes"] == 4096


def test_copied_cli_helpers_match_jax(tmp_path):
    assert DATASET_PRESETS.keys() == JAX_PRESETS.keys()
    for name, p in DATASET_PRESETS.items():
        assert dataclasses.astuple(p) == dataclasses.astuple(JAX_PRESETS[name])
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.uint8, np.int8):
        path = str(tmp_path / f"{np.dtype(dtype).name}.bin")
        save_bin(path, rng.integers(0, 100, (5, 3)).astype(dtype))
        for preferred in (np.float32, np.uint8, np.int8):
            got, want = load_bin_auto(path, preferred), jax_load_bin_auto(path, preferred)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
