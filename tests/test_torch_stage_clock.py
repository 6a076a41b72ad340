"""The stage clock of ENABLE_GPU_STATS (ops/stage_clock.py,
csrc/stage_clock.cu) on the CPU: its plain version, where the searches
stamp it (five stamps a step, two in the prologue, two in the epilogue),
the counters it rides back with (SearchStats), and the graph cache's key,
which the stats bit changes. The kernel itself runs on the card only
(chip_smoke.py's stats phase)."""

import re

import numpy as np
import pytest
import torch

from bang_tpu_torch.constants import ENABLE_GPU_STATS
from bang_tpu_torch.formats.bin_io import load_bin_auto
from bang_tpu_torch.models import compiled, exactdistance, inmemory
from bang_tpu_torch.models.index import device_index_from_files, layout_of
from bang_tpu_torch.models.traversal import SearchStats
from bang_tpu_torch.ops import _build
from bang_tpu_torch.ops import stage_clock as sc
from bang_tpu_torch.utils.config import SearchParams


def test_plain_stamps_add_into_their_buckets():
    """START zeroes the buckets; each stamp adds the time since the last
    one to its stage, so the buckets sum to the first stamp's distance from
    the last."""
    clock = sc.StageClock("cpu")
    clock.buf[:] = 7
    clock.start()
    first = int(clock.buf[-1])
    assert clock.ns().tolist() == [0] * len(sc.STAGES)
    for name in ("tables", "frontier", "frontier", "rerank"):
        sum(range(2000))
        clock.stamp(name)
    ns = dict(zip(sc.STAGES, clock.ns().tolist()))
    assert ns["frontier"] > 0 and ns["visited"] == 0
    assert sum(ns.values()) == int(clock.buf[-1]) - first


def test_no_clock_stamps_nothing(monkeypatch):
    """With the stats off a search stamps NO_CLOCK: no stamp runs, the
    counters go back as they are, and the eager loop's flag reads are
    the flag and count nothing."""
    stamps = _counted_stamps(monkeypatch)
    assert sc.clock_for("cpu", False) is sc.NO_CLOCK
    assert isinstance(sc.clock_for("cpu", True), sc.StageClock)
    clock = sc.NO_CLOCK
    clock.start()
    clock.stamp("frontier")
    counters = torch.tensor([3, 1, 2])
    assert clock.append(counters) is counters and clock.stages() is None
    assert clock.read(torch.tensor(True)) is True and clock.read(torch.tensor(False)) is False
    assert stamps == [] and clock.reads == 0
    on = sc.StageClock("cpu")
    assert on.read(torch.tensor(True)) and on.reads == 1
    assert on.append(counters).tolist() == [3, 1, 2] + [0] * len(sc.STAGES)


def test_stamp_checks_its_arguments():
    with pytest.raises(ValueError, match="int64"):
        sc.stage_clock(torch.zeros(len(sc.STAGES) + 1, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="clock must be"):
        sc.stage_clock(torch.zeros(3, dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="outside"):
        sc.stage_clock(torch.zeros(len(sc.STAGES) + 1, dtype=torch.int64), len(sc.STAGES))


def test_kernel_source_matches_the_stages():
    """The kernel's bucket count is STAGES', its stage a template argument,
    and its entry point takes every stage from START up."""
    src = (_build.SRC_DIR / "stage_clock.cu").read_text()
    assert int(re.search(r"constexpr int kStages = (\d+);", src).group(1)) == len(sc.STAGES)
    assert "template <int S>\n__global__ void stage_clock_kernel(" in src
    cases = [int(c) for c in re.findall(r"case (-?\d+): return", src)]
    assert cases == list(range(sc.START, len(sc.STAGES)))
    assert "%%globaltimer" in src


def test_search_stats_carry_the_buckets():
    st = SearchStats(torch.tensor(3), torch.tensor(1), torch.tensor(2),
                     stages=torch.arange(len(sc.STAGES)) * 1_000_000)
    values = st.device_values()
    assert values.tolist() == [3, 1, 2, *range(0, len(sc.STAGES) * 1_000_000, 1_000_000)]
    st.sync(values.tolist())
    assert (st.iters, st.n_expanded, st.n_dist_comps) == (3, 1, 2)
    assert st.stage_ms == {name: float(i) for i, name in enumerate(sc.STAGES)}
    plain = SearchStats(torch.tensor(3), torch.tensor(1), torch.tensor(2))
    assert plain.device_values().shape == (3,) and plain.stage_ms is None


def _counted_stamps(monkeypatch):
    stamps = []
    plain = sc.stage_clock

    def stamp(clock, stage):
        stamps.append(stage)
        plain(clock, stage)

    monkeypatch.setattr(sc, "stage_clock", stamp)
    return stamps


@pytest.mark.parametrize("variant, fused, beam", [("inmemory", None, 2),
                                                  ("inmemory", False, 1),
                                                  ("exactdistance", None, 1)])
def test_eager_search_stamps_where_the_graph_does(tiny_uint8_index, monkeypatch, variant,
                                                  fused, beam):
    """A search with ENABLE_GPU_STATS stamps START and `tables` in its
    prologue, carry/frontier/visited/merge/select in each step and
    carry/rerank in its epilogue: 5 (iters - 1) + 4 stamps. Its answers
    and counters are the stats-off search's, bit for bit."""
    prefix = tiny_uint8_index["prefix"]
    index = device_index_from_files(prefix, "cpu", variant=variant, fused_frontier=fused)
    queries = load_bin_auto(prefix + "_query.bin", np.float32)[:24]
    search = (inmemory.search_inmemory if variant == "inmemory"
              else exactdistance.search_exact)
    on = SearchParams(L=24, k=10, beam_width=beam, capabilities=ENABLE_GPU_STATS)
    off = SearchParams(L=24, k=10, beam_width=beam)
    stamps = _counted_stamps(monkeypatch)
    ids, dists, st = search(index, queries, on)
    n = st.iters
    step = [sc.STAGES.index(s) for s in ("carry", "frontier", "visited", "merge", "select")]
    assert stamps == ([sc.START, sc.STAGES.index("tables")] + step * (n - 1)
                      + [sc.STAGES.index("carry"), sc.STAGES.index("rerank")])
    assert set(st.stage_ms) == set(sc.STAGES) and min(st.stage_ms.values()) >= 0
    assert st.host_reads in (n, n - 1)
    del stamps[:]
    p_ids, p_dists, p_st = search(index, queries, off)
    assert stamps == [] and p_st.stage_ms is None and p_st.host_reads == 0
    assert torch.equal(ids, p_ids) and torch.equal(dists, p_dists)
    assert (st.iters, st.n_expanded, st.n_dist_comps) == (
        p_st.iters, p_st.n_expanded, p_st.n_dist_comps)


class _RecordedLoop:
    """models/compiled.CapturedLoop stood in on the CPU: records the stats
    flag it was made with; a launch runs the eager loop."""

    made = []

    def __init__(self, start, finish, inputs, max_iters, stats=False):
        self.start, self.finish, self.max_iters, self.stats = start, finish, max_iters, stats
        self.closed = False
        _RecordedLoop.made.append(self)

    def launch(self, *inputs, timers=None):
        return compiled.run_eager(self.start, self.finish, inputs, self.max_iters)

    def close(self):
        self.closed = True


def test_the_stats_bit_is_part_of_the_graph_key(tiny_uint8_index, monkeypatch):
    """The search's graph key holds its SearchParams, so turning the stats
    on drops the stats-off loop and captures one with the stage clock (and
    back): a graph captured without stamps is never launched for a
    stats-on call. The eager first call of a stats-on key reports its
    stages."""
    prefix = tiny_uint8_index["prefix"]
    index = device_index_from_files(prefix, "cpu", variant="inmemory")
    queries = torch.as_tensor(load_bin_auto(prefix + "_query.bin", np.float32)[:16])
    monkeypatch.setattr(compiled, "CapturedLoop", _RecordedLoop)
    monkeypatch.setattr(_RecordedLoop, "made", [])
    owner = type("Owner", (), {})()
    runs = {}
    for caps in (0, ENABLE_GPU_STATS, 0):
        params = SearchParams(L=24, k=10, beam_width=2, capabilities=caps)
        key = ("inmemory", layout_of(index), tuple(queries.shape), params)
        (ids, _), st = compiled.search(owner, key, queries, "cpu", params.max_iters,
                                       *inmemory._parts(index, params),
                                       stats=bool(caps))
        assert (st.stage_ms is not None) == bool(caps)
        runs.setdefault(caps, []).append(ids)
    made = _RecordedLoop.made
    assert [m.stats for m in made] == [False, True, False]
    assert made[0].closed and made[1].closed and not made[2].closed
    assert torch.equal(runs[0][0], runs[ENABLE_GPU_STATS][0])
