"""The captured loop's parts on the CPU: the device iteration counter, the
in-place step (the body the card's WHILE node replays, models/compiled.py),
the loop condition, base's step with a device counter, and the graph cache,
the kernels' launch counters and the readback around them.

The card's WHILE node evaluates `go_flag` after the prologue and after each
step and runs `traversal.step_` while it holds. Here the same graph is
modelled on CPU tensors in the same order (`_while_node`: the flag is the
only tensor read, once a step), and ends in the eager loop's final state
(traversal.traverse, the plain version) bit for bit: worklists, visited
lists, `it`, `n_expanded`, `n_dist_comps`, bloom filters. The step writes
every step into the same buffers, as a replay needs, and once the flag is
false the node runs no step, so nothing changes. Against JAX's
run_traversal: on u8 data with exact distances every distance is an
integer, so the final states are identical; PQ walks are held at
test_torch_search.py's bar (iterations within 1, >= 99% of worklist rows
identical).
"""

import re


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bang_tpu.constants import BF_ENTRIES
from bang_tpu.formats.graph import load_graph_index as jax_load_graph
from bang_tpu.formats.pq import load_pq as jax_load_pq
from bang_tpu.models import base as jbase
from bang_tpu.models import traversal as jtrav
from bang_tpu.ops.pq import prepare_pq_codebook as jax_codebook
from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.constants import INVALID_ID
from bang_tpu_torch.formats.bin_io import load_bin_auto
from bang_tpu_torch.formats.pq import load_pq
from bang_tpu_torch.models import base as tbase
from bang_tpu_torch.models import compiled
from bang_tpu_torch.models.entry import entry_points
from bang_tpu_torch.models.index import device_index_from_files
from bang_tpu_torch.models.traversal import (
    SearchStats,
    go_flag,
    make_exact_distance_fn,
    make_pq_distance_fn,
    start_traversal,
    step_,
    traverse,
)
from bang_tpu_torch.ops import _build
from bang_tpu_torch.ops import pq_kernels as pk
from bang_tpu_torch.ops.merge import merge_worklist, select_parents_beam
from bang_tpu_torch.ops.pq import pq_lookup
from bang_tpu_torch.ops.visited import exact_new_mask, first_occurrence_mask_blocks
from bang_tpu_torch.utils.config import SearchParams

Q = 24  # queries: a few rows keep each walk in milliseconds


def _queries(prefix):
    return torch.as_tensor(load_bin_auto(prefix + "_query.bin", np.float32)[:Q]).float()


def _walk(prefix, kind, params):
    """(step, initial state) of one walk on the bundle at `prefix`: kind
    "exact" (scattered exact L2), "pq" (scattered codes) or "fused" (fused
    PQ rows), the walk the CPU search takes."""
    q = _queries(prefix)
    if kind == "exact":
        index = device_index_from_files(prefix, "cpu", "exactdistance",
                                        fused_frontier=False)
        fn = make_exact_distance_fn(q, index.vectors)
    else:
        index = device_index_from_files(prefix, "cpu", fused_frontier=kind == "fused")
        fn = make_pq_distance_fn(q, index.codebook, index.codes, index.fused_rows)
    entry_ids, entry_dists = entry_points(index, q, params)
    return start_traversal(index.adj, fn, index.medoid, Q, params.L, params.max_iters,
                           params.beam_width, "cpu", entry_ids, entry_dists,
                           params.visited_mode == "bloom")


def _clone(state):
    return type(state)(*(None if t is None else t.clone() for t in state))


def _assert_states_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


class _Reads:
    """Counts host reads of tensors (bool, item, tolist) while on."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("__bool__", "item", "tolist"):
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._counted(orig))

    def _counted(self, orig):
        def read(t, *args):
            self.n += 1
            return orig(t, *args)
        return read


def _while_node(step, state, max_iters):
    """The captured loop's graph on the CPU: the flag after the prologue,
    then, while it holds, the in-place step and the next flag (the card's
    WHILE node reads the flag on the device; here bool() reads it).
    Returns (state, steps run)."""
    go = go_flag(state, max_iters)
    steps = 0
    while bool(go):
        step_(step, state)
        go_flag(state, max_iters, out=go)
        steps += 1
    return state, steps


# (bundle fixture, walk kind, L, beam, extra_iters, visited mode, entry mode)
CASES = {
    "exact_b1": ("tiny_uint8_index", "exact", 24, 1, 40, "exact", "medoid"),
    "exact_b2": ("tiny_uint8_index", "exact", 24, 2, 60, "exact", "medoid"),
    "exact_bloom_b2": ("tiny_uint8_index", "exact", 24, 2, 60, "bloom", "medoid"),
    "exact_sampled_b2": ("tiny_uint8_index", "exact", 24, 2, 40, "exact", "sampled"),
    "pq_b2": ("tiny_index", "pq", 32, 2, 60, "exact", "medoid"),
    "fused_b1": ("tiny_index", "fused", 32, 1, 40, "exact", "medoid"),
    "fused_bloom_b2": ("tiny_index", "fused", 32, 2, 12, "bloom", "sampled"),
    "capped_b2": ("tiny_index", "fused", 32, 2, 3, "exact", "medoid"),  # ends at max_iters
}


def _case(request, name):
    fixture, kind, L, beam, extra, mode, entry = CASES[name]
    info = request.getfixturevalue(fixture)
    params = SearchParams(L=L, k=10, beam_width=beam, extra_iters=extra,
                          visited_mode=mode, entry_mode=entry, entry_samples=64)
    return info["prefix"], kind, params


@pytest.mark.parametrize("name", list(CASES))
def test_while_node_equals_eager_traverse(request, name, monkeypatch):
    """The WHILE node's loop ends in the eager loop's final state, bit for
    bit, after as many steps; the flag is the one tensor it reads, once
    after the prologue and once a step."""
    prefix, kind, params = _case(request, name)
    mi = params.max_iters
    step, state = _walk(prefix, kind, params)
    want = traverse(step, _clone(state), mi)
    reads = _Reads(monkeypatch)
    got, steps = _while_node(step, state, mi)
    assert reads.n == steps + 1
    monkeypatch.undo()
    _assert_states_equal(got, want)
    assert steps == int(want.it) - 1
    if name == "capped_b2":
        assert int(got.it) == mi and bool(got.active.any())
    else:
        assert int(got.it) < mi and not bool(got.active.any())


@pytest.mark.parametrize("name", list(CASES))
def test_step_in_place_keeps_its_buffers(request, name):
    """step_ writes each step into the state's own buffers (a replay reads
    and writes the same addresses) and equals the step that returns new
    tensors, every step of the walk."""
    prefix, kind, params = _case(request, name)
    step, state = _walk(prefix, kind, params)
    ptrs = [None if t is None else t.data_ptr() for t in state]
    ref = _clone(state)
    for _ in range(min(6, params.max_iters - 1)):
        ref = step(ref)
        assert step_(step, state) is state
        assert [None if t is None else t.data_ptr() for t in state] == ptrs
        _assert_states_equal(state, ref)


@pytest.mark.parametrize("name", ["exact_bloom_b2", "capped_b2"])
def test_while_node_with_go_false_changes_nothing(request, name):
    """Once the flag is false the node runs no step and no tensor changes:
    after the queries finish, and at it == max_iters with queries still
    active, bloom filter included."""
    prefix, kind, params = _case(request, name)
    mi = params.max_iters
    step, state = _walk(prefix, kind, params)
    state, _ = _while_node(step, state, mi)
    assert not bool(go_flag(state, mi))
    if name == "capped_b2":  # the flag is false only because it == max_iters
        assert int(state.it) == mi and bool(state.active.any())
    before = _clone(state)
    state, steps = _while_node(step, state, mi)
    assert steps == 0
    _assert_states_equal(state, before)


def _jax_final(prefix, kind, params, t_state_entries):
    """JAX's run_traversal on the same bundle, distance and entries."""
    q = jnp.asarray(_queries(prefix).numpy())
    g = jax_load_graph(prefix)
    entry_ids, entry_dists = t_state_entries
    if kind == "exact":
        vecs = jnp.asarray(g.vectors)
        fn = jtrav.make_exact_distance_fn(q, vecs, None)
    else:
        pq = jax_load_pq(prefix)
        cb = jax_codebook(pq.pivots, pq.centroid, pq.chunk_offsets)
        fn = jtrav.make_pq_distance_fn(q, cb, jnp.asarray(pq.codes), impl="xla")
    return jtrav.run_traversal(
        jnp.asarray(g.adj), fn, g.medoid, Q, params.L, params.max_iters,
        params.visited_mode == "bloom", params.beam_width,
        entry_ids=None if entry_ids is None else jnp.asarray(entry_ids),
        entry_dists=None if entry_dists is None else jnp.asarray(entry_dists))


@pytest.mark.parametrize("name", ["exact_b1", "exact_bloom_b2", "exact_sampled_b2",
                                  "pq_b2"])
def test_while_node_matches_jax_run_traversal(request, name):
    """The WHILE node's loop against JAX's while_loop: identical final
    states on u8 exact walks (bloom cells: the first BF), the PQ bar on
    the scattered PQ walk."""
    prefix, kind, params = _case(request, name)
    step, state = _walk(prefix, kind, params)
    q = _queries(prefix)
    ix = (device_index_from_files(prefix, "cpu", "exactdistance", fused_frontier=False)
          if kind == "exact" else None)
    entries = (entry_points(ix, q, params) if params.entry_mode == "sampled"
               else (None, None))
    entries = tuple(None if e is None else e.numpy() for e in entries)
    got, _ = _while_node(step, state, params.max_iters)
    j = _jax_final(prefix, kind, params, entries)
    if kind == "exact":
        for name_, t, jv in (("wl_ids", got.wl_ids, j.wl_ids),
                             ("wl_dist", got.wl_dist, j.wl_dist),
                             ("visited_ids", got.visited_ids, j.visited_ids),
                             ("active", got.active, j.active)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(jv), err_msg=name_)
        assert (int(got.it), int(got.n_expanded), int(got.n_dist_comps)) == (
            int(j.it), int(j.n_expanded), int(j.n_dist_comps))
        if got.bloom is not None:
            np.testing.assert_array_equal(got.bloom[:, :BF_ENTRIES].numpy(),
                                          np.asarray(j.bloom))
    else:
        assert abs(int(got.it) - int(j.it)) <= 1
        same = (got.wl_ids.numpy() == np.asarray(j.wl_ids)).all(axis=1)
        assert same.mean() >= 0.99, same.mean()


# -- base ----------------------------------------------------------------------

def _old_step_core(state, nbrs, parent_vecs, queries_f32, raw, beam, it):
    """The port's base step before its counter moved to the device (host
    `it`, host slicing), kept as an oracle."""
    pd = ((parent_vecs.float() - queries_f32[:, None, :]) ** 2).sum(-1)
    l2d = state.l2_dists
    l2d[:, (it - 1) * beam : it * beam] = pd.masked_fill(
        ~(state.parent_valid & state.active[:, None]), float("inf"))
    cand_valid = state.parent_valid.repeat_interleave(nbrs.shape[1] // beam, dim=1)
    new = exact_new_mask(nbrs, state.wl_ids, state.visited_ids)
    new = new & cand_valid & state.active[:, None]
    if beam > 1:
        new = new & first_occurrence_mask_blocks(nbrs, beam)
    dist = raw.masked_fill(~new, float("inf"))
    wl_dist, wl_ids, wl_vis = merge_worklist(state.wl_dist, state.wl_ids, state.wl_vis,
                                             dist, nbrs)
    parents, parent_valid, active, wl_vis = select_parents_beam(wl_dist, wl_ids, wl_vis,
                                                                beam)
    visited = state.visited_ids
    visited[:, it * beam : (it + 1) * beam] = parents.masked_fill(~parent_valid,
                                                                  INVALID_ID)
    return (state._replace(wl_dist=wl_dist, wl_ids=wl_ids, wl_vis=wl_vis,
                           parent_valid=parent_valid, active=active),
            parents, active.any())


@pytest.mark.parametrize("beam", [1, 2])
def test_base_step_device_counter_matches_jax_and_the_old_step(tiny_uint8_index, beam):
    """Base's step with its counter on the device, over host-gathered
    neighbors and u8 parent vectors, against JAX's _base_step (tables of
    integers, so PQ sums are exact in any order) and the old host-counter
    step, for every field, five steps."""
    prefix = tiny_uint8_index["prefix"]
    g = jax_load_graph(prefix)
    pq = load_pq(prefix)
    rng = np.random.default_rng(11)
    n, r = g.adj.shape
    L, mi = 16, 12
    q = _queries(prefix)
    m = pq.codes.shape[1]
    tables = rng.integers(0, 50, (Q, m, 256)).astype(np.float32)
    codes_t = torch.as_tensor(pq.codes)
    entries = np.full((Q, 1), g.medoid, np.int32)
    t_state = tbase._init_state(Q, L, mi, torch.as_tensor(entries), beam)
    o_state = tbase._init_state(Q, L, mi, torch.as_tensor(entries), beam)
    j_state = jbase._init_state(Q, L, mi, jnp.asarray(entries), False, beam)
    assert t_state.it.dtype == torch.int32 and t_state.it.shape == ()
    for it in range(1, 6):
        nbrs = rng.integers(0, n, (Q, beam * r)).astype(np.int32)
        vecs = g.vectors[rng.integers(0, n, (Q, beam))]  # [Q, beam, D] u8
        nb, vt = torch.as_tensor(nbrs), torch.as_tensor(vecs)
        raw = pq_lookup(torch.as_tensor(tables), codes_t[nb.long()])
        t_state, t_par, t_any = tbase._step_core(t_state, nb, vt, q, raw, beam)
        o_state, o_par, o_any = _old_step_core(o_state, nb, vt, q, raw.clone(), beam, it)
        j_state, j_par, j_any = jbase._base_step(
            j_state, jnp.asarray(nbrs), jnp.asarray(vecs), jnp.asarray(q.numpy()),
            jnp.asarray(tables), jnp.asarray(pq.codes), False, "xla", beam)
        assert int(t_state.it) == it + 1 == int(j_state.it)
        for name in ("wl_dist", "wl_ids", "wl_vis", "parent_valid", "visited_ids",
                     "l2_dists", "active"):
            t, o = getattr(t_state, name), getattr(o_state, name)
            assert torch.equal(t, o), name
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(j_state, name)),
                                          err_msg=name)
        assert torch.equal(t_par, o_par) and bool(t_any) == bool(o_any) == bool(j_any)
        np.testing.assert_array_equal(t_par.numpy(), np.asarray(j_par))


# -- around the loop -------------------------------------------------------------

def test_search_stats_read_once():
    """The counters stay on the device until read; a caller's own copy of
    them (read with its results) stands in for the read."""
    st = SearchStats(torch.tensor(7, dtype=torch.int32), torch.tensor(30),
                     torch.tensor(400))
    assert st.device_values().tolist() == [7, 30, 400]
    assert (st.iters, st.n_expanded, st.n_dist_comps) == (7, 30, 400)
    other = SearchStats(torch.tensor(3), torch.tensor(1), torch.tensor(2)).sync([9, 8, 7])
    assert (other.iters, other.n_expanded, other.n_dist_comps) == (9, 8, 7)
    assert SearchStats(4, 5, 6).iters == 4


def test_launch_counters_are_read_into_the_wrappers(monkeypatch):
    """Each wrapper's kernel gets its own slot of the card's counter; the
    counts the kernels add there reach `<wrapper>.launches` when read, and
    reading or resetting zeroes the card's counter. (A CPU tensor stands in
    for the card's counter.)"""
    counters = torch.zeros(len(_build.COUNTED), dtype=torch.int64)
    monkeypatch.setitem(_build._COUNTERS, 0, counters)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(pk.frontier_lookup, "launches", 0)
    monkeypatch.setattr(pk.pq_lookup, "launches", 2)
    cuda0 = torch.device("cuda", 0)
    base = counters.data_ptr()
    assert _build.launch_counter(pk.pq_lookup, cuda0) == base
    assert _build.launch_counter(pk.frontier_lookup, cuda0) == base + 8
    assert {_build.launch_counter(k, cuda0) for k in pk.KERNELS} == {
        base + 8 * i for i in range(len(pk.KERNELS))}
    counters[0], counters[1] = 5, 7  # what the kernels would add on the card
    counts = pk.launch_counts()
    assert (counts["pq_lookup"], counts["frontier_lookup"]) == (7, 7)
    assert counters.tolist() == [0] * len(_build.COUNTED)
    counters[1] = 3
    pk.reset_launch_counts()
    assert pk.frontier_lookup.launches == 0 and counters.tolist()[1] == 0


def _entry_point_params(name):
    """The parameter names of csrc/<name>.cu's `<name>_launch`."""
    src = (_build.SRC_DIR / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")], src


@pytest.mark.parametrize("name", [n for n in _build.SIGNATURES if n != "graph_loop"])
def test_each_kernel_takes_its_launch_counter(name):
    """Every kernel's entry point takes as many arguments as its ctypes
    signature, the launch counter then the stream last, and its kernel
    counts the launch first thing."""
    params, src = _entry_point_params(name)
    assert len(params) == len(_build.SIGNATURES[name])
    assert params[-2:] == ["launches", "stream"]
    assert '#include "launch_count.cuh"' in src
    assert re.search(r"unsigned long long\* __restrict__ launches\) \{\n"
                     r"  count_launch\(launches\);", src)


class _FakeLoop:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_graph_cache_holds_one_key_and_the_facade_drops_it(tiny_index):
    """One key at a time; BANGSearch drops the graphs on new parameters and
    at unload, keeps them on the same ones. CPU tensors never capture."""
    class Owner:
        pass

    owner, a, b = Owner(), _FakeLoop(), _FakeLoop()
    cache = compiled.graph_cache(owner)
    assert cache.get("k1", 0) is None
    cache.put(0, a)
    assert cache.get("k1", 0) is a and not a.closed
    assert cache.get("k2", 0) is None and a.closed
    cache.put(1, b)
    compiled.drop_graphs(owner)
    assert b.closed and cache.loops == {}

    s = BANGSearch("inmemory", device="cpu")
    s.bang_load(tiny_index["prefix"])
    s.bang_set_searchparams(10, 24)
    s.bang_alloc(8)
    assert compiled.graph_cache(s._index).loops == {}  # the CPU runs the eager loop
    loop = _FakeLoop()
    compiled.graph_cache(s._index).get("key", 0)
    compiled.graph_cache(s._index).put(0, loop)
    s.bang_set_searchparams(10, 24)
    assert not loop.closed
    s.bang_set_searchparams(10, 32)
    assert loop.closed
    loop = _FakeLoop()
    compiled.graph_cache(s._index).get("key", 0)
    compiled.graph_cache(s._index).put(0, loop)
    s.bang_unload()
    assert loop.closed


def test_free_device_index_drops_its_graphs(tiny_index):
    """free_device_index frees the index's captured loops (their graphs hold
    its tensors) before it drops the tensors."""
    from bang_tpu_torch.models.index import free_device_index

    index = device_index_from_files(tiny_index["prefix"], "cpu")
    loop = _FakeLoop()
    compiled.graph_cache(index).get("key", 0)
    compiled.graph_cache(index).put(0, loop)
    free_device_index(index)
    assert loop.closed and compiled.graph_cache(index).loops == {}
    assert index.vectors is None


def test_readback_and_queries_on_the_cpu():
    ids, d = torch.arange(6).reshape(2, 3), torch.ones(2, 3)
    assert all(x is y for x, y in zip(compiled.readback(ids, d), (ids, d)))
    q = compiled.device_queries(np.ones((2, 4), np.uint8), torch.empty(0))
    assert q.dtype == torch.float32 and q.shape == (2, 4)


def test_base_search_on_the_cpu_keeps_its_sub_batches(tiny_uint8_index):
    """Base keeps one key's sub-batches from call to call (the card captures
    their graphs there) and rebuilds them for a new key; its answers stay
    the same."""
    prefix = tiny_uint8_index["prefix"]
    searcher = tbase.BaseVariantSearcher(prefix, n_pipeline_batches=3, device="cpu")
    queries = load_bin_auto(prefix + "_query.bin", np.float32)[:30]
    params = SearchParams(L=24, k=10, beam_width=2)
    a = searcher.search(queries, params)
    subs = list(searcher._subs)
    b = searcher.search(queries, params)
    assert [x is y for x, y in zip(subs, searcher._subs)] == [True] * 3
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    searcher.search(queries, SearchParams(L=32, k=10, beam_width=2))
    assert searcher._subs[0] is not subs[0]
    assert all(sb.graphs is None for sb in searcher._subs)  # no capture on the CPU
