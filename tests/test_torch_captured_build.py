"""The captured Vamana insert, the captured streaming index and the
chunk-sharded base's capture decision, on the CPU, against the eager loop
and the JAX package.

On the card the insert is one CUDA graph: the prologue (the batch's
vectors, the exact distance function, the traversal's start from the
medoid) over static input buffers, the traversal step under a WHILE node,
and the epilogue (prune, scatter, reverse edges, overflow re-prune) that
writes the adjacency and the degrees in place (formats/vamana.py,
models/compiled.py). Here that graph is modelled on CPU tensors in the
same order (`CpuLoop`: the inputs copied into static buffers, the
prologue, the in-place step while the flag holds, the epilogue), and
`compiled.captures` is patched so that the build and the streaming index
take the card's path through it. On u8 data every distance is an integer
below 2^24, exact in f32 in any order, so the adjacency, the degrees and
the dropped counts are identical to the eager insert's and to JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bang_tpu.formats.vamana import _insert_batch as jax_insert_batch
from bang_tpu.formats.vamana import build_vamana_graph as jax_build_vamana
from bang_tpu.models.streaming import StreamingIndex as JaxStreaming
from bang_tpu.utils.config import SearchParams
from bang_tpu_torch.formats import vamana
from bang_tpu_torch.formats.synthetic import make_clustered_data
from bang_tpu_torch.models import compiled
from bang_tpu_torch.models.streaming import StreamingIndex
from bang_tpu_torch.models.traversal import (
    SearchStats,
    go_flag,
    make_exact_distance_fn,
    start_traversal,
    step_,
    traverse,
)
from bang_tpu_torch.parallel import base_tp
from bang_tpu_torch.parallel.sharded import make_mesh

N, DIM = 1200, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: a pool per worker oversubscribes the cores under
    a parallel test run and makes these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pts():
    return make_clustered_data(N, DIM, n_clusters=12, dtype=np.uint8, seed=6)


class _Reads:
    """Counts host reads of tensors (bool, int, item, tolist) while on."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("__bool__", "__int__", "item", "tolist"):
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._counted(orig))

    def _counted(self, orig):
        def read(t, *args):
            self.n += 1
            return orig(t, *args)
        return read


def _while_node(start, finish, inputs, max_iters):
    """The captured loop's graph on the CPU: the prologue over the static
    inputs, the flag, the in-place step while the flag holds (the card's
    WHILE node reads the flag on the device; here bool() reads it), the
    epilogue. Returns (finish's tensors, final state, steps)."""
    step, state, ctx = start(*inputs)
    go = go_flag(state, max_iters)
    steps = 0
    while bool(go):
        step_(step, state)
        go_flag(state, max_iters, out=go)
        steps += 1
    return finish(ctx, state), state, steps


class CpuLoop:
    """models/compiled.CapturedLoop modelled on the CPU: static input
    buffers of the capturing call's dtypes and shapes, then at each launch
    the inputs copied in and the graph run on them (`_while_node`)."""

    made: list = []

    def __init__(self, start, finish, inputs, max_iters):
        self.start, self.finish, self.max_iters = start, finish, max_iters
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        self.capture_s, self.graph_bytes, self.part_bytes = 0.0, 0, {}
        self.launches, self.closed = 0, False
        CpuLoop.made.append(self)

    def launch(self, *inputs):
        for buf, x in zip(self.inputs, inputs, strict=True):
            buf.copy_(torch.as_tensor(x))
        out, s, _ = _while_node(self.start, self.finish, self.inputs, self.max_iters)
        self.launches += 1
        return [t.clone() for t in out], SearchStats(s.it, s.n_expanded, s.n_dist_comps)

    def close(self):
        self.closed = True


@pytest.fixture
def captured_on_cpu(monkeypatch):
    """The card's path on CPU tensors: captures() true, CpuLoop for
    CapturedLoop; yields the loops made."""
    monkeypatch.setattr(compiled, "captures", lambda device: True)
    monkeypatch.setattr(compiled, "CapturedLoop", CpuLoop)
    monkeypatch.setattr(CpuLoop, "made", [])
    yield CpuLoop.made


# -- the insert ------------------------------------------------------------------

R, B = 8, 128
KW = dict(r=R, alpha=1.2, l=16, max_iters=32, k_overflow=256, max_in=R)


def _start_graph(v):
    n = v.shape[0]
    rng = np.random.default_rng(9)
    adj0 = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, R)).copy()
    adj0[:, : R // 2] = rng.integers(0, n, (n, R // 2))
    deg0 = np.full(n, R // 2, np.int32)
    p_ids = rng.choice(n, B, replace=False).astype(np.int32)
    extra = rng.integers(0, n, (B, 6)).astype(np.int32)
    return adj0, deg0, p_ids, extra


def _port_graph(adj0, deg0):
    n = adj0.shape[0]
    adj = torch.empty((n + 1, R), dtype=torch.int32)
    adj[:n] = torch.from_numpy(adj0)
    adj[n] = n
    deg = torch.zeros(n + 1, dtype=torch.int32)
    deg[:n] = torch.from_numpy(deg0)
    return adj, deg


@pytest.mark.parametrize("extra", [False, True])
def test_insert_graph_equals_eager_and_jax(pts, extra, monkeypatch):
    """The insert's graph (prologue, WHILE{step}, epilogue) over static
    buffers, the medoid a device scalar: adjacency, degrees and dropped
    count identical to the eager _insert_batch and to JAX's, bit for bit;
    the flag is the one tensor read, once after the prologue and once a
    step, so the prologue and the epilogue read nothing back."""
    v = pts[:1000]
    n = v.shape[0]
    adj0, deg0, p_ids, ec = _start_graph(v)
    ec = ec if extra else None
    norms = (v.astype(np.float32) ** 2).sum(-1)
    j_adj, j_deg, j_drop = jax_insert_batch(
        jnp.asarray(adj0), jnp.asarray(deg0), jnp.asarray(v), jnp.asarray(norms),
        jnp.asarray(p_ids), jnp.int32(7), extra_cand=None if ec is None else jnp.asarray(ec),
        **KW)
    vt, nt = torch.from_numpy(v), torch.from_numpy(norms)

    e_adj, e_deg = _port_graph(adj0, deg0)
    e_drop = vamana._insert_batch(e_adj, e_deg, vt, nt, torch.from_numpy(p_ids), 7,
                                  extra_cand=None if ec is None else torch.from_numpy(ec),
                                  **KW)

    g_adj, g_deg = _port_graph(adj0, deg0)
    start, finish = vamana._insert_parts(g_adj, g_deg, vt, nt, **KW)
    inputs = (torch.from_numpy(p_ids), torch.tensor(7, dtype=torch.int32))
    if ec is not None:
        inputs += (torch.from_numpy(ec),)
    static = tuple(torch.empty_like(t) for t in inputs)
    for buf, t in zip(static, inputs):
        buf.copy_(t)
    reads = _Reads(monkeypatch)
    (g_drop,), final, steps = _while_node(start, finish, static, KW["max_iters"])
    assert reads.n == steps + 1
    monkeypatch.undo()
    assert steps == int(final.it) - 1 >= 1
    for t_adj, t_deg, t_drop in ((e_adj, e_deg, e_drop), (g_adj, g_deg, g_drop)):
        np.testing.assert_array_equal(t_adj[:n].numpy(), np.asarray(j_adj))
        np.testing.assert_array_equal(t_deg[:n].numpy(), np.asarray(j_deg))
        assert int(t_drop) == int(j_drop)


def test_medoid_tensor_walks_as_the_int_medoid(pts):
    """start_traversal with the medoid held in an int32 scalar tensor (read
    as data, no host read) gives the state the int medoid gives, and the
    same walk."""
    v = torch.from_numpy(pts)
    adj0, _, p_ids, _ = _start_graph(pts)
    adj = torch.from_numpy(adj0)
    q = v[torch.from_numpy(p_ids).long()].float()
    walks = [start_traversal(adj, make_exact_distance_fn(q, v), m, B, 16, 32, 2, "cpu")
             for m in (431, torch.tensor(431, dtype=torch.int32))]
    for a, b in zip(walks[0][1], walks[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    finals = [traverse(step, state, 32) for step, state in walks]
    for a, b in zip(*finals):
        if a is not None:
            assert torch.equal(a, b)


def test_build_through_static_inputs_equals_jax(pts, captured_on_cpu):
    """build_vamana_graph on the card's path (each pass's first batch eager,
    then one loop per pass launched for every later batch, its graph
    dropped at the next pass and at the end) builds JAX's graph, and the
    eager build's."""
    kw = dict(l_build=24, batch=256, seed=1, verbose=False)
    j_adj, j_deg, j_med = jax_build_vamana(pts, r=12, **kw)
    t_adj, t_deg, t_med = vamana.build_vamana_graph(pts, 12, "cpu", **kw)
    assert t_med == j_med
    np.testing.assert_array_equal(t_adj, j_adj)
    np.testing.assert_array_equal(t_deg, j_deg)
    n_batches = -(-N // 256)
    assert [loop.launches for loop in captured_on_cpu] == [n_batches - 1] * 2
    assert all(loop.closed for loop in captured_on_cpu)
    assert all(loop.inputs[0].dtype == torch.int32 and loop.inputs[1].shape == ()
               for loop in captured_on_cpu)
    e_adj, e_deg, _ = vamana.build_vamana_graph_eager(pts, 12, "cpu", **kw)
    np.testing.assert_array_equal(e_adj, j_adj)
    np.testing.assert_array_equal(e_deg, j_deg)
    assert len(captured_on_cpu) == 2  # the eager build made no loop


def test_device_input_keeps_ids_past_2_24():
    """A static input keeps its dtype: an int32 id past 2^24 is not cast to
    float32 on the way in."""
    ids = np.array([2**24 + 1, 2**30 + 3], np.int32)
    t = compiled.device_input(ids, torch.empty(0))
    assert t.dtype == torch.int32 and t.tolist() == ids.tolist()


# -- the streaming index -----------------------------------------------------------

PARAMS = SearchParams(L=24, k=10, extra_iters=24)


def _assert_same(jix, tix, queries, what):
    cap = jix.capacity
    np.testing.assert_array_equal(tix.adj[:cap].numpy(), np.asarray(jix.adj), what)
    np.testing.assert_array_equal(tix.degrees[:cap].numpy(), np.asarray(jix.degrees), what)
    np.testing.assert_array_equal(tix.deleted[:cap].numpy(), np.asarray(jix.deleted), what)
    assert (tix.free, tix.hwm, tix.medoid) == (jix.free, jix.hwm, jix.medoid), what
    j_ids, j_d = jix.search(queries, PARAMS)
    t_ids, t_d = tix.search(queries, PARAMS)
    np.testing.assert_array_equal(t_ids, j_ids, what)
    np.testing.assert_array_equal(t_d, j_d, what)


def test_streaming_captured_identical_to_jax(pts, captured_on_cpu):
    """The streaming index on the card's path (captured inserts and
    searches over static inputs) against JAX's StreamingIndex through
    inserts, a delete that takes the medoid, a consolidate that re-elects
    it, and a re-insert into the freed slots: identical states and
    answers, the re-elected medoid fed to the same captured search."""
    rng = np.random.default_rng(1)
    queries = np.clip(pts[rng.integers(0, N, 40)].astype(np.float32)
                      + np.rint(rng.normal(0, 2.0, (40, DIM))), 0, 255).astype(np.float32)
    kw = dict(capacity=N, dim=DIM, r=12, l_build=16, dtype=np.uint8)
    jix, tix = JaxStreaming(**kw), StreamingIndex(device="cpu", **kw)
    for s in range(0, 1000, 250):
        np.testing.assert_array_equal(tix.insert(pts[s : s + 250]),
                                      jix.insert(pts[s : s + 250]))
    _assert_same(jix, tix, queries, "insert")
    _assert_same(jix, tix, queries, "insert, second search")
    search_loop = tix.graphs["search"].loops[0]
    victims = np.unique(np.concatenate([[jix.medoid],
                                        rng.choice(1000, 120, replace=False)])).astype(np.int32)
    medoid = jix.medoid
    jix.delete(victims)
    tix.delete(victims)
    _assert_same(jix, tix, queries, "delete")
    assert tix.consolidate(batch=256) == jix.consolidate(batch=256)
    assert tix.medoid != medoid and tix.medoid == jix.medoid
    _assert_same(jix, tix, queries, "consolidate")
    assert tix.graphs["search"].loops[0] is search_loop  # the new medoid is data
    back = victims[:100]
    np.testing.assert_array_equal(tix.insert(pts[back]), jix.insert(pts[back]))
    _assert_same(jix, tix, queries, "re-insert")
    assert search_loop.launches >= 4
    assert sum(loop.launches for loop in captured_on_cpu if loop is not search_loop) >= 1


def test_streaming_caches_capture_at_the_second_call(pts, captured_on_cpu):
    """One graph cache per kind: a key's first call runs the eager loop,
    its second captures and launches, later ones launch; searches between
    inserts keep the insert's loop, and a new insert shape drops it."""
    ix = StreamingIndex(capacity=N, dim=DIM, r=12, l_build=16, dtype=np.uint8,
                        device="cpu")
    q = pts[:16].astype(np.float32)
    ins, srch = ix.graphs["insert"], ix.graphs["search"]
    ix.insert(pts[:64])  # chunk 64: the key's first call
    assert ins.loops == {} and ins.calls == 1
    ix.insert(pts[64:128])  # chunk 64 again: captured
    insert_loop = ins.loops[0]
    assert insert_loop.launches == 1
    ix.search(q, PARAMS)
    assert srch.loops == {} and srch.calls == 1
    ix.insert(pts[128:192])  # 64 points (a 128 chunk holds them all): launched
    assert ins.loops[0] is insert_loop and insert_loop.launches == 2
    ix.search(q, PARAMS)
    ix.search(q, PARAMS)
    assert srch.loops[0].launches == 2 and ins.loops[0] is insert_loop
    assert len(captured_on_cpu) == 2
    ix.insert(pts[192:292])  # a new shape: the old loop goes
    assert insert_loop.closed and ins.loops == {}
    ix.drop_graphs()
    assert srch.loops == {} and all(loop.closed for loop in captured_on_cpu)


# -- the chunk-sharded base --------------------------------------------------------


def test_sharded_base_captures_on_one_device(tiny_uint8_index):
    """ShardedBaseSearcher captures when every device of its row is
    mesh.home (the shards take turns on one card), and keeps the eager
    step for a row of distinct devices."""
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert base_tp.one_device([cuda[0]] * 4, cuda[0])
    assert not base_tp.one_device(cuda, cuda[0])
    assert not base_tp.one_device([torch.device("cpu"), cuda[0]], torch.device("cpu"))
    cpu = torch.device("cpu")
    tp = base_tp.ShardedBaseSearcher(tiny_uint8_index["prefix"],
                                     make_mesh(1, 4, [cpu] * 4), mmap=False)
    assert tp.captured
