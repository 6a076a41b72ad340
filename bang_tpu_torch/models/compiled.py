"""The captured search: `jax.jit` of a search and its `lax.while_loop`, as
one CUDA graph a call.

Ports what JAX compiles the HBM searches into (bang_tpu/models/
traversal.py:248, the jitted searches of models/inmemory.py and
models/exactdistance.py): one device program whose loop condition,
`(it < max_iters) & active.any()`, the device evaluates, so the host waits
only for the result. A search here has three parts, each captured by
PyTorch into a CUDA graph (`torch.cuda.CUDAGraph(keep_graph=True)`) on one
private memory pool:

  prologue  the call's start (`start(queries)`: PQ tables and their
            packing, entries, traversal.init_state) over a static query
            buffer, then the first `go` flag (traversal.go_flag);
  step      one iteration written into the state's own buffers
            (traversal.step_), then the next `go`;
  epilogue  `finish(ctx, state)`: the re-rank or the worklist's head, and
            the three counters as one [3] tensor.

`csrc/graph_loop.cu` joins them into prologue -> WHILE{step} -> epilogue,
a WHILE conditional node whose handle a one-thread kernel sets from `go`
after the prologue and after each step: the node runs the step only while
`go` holds, so the step carries no gate of its own, and a batch that has
finished runs no step. One graph launch runs a whole search; the step's
kernels (K1, K2 or K3, the visited set, the merge, the parent top-k) run
from inside it, and the state stays in its buffers as JAX's donated
while_loop carry does.

Design. The card's torch 2.11 does not bind conditional IF nodes
(`CUDAGraph.get_currently_capturing_graph` and `begin_capture_to_if_node`
are missing, as found on one H100), so a captured block of gated steps that
the host replays and polls is not available. The WHILE node is the
build's own (ctypes, built like the kernels by ops/_build.py): it needs no
block size, and the host neither polls nor enqueues more than one launch a
call. No runtime switch picks between designs.

A call copies its queries into the static buffer, launches the graph and
clones the outputs into fresh tensors, all enqueued on the current stream
with no host wait: calls issued back to back each get their own answer
(`bench._measure_point`'s pipelined calls overlap their host work with the
card's). The one blocking wait is the caller's readback (`readback`).

The first call of a key runs the eager loop (traversal.traverse, the plain
version), which builds the kernels and sets up cuBLAS and the allocator
outside a capture, then captures; later calls of that key launch the
graph. A capture or launch failure raises: there is no return to the
eager loop on CUDA tensors. The CPU runs the eager loop because its
tensors are on the CPU.

Launch counts. A launch from a graph runs no Python, so each kernel counts
its own launches on the card (ops/_build.launch_counter, whose counters
`capture` makes before it captures): a replay's launches count as the
eager loop's do, read by ops/pq_kernels.launch_counts.

Memory. The pool keeps the largest temporaries of the prologue, the step
and the epilogue reserved between calls, where the eager loop hands its
temporaries back to the allocator's common cache after each call;
`part_bytes` records what each part's capture added to it.

Graph cache (`graph_cache(owner)`): on the DeviceIndex, the ShardedIndex or
the BaseVariantSearcher, keyed by the search (variant, layout, the query
shape, SearchParams: L, beam, max_iters, visited_mode, entry_mode, k,
rerank, ...), one captured loop per walk slot. It holds one key at a time,
so an L sweep does not pile up pools; `drop_graphs(owner)` frees them
(`BANGSearch.bang_set_searchparams` with new parameters, `bang_unload`,
`models/index.free_device_index`).
"""

from __future__ import annotations

import ctypes
import time

import torch

from bang_tpu_torch.models.traversal import SearchStats, go_flag, step_, traverse
from bang_tpu_torch.ops import _build


class GraphCache:
    """The captured loops of one search key, by walk slot."""

    def __init__(self):
        self.key = None
        self.loops: dict = {}

    def get(self, key, slot):
        """The loop of `slot` under `key`, or None; a new key drops every
        loop of the old one first."""
        if key != self.key:
            self.clear()
            self.key = key
        return self.loops.get(slot)

    def put(self, slot, loop) -> None:
        self.loops[slot] = loop

    def clear(self) -> None:
        for loop in self.loops.values():
            loop.close()
        self.loops, self.key = {}, None


def graph_cache(owner) -> GraphCache:
    """`owner`'s graph cache, made at first use."""
    cache = owner.__dict__.get("_graph_cache")
    if cache is None:
        cache = owner.__dict__["_graph_cache"] = GraphCache()
    return cache


def drop_graphs(owner) -> None:
    """Free `owner`'s captured loops and their memory pools."""
    cache = owner.__dict__.get("_graph_cache")
    if cache is not None:
        cache.clear()


def capture(graph, fn, device, pool=None, stream=None):
    """fn() captured into `graph` on the CUDA `device`; returns fn's result.
    The kernels' launch counters are made first, outside the capture."""
    _build.launch_counters(device)
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        return fn()


def device_queries(queries, like: torch.Tensor) -> torch.Tensor:
    """`queries` (numpy or a tensor) as float32 on `like`'s device, with no
    host wait: host data goes through pinned memory."""
    t = torch.as_tensor(queries)
    if t.device != like.device:
        t = t.pin_memory().to(like.device, non_blocking=True)
    return t.float()


def readback(*tensors) -> list:
    """The tensors on the host after one blocking wait: each is copied
    into pinned memory without blocking, then one event is waited on. CPU
    tensors come back as they are."""
    if not tensors[0].is_cuda:
        return list(tensors)
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for out, t in zip(outs, tensors):
        out.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return outs


def run_eager(start, finish, queries, max_iters: int):
    """The plain version of a captured loop: start, traversal.traverse,
    finish, eagerly. Returns (finish's tensors, SearchStats)."""
    step, state, ctx = start(queries)
    final = traverse(step, state, max_iters)
    return finish(ctx, final), SearchStats(final.it, final.n_expanded,
                                           final.n_dist_comps)


class CapturedLoop:
    """One search of a fixed shape as one CUDA graph on one device.

    start(queries) -> (step, state, ctx) is the search's prologue over a
    [Q, D] float32 query tensor (`queries` sizes the static buffer);
    finish(ctx, final_state) -> tuple of tensors its epilogue. Call it with
    a call's queries: (finish's tensors, fresh, and SearchStats). Records
    `capture_s`, `graph_bytes` (the memory its pool took) and `part_bytes`
    (what the capture of each part added to it)."""

    def __init__(self, start, finish, queries: torch.Tensor, max_iters: int):
        dev = queries.device
        self._lib = _build.load_library("graph_loop")
        self._exec = ctypes.c_void_p()
        self._graph = ctypes.c_void_p()
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as each capture does: the pool's bytes show
        reserved = torch.cuda.memory_reserved(dev)
        self.queries = torch.empty_like(queries)
        graphs = [torch.cuda.CUDAGraph(keep_graph=True) for _ in range(3)]
        pool = torch.cuda.graph_pool_handle()

        def prologue():
            step, state, ctx = start(self.queries)
            return step, state, ctx, go_flag(state, max_iters)

        def body():
            step_(self.step, self.state)
            go_flag(self.state, max_iters, out=self.go)

        def epilogue():
            s = self.state
            stats = torch.stack([s.it.long(), s.n_expanded, s.n_dist_comps])
            return (*finish(self.ctx, s), stats)

        self.part_bytes = {}

        def part(name, graph, fn):
            torch.cuda.empty_cache()  # as the capture does on entry
            before = torch.cuda.memory_reserved(dev)
            out = capture(graph, fn, dev, pool)
            self.part_bytes[name] = torch.cuda.memory_reserved(dev) - before
            return out

        self.step, self.state, self.ctx, self.go = part("prologue", graphs[0], prologue)
        part("step", graphs[1], body)
        self.out = part("epilogue", graphs[2], epilogue)
        self._graphs = graphs
        err = self._lib.graph_loop_build(
            *(g.raw_cuda_graph() for g in graphs), self.go.data_ptr(),
            ctypes.byref(self._exec), ctypes.byref(self._graph))
        _build.check_launch("graph_loop", err)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved

    def launch(self, queries):
        """Enqueue one search of `queries` on the current stream; returns
        (finish's tensors, cloned, and SearchStats), without a host
        wait."""
        self.queries.copy_(device_queries(queries, self.queries))
        with torch.cuda.device(self.queries.device):
            err = self._lib.graph_loop_launch(
                self._exec, torch.cuda.current_stream().cuda_stream)
        _build.check_launch("graph_loop", err)
        *out, stats = (t.clone() for t in self.out)
        return out, SearchStats(stats[0], stats[1], stats[2])

    def close(self) -> None:
        """Free the executable graph, then the captured graphs and their
        pool."""
        if self._exec or self._graph:
            err = self._lib.graph_loop_destroy(self._exec, self._graph)
            self._exec = self._graph = ctypes.c_void_p()
            _build.check_launch("graph_loop", err)
        self._graphs = self.step = self.state = self.ctx = self.out = None
        self.go = self.queries = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — the interpreter may be shutting down
            pass


def search(owner, key, queries, device, max_iters: int, start, finish):
    """One search on the CUDA `device` through `owner`'s graph cache: the
    captured loop of `key`, or, at the key's first call, the eager loop,
    then the capture. Returns (finish's tensors, SearchStats)."""
    cache = graph_cache(owner)
    loop = cache.get(key, 0)
    if loop is not None:
        return loop.launch(queries)
    q = device_queries(queries, torch.empty(0, device=device))
    out = run_eager(start, finish, q, max_iters)
    cache.put(0, CapturedLoop(start, finish, q, max_iters))
    return out
