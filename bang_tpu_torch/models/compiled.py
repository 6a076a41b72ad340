"""The captured search: `jax.jit` of a search and its `lax.while_loop`, as
one CUDA graph a call.

Ports what JAX compiles the HBM searches into (bang_tpu/models/
traversal.py:248, the jitted searches of models/inmemory.py and
models/exactdistance.py): one device program whose loop condition,
`(it < max_iters) & active.any()`, the device evaluates, so the host waits
only for the result. A search here has three parts, each captured by
PyTorch into a CUDA graph (`torch.cuda.CUDAGraph(keep_graph=True)`) on one
private memory pool:

  prologue  the call's start (`start(*inputs)`: for a search the PQ
            tables and their packing, entries, traversal.init_state) over
            static input buffers, then the first `go` flag
            (traversal.go_flag);
  step      one iteration written into the state's own buffers
            (traversal.step_), then the next `go`;
  epilogue  `finish(ctx, state)`: the re-rank or the worklist's head, and
            the three counters as one [3] tensor.

Under ENABLE_GPU_STATS (`stats=True`) the three parts also stamp a stage
clock (ops/stage_clock: one-thread kernels that read the card's
%globaltimer between the stages), whose buckets the epilogue appends to
the counters: the stages' device times come back in the call's one
readback. Without it no stamp is captured.

The static inputs are a tuple of device buffers, each of the dtype and
shape of the call that captured it: a search's [Q, D] float32 queries; an
insert's [B] int32 point ids, its medoid as an int32 device scalar and
its [B, P] int32 extra candidates (formats/vamana.py); the streaming
search's queries and medoid (models/streaming.py). A buffer is never cast
to float32 on the way in (an int32 id past 2^24 would not survive it).

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

A call copies its inputs into the static buffers, launches the graph and
clones the outputs into fresh tensors, all enqueued on the current stream
with no host wait: calls issued back to back each get their own answer
(`bench._measure_point`'s pipelined calls overlap their host work with the
card's). Host arrays go through pinned memory (`device_input`): each call
pins a fresh block of PyTorch's caching host allocator, which records an
event on the copy and hands the block out again only after that event, so
the next call's host write cannot race a copy still in flight. The one
blocking wait is the caller's readback (`readback`).

The first call of a key runs the eager loop (traversal.traverse, the plain
version), which builds the kernels and sets up cuBLAS and the allocator
outside a capture. A search (`search`) captures right after it; the
Vamana insert and the streaming index (`run`) capture at the key's second
call, so that a shape that comes once (the last short batch, the
streaming insert's doubling ramp) is never captured. Later calls of the
key launch the graph. A capture or launch failure raises: there is no
return to the eager loop on CUDA tensors. The CPU runs the eager loop
because its tensors are on the CPU (`captures`).

Launch counts. A launch from a graph runs no Python, so each kernel counts
its own launches on the card (ops/_build.launch_counter, whose counters
`capture` makes before it captures): a replay's launches count as the
eager loop's do, read by ops/pq_kernels.launch_counts.

Memory. The pool keeps the largest temporaries of the prologue, the step
and the epilogue reserved between calls, where the eager loop hands its
temporaries back to the allocator's common cache after each call;
`part_bytes` records what each part's capture added to it.

Graph cache (`graph_cache(owner)`): on the DeviceIndex, the ShardedIndex or
the BaseVariantSearcher, keyed by the search (variant, the layout tensors
the index holds (models/index.layout_of), the query shape, SearchParams:
L, beam, max_iters, visited_mode, entry_mode, k, rerank, pq_impl, ...)
and the merge form BANG_MERGE_IMPL names at the call (ops/merge.
merge_impl), one captured loop per walk slot. It holds one key at a time,
so an L sweep does not pile up pools; `drop_graphs(owner)` frees them
(`BANGSearch.bang_set_searchparams` with new parameters, `bang_unload`,
`models/index.free_device_index`). A Vamana build keeps one GraphCache of
its own, cleared at each pass (alpha is part of the key) and before it
returns; a StreamingIndex keeps one per kind, insert and search, which a
churn alternates.
"""

from __future__ import annotations

import ctypes
import time

import torch

from bang_tpu_torch.models.traversal import SearchStats, go_flag, step_, traverse
from bang_tpu_torch.ops import _build
from bang_tpu_torch.ops.merge import merge_impl
from bang_tpu_torch.ops.stage_clock import NO_CLOCK, clock_for
from bang_tpu_torch.utils.timer import NO_TIMERS


class GraphCache:
    """The captured loops of one search key, by walk slot; `calls` counts
    the eager calls made under the key (`run`)."""

    def __init__(self):
        self.key = None
        self.loops: dict = {}
        self.calls = 0

    def get(self, key, slot):
        """The loop of `slot` under `key`, or None; a new key drops every
        loop of the old one first. The merge form the environment names
        now is part of every key: a loop captured with one form is never
        launched under the other."""
        key = (key, merge_impl())
        if key != self.key:
            self.clear()
            self.key = key
        return self.loops.get(slot)

    def put(self, slot, loop) -> None:
        self.loops[slot] = loop

    def clear(self) -> None:
        for loop in self.loops.values():
            loop.close()
        self.loops, self.key, self.calls = {}, None, 0


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


def captures(device) -> bool:
    """Whether work on `device` runs as captured graphs: on CUDA devices
    only; the CPU runs the eager loop."""
    return torch.device(device).type == "cuda"


def device_input(x, like: torch.Tensor) -> torch.Tensor:
    """`x` (numpy, a Python scalar or a tensor) on `like`'s device in its
    own dtype, with no host wait: host data goes through a pinned block of
    the caching host allocator, which is not handed out again before the
    copy from it has run."""
    t = torch.as_tensor(x)
    if t.device != like.device:
        if like.device.type == "cuda":
            t = t.pin_memory()
        t = t.to(like.device, non_blocking=True)
    return t


def device_queries(queries, like: torch.Tensor) -> torch.Tensor:
    """`queries` (numpy or a tensor) as float32 on `like`'s device, with no
    host wait (`device_input`)."""
    return device_input(queries, like).float()


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


def run_eager(start, finish, inputs: tuple, max_iters: int, clock=NO_CLOCK):
    """The plain version of a captured loop: start(*inputs),
    traversal.traverse, finish, eagerly. Returns (finish's tensors,
    SearchStats). The stage clock (ops/stage_clock: a StageClock under
    ENABLE_GPU_STATS, else NO_CLOCK) takes a captured loop's stamps:
    `start` first, `tables` after the prologue, the steps' own, `carry`
    and `rerank` around finish; the SearchStats carry its buckets and the
    loop's host reads."""
    clock.start()
    step, state, ctx = start(*inputs)
    clock.stamp("tables")
    final = traverse(step, state, max_iters, clock)
    clock.stamp("carry")
    out = finish(ctx, final)
    clock.stamp("rerank")
    return out, SearchStats(final.it, final.n_expanded, final.n_dist_comps,
                            stages=clock.stages(), host_reads=clock.reads)


class CapturedLoop:
    """One loop of a fixed shape (a search, an insert) as one CUDA graph on
    one device.

    start(*inputs) -> (step, state, ctx) is its prologue over the static
    input buffers (`inputs`, device tensors, size them: each buffer keeps
    its tensor's dtype and shape); finish(ctx, final_state) -> tuple of
    tensors its epilogue. `launch(*inputs)` runs it on a call's inputs.
    Records `capture_s`, `graph_bytes` (the memory its pool took) and
    `part_bytes` (what the capture of each part added to it).

    stats=True (ENABLE_GPU_STATS) captures a stage clock into the graph
    (ops/stage_clock; its buffer, `clock`, made before the capture): the
    prologue stamps `start` first and `tables` last, the step its five
    stamps (traversal.make_step), the epilogue `carry` first and `rerank`
    after finish, then appends the buckets to the three counters, so they
    come back in the call's one readback. stats=False stamps NO_CLOCK, so
    no stamp is captured."""

    def __init__(self, start, finish, inputs: tuple, max_iters: int,
                 stats: bool = False):
        dev = inputs[0].device
        self.clock = clock = clock_for(dev, stats)
        self._lib = _build.load_library("graph_loop")
        self._exec = ctypes.c_void_p()
        self._graph = ctypes.c_void_p()
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as each capture does: the pool's bytes show
        reserved = torch.cuda.memory_reserved(dev)
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        graphs = [torch.cuda.CUDAGraph(keep_graph=True) for _ in range(3)]
        pool = torch.cuda.graph_pool_handle()

        def prologue():
            clock.start()
            step, state, ctx = start(*self.inputs)
            go = go_flag(state, max_iters)
            clock.stamp("tables")
            return step, state, ctx, go

        def body():
            step_(self.step, self.state, clock)
            go_flag(self.state, max_iters, out=self.go)

        def epilogue():
            s = self.state
            stats = torch.stack([s.it.long(), s.n_expanded, s.n_dist_comps])
            clock.stamp("carry")
            out = finish(self.ctx, s)
            clock.stamp("rerank")
            return (*out, clock.append(stats))

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

    def launch(self, *inputs, timers=NO_TIMERS):
        """Enqueue one run on `inputs` (numpy or tensors, in the order of
        the static buffers, each copied into its buffer) on the current
        stream; returns (finish's tensors, cloned, and SearchStats),
        without a host wait. `timers` (utils/timer.StageTimers) takes the
        spans `copy_in` (the pinned staging and the copies' enqueue) and
        `launch` (the graph's launch and the outputs' clones)."""
        with timers.stage("copy_in"):
            for buf, x in zip(self.inputs, inputs, strict=True):
                buf.copy_(device_input(x, buf))
        with timers.stage("launch"):
            with torch.cuda.device(self.inputs[0].device):
                err = self._lib.graph_loop_launch(
                    self._exec, torch.cuda.current_stream().cuda_stream)
            _build.check_launch("graph_loop", err)
            *out, stats = (t.clone() for t in self.out)
        stages = stats[3:] if len(stats) > 3 else None  # the stage clock's buckets
        return out, SearchStats(stats[0], stats[1], stats[2], stages=stages)

    def close(self) -> None:
        """Free the executable graph, then the captured graphs and their
        pool."""
        if self._exec or self._graph:
            err = self._lib.graph_loop_destroy(self._exec, self._graph)
            self._exec = self._graph = ctypes.c_void_p()
            _build.check_launch("graph_loop", err)
        self._graphs = self.step = self.state = self.ctx = self.out = None
        self.go = self.inputs = self.clock = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — the interpreter may be shutting down
            pass


def search(owner, key, queries, device, max_iters: int, start, finish,
           stats: bool = False, timers=NO_TIMERS):
    """One search on the CUDA `device` through `owner`'s graph cache: the
    captured loop of `key`, or, at the key's first call, the eager loop,
    then the capture. stats=True (ENABLE_GPU_STATS, part of the key
    through the SearchParams) runs and captures the stage clock; `timers`
    takes a launch's spans (CapturedLoop.launch). Returns (finish's
    tensors, SearchStats)."""
    cache = graph_cache(owner)
    loop = cache.get(key, 0)
    if loop is not None:
        return loop.launch(queries, timers=timers)
    q = (device_queries(queries, torch.empty(0, device=device)),)
    out = run_eager(start, finish, q, max_iters, clock_for(device, stats))
    cache.put(0, CapturedLoop(start, finish, q, max_iters, stats=stats))
    return out


def run(cache: GraphCache | None, key, inputs: tuple, start, finish, max_iters: int):
    """One loop on device tensors `inputs` through `cache`: at the key's
    first call the eager loop (run_eager), at its second the capture and
    then the graph's launch, afterwards the launch alone. With no cache,
    or on the CPU (`captures`), the eager loop. Returns (finish's tensors,
    SearchStats), with no host wait once captured."""
    if cache is None or not captures(inputs[0].device):
        return run_eager(start, finish, inputs, max_iters)
    loop = cache.get(key, 0)
    if loop is None:
        if cache.calls == 0:
            cache.calls += 1
            return run_eager(start, finish, inputs, max_iters)
        loop = CapturedLoop(start, finish, inputs, max_iters)
        cache.put(0, loop)
    return loop.launch(*inputs)
