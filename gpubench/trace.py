"""The traced run's device timeline: one torch.profiler session, reduced to
the kernel intervals, the device's busy time and the host ranges that were
open while the device idled, over one steady slice of the window.

CUPTI lists the kernels of a CUDA graph replay only for graphs captured
after the process's first profiler session. So the session opens before
the program loads and captures (`Slice.open`) and stays open until the
slice ends: no session starts while captured graphs replay. The slice is
marked by a host range (`Slice.mark`, "gpubench.slice"); stop() keeps the
events inside it.
"""

from __future__ import annotations

import dataclasses
import heapq

import torch

# the kernels built from bang_tpu_torch/csrc/ (their __global__ names):
# every other kernel is PyTorch's, launched by the program's ops
CSRC_KERNELS = ("frontier_lookup_kernel", "exact_frontier_kernel", "pq_lookup_kernel",
                "frontier_packed_kernel", "row_gather_kernel", "set_condition")
NOT_KERNELS = ("Memcpy", "Memset")  # copies the runtime does, not kernels
ANNOTATIONS = ("gpubench.",)  # the harness's own ranges (record_function)
SLICE = "gpubench.slice"


@dataclasses.dataclass
class Timeline:
    """What one profiled slice saw. Times in seconds; kernels are
    (name, start, end) on the device's clock, host ranges the same on the
    host's (the profiler puts both on one clock)."""

    window_s: float
    kernels: list
    copies: list
    host: list

    def busy_s(self) -> float:
        """Seconds in which at least one kernel or copy ran (their union)."""
        return sum(b - a for a, b in self.busy_spans())

    def busy_spans(self) -> list:
        spans = sorted((a, b) for _, a, b in self.kernels + self.copies if b > a)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_s(self, match) -> tuple[float, int]:
        """(seconds, count) of the kernels whose name `match` accepts."""
        ts = [b - a for name, a, b in self.kernels if match(name)]
        return sum(ts), len(ts)

    def top_ops(self, n: int = 10) -> list:
        acc = {}
        for name, a, b in self.kernels + self.copies:
            acc[name[:120]] = acc.get(name[:120], 0.0) + (b - a)
        return sorted(([k, v] for k, v in acc.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds between device work, summed by the innermost host
        range open at each gap's midpoint ("no host range" when none). The
        innermost is the latest-starting range that has not ended: a sweep
        over the midpoints in order, the ranges on a max-heap by start,
        dropping those that ended before the midpoint."""
        spans = self.busy_spans()
        host = sorted(self.host, key=lambda h: h[1])
        heap, i, acc = [], 0, {}
        for (_, a), (b, _) in zip(spans, spans[1:]):
            mid = (a + b) / 2
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(heap, (-host[i][1], i))
                i += 1
            while heap and host[heap[0][1]][2] < mid:
                heapq.heappop(heap)
            label = host[heap[0][1]][0] if heap else "no host range"
            acc[label] = acc.get(label, 0.0) + (b - a)
        return sorted(([k, v] for k, v in acc.items()), key=lambda kv: -kv[1])[:n]


class Slice:
    """The profiler session of a traced run: open() before the program
    loads, mark() between two requests where the slice begins, stop()
    between two requests where it ends; each after a synchronise. stop()
    returns the Timeline of the slice alone."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.range = None
        self.t0 = None  # the host clock at mark()

    @property
    def recording(self) -> bool:
        return self.range is not None

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()

    def mark(self, clock) -> None:
        torch.cuda.synchronize(self.device)
        self.range = torch.autograd.profiler.record_function(SLICE)
        self.range.__enter__()
        self.t0 = clock()

    def stop(self) -> Timeline:
        torch.cuda.synchronize(self.device)
        self.range.__exit__(None, None, None)
        self.range = None
        self.prof.stop()
        events = []
        lo = hi = None
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns() * 1e-9
            b = a + e.duration_ns() * 1e-9
            cpu = e.device_type() == torch.autograd.DeviceType.CPU
            if cpu and e.name() == SLICE:
                lo, hi = a, b
            events.append((e, a, b, cpu))
        self.prof = None
        kernels, copies, host = [], [], []
        for e, a, b, cpu in events:
            if b <= lo or a >= hi:
                continue
            a, b = max(a, lo), min(b, hi)
            if getattr(e, "is_user_annotation", bool)() or e.name().startswith(ANNOTATIONS):
                # a range the profiler also draws on the device's timeline:
                # a span, not device work
                if cpu and e.name() != SLICE:
                    host.append((e.name(), a, b))
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                name = e.name()
                (copies if name.startswith(NOT_KERNELS) else kernels).append((name, a, b))
            elif cpu:
                host.append((e.name(), a, b))
        return Timeline(hi - lo, kernels, copies, host)
