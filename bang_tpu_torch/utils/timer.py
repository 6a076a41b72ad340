"""Wall-clock and per-stage timers (port of bang_tpu/utils/timer.py).

The reference times host work with a gettimeofday pair (CPUTimer) and device
work with a cudaEvent pair (GPUTimer, BANG_Base/utils/timer.h); its stage
report has 8-9 buckets (BANG_Base/bang_search.cu:1028-1051). Here a stage is
a host-clock span; `stage(name, block_on=...)` ends the span only once the
device has finished the work queued before it: an event recorded on the
current stream of each CUDA tensor in `block_on`, then synchronized. The
JAX package waits on `jax.block_until_ready` at the same point. PyTorch
returns before the card finishes, so a stage that did not wait would time
the enqueue only.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class CPUTimer:
    """Start/stop accumulating wall-clock timer (milliseconds)."""

    def __init__(self) -> None:
        self.total_ms = 0.0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.total_ms += dt
        self._t0 = None
        return dt


def wait_for(tensors) -> None:
    """Block the host until the work queued so far on the current stream of
    each CUDA tensor's device has run: an event recorded there, then
    synchronized. CPU tensors are ready when their op returns."""
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    for t in tensors:
        if t.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            ev.synchronize()


class StageTimers:
    """Named stage accumulator with an enable flag (ENABLE_GPU_STATS analog)."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.ms = collections.defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Add the span of the body to `ms[name]`; with `block_on` (a tensor
        or a sequence of them) the span ends after the device has run what
        was queued for them (`wait_for`)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            wait_for(block_on)
        self.ms[name] += (time.perf_counter() - t0) * 1000.0

    def report(self) -> str:
        lines = [f"{name:32s} {ms:10.3f} ms" for name, ms in sorted(self.ms.items())]
        return "\n".join(lines)
