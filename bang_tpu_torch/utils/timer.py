"""Per-stage timers, the ENABLE_GPU_STATS report (port of
bang_tpu/utils/timer.py).

The reference's stage report has 8-9 buckets (BANG_Base/bang_search.cu:
1028-1051, BANG_Inmemory/parANN.cu:803-823), timed on the host with a
gettimeofday pair and on the device with cudaEvent pairs. Here one
StageTimers holds a report:

  ms      host-clock spans (`stage(name)`, milliseconds), and device
          times that a caller adds in (the HBM searches' stage clock,
          ops/stage_clock, as `dev.<stage>`; api.BANGSearch);
  counts  counters (the host's blocking waits a call, `host_waits`);
  setup   what the last bang_alloc recorded (capture seconds, graph
          bytes), kept by `clear()`.

A span ends when its body returns: PyTorch returns before the card
finishes, so a span of device work times its enqueue, unless the body
waits (the API's `readback` span holds the one wait of a call). While a
torch.profiler session records, each span also opens a profiler range
named `bang.<name>`, nested as the spans are, so a device trace puts its
gaps down to the program's spans. A disabled StageTimers records nothing
and opens no range: `stage` returns a shared null context.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

RANGE_PREFIX = "bang."  # the profiler ranges' names: RANGE_PREFIX + the span's
_OFF = contextlib.nullcontext()


class StageTimers:
    """Named stage accumulator with an enable flag (ENABLE_GPU_STATS analog)."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.ms = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)
        self.setup: dict = {}

    def stage(self, name: str):
        """A context that adds the span of its body to `ms[name]`, inside a
        profiler range `bang.<name>` while a profiler records; a no-op when
        disabled."""
        return self._span(name) if self.enabled else _OFF

    @contextlib.contextmanager
    def _span(self, name: str):
        with (torch.profiler.record_function(RANGE_PREFIX + name)
              if torch.autograd._profiler_enabled() else _OFF):
            t0 = time.perf_counter()
            yield
            self.ms[name] += (time.perf_counter() - t0) * 1000.0

    def clear(self) -> None:
        """Forget the spans and counters (a new call); `setup` stays."""
        self.ms.clear()
        self.counts.clear()

    def report(self) -> str:
        lines = [f"{name:32s} {ms:10.3f} ms" for name, ms in sorted(self.ms.items())]
        lines += [f"{name:32s} {n:10d}" for name, n in sorted(self.counts.items())]
        lines += [f"{name:32s} {v:10.3f}" if isinstance(v, float) else f"{name:32s} {v:10d}"
                  for name, v in sorted(self.setup.items())]
        return "\n".join(lines)


NO_TIMERS = StageTimers(enabled=False)  # what a call without a report passes
