"""The stage clock of the HBM searches under ENABLE_GPU_STATS, with its plain
version.

The reference's ENABLE_GPU_STATS report times each stage of a search with
CUDA events (BANG_Inmemory/parANN.cu:803-823). A captured search runs its
loop inside a WHILE node, whose body takes no event-record node, so here a
stamp is a one-thread kernel (`csrc/stage_clock.cu`): it reads the card's
%globaltimer, adds the nanoseconds since the last stamp to its stage's
bucket of an int64 buffer and makes the time the last stamp. A stamp goes
after each stage of the stream (models/traversal.make_step,
models/compiled), so the buckets sum to the span from the first stamp to
the last. On CPU tensors the plain version does the same with
`time.perf_counter_ns()`.

Stages (`STAGES`, the buckets in the buffer's order):
  tables    the prologue: PQ tables and their packing, entries, init_state
  frontier  the fetch and the distances (K2, K3, or K1 and its gathers)
  visited   the visited mask or bloom filter and the beam's first-occurrence
            mask
  merge     merge_worklist
  select    select_parents_beam and the visited-list write
  carry     the step's counters, its write-back into the state's buffers,
            the go flag, and the WHILE node's condition kernel
  rerank    the epilogue: the re-rank or the worklist's head

`stage_clock.launches` counts the kernel's launches, which the kernel
counts on the card (ops/_build.launch_counter); it is no compute kernel
and stays out of ops/pq_kernels.KERNELS: `launches()` reads it.
"""

from __future__ import annotations

import time

import torch

from bang_tpu_torch.ops import _build

STAGES = ("tables", "frontier", "visited", "merge", "select", "carry", "rerank")
START = -1  # the start stamp: zero the buckets


def stage_clock_plain(clock: torch.Tensor, stage: int) -> None:
    """Plain version of the stamp on a CPU buffer: perf_counter_ns."""
    now = time.perf_counter_ns()
    if stage == START:
        clock[:-1] = 0
    else:
        clock[stage] += now - int(clock[-1])
    clock[-1] = now


def stage_clock(clock: torch.Tensor, stage: int) -> None:
    """One stamp of `stage` (an index into STAGES, or START) on `clock`, an
    int64 [len(STAGES) + 1] buffer: the stage's bucket gains the time since
    the last stamp (ns). A CUDA buffer launches the kernel on the current
    stream; a CPU buffer takes the plain version."""
    _build.check_tensor("clock", clock, torch.int64, 1)
    if clock.shape[0] != len(STAGES) + 1:
        raise ValueError(f"clock must be [{len(STAGES) + 1}], got {tuple(clock.shape)}")
    if not START <= stage < len(STAGES):
        raise ValueError(f"stage {stage} outside [{START}, {len(STAGES)})")
    if _build.route(clock) == "cpu":
        stage_clock_plain(clock, stage)
        return
    lib = _build.load_library("stage_clock")
    with torch.cuda.device(clock.device):
        err = lib.stage_clock_launch(
            clock.data_ptr(), stage, _build.launch_counter(stage_clock, clock.device),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("stage_clock", err)


stage_clock.launches = 0


def launches() -> int:
    """The stamps launched on the cards so far (waits for each card)."""
    _build.collect_launches()
    return stage_clock.launches


class StageClock:
    """One search's stage clock: its buffer on `device`, made outside any
    capture (a captured loop makes it before it captures, as the launch
    counters), and the stamps."""

    def __init__(self, device):
        self.buf = torch.zeros(len(STAGES) + 1, dtype=torch.int64, device=device)
        self.reads = 0  # the eager loop's host reads of its flag (traversal.traverse)

    def start(self) -> None:
        stage_clock(self.buf, START)

    def stamp(self, stage: str) -> None:
        stage_clock(self.buf, STAGES.index(stage))

    def read(self, flag) -> bool:
        """The host's read of the eager loop's flag, counted in `reads`."""
        self.reads += 1
        return bool(flag)

    def ns(self) -> torch.Tensor:
        """The buckets, [len(STAGES)] int64 ns, a view of the buffer."""
        return self.buf[: len(STAGES)]

    def stages(self) -> torch.Tensor:
        """A copy of the buckets, for a SearchStats."""
        return self.ns().clone()

    def append(self, counters: torch.Tensor) -> torch.Tensor:
        """`counters` with the buckets after them (a captured epilogue's
        output)."""
        return torch.cat([counters, self.ns()])


class NoClock:
    """The stage clock with ENABLE_GPU_STATS off: a stamp does nothing, so
    a search that stamps it runs, and captures, no stamp."""

    reads = 0

    def start(self) -> None:
        pass

    def stamp(self, stage: str) -> None:
        pass

    def read(self, flag) -> bool:
        return bool(flag)

    def stages(self) -> None:
        return None

    def append(self, counters: torch.Tensor) -> torch.Tensor:
        return counters


NO_CLOCK = NoClock()


def clock_for(device, on: bool):
    """A StageClock on `device` when `on` (ENABLE_GPU_STATS), else
    NO_CLOCK."""
    return StageClock(device) if on else NO_CLOCK
