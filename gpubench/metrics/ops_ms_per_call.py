"""ms a call of device time in PyTorch's kernels, the program's ops layer
(visited and first-occurrence masks, merge, parent top-k, tables,
re-rank): every profiled kernel that is not built from csrc/, per call of
the slice. Layer: ops. Moves: qps (.batch), p95_ms (.online)."""

from gpubench.trace import CSRC_KERNELS


def read(rec):
    tl = rec.timeline
    if tl is None or not len(rec.slice_calls):
        return None
    seconds, _ = tl.kernel_s(lambda name: not any(k in name for k in CSRC_KERNELS))
    return 1e3 * seconds / len(rec.slice_calls)
