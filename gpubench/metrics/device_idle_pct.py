"""Share (%) of a call's untraced wall in which the card is idle: 1 - the
device's busy time a call inside the profiled slice / the mean wall of the
calls outside it (the profiler's host events lengthen the traced calls,
not the card's work). Layer: device. Moves: qps (.batch), p95_ms
(.online)."""


def read(rec):
    wall = rec.untraced_wall_s()
    if rec.timeline is None or wall is None:
        return None
    return 100.0 * (1.0 - rec.timeline.busy_s() / len(rec.slice_calls) / wall)
