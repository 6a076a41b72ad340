"""ms a call spends off the device: the mean host-clock wall of the calls
outside the profiled slice (BANGSearch.bang_query, or SearchServer.query;
the profiler slows the host inside it), less the device's busy time a
call inside the slice. Layer: api. Moves: qps (.batch), p95_ms
(.online)."""


def read(rec):
    wall = rec.untraced_wall_s()
    if rec.timeline is None or wall is None:
        return None
    return 1e3 * (wall - rec.timeline.busy_s() / len(rec.slice_calls))
