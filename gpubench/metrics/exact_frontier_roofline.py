"""K3 (csrc/exact_frontier.cu): its share of its memory floor, the bytes of
_kernel_bytes.exact_frontier over the card's published rate, against its
profiled time in the slice. Layer: kernels. Moves: qps (.batch), p95_ms
(.online)."""

from gpubench.metrics import _kernel_bytes


def read(rec):
    return _kernel_bytes.roofline_pct(rec, "exact_frontier", _kernel_bytes.exact_frontier,
                                      rec.config["dim"])
