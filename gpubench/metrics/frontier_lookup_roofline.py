"""K2 (csrc/frontier_lookup.cu): its share of its memory floor, the bytes of
_kernel_bytes.frontier_lookup over the card's published rate, against its
profiled time in the slice. Layer: kernels. Moves: qps."""

from gpubench.metrics import _kernel_bytes


def read(rec):
    return _kernel_bytes.roofline_pct(rec, "frontier_lookup", _kernel_bytes.frontier_lookup,
                                      rec.config["pq_chunks"])
