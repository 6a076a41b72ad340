"""Bytes a launch of K2 or K3 needs, from the cell's shapes and the
parents the traversal expanded (its `n_expanded` counter, counted on the
card): each input byte read once and each output byte written once.

Per launch every query stages its table (K2: m x 128 int32 words, the
bf16-pair PQ table) or its float32 query (K3) and its `beam` parent ids,
and writes `beam * R` ids and distances (int32, float32), whether or not
its parents are valid. A parent row is read only for a valid parent (an
invalid one reads nothing), so the rows count once per expanded parent:
R * (4 + m) bytes (K2's fused rows: 4 id byte-planes, m code bytes a
neighbor) or R * (8 + D) (K3's: 4 id planes, 4 norm planes, D u8 a
neighbor). A row that several queries expand in one launch counts once per
query: each query's block reads it, L2 serving the repeats.
"""

import json
import os
import sys


def frontier_lookup(q: int, beam: int, r: int, m: int, launches: int, expanded: int) -> int:
    return launches * q * (m * 512 + 4 * beam + 8 * beam * r) + expanded * r * (4 + m)


def exact_frontier(q: int, beam: int, r: int, d: int, launches: int, expanded: int) -> int:
    return launches * q * (4 * d + 4 * beam + 8 * beam * r) + expanded * r * (8 + d)


def hbm_bytes_per_s(kind: str):
    """The card's published memory rate (peaks.json), None for a card not
    in the table."""
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "peaks.json")) as f:
        peaks = json.load(f)
    return peaks.get(kind, {}).get("hbm_bytes_per_s")


def roofline_pct(rec, kernel: str, nbytes_fn, width: int):
    """Share (%) of the memory floor of `kernel` over its profiled time in
    the slice; None without a trace, without launches, or when the
    profiler listed another number of launches than the card counted."""
    tl = rec.timeline
    if tl is None or not rec.launches or not rec.launches.get(kernel):
        return None
    seconds, listed = tl.kernel_s(lambda name: f"{kernel}_kernel" in name)
    launches = rec.launches[kernel]
    if listed != launches or seconds <= 0:
        print(f"[gpubench] {kernel}: the profiler listed {listed} launches, the card "
              f"counted {launches}", file=sys.stderr, flush=True)
        return None
    rate = hbm_bytes_per_s(rec.kind)
    if rate is None:
        return None
    cfg = rec.config
    expanded = sum(rec.expanded[i] for i in rec.slice_calls)
    nbytes = nbytes_fn(rec.batch, rec.params.beam_width, cfg["R"], width, launches, expanded)
    return 100.0 * nbytes / rate / seconds
