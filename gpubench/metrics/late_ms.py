"""95th percentile, in ms, of how late each open-loop request began after
it was due: the wait behind earlier requests (one request a call, FIFO)
plus the generator's own lag. Layer: traffic. Moves: p95_ms."""

import numpy as np


def read(rec):
    if not rec.lateness:
        return None
    return float(np.percentile(np.asarray(rec.lateness), 95)) * 1e3
