"""The MIPS query transform, copied from bang_tpu/formats/preprocess.py
(`preprocess_queries_mips` only; the DiskANN index converter is not copied).
"""

from __future__ import annotations

import numpy as np


def preprocess_queries_mips(queries: np.ndarray) -> np.ndarray:
    """MIPS query transform: L2-normalize and append a zero dimension.

    Matches the reference's preprocess mode (BANG_Base/test_driver.cpp:280-336):
    with data points augmented by sqrt(M^2 - |x|^2), L2 search over the
    augmented space returns maximum-inner-product neighbors.
    """
    q = queries.astype(np.float32)
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    norms = np.where(norms == 0, 1.0, norms)
    q = q / norms
    return np.concatenate([q, np.zeros((q.shape[0], 1), np.float32)], axis=1)
