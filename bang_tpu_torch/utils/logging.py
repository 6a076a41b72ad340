"""Timestamped phase logging, copied from bang_tpu/utils/logging.py
(reference: BANG_Base/utils/utils.h:58-68)."""

from __future__ import annotations

import sys
import time

_T0 = time.time()


def log_message(msg: str, file=None) -> None:
    """Print `msg` with wall-clock milliseconds since process start; the
    stream is resolved at call time, so later redirection is honoured."""
    out = sys.stdout if file is None else file
    print(f"[{(time.time() - _T0) * 1000.0:12.3f} ms] {msg}", file=out, flush=True)
