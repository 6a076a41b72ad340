"""The one traffic generator: turns a mix's parameters (traffic/<mix>.json,
overridden by cells/<cell>.json) and a seed into requests over the query
pool.

closed  one client sends the next request when the last one has returned:
        `request_size` queries a request, the whole pool in its order when
        that is the pool's size, else a fresh draw without replacement.
open    requests are due on a schedule whatever the system does. Poisson
        arrivals at `rate_per_s` and sizes log-uniform over
        [size_min, size_max]. Every seed gets the same multiset of gaps (the
        midpoint quantiles of the exponential, scaled so that the n =
        floor(rate * seconds) gaps add up to seconds * (n - 0.5) / n) and of
        sizes (the log-uniform's midpoint quantiles), each in its own
        seeded order, so seeds differ in order and in which queries they
        ask, not in the amount of work. Each request's queries are a
        seeded draw from the pool without replacement.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np


@dataclasses.dataclass
class Request:
    """One request: the pool rows it asks for and, open loop, when it is due
    (seconds after the window opens)."""

    idx: np.ndarray
    due: float | None = None


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one of the generator's streams of `seed`."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def closed_requests(params: dict, pool: int, seed: int):
    """Endless closed-loop requests."""
    size = int(params["request_size"])
    if not 1 <= size <= pool:
        raise ValueError(f"request_size {size} outside [1, {pool}]")
    if size == pool:
        whole = np.arange(pool)
        return itertools.repeat(Request(whole))
    rng = rng_for(seed, 1)
    return (Request(np.sort(rng.choice(pool, size, replace=False))) for _ in itertools.count())


def open_schedule(params: dict, pool: int, seed: int, seconds: float) -> list[Request]:
    """The open-loop requests due in a window of `seconds`, in due order."""
    rate = float(params["rate_per_s"])
    n = int(math.floor(rate * seconds))
    if n < 1:
        raise ValueError(f"rate {rate}/s gives no request in {seconds} s")
    lo, hi = int(params["size_min"]), int(params["size_max"])
    if not 1 <= lo <= hi <= pool:
        raise ValueError(f"sizes [{lo}, {hi}] outside [1, {pool}]")
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps *= seconds * (n - 0.5) / n / gaps.sum()
    sizes = np.rint(np.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)).astype(np.int64)
    rng = rng_for(seed, 2)
    due = np.cumsum(rng.permutation(gaps))
    sizes = rng.permutation(sizes)
    return [Request(np.sort(rng.choice(pool, int(s), replace=False)), float(t))
            for t, s in zip(due, sizes)]
