"""Traversal iterations a call, counted on the card (BANGSearch.last_stats
.iters), the mean over every call of the window. Layer: models. Moves:
qps (.batch), p95_ms (.online)."""


def read(rec):
    return sum(rec.iters) / len(rec.iters) if rec.iters else None
