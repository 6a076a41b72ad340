"""Fixtures of gpubench's tests: tiny cells that run on the CPU through
BANGSearch(device="cpu") in seconds. The card's test is marked `card` and
skips, inside the test, where no CUDA device is visible.

    python -m pytest gpubench/tests -q             # here: the CPU tests
    python -m pytest gpubench/tests -q -m card     # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


def cell_names() -> list:
    """Every cell that gpubench/cells/ holds, in BENCHMARK.json or not."""
    return sorted(f[: -len(".json")] for f in os.listdir(os.path.join(ROOT, "gpubench", "cells")))


def _from_files(name: str) -> dict:
    """A cell of gpubench/cells/ that BENCHMARK.json does not list (yet),
    with end-to-end metrics and per-layer readers for its kind of loop."""
    from gpubench import run

    here = os.path.join(ROOT, "gpubench")
    cell = run._json(os.path.join(here, "cells", f"{name}.json"))
    traffic = run._json(os.path.join(here, "traffic", f"{cell['traffic']}.json"))
    traffic.update(cell["params"])
    closed = traffic["loop"] == "closed"
    e2e = [{"name": n, "unit": u} for n, u in
           ((("qps", "queries/s"),) if closed else (("p95_ms", "ms"),))
           + (("recall_at_10", "%"), ("setup_s", "s"))]
    tag = "batch" if closed else "online"
    layer = [{"name": n, "unit": u, "source": src} for n, u, src in
             ((f"iters_per_call.{tag}", "iterations", "program_counter"),
              (f"device_idle_pct.{tag}", "%", "device_trace"),
              ("graph_build_s", "s", "host_clock"))
             + ((("late_ms.online", "ms", "host_clock"),) if not closed else ())]
    return {"name": name, "chips": 1, "traffic": traffic, "end_to_end": e2e, "per_layer": layer,
            "config": run._json(os.path.join(here, "configs", f"{cell['config']}.json"))}


def tiny_cell(name: str) -> dict:
    """The cell `name` of gpubench/cells/ cut to a CPU run of seconds: 2,000
    16-dimensional points, a pool of 200 queries, R=16."""
    from gpubench import run

    bench = run._json(os.path.join(ROOT, "BENCHMARK.json"))
    listed = any(w["name"] == name for w in bench["workloads"])
    cell = run.load_cell(name) if listed else _from_files(name)
    cfg = dict(cell["config"])
    cfg.update(n=2000, dim=16, query_pool=200, n_clusters=8, R=16, L_build=24,
               build_batch=256, pq_chunks=4 if cfg["pq_chunks"] else 0, L=24,
               recall_limit=80.0)
    traffic = dict(cell["traffic"])
    if traffic["loop"] == "closed":
        traffic.update(request_size=200, batch=200)
    else:
        traffic.update(rate_per_s=20.0, size_min=8, size_max=64, batch=64)
    cell.update(config=cfg, traffic=traffic)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
