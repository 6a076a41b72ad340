"""Merge two result lines of the bench (bang_tpu_torch/bench.py, or the
root bench.py: the same JSON contract), the counterpart of
scripts/merge_bench_json.py: the fresh run wins every key it has; a section
the fresh run skipped (time budget) or whose row errored is carried over
from the earlier run, marked with `carried_from`. An errored section of the
earlier run is never carried. Each file's last line is read; the output is
byte for byte the JAX script's on the same files.

    python -m bang_tpu_torch.scripts.merge_bench_json fresh.json earlier.json out.json
"""

from __future__ import annotations

import json
import sys


def _errored(val) -> bool:
    return isinstance(val, dict) and set(val) == {"error"}


def merge(fresh: dict, earlier: dict, earlier_name: str) -> tuple[dict, list]:
    """(the merged dict, the keys carried from `earlier`); `fresh` is not
    changed. `earlier_name` goes into each carried section's
    `carried_from` and the `carried_sections` record."""
    out = dict(fresh)
    carried = []
    for key, val in earlier.items():
        if (key not in out or _errored(out[key])) and not _errored(val):
            out[key] = (dict(val, carried_from=earlier_name) if isinstance(val, dict)
                        else val)
            carried.append(key)
    if carried:
        out["carried_sections"] = {
            "from": earlier_name,
            "keys": carried,
            "note": "sections the fresh run skipped (time budget) or "
                    "errored, measured earlier the same day on the same "
                    "code + chip",
        }
    return out, carried


def _last_line(path: str) -> dict:
    with open(path) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def main(argv=None) -> dict:
    fresh_p, earlier_p, out_p = (sys.argv[1:] if argv is None else argv)[:3]
    merged, carried = merge(_last_line(fresh_p), _last_line(earlier_p), earlier_p)
    with open(out_p, "w") as f:
        f.write(json.dumps(merged) + "\n")
    print(f"merged: carried {carried or 'nothing'} -> {out_p}")
    return merged


if __name__ == "__main__":
    main()
