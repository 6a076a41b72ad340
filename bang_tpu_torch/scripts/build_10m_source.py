"""Build the 10M R=64 / m=64 source bundle (the counterpart of
scripts/build_10m_source.py): bench.py's scale10m recipe through
bundles.build_bundle (Vamana l_build 48, batch 8192, 10K queries), whose
vectors, queries and ground truth build_10m_tuned.py reuses.

    python -m bang_tpu_torch.scripts.build_10m_source
"""

from __future__ import annotations

from bang_tpu_torch.scripts import bundles


def main(n=10_000_000, cache=bundles.CACHE, device="cuda") -> str:
    """Build the bundle; returns its prefix."""
    prefix = bundles.prefix_for("synth", n, 128, 64, 64, "vamana", cache)
    bundles.build_bundle(prefix, n, 128, 64, 64, "vamana", 10_000, l_build=48,
                         build_batch=8192, device=device)
    return prefix


if __name__ == "__main__":
    print(main())
