"""Build the tuned 10M bundle (R=32 graph, m=32 PQ) from scratch (the
counterpart of scripts/build_10m_tuned_direct.py), through
bundles.build_bundle with the source bundle's recipe: the dataset, queries
and ground truth depend only on (n, dim, seed, query noise), so they are
byte-identical to the source bundle's and to build_10m_tuned.py's.

    python -m bang_tpu_torch.scripts.build_10m_tuned_direct
"""

from __future__ import annotations

from bang_tpu_torch.scripts import bundles


def main(n=10_000_000, cache=bundles.CACHE, device="cuda") -> str:
    """Build the bundle; returns its prefix."""
    prefix = bundles.prefix_for("synth", n, 128, 32, 32, "vamana", cache)
    bundles.build_bundle(prefix, n, 128, 32, 32, "vamana", 10_000, l_build=48,
                         build_batch=8192, device=device)
    return prefix


if __name__ == "__main__":
    print(main())
