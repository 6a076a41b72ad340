"""A SIFT-shaped corpus and its held-out queries, made on the device from a
seed.

The recipe is that of `bang_tpu_torch.formats.synthetic.make_clustered_data`,
frozen here so that a change to the program cannot change the benchmark's
data: `n_clusters` centers in a `latent_dim`-dimensional latent space,
points at N(0, cluster_sigma) around a uniformly drawn center, mapped to
`dim` dimensions by a random N(0, 1/sqrt(latent_dim)) linear map, plus
N(0, ambient_sigma) noise, then x * scale + offset. With `dtype` "uint8"
the vectors are u8 as SIFT's descriptors are, clipped to [0, 255]: the
base vectors truncated, as numpy's astype does, the queries rounded; with
"float32" they stay float32 (DEEP's and GIST's kind). The queries are
further draws of the same mixture: descriptors of other images, as
SIFT1M's are, never base points plus noise.

All draws come from one torch.Generator on `device`, in a fixed order and
in a few large calls, so one seed gives the same bytes on one kind of
device (not across devices: CPU and CUDA generators differ).
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 18  # rows mapped at a time: bounds the f32 transient to ~128 MB


def make(spec: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(base [n, dim], queries [query_pool, dim]) of `spec["dtype"]` on
    `device`."""
    dtype = {"uint8": torch.uint8, "float32": torch.float32}.get(spec["dtype"])
    if dtype is None:
        raise ValueError(f"the clustered corpus is uint8 or float32, not {spec['dtype']!r}")
    dev = torch.device(device)
    n, pool, dim, dz = spec["n"], spec["query_pool"], spec["dim"], spec["latent_dim"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    centers = torch.randn(spec["n_clusters"], dz, generator=gen, device=dev)
    mapping = torch.randn(dz, dim, generator=gen, device=dev) / math.sqrt(dz)
    total = n + pool
    assign = torch.randint(0, spec["n_clusters"], (total,), generator=gen, device=dev)
    latent = centers[assign] + spec["cluster_sigma"] * torch.randn(
        total, dz, generator=gen, device=dev)
    out = torch.empty(total, dim, dtype=dtype, device=dev)
    for s in range(0, total, CHUNK):
        e = min(s + CHUNK, total)
        # the map in full float32 whatever the process's TF32 setting
        x = (latent[s:e].double() @ mapping.double()).float()
        x = x + spec["ambient_sigma"] * torch.randn(e - s, dim, generator=gen, device=dev)
        x = x * spec["scale"] + spec["offset"]
        if dtype == torch.float32:
            out[s:e] = x
            continue
        lo, hi = max(s, n), e  # rows past n are queries: rounded
        if s < n:
            out[s:min(e, n)] = x[: min(e, n) - s].clamp(0, 255).to(torch.uint8)
        if hi > lo:
            out[lo:hi] = x[lo - s :].round().clamp(0, 255).to(torch.uint8)
    return out[:n], out[n:]
