"""What the probe scripts share: the device and generator, CUDA-event
timing, seeded data on the device, the checks and the one-line report."""

from __future__ import annotations

import torch

from bang_tpu_torch.device import resolve_device
from bang_tpu_torch.ops.adjacency import pack_adj_planes

ITERS = 20  # calls per timing, as in the JAX scripts


def setup(device, seed: int):
    """(torch.device, a torch.Generator on it seeded with `seed`). A CUDA
    device that is not there raises (device.resolve_device)."""
    dev = resolve_device(device)
    return dev, torch.Generator(device=dev).manual_seed(seed)


def time_ms(fn, dev, iters: int = ITERS):
    """Mean device ms per call of fn(i), i = 0..iters-1, between two CUDA
    events after three warm-up calls. On the CPU fn(0) runs once and the
    result is None: a host clock there is no device time."""
    if dev.type != "cuda":
        fn(0)
        return None
    for i in range(3):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def shifted(parents: torch.Tensor, n: int, iters: int = ITERS):
    """The parents of each timed call, (parents + i) % n, made before the
    timing (the JAX scripts shift them inside their loops)."""
    p = parents.long()
    return [((p + i) % n).to(torch.int32) for i in range(iters)]


def tables(gen, q: int, m: int, dev) -> torch.Tensor:
    """[Q, m, 256] f32 non-negative distance tables."""
    return torch.randn((q, m, 256), generator=gen, device=dev) ** 2


def u8(gen, shape, dev) -> torch.Tensor:
    return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)


def fused_rows(gen, n: int, r: int, m: int, id_hi: int, dev):
    """(rows [n, R*(4+m)] u8, ids [n, R] int32): random neighbor ids below
    `id_hi` as 4 byte-planes, then random chunk-major codes — the layout of
    ops/pq_kernels.pack_frontier_rows."""
    ids = torch.randint(0, id_hi, (n, r), generator=gen, device=dev,
                        dtype=torch.int32)
    codes = u8(gen, (n, m * r), dev)
    rows = torch.cat([pack_adj_planes(ids), codes], dim=1)
    return rows, ids


def exact_rows(gen, n: int, r: int, d: int, id_hi: int, dev,
               block: int = 65_536) -> torch.Tensor:
    """Fused exact rows [n, R*(8+D)] in the layout of
    ops/l2.pack_exact_frontier_rows, from random ids below `id_hi` and
    random u8 vectors whose norm planes hold their true squared norms;
    built in row blocks on `dev`."""
    rows = torch.empty((n, r * (8 + d)), dtype=torch.uint8, device=dev)
    for s in range(0, n, block):
        b = min(block, n - s)
        ids = torch.randint(0, id_hi, (b, r), generator=gen, device=dev,
                            dtype=torch.int32)
        vecs = u8(gen, (b, r, d), dev)
        norms = (vecs.float() ** 2).sum(-1)
        rows[s : s + b] = torch.cat([pack_adj_planes(ids),
                                     pack_adj_planes(norms.view(torch.int32)),
                                     vecs.reshape(b, r * d)], dim=1)
    return rows


def dist_err(label: str, got: torch.Tensor, want: torch.Tensor,
             scale: torch.Tensor | None = None) -> float:
    """Max |got - want|; raises past rtol 1e-5 + atol 1e-5 x `scale` (by
    default the row's largest |want|): both sides sum the same f32 or bf16
    entries in f32, so only the summation order differs."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    err = (got - want).abs()
    if scale is None:
        scale = want.abs().amax(dim=-1, keepdim=True)
    bad = int((err > 1e-5 * want.abs() + 1e-5 * scale).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: {bad} values out of tolerance, "
                             f"max err {float(err.max())}")
    return float(err.max())


def same(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 when `got` equals `want` bit for bit; raises otherwise."""
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: not bit-exact")
    return 0.0


def report(result: dict, tag: str, name: str, ms, err: float) -> None:
    """Print one variant's line and keep it in `result[name]`."""
    t = "not measured (cpu)" if ms is None else f"{ms:8.4f} ms/call"
    print(f"[{tag}] {name:52s} {t}  max abs err {err:.3e}", flush=True)
    result[name] = {"ms": ms, "max_abs_err": err}
