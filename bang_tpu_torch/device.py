"""Explicit device selection and float32 matmul precision.

The port never picks a device on its own: every entry point takes a
`device` argument. "cuda" requires a visible CUDA device and raises
otherwise — there is no silent CPU fallback. The CPU is used only when the
caller asks for it (the CPU tests), and a kernel wrapper takes its plain
PyTorch version only because the tensor it was given lies on the CPU.
"""

from __future__ import annotations

import torch


def set_exact_float32() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32).

    The reference builds PQ tables and exact distances at
    `Precision.HIGHEST` (bang_tpu/ops/pq.py, ops/l2.py); TF32 keeps about
    three decimal digits and would reorder near-tied candidates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def assert_exact_float32() -> None:
    """Raise if something in the process turned TF32 back on."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.backends.cudnn.allow_tf32); the port's distances need full "
            "float32 — call bang_tpu_torch.device.set_exact_float32()"
        )


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:1", "cpu", or a torch.device).

    A CUDA device that is not available raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
