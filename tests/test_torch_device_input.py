"""Host arrays on their way to the device (models/compiled.device_input):
the values and dtype arrive unchanged, and on the card the staging block is
a pinned copy written by the calling thread (compiled.pinned).

The tests marked `cuda` need the card and skip without one. This file
imports no JAX, so they run on the card's host, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_device_input.py
"""

import numpy as np
import pytest
import torch

from bang_tpu_torch.models import compiled

HOST_INPUTS = [
    ("f32 queries", lambda rng: rng.standard_normal((300, 128)).astype(np.float32)),
    ("u8 rows", lambda rng: rng.integers(0, 256, (257, 128), dtype=np.uint8)),
    ("int32 ids, strided", lambda rng: rng.integers(-1, 1000, (64, 40), dtype=np.int32)[:, ::3]),
    ("a scalar", lambda rng: np.int32(7)),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned memory needs one")
    return torch.device("cuda")


@pytest.mark.parametrize("label,make", HOST_INPUTS, ids=[h[0] for h in HOST_INPUTS])
def test_host_input_on_the_cpu_is_unchanged(label, make):
    x = make(np.random.default_rng(0))
    t = compiled.device_input(x, torch.empty(0))
    assert t.dtype == torch.as_tensor(x).dtype
    np.testing.assert_array_equal(t.numpy(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("label,make", HOST_INPUTS, ids=[h[0] for h in HOST_INPUTS])
def test_host_input_reaches_the_card_unchanged(card, label, make):
    x = make(np.random.default_rng(1))
    t = compiled.device_input(x, torch.empty(0, device=card))
    assert t.device.type == "cuda" and t.dtype == torch.as_tensor(x).dtype
    np.testing.assert_array_equal(t.cpu().numpy(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.int32])
def test_pinned_is_a_pinned_copy(card, dtype):
    src = torch.arange(4096, dtype=torch.float32).reshape(64, 64)[:, ::2].to(dtype)
    out = compiled.pinned(src)
    assert out.is_pinned() and out.dtype == dtype
    assert out.data_ptr() != src.data_ptr()
    assert torch.equal(out, src)
