"""The base step at billion-point shapes, on `meta` tensors (the port's
counterpart of tests/test_billion_shapes.py).

The JAX test lowers the chunk-sharded base step at SIFT1B's shapes from
ShapeDtypeStructs and traces the single-chip step with eval_shape: nothing
is allocated. The port's steps are eager PyTorch, so the same proof runs
them on the `meta` device, where every op computes its output's shape and
dtype and no data exists: the [S, 1B, m/S] code shards (8 GB each) cost
nothing. K1's wrapper takes its plain version for meta tensors, as for CPU
ones, and launches nothing; on a CUDA tensor it launches or raises.
"""

import pytest
import torch

from bang_tpu_torch.constants import BF_ENTRIES
from bang_tpu_torch.models.base import BaseState, _step_core
from bang_tpu_torch.ops import _build
from bang_tpu_torch.ops import pq_kernels as pk
from bang_tpu_torch.ops import probe_kernels as prk
from bang_tpu_torch.ops.pq import pack_tables
from bang_tpu_torch.parallel.base_tp import make_base_step_tp
from bang_tpu_torch.parallel.sharded import Mesh

META = torch.device("meta")
N = 1_000_000_000  # SIFT1B
D = 128
M = 32  # PQ chunks: 32 GB of codes
R = 64  # the reference's MAX_R (bang_search.cu:35)
Q = 1024  # one pipelined sub-batch
L = 128
BEAM = 2
MAX_ITERS = L + 50  # the reference's maxIters headroom (bang_search.cu:53-54)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _state(q, l, max_iters, beam, bloom=False):
    mi = max_iters * beam
    return BaseState(
        wl_dist=_meta((q, l), torch.float32),
        wl_ids=_meta((q, l), torch.int32),
        wl_vis=_meta((q, l), torch.bool),
        parent_valid=_meta((q, beam), torch.bool),
        visited_ids=_meta((q, mi), torch.int32),
        l2_dists=_meta((q, mi), torch.float32),
        bloom=_meta((q, BF_ENTRIES + 1), torch.uint8) if bloom else None,
        active=_meta((q,), torch.bool),
        it=1,
    )


def _check_step_out(out, q, beam, bloom):
    new_state, parents, cont = out
    assert new_state.wl_ids.shape == (q, L) and new_state.wl_ids.dtype == torch.int32
    assert new_state.wl_dist.shape == (q, L) and new_state.wl_dist.dtype == torch.float32
    assert new_state.visited_ids.shape == (q, MAX_ITERS * beam)
    assert new_state.l2_dists.dtype == torch.float32 and new_state.it == 2
    assert (new_state.bloom is not None) == bloom
    assert parents.shape == (q, beam) and parents.dtype == torch.int32
    assert cont.shape == () and cont.dtype == torch.bool
    assert all(t.is_meta for t in (new_state.wl_ids, parents, cont))


@pytest.mark.parametrize("tables", ["packed", "f32"])
def test_base_tp_step_at_1b(tables):
    """The chunk-sharded step on a (2, 4) mesh: codes [4, 1B, 8] u8, one
    slice a shard; packed tables take K1's wrapper, f32 ones the plain
    lookup (JAX's test feeds f32 tables)."""
    model_axis = 4
    mesh = Mesh([[META] * model_axis] * 2)
    m_loc = M // model_axis
    codes = _meta((model_axis, N, m_loc), torch.uint8)
    assert [c.numel() * c.element_size() for c in codes] == [8_000_000_000] * model_axis
    if tables == "packed":
        tabs = _meta((model_axis, Q, m_loc, 128), torch.int32)
    else:
        tabs = _meta((model_axis, Q, m_loc, 256), torch.float32)
    pk.reset_launch_counts()
    out = make_base_step_tp(mesh)(
        _state(Q, L, MAX_ITERS, BEAM),
        _meta((Q, BEAM * R), torch.int32),  # host-gathered neighbor ids
        _meta((Q, BEAM, D), torch.uint8),  # the parents' u8 vectors
        _meta((Q, D), torch.float32),  # queries
        tabs, codes, BEAM,
    )
    _check_step_out(out, Q, BEAM, bloom=False)
    assert pk.pq_lookup.launches == 0


def test_single_card_base_step_at_1b():
    """The single-card step (models/base._step_core after K1 on codes[nbrs],
    as BaseVariantSearcher._run_step runs it on the card) at 1B shapes, in
    bloom mode at beam 1 as JAX's test traces it."""
    codes = _meta((N, M), torch.uint8)
    assert codes.numel() * codes.element_size() == 32_000_000_000
    nbrs = _meta((Q, R), torch.int32)
    packed = pack_tables(_meta((Q, M, 256), torch.float32))
    assert packed.shape == (Q, M, 128) and packed.dtype == torch.int32
    pk.reset_launch_counts()
    raw = pk.pq_lookup(packed, codes[nbrs.long()])
    assert raw.shape == (Q, R) and raw.dtype == torch.float32 and raw.is_meta
    out = _step_core(_state(Q, L, MAX_ITERS, 1, bloom=True), nbrs,
                     _meta((Q, 1, D), torch.uint8), _meta((Q, D), torch.float32), raw, 1)
    _check_step_out(out, Q, 1, bloom=True)
    assert pk.pq_lookup.launches == 0


def test_k1_wrapper_raises_on_the_card_when_the_build_fails(monkeypatch):
    """On the kernel's route a failed build raises: no plain fallback."""
    packed = pack_tables(torch.zeros((2, 8, 256)))
    codes = torch.zeros((2, 4, 8), dtype=torch.uint8)

    def failed(name):
        raise RuntimeError(f"nvcc failed to build {name}")

    monkeypatch.setattr(prk, "route", lambda *t: "cuda")
    monkeypatch.setattr(_build, "load_library", failed)
    pk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc failed to build pq_lookup"):
        pk.pq_lookup(packed, codes)
    assert pk.pq_lookup.launches == 0


def test_route_takes_meta_to_the_plain_version():
    cpu, meta = torch.zeros(2), _meta((2,), torch.float32)
    assert _build.route(cpu) == "cpu" and _build.route(meta) == "cpu"
    with pytest.raises(ValueError, match="different devices"):
        _build.route(cpu, meta)
