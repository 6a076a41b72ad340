"""The traversal's exact visited filter (ops/visited.visited_filter).

On the CPU the wrapper's route is its plain version, today's composition;
it is held here against a loop over the definition (a candidate is new iff
its query is active, its parent valid, its id in neither the worklist nor
the expanded parents, and in no earlier parent's block) and against the
composition written out with the dense masks, bit for bit, on cases with
INVALID_ID in all three id lists, inactive queries, invalid parents,
duplicates across and inside blocks, and fewer or more visited slots than
worklist slots.

The tests marked `cuda` need the card and skip without one. They hold the
kernel (csrc/visited_filter.cu) to the plain version bit for bit, and count
one launch a step in a captured search. This file imports no JAX, so they
run on the card's host, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_visited_filter.py
"""

import numpy as np
import pytest
import torch

from bang_tpu_torch.constants import INVALID_ID
from bang_tpu_torch.models import traversal
from bang_tpu_torch.ops import _build
from bang_tpu_torch.ops import pq_kernels as pk
from bang_tpu_torch.ops import visited


def _case(seed, q, beam, r, l, v, device="cpu"):
    """Seeded inputs: ids from a small range, so candidates hit the lists
    and each other; INVALID_ID in the candidates and as tails of both
    lists; about a fifth of the queries inactive and of the parents
    invalid; rows with a duplicate inside a block and across blocks."""
    rng = np.random.default_rng(seed)
    c = beam * r
    hi = max(2 * (l + v) // 3, 8)
    cand = rng.integers(0, hi, size=(q, c)).astype(np.int32)
    cand[rng.random((q, c)) < 0.05] = INVALID_ID
    cand[::3, 1] = cand[::3, 0]  # inside block 0
    if beam > 1:
        cand[1::3, r] = cand[1::3, 0]  # block 1 repeats block 0
    wl = rng.integers(0, hi, size=(q, l)).astype(np.int32)
    wl[:, 3 * l // 4 :] = INVALID_ID
    vis = rng.integers(0, hi, size=(q, v)).astype(np.int32)
    vis[:, v // 2 :] = INVALID_ID
    raw = rng.random((q, c), dtype=np.float32) * 100
    parent_valid = rng.random((q, beam)) > 0.2
    parent_valid[:, 0] |= rng.random(q) > 0.5
    active = rng.random(q) > 0.2
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cand, raw, wl, vis, parent_valid, active))


def _loop_oracle(cand, raw, wl, vis, parent_valid, active, beam):
    cand, raw, wl, vis = (t.numpy() for t in (cand, raw, wl, vis))
    q, c = cand.shape
    r = c // beam
    new = np.zeros((q, c), dtype=bool)
    for i in range(q):
        known = set(wl[i].tolist()) | set(vis[i].tolist())
        for j in range(c):
            b = j // r
            new[i, j] = (bool(active[i]) and bool(parent_valid[i, b])
                         and int(cand[i, j]) not in known
                         and int(cand[i, j]) not in cand[i, : b * r].tolist())
    return new, np.where(new, raw, np.float32(np.inf))


def _dense_composition(cand, raw, wl, vis, parent_valid, active, beam):
    q, c = cand.shape
    cand_valid = parent_valid.repeat_interleave(c // beam, dim=1)
    new = visited.exact_new_mask_dense(cand, wl, vis) & cand_valid & active[:, None]
    if beam > 1:
        new &= visited.first_occurrence_mask_blocks(cand, beam)
    return new, torch.where(new, raw, torch.full_like(raw, float("inf")))


def _same_bits(got, want):
    """new equal and dist equal bit for bit (+inf included)."""
    assert got[0].dtype == torch.bool and got[1].dtype == torch.float32
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("lv", ["V<L", "V>L"])
@pytest.mark.parametrize("beam", [1, 2, 3, 4])
def test_cpu_route_is_the_composition(beam, lv):
    """visited_filter on CPU tensors: the plain version, equal to the loop
    over the definition and to the dense composition."""
    l, v = (20, 12) if lv == "V<L" else (12, 30)
    args = _case(100 * beam + l, 24, beam, 8, l, v)
    got = visited.visited_filter(*args, beam)
    want = _loop_oracle(*args, beam)
    assert torch.equal(got[0], torch.from_numpy(want[0]))
    assert torch.equal(got[1], torch.from_numpy(want[1]))
    _same_bits(got, _dense_composition(*args, beam))
    _same_bits(got, visited.visited_filter_plain(*args, beam))
    new = got[0]
    cand, _, _, _, parent_valid, active = args
    assert 0 < new.sum() < new.numel()
    assert not new[~active].any() and not new[cand == INVALID_ID].any()
    assert not new.view(24, beam, 8)[~parent_valid].any()
    # a duplicate inside block 0 stays new when the first one is
    rows = torch.arange(0, 24, 3)
    assert torch.equal(new[rows, 1], new[rows, 0])
    if beam > 1:  # block 1's repeat of block 0's first id never is
        assert not new[torch.arange(1, 24, 3), 8].any()


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32"), ("contiguity", "contiguous"), ("beam", "beam=3"),
    ("shape", "shapes"), ("shared memory", "shared memory")])
def test_refuses_what_the_kernel_does_not_take(bad, match):
    cand, raw, wl, vis, pv, act = _case(1, 4, 2, 8, 10, 6)
    beam = 2
    if bad == "dtype":
        raw = raw.double()
    elif bad == "contiguity":
        wl = torch.cat([wl, wl], dim=1)[:, ::2]
    elif bad == "beam":
        beam = 3
    elif bad == "shape":
        act = act[:3]
    else:
        wl = torch.zeros((4, _build.MAX_SHARED_BYTES // 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        visited.visited_filter(cand, raw, wl, vis, pv, act, beam)


@pytest.mark.parametrize("q,r", [(0, 8), (3, 0)])
def test_kernel_route_launches_nothing_for_an_empty_batch(monkeypatch, q, r):
    """On the kernel's route an empty batch returns empty results before
    any launch, and no launch is counted."""
    monkeypatch.setattr(visited, "route", lambda *t: "cuda")
    monkeypatch.setattr(_build, "load_library", lambda n: pytest.fail("launched"))
    pk.reset_launch_counts()
    ids = torch.zeros((q, 2 * r), dtype=torch.int32)
    args = (ids, ids.float(), torch.zeros((q, 10), dtype=torch.int32),
            torch.zeros((q, 6), dtype=torch.int32), torch.ones((q, 2), dtype=torch.bool),
            torch.ones(q, dtype=torch.bool))
    new, dist = visited.visited_filter(*args, 2)
    assert new.shape == dist.shape == (q, 2 * r) and new.dtype == torch.bool
    assert visited.visited_filter.launches == 0


@pytest.mark.parametrize("mode", ["exact", "bloom"])
def test_step_filters_through_the_wrapper_in_exact_mode(monkeypatch, tmp_path, mode):
    """Every exact-mode step calls visited_filter once; bloom mode never
    does. Both searches answer as they did."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.formats import synthetic
    from bang_tpu_torch.formats.bin_io import load_bin

    info = synthetic.build_synthetic_index(str(tmp_path / "b"), n=1200, dim=16, r=16,
                                           m=4, n_queries=8, seed=3)
    queries = load_bin(info["prefix"] + "_query.bin", np.float32)
    engine = BANGSearch("inmemory", device="cpu")
    engine.bang_load(info["prefix"])
    engine.bang_set_searchparams(10, 16, beam_width=2, visited_mode=mode)
    want = engine.bang_query(queries)
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return visited.visited_filter(*args)

    monkeypatch.setattr(traversal, "visited_filter", counting)
    got = engine.bang_query(queries)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    steps = engine.last_stats.iters - 1
    assert steps > 1
    assert calls == ([(8, 32)] * steps if mode == "exact" else [])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (label, Q, beam, R, L, V)
CARD_SHAPES = [
    ("cell", 10_000, 2, 64, 40, 52),
    ("C=72, L and V not multiples of 4", 3_000, 3, 24, 37, 22),
    ("C=17", 1_000, 1, 17, 16, 9),
    ("beam 16 x R 64", 512, 16, 64, 128, 960),
    ("L=512 beam 1", 2_048, 1, 64, 512, 562),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=[s[0] for s in CARD_SHAPES])
def test_kernel_bit_identical_on_the_card(card, shape):
    _, q, beam, r, l, v = shape
    args = _case(q + l, q, beam, r, l, v, card)
    pk.reset_launch_counts()
    got = visited.visited_filter(*args, beam)
    torch.cuda.synchronize()
    assert pk.launch_counts()["visited_filter"] == 1
    _same_bits(got, visited.visited_filter_plain(*args, beam))
    assert 0 < got[0].sum() < got[0].numel()


@pytest.mark.cuda
def test_kernel_off_a_16_byte_boundary(card):
    """Inputs 4 bytes (the bool ones 1 byte) off a 16-byte boundary give
    what aligned ones give."""
    args = _case(5, 1_000, 2, 64, 40, 52, card)
    moved = []
    for a in args:
        buf = torch.empty(a.numel() + 4, dtype=a.dtype, device=card)
        m = buf[1 : 1 + a.numel()].view(a.shape)
        m.copy_(a)
        moved.append(m)
    assert moved[0].data_ptr() % 16
    _same_bits(visited.visited_filter(*moved, 2), visited.visited_filter(*args, 2))


@pytest.mark.cuda
def test_captured_search_counts_one_launch_a_step(card, tmp_path):
    """A replay of a captured in-memory search launches the filter once a
    step, as K2."""
    from bang_tpu_torch.api import BANGSearch
    from bang_tpu_torch.formats import synthetic
    from bang_tpu_torch.formats.bin_io import load_bin

    info = synthetic.build_synthetic_index(str(tmp_path / "b"), n=3000, dim=32, r=64,
                                           m=8, n_queries=256, dtype=np.uint8, seed=7)
    queries = load_bin(info["prefix"] + "_query.bin", np.uint8)
    engine = BANGSearch("inmemory", device=card)
    engine.bang_load(info["prefix"])
    engine.bang_set_searchparams(10, 40, beam_width=2, extra_iters=11)
    engine.bang_alloc(len(queries))
    first = engine.bang_query(queries)
    pk.reset_launch_counts()
    again = engine.bang_query(queries)
    counts = pk.launch_counts()
    steps = engine.last_stats.iters - 1
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert counts["visited_filter"] == counts["frontier_lookup"] == steps > 1
