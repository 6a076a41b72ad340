"""The two kernel wrappers of bang_tpu_torch.ops.pq_kernels, on the CPU.

Here the wrappers take their plain versions (the tensors lie on the CPU);
the CUDA kernels themselves are compared with the same plain versions on
the card by chip_smoke.py. Held against the JAX package:
  * the CPU's in-memory routes, ops/pq.pq_lookup on the scattered codes and
    the f32 decode `frontier_decode_plain` on the fused rows, against JAX
    `pq_lookup` and `frontier_decode_xla`: f32 tables both sides, rtol 1e-5
    plus atol 1e-5 x the row's magnitude (summation order only);
  * K1 `pq_lookup` (plain) on the port's `pack_tables` against the Pallas
    `pq_lookup_packed` in interpret mode on JAX's packing, C=256 (the
    Pallas kernel's 128-lane slices) included: the same bf16 entries, only
    the order of the f32 sum differs, so rtol 1e-5 plus atol 1e-5 x the
    row's largest;
  * K2 `frontier_lookup` (plain) against the Pallas `frontier_lookup` and
    `frontier_lookup_dma` in interpret mode, both over the same bf16-pair
    tables (the port's `pack_tables` words equal JAX's): ids bit-exact,
    distances within rtol 1e-5 plus atol 1e-5 x the row's largest — the
    same bf16 entries, only the order of the f32 sum differs;
  * K2 equal bit for bit to K5's plain version on the gathered rows, ids
    up to 2^30 (byte planes 2 and 3 non-zero) and at R=24, which the JAX
    kernels do not take; its distances there also within the same
    tolerance of a numpy sum, in chunk order, of the bf16 entries of JAX's
    packing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bang_tpu.ops import pq as jpq
from bang_tpu.ops import pq_pallas as jpp
from bang_tpu_torch.ops import _build
from bang_tpu_torch.ops import pq_kernels as k
from bang_tpu_torch.ops.pq import pq_lookup as pq_lookup_f32
from bang_tpu_torch.ops.probe_kernels import frontier_packed_plain


def _close(got, want, rtol, atol_scale):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = rtol * np.abs(want) + atol_scale
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max err {err.max()}"


def _tables(rng, q, m):
    return (rng.normal(size=(q, m, 256)).astype(np.float32) ** 2)


def _hand_rows(rng, ids, m):
    """Fused rows [P, 4R + m*R] for arbitrary ids [P, R] (no N-row table
    needed), the byte layout of pack_frontier_rows."""
    p, r = ids.shape
    planes = ids.astype("<i4").view(np.uint8).reshape(p, r, 4).transpose(0, 2, 1)
    codes = rng.integers(0, 256, size=(p, m * r), dtype=np.uint8)
    return np.concatenate([planes.reshape(p, 4 * r), codes], axis=1)


def _fused_case(rng, q, n, r, m, beam, id_hi):
    ids = rng.integers(0, id_hi, size=(n, r), dtype=np.int32)
    rows = _hand_rows(rng, ids, m)
    parents = rng.integers(0, n, size=(q, beam), dtype=np.int32)
    return _tables(rng, q, m), rows, parents, ids


def _k2(tables, rows, parents):
    """K2 through its wrapper on the port's packing of `tables`."""
    packed = k.pack_tables(torch.from_numpy(tables))
    return k.frontier_lookup(packed, torch.from_numpy(rows), torch.from_numpy(parents))


def _numpy_bf16_sums(tables, rows, parents, r, m):
    """dists [Q, beam*R]: JAX's packed words unpacked in numpy and summed
    in f32 in chunk order 0..m-1, independent of the port's code."""
    q, beam = parents.shape
    words = np.asarray(jpp.pack_tables(jnp.asarray(tables))).view(np.uint32)
    halves = np.stack([words & 0xFFFF, words >> 16], axis=-1).reshape(q, m, 256)
    entries = (halves << 16).astype(np.uint32).view(np.float32)
    codes = rows[parents][..., 4 * r :].reshape(q, beam, m, r).astype(np.int64)
    acc = np.zeros((q, beam, r), np.float32)
    for c in range(m):
        acc += np.take_along_axis(entries[:, None, c, :], codes[:, :, c, :], axis=2)
    return acc.reshape(q, beam * r)


def test_k1_plain_matches_jax_lookup():
    """The CPU's scattered route: ops/pq.pq_lookup on f32 tables, as JAX's
    `pq_lookup` there."""
    rng = np.random.default_rng(0)
    tables = _tables(rng, 12, 16)
    codes = rng.integers(0, 256, size=(12, 96, 16), dtype=np.uint8)
    want = np.asarray(jpq.pq_lookup(jnp.asarray(tables), jnp.asarray(codes)))
    got = pq_lookup_f32(torch.from_numpy(tables), torch.from_numpy(codes))
    _close(got, want, 1e-5, 1e-5 * np.abs(want).max(-1, keepdims=True))


@pytest.mark.parametrize("r,m,beam", [(64, 16, 2), (24, 12, 4)])
def test_k2_plain_matches_jax_decode(r, m, beam):
    rng = np.random.default_rng(r)
    tables, rows, parents, _ = _fused_case(rng, 10, 300, r, m, beam, 1 << 20)
    want_ids, want_d = jpp.frontier_decode_xla(
        jnp.asarray(tables), jnp.asarray(rows)[parents], m, r, beam
    )
    got_ids, got_d = k.frontier_decode_plain(
        *map(torch.from_numpy, (tables, rows, parents)))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    want_d = np.asarray(want_d)
    _close(got_d, want_d, 1e-5, 1e-5 * np.abs(want_d).max(-1, keepdims=True))


@pytest.mark.parametrize("r,m,beam", [pytest.param(64, 16, 2, id="64-16"),
                                       pytest.param(32, 8, 2, id="32-8"),
                                       pytest.param(64, 16, 4, id="64-16-C256")])
def test_k1_plain_matches_pallas_interpret(r, m, beam):
    """K1 on the port's packing against the Pallas kernel on JAX's, C =
    beam * R candidates; C=256 takes the Pallas kernel's 128-lane slices."""
    rng = np.random.default_rng(10 + r + beam)
    tables = _tables(rng, 16, m)
    codes = rng.integers(0, 256, size=(16, beam * r, m), dtype=np.uint8)
    packed_j = jpp.pack_tables(jnp.asarray(tables))
    packed = k.pack_tables(torch.from_numpy(tables))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    want = np.asarray(jpp.pq_lookup_packed(packed_j, jnp.asarray(codes), interpret=True))
    got = k.pq_lookup(packed, torch.from_numpy(codes))
    _close(got, want, 1e-5, 1e-5 * np.abs(want).max(-1, keepdims=True))


@pytest.mark.parametrize("r,m,beam", [(64, 16, 2), (32, 8, 4)])
def test_k2_plain_matches_pallas_interpret(r, m, beam):
    """Against the Pallas frontier kernel on the same packed words: ids
    bit-exact with planes 2 and 3 in play (ids up to 2^30), distances to
    f32 summation order."""
    rng = np.random.default_rng(20 + r)
    tables, rows, parents, _ = _fused_case(rng, 16, 200, r, m, beam, 1 << 30)
    packed_j = jpp.pack_tables(jnp.asarray(tables))
    packed = k.pack_tables(torch.from_numpy(tables))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    want_ids, want_d = jpp.frontier_lookup(
        packed_j, jnp.asarray(rows)[parents],
        m=m, r=r, beam=beam, tile_q=8, interpret=True,
    )
    got_ids, got_d = k.frontier_lookup(packed, *map(torch.from_numpy, (rows, parents)))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    want_d = np.asarray(want_d)
    _close(got_d, want_d, 1e-5, 1e-5 * np.abs(want_d).max(-1, keepdims=True))


def test_k2_plain_matches_pallas_dma_interpret():
    """Against the in-kernel-DMA Pallas frontier on its tiled rows, N >
    65,536 (byte plane 2 set), tile_q=8: the flat prefix of each tiled row
    is the port's fused row."""
    rng = np.random.default_rng(40)
    n, r, m, beam, q = 70_000, 64, 8, 2, 16
    adj = rng.integers(0, n, size=(n, r), dtype=np.int32)
    codes = rng.integers(0, 256, size=(n, m), dtype=np.uint8)
    tiled = jpp.pack_frontier_rows_tiled(adj, codes)
    rows = k.pack_frontier_rows(torch.from_numpy(adj), torch.from_numpy(codes))
    np.testing.assert_array_equal(
        rows.numpy(), tiled.reshape(n, -1)[:, : r * (4 + m)])
    tables = _tables(rng, q, m)
    parents = rng.integers(0, n, size=(q, beam), dtype=np.int32)
    want_ids, want_d = jpp.frontier_lookup_dma(
        jpp.pack_tables(jnp.asarray(tables)), jnp.asarray(tiled),
        jnp.asarray(parents), m=m, r=r, beam=beam, tile_q=8, interpret=True,
    )
    got_ids, got_d = k.frontier_lookup(
        k.pack_tables(torch.from_numpy(tables)), rows, torch.from_numpy(parents))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert (got_ids.numpy() >= 1 << 16).any()
    want_d = np.asarray(want_d)
    _close(got_d, want_d, 1e-5, 1e-5 * np.abs(want_d).max(-1, keepdims=True))


@pytest.mark.parametrize("r,m,beam", [(32, 32, 2), (24, 12, 4), (64, 64, 2)])
def test_k2_ids_bit_exact_hand_packed(r, m, beam):
    """Every id of every parent comes back, up to 2^30, at any R; the
    distances are K5's plain version's on the gathered rows, bit for bit,
    and within tolerance of the numpy sum of JAX's bf16 entries."""
    rng = np.random.default_rng(30 + r)
    tables, rows, parents, ids = _fused_case(rng, 9, 150, r, m, beam, 1 << 30)
    assert (ids >= 1 << 24).any()  # plane 3 is non-zero somewhere
    got_ids, got_d = _k2(tables, rows, parents)
    np.testing.assert_array_equal(got_ids.numpy(), ids[parents].reshape(9, beam * r))
    want_ids, want_d = frontier_packed_plain(
        k.pack_tables(torch.from_numpy(tables)), torch.from_numpy(rows[parents]), r, 4)
    assert torch.equal(got_ids, want_ids) and torch.equal(got_d, want_d)
    ref = _numpy_bf16_sums(tables, rows, parents, r, m)
    _close(got_d, ref, 1e-5, 1e-5 * np.abs(ref).max(-1, keepdims=True))


def test_k2_out_of_range_parents_give_invalid_lanes():
    """A parent outside [0, N) gives id -1 and +inf on its R lanes, the
    other parent's lanes as usual."""
    rng = np.random.default_rng(2)
    tables, rows, parents, ids = _fused_case(rng, 3, 40, 8, 4, 2, 40)
    parents[0, 1], parents[1, 0] = -1, 40
    got_ids, got_d = _k2(tables, rows, parents)
    bad = np.zeros((3, 2), bool)
    bad[0, 1] = bad[1, 0] = True
    lanes = np.repeat(bad, 8, axis=1)
    assert (got_ids.numpy()[lanes] == -1).all() and np.isinf(got_d.numpy()[lanes]).all()
    want = ids[np.clip(parents, 0, 39)].reshape(3, 16)
    np.testing.assert_array_equal(got_ids.numpy()[~lanes], want[~lanes])
    assert np.isfinite(got_d.numpy()[~lanes]).all()


def test_cpu_wrappers_run_plain_and_count_nothing():
    rng = np.random.default_rng(1)
    k.reset_launch_counts()
    tables, rows, parents, _ = _fused_case(rng, 4, 50, 8, 4, 2, 50)
    tt, rt, pt = map(torch.from_numpy, (tables, rows, parents))
    packed = k.pack_tables(tt)
    ids, d = k.frontier_lookup(packed, rt, pt)
    p_ids, p_d = k.frontier_lookup_plain(packed, rt, pt)
    assert torch.equal(ids, p_ids) and torch.equal(d, p_d)
    codes = torch.from_numpy(rng.integers(0, 256, size=(4, 16, 4), dtype=np.uint8))
    assert torch.equal(k.pq_lookup(packed, codes), k.lookup_packed_plain(packed, codes))
    assert k.pq_lookup.launches == 0 and k.frontier_lookup.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    packed = torch.zeros((4, 8, 128), dtype=torch.int32)
    codes = torch.zeros((4, 16, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        k.pq_lookup(packed, codes.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        k.pq_lookup(packed.transpose(0, 1).contiguous().transpose(0, 1), codes)
    with pytest.raises(ValueError, match="contiguous"):
        k.pq_lookup(packed, codes.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="do not match"):
        k.pq_lookup(packed, codes[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="do not match"):
        k.pq_lookup(packed, codes[:2].contiguous())
    with pytest.raises(ValueError, match="128"):
        k.pq_lookup(torch.zeros((4, 8, 256), dtype=torch.int32), codes)
    with pytest.raises(ValueError, match="m=500"):
        k.pq_lookup(torch.zeros((1, 500, 128), dtype=torch.int32),
                    torch.zeros((1, 2, 500), dtype=torch.uint8))
    with pytest.raises(ValueError, match="16-byte"):
        k.pq_lookup(torch.zeros(4 * 8 * 128 + 1, dtype=torch.int32)[1:].view(4, 8, 128),
                    codes)
    rows = torch.zeros((10, 8 * 12), dtype=torch.uint8)
    parents = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        k.frontier_lookup(packed, rows, parents.long())
    with pytest.raises(ValueError, match="not R"):
        k.frontier_lookup(packed, rows[:, :-1].contiguous(), parents)
    with pytest.raises(ValueError, match="beam"):
        k.frontier_lookup(packed, rows, torch.zeros((4, 17), dtype=torch.int32))
    with pytest.raises(ValueError, match="128"):
        k.frontier_lookup(torch.zeros((4, 8, 256), dtype=torch.int32), rows, parents)
    with pytest.raises(ValueError, match="16-byte"):
        k.frontier_lookup(torch.zeros(4 * 8 * 128 + 1, dtype=torch.int32)[1:].view(4, 8, 128),
                          rows, parents)
    # m=440: the 220 KB table fits, the table and one 28 KB row do not
    with pytest.raises(ValueError, match="shared memory"):
        k.frontier_lookup(torch.zeros((1, 440, 128), dtype=torch.int32),
                          torch.zeros((2, 64 * 444), dtype=torch.uint8),
                          torch.zeros((1, 1), dtype=torch.int32))


def test_k1_candidate_group_bound():
    """K1 stages the table and at least one code row (m rounded up to an odd
    number of 16-byte units): m=453 fits, so any C goes through in groups;
    at m=454 the 227 KB table leaves no room for a row."""
    assert _build.MAX_LOOKUP_CHUNKS == 453
    assert 453 * 512 + 16 * 29 <= _build.MAX_SHARED_BYTES < 454 * 512 + 16
    packed = torch.zeros((1, 453, 128), dtype=torch.int32)
    codes = torch.zeros((1, 1024, 453), dtype=torch.uint8)
    assert k.pq_lookup(packed, codes).shape == (1, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        k.pq_lookup(torch.zeros((1, 454, 128), dtype=torch.int32),
                    torch.zeros((1, 2, 454), dtype=torch.uint8))


@pytest.mark.parametrize("q,c", [(3, 0), (0, 5)])
@pytest.mark.parametrize("name", ["pq_lookup", "lookup_packed"])
def test_k1_counts_no_launch_for_an_empty_batch(monkeypatch, name, q, c):
    """On the kernel's route an empty batch returns an empty [Q, C] result
    before any launch, and its wrapper's count stays where it was."""
    from bang_tpu_torch.ops import probe_kernels as prk

    wrapper = getattr(k, name)
    monkeypatch.setattr(prk, "route", lambda *t: "cuda")
    monkeypatch.setattr(_build, "load_library", lambda n: pytest.fail("launched"))
    k.reset_launch_counts()
    out = wrapper(torch.zeros((q, 8, 128), dtype=torch.int32),
                  torch.zeros((q, c, 8), dtype=torch.uint8))
    assert out.shape == (q, c) and out.dtype == torch.float32
    assert all(kern.launches == 0 for kern in k.KERNELS)


def test_k1_refuses_f32_tables():
    """The f32 [Q, m, 256] tables of the CPU's routes, passed to K1 by
    mistake, raise instead of being read as words."""
    with pytest.raises(ValueError, match="int32"):
        k.pq_lookup(torch.zeros((4, 8, 256)), torch.zeros((4, 16, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="int32"):
        k.pq_lookup(torch.zeros((4, 8, 128)), torch.zeros((4, 16, 8), dtype=torch.uint8))


def test_k1_sums_in_chunk_order_equal_to_k2():
    """K1's plain version on the codes of gathered fused rows is K2's plain
    version's distances bit for bit, and within tolerance of the numpy sum
    of JAX's bf16 entries in chunk order."""
    rng = np.random.default_rng(5)
    r, m, beam = 24, 12, 4
    tables, rows, parents, _ = _fused_case(rng, 9, 150, r, m, beam, 1 << 20)
    _, want = _k2(tables, rows, parents)
    codes = rows[parents][..., 4 * r :].reshape(9, beam, m, r).transpose(0, 1, 3, 2)
    got = k.pq_lookup(k.pack_tables(torch.from_numpy(tables)),
                      torch.from_numpy(np.ascontiguousarray(codes.reshape(9, beam * r, m))))
    assert torch.equal(got, want)
    ref = _numpy_bf16_sums(tables, rows, parents, r, m)
    _close(got, ref, 1e-5, 1e-5 * np.abs(ref).max(-1, keepdims=True))


def test_k2_refuses_f32_tables():
    """The f32 [Q, m, 256] tables of the CPU's routes, passed to K2
    by mistake, raise instead of being read as words."""
    tables = torch.zeros((4, 8, 256))
    rows = torch.zeros((10, 8 * 12), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32"):
        k.frontier_lookup(tables, rows, torch.zeros((4, 2), dtype=torch.int32))


def test_build_command_names_sm_90a():
    cmd = _build.nvcc_command("csrc/pq_lookup.cu", "out.so", "nvcc")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-O3" in cmd
    for name in _build.SIGNATURES:
        assert (_build.SRC_DIR / f"{name}.cu").exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR
