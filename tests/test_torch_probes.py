"""The probe wrappers (bang_tpu_torch.ops.probe_kernels: `lookup_packed`,
which launches K1, and K5-K6) and the probe scripts
(bang_tpu_torch.scripts), on the CPU.

Here the wrappers take their plain versions (the tensors lie on the CPU);
chip_smoke.py compares the CUDA kernels with the same plain versions on the
card. Held against the JAX package:
  * `pack_tables` bit-identical to `pq_pallas.pack_tables`, with entries
    that round up to the next bf16 and ones that set the int32 sign bit;
  * the port's `lookup_v2`, `lookup_flat`, `v6`, `v7` and `fused_lookup`
    against the scripts' own Pallas kernels in interpret mode: rtol 1e-5
    plus atol 1e-5 x the row's largest value (both sides sum the same bf16
    entries in f32; only the order differs), ids bit-exact. The JAX scripts
    do 1M-point work at import, so the kernels are compiled from their
    source: only the kernel body and its pallas_call wrapper, with
    `pl.pallas_call` passing interpret=True. As a second opinion, against
    `pq_lookup_packed` / `frontier_lookup` in interpret mode;
  * `row_gather` bit-exact against numpy `rows[par]`, the probe's `want`.
"""

import ast
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bang_tpu.ops import pq_pallas as jpp
from bang_tpu_torch.ops import _build
from bang_tpu_torch.ops import pq_kernels as pk
from bang_tpu_torch.ops import probe_kernels as prk
from bang_tpu_torch.scripts import (
    exp_dma_tiled,
    exp_flat2,
    exp_flat_lookup,
    exp_fused,
    exp_lookup,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
Q, C = 32, 128


def _script_kernels(path, names):
    """The functions `names` of a JAX script, compiled from its source
    without running the rest of it; `pl.pallas_call` there interprets."""
    tree = ast.parse((REPO / path).read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    interpreting = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    ns = {"functools": functools, "jax": jax, "jnp": jnp, "pl": interpreting,
          "pltpu": pltpu}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


@functools.lru_cache(maxsize=None)
def _jax_probe(name):
    where = {"lookup_v2": ("scripts/exp_lookup.py", "_kernel_v2"),
             "lookup_flat": ("scripts/exp_flat_lookup.py", "_kernel_flat"),
             "v6": ("scripts/exp_flat2.py", "_kernel_v6"),
             "v7": ("scripts/exp_flat2.py", "_kernel_v7"),
             "fused_lookup": ("scripts/exp_fused.py", "_kernel_fused")}
    path, body = where[name]
    return _script_kernels(path, [body, name])[name]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max(-1, keepdims=True)
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max err {err.max()}"


def _tables(rng, q, m):
    return rng.normal(size=(q, m, 256)).astype(np.float32) ** 2


def _packed(tables):
    return pk.pack_tables(torch.from_numpy(tables))


def test_pack_tables_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    t = (rng.normal(size=(5, 7, 256)) * 100).astype(np.float32)  # negatives too
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)  # bf16 spacing at 1.0
    t[0, 0, :8] = [one + ulp * 0.75,  # rounds up
                   one + ulp * 0.5,  # tie: to even (down, to 1.0)
                   one + ulp * 1.5,  # tie: to even (up)
                   one + ulp * 0.25,  # rounds down
                   -3.0, -1e-30, 65504.0, 3.4e38]
    t[1, 2, 1::2] = -np.abs(t[1, 2, 1::2]) - 1  # high half-words >= 0x8000
    want = np.asarray(jpp.pack_tables(jnp.asarray(t)))
    got = pk.pack_tables(torch.from_numpy(t))
    assert got.dtype == torch.int32 and got.shape == (5, 7, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any()  # the sign bit is in play
    assert (got.numpy()[0, 0, 0] & 0xFFFF) == 0x3F81  # 1 + 0.75 ulp rounded up


def test_unpack_tables_inverts_the_packing():
    t = _tables(np.random.default_rng(1), 3, 5)
    back = pk.unpack_tables(_packed(t))
    want = torch.from_numpy(t).to(torch.bfloat16).float()
    assert back.shape == (3, 5, 256) and torch.equal(back, want)


def _codes(rng, q, c, m):
    return rng.integers(0, 256, size=(q, c, m), dtype=np.uint8)


@pytest.mark.parametrize("name,m", [(n, m) for n in ("lookup_v2", "lookup_flat", "v6")
                                    for m in (8, 16)])
def test_lookup_probes_match_the_script_kernels(name, m):
    rng = np.random.default_rng(m)
    tables = _tables(rng, Q, m)
    codes = _codes(rng, Q, C, m)
    pj = jpp.pack_tables(jnp.asarray(tables))
    fn = _jax_probe(name)
    flat = codes.reshape(Q, C * m)
    if name == "lookup_v2":
        want = fn(pj, jnp.asarray(codes), tile_q=Q)
        got = exp_lookup.lookup_v2(_packed(tables), torch.from_numpy(codes))
    elif name == "lookup_flat":
        want = fn(pj, jnp.asarray(flat), m, tile_q=Q)
        got = exp_flat_lookup.lookup_flat(_packed(tables), torch.from_numpy(flat), m)
    else:
        want = fn(pj, jnp.asarray(flat), tile_q=Q)
        got = exp_flat2.v6(_packed(tables), torch.from_numpy(flat))
    _close(got, want)
    # second opinion: the scripts' own reference, the library kernel
    _close(got, jpp.pq_lookup_packed(pj, jnp.asarray(codes), interpret=True))


def _fused_rows(rng, q, beam, r, m, id_hi=1 << 30):
    """Gathered fused rows [Q, beam, 4R + m*R] and their ids [Q, beam, R]."""
    ids = rng.integers(0, id_hi, size=(q, beam, r), dtype=np.int32)
    planes = ids.astype("<i4").view(np.uint8).reshape(q, beam, r, 4)
    planes = planes.transpose(0, 1, 3, 2).reshape(q, beam, 4 * r)
    codes = rng.integers(0, 256, size=(q, beam, m * r), dtype=np.uint8)
    return np.concatenate([planes, codes], axis=2), ids


@pytest.mark.parametrize("r,m", [(32, 8), (64, 16)])
def test_v7_matches_the_script_kernel(r, m):
    beam = C // r
    rng = np.random.default_rng(r + m)
    tables = _tables(rng, Q, m)
    rows, _ = _fused_rows(rng, Q, beam, r, m)
    cm_rows = np.ascontiguousarray(rows[..., 4 * r :])  # chunk-major codes only
    pj = jpp.pack_tables(jnp.asarray(tables))
    want = _jax_probe("v7")(pj, jnp.asarray(cm_rows), tile_q=Q)
    got = exp_flat2.v7(_packed(tables), torch.from_numpy(cm_rows))
    _close(got, want)
    # second opinion: the same codes candidate-major through pq_lookup_packed
    nrm = cm_rows.reshape(Q, beam, m, r).transpose(0, 1, 3, 2).reshape(Q, C, m)
    _close(got, jpp.pq_lookup_packed(pj, jnp.asarray(nrm), interpret=True))


@pytest.mark.parametrize("r,m", [(32, 8), (64, 16)])
def test_fused_lookup_matches_the_script_kernel(r, m):
    """Ids bit-exact with byte planes 2 and 3 in play (ids up to 2^30)."""
    beam = C // r
    rng = np.random.default_rng(100 + r)
    tables = _tables(rng, Q, m)
    rows, ids = _fused_rows(rng, Q, beam, r, m)
    assert (ids >= 1 << 24).any()
    pj = jpp.pack_tables(jnp.asarray(tables))
    want_ids, want_d = _jax_probe("fused_lookup")(pj, jnp.asarray(rows), m, r, beam,
                                                  tile_q=Q)
    got_ids, got_d = exp_fused.fused_lookup(_packed(tables), torch.from_numpy(rows),
                                            m, r, beam)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_ids.numpy(), ids.reshape(Q, C))
    _close(got_d, want_d)
    # second opinion: the library's fused-row kernel
    lib_ids, lib_d = jpp.frontier_lookup(pj, jnp.asarray(rows), m=m, r=r, beam=beam,
                                         tile_q=8, interpret=True)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(lib_ids))
    _close(got_d, lib_d)


@pytest.mark.parametrize("width", [100, 4352, 40 * 128])
def test_row_gather_bit_exact_against_numpy(width):
    rng = np.random.default_rng(width)
    rows = rng.integers(0, 256, size=(300, width), dtype=np.uint8)
    par = rng.integers(0, 300, size=(57,), dtype=np.int32)
    par[:4] = [5, 9, 77, 299]
    got = prk.row_gather(torch.from_numpy(rows), torch.from_numpy(par))
    np.testing.assert_array_equal(got.numpy(), rows[par])
    tiled = rows.reshape(300, -1, 128) if width % 128 == 0 else rows
    probe = exp_dma_tiled.sublane_probe(torch.from_numpy(tiled), torch.from_numpy(par))
    np.testing.assert_array_equal(probe.numpy().reshape(57, width), rows[par])


def test_lookup_packed_is_k1_with_its_own_count():
    """`lookup_packed` computes K1's function with K1's checks (the
    shared-memory bound included) and counts apart from `pq_lookup`."""
    rng = np.random.default_rng(3)
    packed = _packed(_tables(rng, 6, 12))
    codes = torch.from_numpy(_codes(rng, 6, 40, 12))
    pk.reset_launch_counts()
    assert torch.equal(prk.lookup_packed(packed, codes), pk.pq_lookup(packed, codes))
    assert torch.equal(prk.lookup_packed(packed, codes),
                       prk.lookup_packed_plain(packed, codes))
    assert prk.lookup_packed.launches == 0 and pk.pq_lookup.launches == 0
    with pytest.raises(ValueError, match="shared memory"):
        prk.lookup_packed(torch.zeros((1, 454, 128), dtype=torch.int32),
                          torch.zeros((1, 2, 454), dtype=torch.uint8))


def test_wrappers_reject_what_the_kernels_do_not_take():
    packed = torch.zeros((4, 8, 128), dtype=torch.int32)
    codes = torch.zeros((4, 16, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32"):
        prk.lookup_packed(packed.float(), codes)
    with pytest.raises(ValueError, match="128"):
        prk.lookup_packed(torch.zeros((4, 8, 256), dtype=torch.int32), codes)
    with pytest.raises(ValueError, match="do not match"):
        prk.lookup_packed(packed, codes[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="m=500"):
        prk.lookup_packed(torch.zeros((1, 500, 128), dtype=torch.int32),
                          torch.zeros((1, 2, 500), dtype=torch.uint8))
    rows = torch.zeros((4, 2, 12 * 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="id_planes"):
        prk.frontier_packed(packed, rows, 8, 2)
    with pytest.raises(ValueError, match="not \\(id_planes"):
        prk.frontier_packed(packed, rows, 8, 0)
    with pytest.raises(ValueError, match="R=65"):
        prk.frontier_packed(packed, rows, 65, 4)
    with pytest.raises(ValueError, match="beam"):
        prk.frontier_packed(packed, torch.zeros((4, 17, 96), dtype=torch.uint8), 8, 4)
    table = torch.zeros((10, 7), dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        prk.row_gather(table, torch.tensor([0, 10], dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        prk.row_gather(table, torch.tensor([-1], dtype=torch.int32))
    with pytest.raises(ValueError, match="1-d"):
        prk.row_gather(table, torch.zeros((2, 2), dtype=torch.int32))


def test_kernel_registry_covers_k1_to_k6():
    """Seven wrappers (K1-K6 and the traversal's visited filter), six
    kernel sources (`lookup_packed` launches K1's), the captured search's
    WHILE-node source, graph_loop.cu (models/compiled.py), which is no
    kernel wrapper, and the stage clock's stamp (ops/stage_clock), which
    counts its launches in the last slot but is no compute kernel;
    resetting zeroes it too."""
    from bang_tpu_torch.ops.stage_clock import stage_clock

    names = [k.__name__ for k in pk.KERNELS]
    assert names == ["pq_lookup", "frontier_lookup", "exact_frontier",
                     "lookup_packed", "frontier_packed", "row_gather", "visited_filter"]
    assert set(_build.SIGNATURES) == (set(names) - {"lookup_packed"}
                                      | {"graph_loop", "stage_clock"})
    assert sorted(p.stem for p in _build.SRC_DIR.glob("*.cu")) == sorted(_build.SIGNATURES)
    assert _build.COUNTED == (*names, "stage_clock")
    for k in (*pk.KERNELS, stage_clock):
        k.launches = 3
    pk.reset_launch_counts()
    assert all(k.launches == 0 for k in (*pk.KERNELS, stage_clock))


TINY = {
    exp_lookup: dict(q=16, m=8, c=128, n=500, gather_shapes=((50, 64), (30, 100))),
    exp_flat_lookup: dict(n=400, r=32, m=8, q=16, small=10),
    exp_flat2: dict(n=400, r=32, m=8, q=16),
    exp_fused: dict(n=400, r=32, m=8, q=16),
    exp_dma_tiled: dict(sublane=dict(n=300, tiled=(5120,), flat_widths=(4352, 100), p=40),
                        frontier=dict(n=500, r=32, m=8, q=16),
                        exact=dict(n=400, r=16, d=24, q=16)),
}


@pytest.mark.parametrize("mod", list(TINY), ids=lambda m: m.__name__.split(".")[-1])
def test_probe_script_runs_on_the_cpu(mod, capsys):
    pk.reset_launch_counts()
    res = mod.main("cpu", iters=2, **TINY[mod])
    variants = {k: v for k, v in res.items() if isinstance(v, dict)}
    assert variants and all(v["ms"] is None and v["max_abs_err"] == 0.0
                            for v in variants.values())
    out = capsys.readouterr().out
    assert out.count("not measured (cpu)") == len(variants)
    assert all(k.launches == 0 for k in pk.KERNELS)


def test_probe_scripts_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the CUDA-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        exp_fused.main("cuda", n=10, r=4, m=2, q=2)
