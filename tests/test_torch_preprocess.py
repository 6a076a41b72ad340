"""The DiskANN converter and the MIPS transforms: the port's
formats/preprocess.py against the JAX package's.

A `_disk.index` written here in DiskANN's sector layout (4096-byte
sectors; sector 0 the metadata, then whole node records per sector,
BANG_Base/bang_preprocess.py:27-110) is read by both packages into
identical arrays; `convert`, the library call and both CLI subcommands
write byte-identical files.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from bang_tpu.formats import preprocess as jpp
from bang_tpu_torch.constants import NUMPY_TO_DTYPE_CODE
from bang_tpu_torch.formats import preprocess as pp
from bang_tpu_torch.formats.bin_io import save_bin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_diskann_index(path, vecs, adj_lists, medoid):
    """DiskANN's `_disk.index` for `vecs` (f32 or u8) and neighbor lists."""
    n, d = vecs.shape
    vec_bytes = d * vecs.dtype.itemsize
    degree = max(len(a) for a in adj_lists)
    max_node_len = vec_bytes + 4 + 4 * degree
    per_sector = pp.SECTOR_LEN // max_node_len
    n_sectors = -(-n // per_sector)
    file_size = (n_sectors + 1) * pp.SECTOR_LEN
    buf = bytearray(file_size)
    struct.pack_into("<ii", buf, 0, 1, 1)
    struct.pack_into("<QQQQQQQQQ", buf, 8, n, d, medoid, max_node_len, per_sector,
                     0, 0, 0, file_size)
    for i in range(n):
        off = (i // per_sector + 1) * pp.SECTOR_LEN + (i % per_sector) * max_node_len
        buf[off : off + vec_bytes] = vecs[i].tobytes()
        struct.pack_into("<I", buf, off + vec_bytes, len(adj_lists[i]))
        nb = np.asarray(adj_lists[i], "<u4").tobytes()
        buf[off + vec_bytes + 4 : off + vec_bytes + 4 + len(nb)] = nb
    with open(path, "wb") as f:
        f.write(bytes(buf))
    return degree


def _index(tmp_path, dtype):
    rng = np.random.default_rng(0 if dtype == np.float32 else 1)
    n, d = 53, 8 if dtype == np.float32 else 20
    if dtype == np.float32:
        vecs = rng.normal(size=(n, d)).astype(np.float32)
    else:
        vecs = rng.integers(0, 256, (n, d)).astype(np.uint8)
    adj = [list(rng.choice(n, size=rng.integers(1, 6), replace=False)) for _ in range(n)]
    src = tmp_path / "x_disk.index"
    degree = write_diskann_index(src, vecs, adj, medoid=11)
    code = NUMPY_TO_DTYPE_CODE[np.dtype(dtype).name]
    return src, vecs, adj, d, code, degree


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
def test_read_diskann_matches_jax(tmp_path, dtype):
    src, vecs, adj, d, code, degree = _index(tmp_path, dtype)
    got, meta = pp.read_diskann_index(src, d, code, degree)
    want, want_meta = jpp.read_diskann_index(src, d, code, degree)
    for field in ("vectors", "adj", "degrees"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert got.medoid == want.medoid == 11
    assert vars(meta) == vars(want_meta)
    np.testing.assert_array_equal(got.vectors, vecs)
    for i, nbrs in enumerate(adj):
        assert sorted(int(x) for x in nbrs) == got.adj[i][: got.degrees[i]].tolist()
        assert (got.adj[i][got.degrees[i] :] == i).all()
    with pytest.raises(ValueError, match="dim mismatch"):
        pp.read_diskann_index(src, d + 1, code, degree)


def _files(prefix):
    return [open(prefix + suffix, "rb").read()
            for suffix in ("_disk.bin", "_disk_metadata.bin")]


def test_convert_and_cli_write_jax_bytes(tmp_path):
    src, _, _, d, code, degree = _index(tmp_path, np.uint8)
    jpp.convert_diskann_index(src, str(tmp_path / "jax"), d, code, degree)
    meta = pp.convert_diskann_index(src, str(tmp_path / "lib"), d, code, degree)
    assert meta.n == 53 and meta.degree == degree
    want = _files(str(tmp_path / "jax"))
    assert _files(str(tmp_path / "lib")) == want

    q = np.random.default_rng(2).normal(size=(6, 5)).astype(np.float32)
    q[3] = 0.0  # a zero query keeps its zeros
    save_bin(tmp_path / "q.bin", q)
    jpp.main(["mips-queries", str(tmp_path / "q.bin"), str(tmp_path / "q_jax.bin")])
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("BANG_FORCE_CPU", None)
    for args in (["convert", str(src), str(tmp_path / "cli_disk.bin"), str(d),
                  str(code), str(degree)],
                 ["mips-queries", str(tmp_path / "q.bin"), str(tmp_path / "q_cli.bin")]):
        res = subprocess.run([sys.executable, "-m", "bang_tpu_torch.formats.preprocess",
                              *args], env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
    assert _files(str(tmp_path / "cli")) == want
    assert (tmp_path / "q_cli.bin").read_bytes() == (tmp_path / "q_jax.bin").read_bytes()


def test_mips_transforms_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 7)).astype(np.float32) * 3
    got, want = pp.preprocess_data_mips(x), jpp.preprocess_data_mips(x)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    q = rng.normal(size=(9, 7)).astype(np.float32)
    assert pp.preprocess_queries_mips(q).tobytes() == jpp.preprocess_queries_mips(q).tobytes()
    # the augmented L2 order is the inner-product order
    qa = pp.preprocess_queries_mips(q)
    l2 = ((qa[:, None] - got[None]) ** 2).sum(-1)
    ip = q @ x.T
    np.testing.assert_array_equal(np.argmin(l2, 1), np.argmax(ip, 1))
