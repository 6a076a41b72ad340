"""The measuring scripts the port's bench brought (bang_tpu_torch/scripts/
{exp_bloom,exp_large_l,profile_base_step,exp_iter_profile}.py) run on the
CPU at tiny sizes through `main(device="cpu", ...)` and return their keys.
On the CPU the kernel wrappers take their plain versions and no time is
taken (the ms fields are None); chip_smoke.py and the card run them at the
JAX scripts' sizes.
"""

import pytest
import torch

from bang_tpu_torch.scripts import (
    bundles,
    exp_bloom,
    exp_iter_profile,
    exp_large_l,
    profile_base_step,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's eager ops on one intra-op thread: under a parallel test
    run a thread pool per worker oversubscribes the cores and makes the
    builds many times slower (as tests/test_torch_scale_scripts.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("scripts") / "b")
    bundles.build_bundle(prefix, 2000, 16, 16, 8, "vamana", 64, device="cpu")
    return prefix


def _bloom(bundle, tmp_path):
    res = exp_bloom.main("cpu", prefix=bundle, nq=64, out=str(tmp_path / "b.json"))
    for mode in ("exact", "bloom"):
        assert {"recall", "qps", "qps_pipelined", "rep_s", "iters", "peak_gb"} <= set(
            res[mode])
        assert res[mode]["peak_gb"] is None  # no device memory on the CPU
    assert res["recall_delta"] == pytest.approx(
        res["bloom"]["recall"] - res["exact"]["recall"], abs=0.011)
    assert res["bloom_filter_bytes"] == 64 * (res["bf_entries"] + 1)
    assert (tmp_path / "b.json").exists()
    return res


def _large_l(bundle, tmp_path):
    res = exp_large_l.main("cpu", n=2000, d=16, r=16, q=32, l_grid=(16, 64), extra=8)
    assert list(res["per_L"]) == ["16", "64"] and res["layout"] == "scattered"
    for row in res["per_L"].values():
        assert row["exact"]["iters"] > 0 and row["bloom"]["recall"] >= 0
        assert "qps_pipelined" not in row["exact"]
    return res


def _profile_base(bundle, tmp_path):
    res = profile_base_step.main("cpu", q=32, r=16, m=8, d=16, n=20_000, extra=8,
                                 l_grid=(16, 32), iters=2)
    assert list(res["per_L"]) == ["16", "32"]
    assert set(res["per_L"]["16"]) == {"lookup_gather", "frontier_fused", "dedup_mask",
                                       "merge_sort", "merge_ranked", "select_parents",
                                       "parent_l2", "sum_ms"}
    assert all(v is None for v in res["per_L"]["32"].values())
    return res


def _iter_profile(bundle, tmp_path):
    res = exp_iter_profile.main("cpu", n=5000, q=64, r=16, m=8, iters=2)
    assert {"k2_frontier", "dedup_masks", "merge_select", "minus_k2",
            "full_iteration"} <= set(res)
    assert res["k2_frontier"] == {"ms": None, "max_abs_err": 0.0}
    assert res["shapes"]["L"] == 12 and res["shapes"]["mi"] == 24
    return res


@pytest.mark.parametrize("script", ["exp_bloom", "exp_large_l", "profile_base_step",
                                    "exp_iter_profile"])
def test_script_runs_on_the_cpu(script, bundle, tmp_path):
    run = {"exp_bloom": _bloom, "exp_large_l": _large_l,
           "profile_base_step": _profile_base, "exp_iter_profile": _iter_profile}[script]
    assert run(bundle, tmp_path)


@pytest.mark.parametrize("form", ["flags", "positional"])
def test_profile_base_step_takes_the_jax_flags(form, tmp_path):
    """profile_base_step's command line: scripts/profile_base_step.py's
    flags (--q --beam --r --m --d --n --extra --l-grid --out) onto main's
    keywords, and the bare OUT form."""
    import json

    out = tmp_path / "p.json"
    sizes = ["--q", "32", "--beam", "1", "--r", "16", "--m", "8", "--d", "16", "--n",
             "20000", "--extra", "8", "--l-grid", "16", "32", "--device", "cpu"]
    argv = sizes + (["--out", str(out)] if form == "flags" else [str(out)])
    res = profile_base_step.cli(argv)
    assert res["shapes"] == {"q": 32, "beam": 1, "r": 16, "m": 8, "d": 16, "n": 20000,
                             "extra": 8}
    assert list(res["per_L"]) == ["16", "32"]
    assert json.loads(out.read_text())["shapes"] == res["shapes"]
    with pytest.raises(SystemExit):
        profile_base_step.cli(sizes + ["--out", str(out), str(tmp_path / "other.json")])
