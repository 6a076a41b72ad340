"""What decides `correct` has to fail: the control (the reference in the
program's place, in a lower precision) and a run whose timed path is
broken underneath, each on a tiny cell on the CPU."""

import numpy as np
import pytest

from gpubench import run
from gpubench.corpus import clustered
from gpubench.reference import l2_knn

SPEC = dict(n=4000, dim=128, query_pool=200, n_clusters=16, latent_dim=16, cluster_sigma=0.35,
            ambient_sigma=0.02, scale=28.0, offset=128.0, dtype="uint8")


def _judge(precision):
    base, pool = clustered.make(SPEC, 2**31 + 5, "cpu")
    gold = l2_knn.exact_knn(base, pool, l2_knn.GOLD)
    ids, dists = l2_knn.exact_knn(base, pool, 10, precision=precision)
    judge = l2_knn.Judge(base, pool, *gold, 10)
    judge.add(np.arange(200), ids.numpy(), dists.numpy())
    return judge


def test_control_in_bfloat16_is_not_correct():
    cfg = run.load_cell("sift1m-inmemory.batch10k")["config"]
    judge = _judge("bfloat16")
    assert judge.gap > 1e-3  # the limit is 0: an exact comparison
    assert not judge.correct(cfg)  # the run's own decision
    exact = _judge("float32")
    assert exact.gap == 0.0 and exact.recall() == 100.0 and exact.correct(cfg)


def _break(monkeypatch, fault):
    from bang_tpu_torch import api
    from bang_tpu_torch.models import traversal

    query = api.BANGSearch.bang_query

    def broken(self, queries):
        if fault == "state_unchanged":
            with monkeypatch.context() as m:
                m.setattr(traversal, "make_step", lambda *a, **k: (lambda state: state))
                return query(self, queries)
        if fault == "half_batch":
            half = max(1, len(queries) // 2)
            ids, dists = query(self, queries[:half])
            reps = -(-len(queries) // half)
            return np.tile(ids, (reps, 1))[: len(queries)], np.tile(dists, (reps, 1))[: len(queries)]
        ids, dists = query(self, queries)  # "answer_altered"
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 1) % self._dim()
        return ids, dists

    monkeypatch.setattr(api.BANGSearch, "bang_query", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["sift1m-inmemory.batch10k", "sift1m-exact.batch10k",
                                  "sift1m-exact.online4096"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    c = tiny(cell)
    _break(monkeypatch, fault)
    out = run.execute(c, 2**31 + 3, 1.0, False, "cpu")
    assert out["correct"] is False
    assert out["checks"]["dist_gap"]["value"] > 0 or out["checks"]["recall"]["value"] < 80
