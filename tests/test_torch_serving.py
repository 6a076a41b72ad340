"""The serving harness (harness/serving.py) on the CPU: JAX's stream test on
the port's SearchServer, and the two latency probes on CPU indexes (the
host clock there: they time nothing on a device the index does not use).
"""

import numpy as np
import pytest

from bang_tpu.formats.bin_io import load_bin, load_truthset
from bang_tpu.utils.recall import calculate_recall
from bang_tpu_torch.api import BANGSearch
from bang_tpu_torch.harness.serving import (
    SearchServer,
    measure_base_device_step_ms,
    measure_device_batch_latency,
)
from bang_tpu_torch.models.base import BaseVariantSearcher
from bang_tpu_torch.models.index import device_index_from_files
from bang_tpu_torch.utils.config import SearchParams


def test_server_stream(tiny_index):
    """100 queries through batches of 48 (2 full + 1 padded): the ids of a
    BANGSearch warmed up at Q=48, recall >= 88, percentiles ordered."""
    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)
    gt_ids, gt_dists = load_truthset(prefix + "_gt.bin")
    params = SearchParams(L=48, k=10)
    server = SearchServer(prefix, variant="inmemory", batch_size=48, params=params,
                          device="cpu")
    ids, dists = server.query(queries[:100])
    assert ids.shape == (100, 10) and ids.dtype == np.int64
    assert len(server.latencies_ms) == 3
    ref = BANGSearch("inmemory", device="cpu")
    ref.bang_load(prefix)
    ref.bang_set_searchparams(10, 48)
    ref.bang_alloc(48)
    r_ids, r_d = ref.bang_query(queries[:100])
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(dists, r_d)
    assert calculate_recall(gt_ids[:100], ids, 10, gt_dists[:100]) >= 88.0
    pct = server.latency_percentiles()
    assert 0 < pct["p50"] <= pct["p90"] <= pct["p99"]
    server.close()
    assert server.engine._index is None


@pytest.mark.parametrize("variant", ["inmemory", "exactdistance", "base"])
@pytest.mark.parametrize("visited_mode", ["exact", "bloom"])
def test_latency_probes_on_cpu(tiny_index, variant, visited_mode):
    prefix = tiny_index["prefix"]
    queries = load_bin(prefix + "_query.bin", np.float32)[:32]
    params = SearchParams(L=24, k=10, beam_width=2, visited_mode=visited_mode)
    if variant == "base":
        ms = measure_base_device_step_ms(BaseVariantSearcher(prefix, device="cpu"),
                                         queries, params, n_chain=3)
    else:
        index = device_index_from_files(prefix, "cpu", variant)
        ms = measure_device_batch_latency(index, queries, params, variant, n_reps=2)
    assert np.isfinite(ms) and ms >= 0.0
    with pytest.raises(ValueError, match="HBM variants"):
        measure_device_batch_latency(None, queries, params, "base")
