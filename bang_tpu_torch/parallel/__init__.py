"""Multi-device search (port of bang_tpu/parallel): a single-controller
(data, model) mesh of torch devices (sharded.py)."""

from bang_tpu_torch.parallel.base_tp import (  # noqa: F401
    ShardedBaseSearcher,
    make_base_step_tp,
    make_sampled_entry_tp,
)
from bang_tpu_torch.parallel.partition import ShardedIndex, build_sharded_index  # noqa: F401
from bang_tpu_torch.parallel.pq_tp import (  # noqa: F401
    pq_lookup_tp,
    shard_codes_by_chunk,
    shard_tables_by_chunk,
)
from bang_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    make_mesh,
    search_data_parallel,
    search_sharded,
)
