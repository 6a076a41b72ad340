"""File formats and builders of the port. `bin_io`, `graph`, `pq`,
`synthetic` and `preprocess` are the port's own copies of the JAX package's
numpy layers (the port imports nothing of `bang_tpu`); they write the same
bytes (`preprocess` also converts a DiskANN `_disk.index`). `accel` and
`vamana` build an index on the device, `bigbuild` one too large for it,
shard by shard."""
