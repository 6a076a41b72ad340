"""Offline builders of the port (`accel`, `vamana`). File formats are the JAX
package's numpy layers (`bang_tpu.formats`), shared as they are."""
