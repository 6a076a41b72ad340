"""Counterparts of the JAX package's Pallas layout probes in `scripts/`.

Each module has the name of its JAX script and defines that script's TPU
kernels under their own names, as wrappers over the port's kernels:
`lookup_packed` (K1's kernel) and K5-K6 (ops/probe_kernels.py), K1-K2
(ops/pq_kernels.py) and K3 (ops/exact_kernels.py):

  exp_lookup        lookup_v2 (K1) beside v1, K1 itself; the aligned-row
                    gather study (K6)
  exp_flat_lookup   lookup_flat (K1) on rows gathered by K6
  exp_flat2         v6 (K1) and v7 (K5 without id planes)
  exp_fused         fused_lookup (K5 with id planes)
  exp_dma_tiled     sublane_probe (K6); K2 against K6 + K5; K3

Each has `main(device="cuda", **sizes)`, does no work at import, makes its
data from seeded torch.Generators on the device, checks every result
against its reference (raising, never catching), prints one line per
variant and returns a dict. On the card times are CUDA-event means; on the
CPU the kernels' plain versions run and no time is taken.

    python -m bang_tpu_torch.scripts.exp_lookup       # on a CUDA card
"""
