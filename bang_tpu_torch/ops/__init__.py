"""Tensor ops of the port: PQ tables and lookup, exact L2, visited-set
filters, worklist merge, byte-plane ids, and the CUDA kernel wrappers
(`pq_kernels`, `exact_kernels`)."""
