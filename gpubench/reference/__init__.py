"""The plain reference the benchmark judges the program by.

Plain PyTorch on whatever device it is given. Nothing here imports the
program (bang_tpu_torch) or JAX, or reads a file the program wrote: it
works from the corpus and the queries the benchmark made, and reads the
program's answers only to judge them.
"""
