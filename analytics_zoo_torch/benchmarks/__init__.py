"""Benchmark entry points of the port (the counterparts of ``bench.py``'s
functions in the JAX package)."""
