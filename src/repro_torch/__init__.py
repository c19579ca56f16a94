"""PyTorch/CUDA port of the randomized approximate Cholesky solver.

The JAX package ``repro`` is the reference; this package imports
neither it nor ``jax``.
"""
