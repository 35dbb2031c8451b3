"""PyTorch/CUDA port of the coprocessor's device path.

``tikv_tpu`` (JAX) stays the reference; this package keeps its own copy of
every module it needs, imports neither ``jax`` nor ``tikv_tpu``, and runs its
hot path through kernels written by hand for Hopper (``csrc/``).
"""
