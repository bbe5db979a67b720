"""passport_zk_circuits_tpu_torch: the PyTorch + CUDA port of
passport_zk_circuits_tpu for one NVIDIA H100.

Same layout and function names as the JAX package, which stays the
reference the port is held against. The port imports torch and never jax.
"""
