"""Limb arithmetic, hashes, SMT and curve ops in plain PyTorch, and the
wrappers of the hand-written CUDA kernels (cuda_*.py, csrc/)."""
