"""Batch sharding over the GPUs of one process (mesh) and over processes,
one a GPU, with torch.distributed (distributed)."""
