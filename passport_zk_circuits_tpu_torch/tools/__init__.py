"""Command-line tools of the port, each run with ``python -m``:
microbench_field (BN254 field-muls/s), microbench_kernel (K8 body costs),
probe_nvcc (the K9 probe battery)."""
