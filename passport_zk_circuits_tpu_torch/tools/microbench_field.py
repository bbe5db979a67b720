"""BN254 field-muls/s on the card: candidate Fr-mul formulations, each
chained across calls so that nothing can be skipped or overlapped.

Counterpart of ``tools/microbench_field.py``. Each candidate advances a
(16, batch) state by scan_len self-dependent products per call; calls are
chained (each on the previous call's output) and timed with CUDA events
around ITERS calls (PLAIN_ITERS for the plain loop, about half a second a
call on the card). Candidates:

  plain_loop   scan_len plain fr.mul calls (Barrett in plain PyTorch)
  k6_per_mul   K6 (csrc/field.cu) launched once per product
  k7_fused     K7: the whole chain in one launch (the metric's figure)
  k8_raw_u32   K8's u32_mul_add body, scan_len * 16 steps: the raw 32-bit
               multiply chain, no field arithmetic

    python -m passport_zk_circuits_tpu_torch.tools.microbench_field \\
        [--batch 1024] [--scan-len 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import bignum as bn
from ..ops import cuda_field
from ..ops import cuda_loop
from ..ops import field as fr
from ..utils.profiling import chain_time

C = 0x1234567890ABCDEF11223344
RAW_C = 12345
FIELD_CANDIDATES = ("plain_loop", "k6_per_mul", "k7_fused")
ITERS = 100
PLAIN_ITERS = 3


def make_inputs(batch: int, device):
    """x0: (16, batch) from numpy's default_rng(0) as the JAX tool's; c:
    one (16, 1) column."""
    rng = np.random.default_rng(0)
    x0 = bn.to_tensor(fr.batch_to_limbs(
        [int(rng.integers(1, 1 << 63)) for _ in range(batch)]), device)
    c = bn.to_tensor(fr.to_limbs(C)[:, None], device)
    return x0, c


def run(device, batch: int = 1024, scan_len: int = 256, iters: int = ITERS):
    """Time every candidate; returns {name: seconds per call}. Raises if
    K6 or K7 disagrees with the plain products."""
    x0, c = make_inputs(batch, device)

    def plain_loop(x):
        for _ in range(scan_len):
            x = fr.mul(x, c.expand_as(x))
        return x

    def k6_per_mul(x):
        for _ in range(scan_len):
            x = cuda_field.mul(x, c)
        return x

    want = cuda_field.mul_chain_plain(x0, c, 4)
    if not torch.equal(cuda_field.mul(x0, c), fr.mul(x0, c.expand_as(x0))):
        raise AssertionError("K6 differs from the plain product")
    if not torch.equal(cuda_field.mul_chain(x0, c, 4), want):
        raise AssertionError("K7 (n = 4) differs from the plain chain")

    raw_c = torch.full_like(x0, RAW_C)
    res = {
        "plain_loop": chain_time(plain_loop, x0, min(iters, PLAIN_ITERS)),
        "k6_per_mul": chain_time(k6_per_mul, x0, iters),
        "k7_fused": chain_time(
            lambda x: cuda_field.mul_chain(x, c, scan_len), x0, iters),
        "k8_raw_u32": chain_time(
            lambda x: cuda_loop.loop("u32_mul_add", x, raw_c, scan_len * 16),
            x0, iters),
    }
    return res


def field_muls_per_s(seconds: float, batch: int, scan_len: int) -> float:
    return batch * scan_len / seconds


def report(res, batch: int, scan_len: int) -> None:
    for name, s in res.items():
        per_mul_ns = s / scan_len * 1e9
        rate = (f"{field_muls_per_s(s, batch, scan_len):.6g} field-muls/s"
                if name in FIELD_CANDIDATES else
                f"{16 * batch * scan_len * 16 / s:.6g} u32 mul-adds/s")
        print(f"{name:12s} {s * 1e3:10.4f} ms/step {per_mul_ns:10.2f} ns/mul "
              f"({per_mul_ns / batch * 1e3:8.3f} ps/mul/elem)  {rate}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--scan-len", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("microbench_field: no CUDA device", file=sys.stderr)
        return 1
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    print(f"device={kind} batch={args.batch} scan_len={args.scan_len}")
    report(run(dev, args.batch, args.scan_len), args.batch, args.scan_len)
    return 0


if __name__ == "__main__":
    sys.exit(main())
