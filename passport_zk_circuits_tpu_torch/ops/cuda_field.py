"""K6 and K7 wrappers: one BN254 Fr product per lane, and a chain of n
products in one launch (csrc/field.cu).

Replace ``mul`` and ``mul_chain`` of
``passport_zk_circuits_tpu/ops/pallas_field.py``. Operands are (16, B)
16-bit limbs as int64, batch last; ``b`` / ``c`` may be one (16, 1) column
that every lane uses (the kernel reads it with stride 0, as ``pf.mul``
broadcasts it). Inputs need not be below P: a Montgomery product takes
one operand as it is, below 2^256, so the result is (a·b) mod P for any
a, b < 2^256, as the JAX package's. Both kernels run each lane on a team
of threads (csrc/fr_slice.cuh): K6 in two CIOS products, mont(a, R^2) then
mont(b, a·R); K7, the kernel behind the field-muls/s metric, both operands
into Montgomery form, then n dependent products in registers, so at
B = 1024 its time is the chain's latency.
"""

from __future__ import annotations

import torch

from . import cuda_build
from . import field as fr


def _check_shapes(name, a, b):
    if a.dim() != 2 or a.shape[0] != fr.NLIMBS:
        raise ValueError(f"{name}: a must be (16, B), got {tuple(a.shape)}")
    if b.shape not in ((fr.NLIMBS, a.shape[1]), (fr.NLIMBS, 1)):
        raise ValueError(f"{name}: b must be (16, B) or (16, 1), got "
                         f"{tuple(b.shape)}")


def mul_plain(a, b):
    """Plain PyTorch version: fr.mul (Barrett, exact for a, b < 2^256)."""
    return fr.mul(a, b.expand_as(a))


def mul_chain_plain(a, c, n: int):
    """Plain PyTorch version: n fr.mul steps; n = 0 returns a unchanged."""
    x = a.clone()
    c = c.expand_as(a)
    for _ in range(n):
        x = fr.mul(x, c)
    return x


def _launch(name, fn, a, b, *extra):
    a, b = a.contiguous(), b.contiguous()
    cuda_build.require_cuda_int64(name, a, b)
    out = torch.empty_like(a)
    cuda_build.launch(name, fn, a, a.data_ptr(), b.data_ptr(),
                      int(b.shape[1] == 1), out.data_ptr(), *extra,
                      a.shape[1])
    return out


def mul(a, b):
    """(a·b) mod P per lane. a: (16, B); b: (16, B) or (16, 1). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    _check_shapes("mul", a, b)
    if not a.is_cuda:
        return mul_plain(a, b)
    out = _launch("mul", "pzk_fr_mul", a, b)
    mul.launches += 1
    return out


mul.launches = 0


def mul_chain(a, c, n: int):
    """n sequential steps x <- x·c mod P from x = a, in one launch.
    n = 0 returns a unchanged (not reduced), as the TPU kernel's zero-trip
    loop does. A CPU tensor takes the plain version."""
    _check_shapes("mul_chain", a, c)
    if n < 0:
        raise ValueError(f"mul_chain: n must be >= 0, got {n}")
    if not a.is_cuda:
        return mul_chain_plain(a, c, n)
    out = _launch("mul_chain", "pzk_fr_mul_chain", a, c, n)
    mul_chain.launches += 1
    return out


mul_chain.launches = 0
