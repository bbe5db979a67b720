"""K8 wrapper: a field-op body looped n_iter times in one kernel
(csrc/loop_bench.cu over the bodies of csrc/loop_bodies.cuh).

Replaces ``run_loop`` of ``tools/microbench_kernel.py``, the TPU's way of
timing a body inside one kernel so that the modmul design follows measured
numbers. Every body works on (16, B) 16-bit limbs, batch last, as int64;
each has its plain PyTorch step here. The TPU-only MXU bodies have no
counterpart; ``modmul_barrett16`` (the TPU's VPU formulation) and
``modmul_mont32`` (the card's, as in ``csrc/fr_bn254.cuh``) stand in for
them and are held against the canonical (x·c) mod P. A body's time is
its dependent chain's latency, not its few hundred bytes per lane, so the
kernel maps each body to the card by how it depends on itself: the
elementwise bodies (``PER_LIMB``: 16 independent chains a lane) one thread
a (limb, lane), ``modmul_mont32`` a lane on a team of threads (K7's lane
body), the TPU's 16-bit ``school``, ``modmul_barrett16`` and
``barrett_only`` one lane a thread.
"""

from __future__ import annotations

import torch

from . import bignum as bn
from . import cuda_build
from . import field as fr

MASK = 0xFFFF


def _mul_add(x, c):
    return (x * c + 1) & MASK


# body name -> plain step (x, c) -> x; csrc/loop_bodies.cuh's ids are the
# positions in this dict
PLAIN_STEPS = {
    "u32_mul_add": _mul_add,
    "i32_mul_add": _mul_add,        # int32 wraps; its low 16 bits are these
    "mask_shift_add": lambda x, c: ((x & MASK) + (c >> 1)) & MASK,
    "school": lambda x, c: bn.carry_normalize(bn.poly_mul(x, c)[:16], 16),
    "modmul_barrett16": fr.mul,
    "modmul_mont32": fr.mul,
    "barrett_only": lambda x, c: fr.reduce_overflowed(torch.cat([x, x])),
}
BODIES = tuple(PLAIN_STEPS)
# the bodies whose limbs are independent chains (loopb::PerLimb)
PER_LIMB = ("u32_mul_add", "i32_mul_add", "mask_shift_add")


def _check(body, a, c, n_iter):
    if body not in PLAIN_STEPS:
        raise ValueError(f"loop: unknown body {body!r}; one of {BODIES}")
    if a.dim() != 2 or a.shape[0] != fr.NLIMBS or c.shape != a.shape:
        raise ValueError(f"loop: a and c must be (16, B), got "
                         f"{tuple(a.shape)}, {tuple(c.shape)}")
    if n_iter < 1:
        raise ValueError(f"loop: n_iter must be >= 1, got {n_iter}")


def loop_plain(body: str, a, c, n_iter: int):
    """Plain PyTorch version: n_iter steps from x = a."""
    step = PLAIN_STEPS[body]
    x = a
    for _ in range(n_iter):
        x = step(x, c)
    return x


def loop(body: str, a, c, n_iter: int):
    """n_iter steps x <- body(x, c) from x = a, in one launch. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    _check(body, a, c, n_iter)
    if not a.is_cuda:
        return loop_plain(body, a, c, n_iter)
    a, c = a.contiguous(), c.contiguous()
    cuda_build.require_cuda_int64("loop", a, c)
    out = torch.empty_like(a)
    cuda_build.launch(f"loop {body}", "pzk_loop", a, BODIES.index(body),
                      a.data_ptr(), c.data_ptr(), out.data_ptr(), n_iter,
                      a.shape[1])
    loop.launches += 1
    return out


loop.launches = 0


def body_ints(body: str, x: int, c: int, n: int) -> int:
    """Python-int value of n steps of a body on one lane (the oracle)."""
    if body in PER_LIMB:
        xs = [(x >> (16 * i)) & MASK for i in range(16)]
        cs = [(c >> (16 * i)) & MASK for i in range(16)]
        for _ in range(n):
            xs = [(u * v + 1) & MASK if body != "mask_shift_add"
                  else (u + (v >> 1)) & MASK for u, v in zip(xs, cs)]
        return sum(v << (16 * i) for i, v in enumerate(xs))
    if body == "school":
        return x * pow(c, n, 1 << 256) % (1 << 256)
    if body == "barrett_only":
        return x * pow((1 << 256) + 1, n, fr.P) % fr.P
    return x * pow(c, n, fr.P) % fr.P
