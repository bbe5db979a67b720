"""K2 wrapper: batched sig^e mod n, modulus per lane (csrc/rsa.cu).

Replaces ``pow_mod`` of ``passport_zk_circuits_tpu/ops/pallas_rsa.py``, with
the same contract: 16-bit limbs, the host's per-lane Barrett constant
mu = floor(b^2k / n), canonical output. The TPU kernel runs only e = 3 and
e = 65537 on hardware; this one takes any exponent e >= 1.

On the H100 the kernel runs one warp a lane, the lane's numbers spread
over the 32 threads in registers, and multiplies in Montgomery form across
the warp (csrc/bignum.cuh, ``bnw``): R^2 mod n is the negated low half of
mu * n, so a lane needs no host work. A product is bound by the latency of
its K outer steps, each waiting on two shuffles; B = 1024 lanes fill the
card with 1024 warps. A lane with an even modulus takes the Barrett
``bn::powmod`` on one thread, in a scratch buffer this wrapper allocates.
"""

from __future__ import annotations

import torch

from . import bignum as bn
from . import cuda_build


def pow_mod_plain(sig, n_limbs, mu_limbs, exp: int):
    """Plain PyTorch version: bignum.mod_pow."""
    return bn.mod_pow(sig, exp, n_limbs, mu_limbs)


def pow_mod(sig, n_limbs, mu_limbs, exp: int):
    """sig^exp mod n; sig, n: (k, B) 16-bit limbs, mu: (k+1, B).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if not sig.is_cuda:
        return pow_mod_plain(sig, n_limbs, mu_limbs, exp)
    k = sig.shape[0]
    if sig.dim() != 2 or k % 2 or not 2 <= k <= 512:
        raise ValueError(f"pow_mod: need (k, B) with even k <= 512, "
                         f"got {tuple(sig.shape)}")
    if not 1 <= exp < 1 << 64:
        raise ValueError("pow_mod: exponent must be in [1, 2^64)")
    B = sig.shape[1]
    sig, n_limbs, mu_limbs = (x.contiguous() for x in (sig, n_limbs, mu_limbs))
    if n_limbs.shape != (k, B) or mu_limbs.shape != (k + 1, B):
        raise ValueError("pow_mod: need n (k, B) and mu (k+1, B)")
    cuda_build.require_cuda_int64("pow_mod", sig, n_limbs, mu_limbs)
    out = torch.empty_like(sig)
    # an even-modulus lane's words (csrc/bignum.cuh, bn::powmod_lane_words)
    scratch = torch.empty(B * (9 * (k // 2) + 4), dtype=torch.int32,
                          device=sig.device)
    cuda_build.launch("pow_mod", "pzk_rsa_pow", sig, sig.data_ptr(),
                      n_limbs.data_ptr(), mu_limbs.data_ptr(),
                      out.data_ptr(), k, B, exp, scratch.data_ptr())
    pow_mod.launches += 1
    return out


pow_mod.launches = 0
