"""Batched radix-2 NTT over BN254 Fr, plain PyTorch: the prover's h(X).

Counterpart of ``passport_zk_circuits_tpu/ops/ntt.py`` (XLA code there: no
Pallas kernel reaches it). Values are (16, n, *B) limb tensors; log2(n)
stages of vectorized Cooley-Tukey butterflies after a bit-reversal
permutation, the same stages as the JAX package's, so every output equals
its. The twiddles and the bit-reverse index are made on the host once and
cached on the device, keyed by (log_n, device).

BN254 Fr has 2-adicity 28 (p - 1 = 2^28 * odd); the primitive root is
derived from the multiplicative generator 5 and proof-checked.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bignum as bn
from . import field as fr

TWO_ADICITY = 28
_GEN = 5

assert (fr.P - 1) % (1 << TWO_ADICITY) == 0


@functools.lru_cache(maxsize=None)
def root_of_unity(log_n: int) -> int:
    """2^log_n-th primitive root of unity (proof-checked)."""
    if not 0 <= log_n <= TWO_ADICITY:
        raise ValueError(f"no 2^{log_n}-th root of unity in Fr")
    w = pow(_GEN, (fr.P - 1) >> log_n, fr.P)
    if pow(w, 1 << log_n, fr.P) != 1 or (
            log_n > 0 and pow(w, 1 << (log_n - 1), fr.P) == 1):
        raise ArithmeticError("root of unity failed its check")
    return w


@functools.lru_cache(maxsize=None)
def _twiddles(log_n: int, inverse: bool):
    """Per-stage twiddle limb tables: stage s (m = 2^s) holds wm^j for
    j < m/2, wm = w^(n/m), as (16, m/2) uint32. Every stage's are a stride
    of the last stage's powers of w, which are made once."""
    n = 1 << log_n
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, fr.P - 2, fr.P)
    pows = [1] * max(1, n // 2)
    for j in range(1, n // 2):
        pows[j] = pows[j - 1] * w % fr.P
    limbs = fr.batch_to_limbs(pows)                        # (16, n/2)
    return [np.ascontiguousarray(limbs[:, ::n >> s][:, :(1 << s) // 2])
            for s in range(1, log_n + 1)]


@functools.lru_cache(maxsize=None)
def _bit_reverse(log_n: int) -> np.ndarray:
    idx = np.arange(1 << log_n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def device_tables(log_n: int, inverse: bool, device: torch.device):
    """(per-stage twiddle tensors (16, m/2) int64, bit-reverse index) on
    device, made once per (log_n, inverse, device)."""
    return ([bn.to_tensor(t, device) for t in _twiddles(log_n, inverse)],
            torch.as_tensor(_bit_reverse(log_n), device=device))


def _transform(a, inverse: bool):
    """a: (16, n, *B) -> (16, n, *B). Iterative Cooley-Tukey."""
    n = a.shape[1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT length {n} is not a power of two")
    stages, rev = device_tables(log_n, inverse, torch.device(a.device))
    a = a[:, rev]
    bshape = tuple(a.shape[2:])
    bdims = (1,) * len(bshape)
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        grp = a.reshape((fr.NLIMBS, n // m, m) + bshape)
        lo = grp[:, :, :half]
        hi = grp[:, :, half:]
        t = fr.mul(stages[s - 1].reshape((fr.NLIMBS, 1, half) + bdims), hi)
        a = torch.cat([fr.add(lo, t), fr.sub(lo, t)], dim=2)
        a = a.reshape((fr.NLIMBS, n) + bshape)
    return a


def ntt(a):
    """Forward NTT of (16, n, *B) Fr limbs (n a power of two <= 2^28)."""
    return _transform(a, inverse=False)


def intt(a):
    """Inverse NTT (scaled by n^-1)."""
    n = a.shape[1]
    out = _transform(a, inverse=True)
    n_inv = bn.cached_const(pow(n, fr.P - 2, fr.P), fr.NLIMBS, out.device,
                            out.dim())
    return fr.mul(out, n_inv)


def poly_mul_ntt(a, b):
    """Cyclic polynomial product of two (16, n, *B) coefficient tensors."""
    return intt(fr.mul(ntt(a), ntt(b)))
