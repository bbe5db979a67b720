"""Multi-precision modular arithmetic over 16-bit limbs, batched, in PyTorch.

Counterpart of ``passport_zk_circuits_tpu/ops/bignum.py`` with the same
layout and the same Barrett semantics:

* a k-limb integer is a tensor of shape ``(k, *batch)``, limb-major, holding
  16-bit little-endian limbs. The dtype is ``torch.int64`` because PyTorch on
  the CPU cannot add, shift or compare ``uint32`` tensors; the spare bits also
  let products and lazy sums stay exact without splitting them into halves;
* reduction is Barrett, with ``mu = floor(b^2k / m)`` precomputed on the host
  (per instance for RSA moduli);
* carries are resolved in constant depth: two local split passes leave 0/1
  carries, which a carry-lookahead over bit-packed generate/propagate words
  resolves without a sequential ripple.

The TPU package's MXU one-hot and byte-matrix machinery has no counterpart
here: limb products are one broadcast multiply and one skewed sum.
"""

from __future__ import annotations

import numpy as np
import torch

W = 16                      # bits per limb
BASE = 1 << W               # limb radix
MASK = BASE - 1

_PACK = 60                  # limbs per int64 word in the carry lookahead


# ---------------------------------------------------------------------------
# Host-side helpers (Python ints <-> limb arrays), numpy like the JAX package
# ---------------------------------------------------------------------------

def int_to_limbs(x: int, k: int) -> np.ndarray:
    """Python int -> (k,) uint32 limb array (little-endian base 2^16)."""
    if x < 0:
        raise ValueError("negative")
    try:
        raw = x.to_bytes(2 * k, "little")
    except OverflowError:
        raise ValueError(f"{k} limbs too small")
    return np.frombuffer(raw, dtype="<u2").astype(np.uint32)


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def limbs_to_int(a) -> int:
    """(k,) limb array or tensor -> Python int."""
    a = _to_numpy(a)
    return sum(int(v) << (W * i) for i, v in enumerate(a.astype(np.uint64)))


def ints_to_limbs_batch(xs, k: int) -> np.ndarray:
    """list of B ints -> (k, B) uint32 (limb-major batch layout)."""
    return np.stack([int_to_limbs(x, k) for x in xs], axis=-1)


def limbs_to_ints_batch(a) -> list:
    """(k, *B) limbs (array or tensor) -> list of ints, batch flattened."""
    a = _to_numpy(a)
    flat = a.reshape(a.shape[0], -1)
    if (flat >= 0).all() and (flat <= MASK).all():
        cols = np.ascontiguousarray(flat.T).astype("<u2")
        return [int.from_bytes(row.tobytes(), "little") for row in cols]
    return [sum(int(flat[i, j]) << (W * i) for i in range(a.shape[0]))
            for j in range(flat.shape[1])]


def barrett_mu(mod: int, k: int) -> np.ndarray:
    """mu = floor(b^2k / mod) as (k+1,) limbs. Requires
    b^(k-1) <= mod < b^k so that mu fits in k+1 limbs."""
    if not (1 << (W * (k - 1))) <= mod < (1 << (W * k)):
        raise ValueError("modulus must be sized to its limb count")
    return int_to_limbs((1 << (W * 2 * k)) // mod, k + 1)


def barrett_mu_batch(mods, k: int) -> np.ndarray:
    return np.stack([barrett_mu(m, k) for m in mods], axis=-1)


def to_tensor(a, device) -> torch.Tensor:
    """Host limb or word array -> int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def const_like(limbs, like: torch.Tensor) -> torch.Tensor:
    """(k,) host limbs -> (k, 1, ..., 1) int64 tensor that broadcasts
    against `like`'s batch dims, on `like`'s device."""
    t = to_tensor(limbs, like.device)
    return t.reshape((t.shape[0],) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# Device-side ops. Limb tensors are int64 (k, *batch); normalized (< 2^16)
# at function boundaries unless stated otherwise.
# ---------------------------------------------------------------------------

def _row_shape(x: torch.Tensor, k: int):
    return (k,) + (1,) * (x.dim() - 1)


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Row i -> row i+1, zero into row 0, top row dropped."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _resolve_carry(g, p):
    """Carry-lookahead: per-limb generate/propagate bits (disjoint, 0/1,
    shape (k, *B)) -> (cin (k, *B), carry_out (*B,)) with
    cin_i = g_{i-1} | (p_{i-1} & cin_{i-1}), cin_0 = 0.

    Each chunk of up to 60 limbs is bit-packed into one int64 per batch
    element, with the incoming chunk carry as a virtual generate bit at
    position 0: the carries of the integer sum G + (G | P) are exactly the
    lookahead recurrence, so a chunk costs a handful of flat ops."""
    k = g.shape[0]
    carry = torch.zeros_like(g[0])
    cins = []
    for s in range(0, k, _PACK):
        gi, pi = g[s:s + _PACK], p[s:s + _PACK]
        kk = gi.shape[0]
        sh = torch.arange(1, kk + 1, device=g.device).reshape(
            _row_shape(gi, kk))
        G = (gi << sh).sum(0) | carry
        Y = G | (pi << sh).sum(0)
        S = G + Y
        cmask = S ^ G ^ Y
        cins.append((cmask.unsqueeze(0) >> sh) & 1)
        carry = (S >> (kk + 1)) & 1
    return (cins[0] if len(cins) == 1 else torch.cat(cins)), carry


def carry_normalize(t, k_out=None):
    """Propagate carries of an overflowed limb vector.

    t: (m, *B) int64 with limbs < 2^47. Returns (k_out, *B) normalized
    limbs holding t mod b^k_out. Two local split passes bring every limb
    under 2^17 (so each carry is 0 or 1); the carry-lookahead resolves the
    rest."""
    m = t.shape[0]
    k_out = k_out or m
    if k_out < m:
        t = t[:k_out]
    elif k_out > m:
        t = torch.cat([t, t.new_zeros((k_out - m,) + t.shape[1:])])
    for _ in range(2):                       # < 2^16 + 2^31, then < 2^17
        t = (t & MASK) + _shift_up(t >> W)
    low = t & MASK
    cin, _ = _resolve_carry(t >> W, (low == MASK).long())
    return (low + cin) & MASK


def poly_mul(a, b):
    """Exact product of two limb vectors (batched convolution).

    a: (n, *B), b: (m, *B) normalized -> (n+m, *B) overflowed limbs
    (< min(n, m) * 2^32). One broadcast multiply; the anti-diagonal sums
    come from laying the (n, m) product rows out with stride n+m and
    reading them back with stride n+m-1, which shifts row i right by i."""
    n, m = a.shape[0], b.shape[0]
    prod = a.unsqueeze(1) * b.unsqueeze(0)              # (n, m, *B)
    bshape = prod.shape[2:]
    buf = prod.new_zeros((n, n + m) + bshape)
    buf[:, :m] = prod
    r = n + m - 1
    diag = buf.reshape((n * (n + m),) + bshape)[:n * r]
    diag = diag.reshape((n, r) + bshape).sum(0)
    return torch.cat([diag, diag.new_zeros((1,) + bshape)])


def sub_limbs(a, b):
    """a - b over normalized limbs -> (diff mod b^k (k, *B), borrow (*B,)).
    Borrows resolve by the same lookahead (generate = a_i < b_i,
    propagate = a_i == b_i)."""
    low = (a - b) & MASK
    bin_, borrow = _resolve_carry((a < b).long(), (a == b).long())
    return (low - bin_) & MASK, borrow


def _ext(mod_limbs):
    """Append one zero limb."""
    return torch.cat([mod_limbs, torch.zeros_like(mod_limbs[:1])])


def cond_sub_mod(a, mod_limbs):
    """a - mod if a >= mod else a (for a < 2*mod, normalized)."""
    d, borrow = sub_limbs(a, mod_limbs)
    return torch.where(borrow.bool(), a, d)


def add_mod(a, b, mod_limbs):
    """(a + b) mod m for normalized a, b < m."""
    k = a.shape[0]
    s = carry_normalize(a + b, k + 1)
    d, borrow = sub_limbs(s, _ext(mod_limbs))
    return torch.where(borrow.bool(), s, d)[:k]


def sub_mod(a, b, mod_limbs):
    """(a - b) mod m for normalized a, b < m."""
    d, borrow = sub_limbs(a, b)
    dp = carry_normalize(d + mod_limbs, d.shape[0])
    return torch.where(borrow.bool(), dp, d)


def barrett_reduce(t, mod_limbs, mu_limbs):
    """Barrett reduction: t mod m for t < b^2k (overflowed limbs < 2^47).

    t: (<= 2k, *B); mod_limbs: (k, *B) or broadcastable; mu_limbs: (k+1, ...)
    = floor(b^2k / m). Returns (k, *B) normalized, < m. The quotient
    estimate is off by at most 2, fixed with two conditional subtracts."""
    k = mod_limbs.shape[0]
    x = carry_normalize(t, 2 * k)
    q1 = x[k - 1:]                                       # k+1 limbs
    q3 = carry_normalize(poly_mul(q1, mu_limbs), 2 * k + 2)[k + 1:]
    r2 = carry_normalize(poly_mul(q3, mod_limbs)[:k + 1], k + 1)
    r, _ = sub_limbs(x[:k + 1], r2)                      # mod b^(k+1)
    mod_ext = _ext(mod_limbs)
    r = cond_sub_mod(r, mod_ext)
    r = cond_sub_mod(r, mod_ext)
    return r[:k]


def mod_mul(a, b, mod_limbs, mu_limbs):
    """(a * b) mod m for normalized a, b < b^k."""
    return barrett_reduce(poly_mul(a, b), mod_limbs, mu_limbs)


def mod_sqr(a, mod_limbs, mu_limbs):
    return mod_mul(a, a, mod_limbs, mu_limbs)


def mod_pow(a, exp: int, mod_limbs, mu_limbs, one=None):
    """Fixed exponent power, left to right: one squaring per bit below the
    top one and one multiply per set bit (e = 65537: 16 + 1)."""
    if exp < 0:
        raise ValueError("negative exponent")
    if exp == 0:
        if one is None:
            one = int_to_limbs(1, mod_limbs.shape[0])
        return const_like(one, a).expand(a.shape).clone()
    acc = a
    for bit in bin(exp)[3:]:
        acc = mod_sqr(acc, mod_limbs, mu_limbs)
        if bit == "1":
            acc = mod_mul(acc, a, mod_limbs, mu_limbs)
    return acc


def is_zero(a):
    """Exact zero test of normalized limbs -> bool (*B,)."""
    return (a == 0).all(0)


def eq(a, b):
    return (a == b).all(0)


def lt(a, b):
    """a < b for normalized limb vectors -> bool (*B,)."""
    _, borrow = sub_limbs(a, b)
    return borrow.bool()
