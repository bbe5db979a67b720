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

import functools

import numpy as np
import torch

W = 16                      # bits per limb
BASE = 1 << W               # limb radix
MASK = BASE - 1

_PACK = 60                  # limbs per int64 word in the carry lookahead


# ---------------------------------------------------------------------------
# Host-side helpers (Python ints <-> limb arrays), numpy like the JAX package
# ---------------------------------------------------------------------------

def nlimbs_for_bits(bits: int) -> int:
    return -(-bits // W)


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
    """list of B ints -> (k, B) uint32 (limb-major batch layout); raises
    as int_to_limbs does on a negative int or one too wide for k limbs."""
    try:
        raw = b"".join(x.to_bytes(2 * k, "little") for x in xs)
    except OverflowError:
        for x in xs:
            int_to_limbs(x, k)
        raise
    return np.frombuffer(raw, dtype="<u2").reshape(-1, k).T.astype(
        np.uint32, order="C")


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


@functools.lru_cache(maxsize=None)
def cached_const(x: int, nlimbs: int, device: torch.device, ndim: int):
    """Static integer x as (nlimbs, 1, ..., 1) int64 limbs on `device`,
    made once per (x, nlimbs, device, ndim) and shared: never write to it."""
    t = to_tensor(int_to_limbs(x, nlimbs), device)
    return t.reshape((nlimbs,) + (1,) * (ndim - 1))


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



# ---------------------------------------------------------------------------
# Arithmetic mod a static modulus in few tensor ops (the curve fields and
# orders). Results are the canonical residues, the same integers that
# mod_mul / add_mod / sub_mod give. Every op takes (k, *B) normalized limbs
# of any batch shape, so independent products can share one call.
# ---------------------------------------------------------------------------

class StaticMod:
    """Arithmetic mod m, b^k / 8 <= m < b^k, k <= 24 (the BN254 fields,
    just above 2^253, at k = 16 among them).

    A product is the (2k-1)-column convolution (columns < k 2^32) with its
    high columns folded onto the low k by the constants b^(k+i) mod m, so
    V = T mod m with k limbs below 2^58; q = floor(V / m) < 2^45 estimated
    in float64 (relative error below 2^-48, so within 0.13 of V / m, and
    0.25 below it: one low at most, and R = V - q m lies in [0, 2m)); q
    takes three 16-bit digits; then R and
    R - m are normalized together, by a 16-bit digit split and one
    carry-lookahead, and the nonnegative one is kept. About 45 tensor ops,
    where ``mod_mul``'s Barrett reduction takes about 180. A sum or a
    difference takes about 23."""

    def __init__(self, m: int, k: int):
        if not (1 << (W * k - 3)) <= m < (1 << (W * k)) or k > 24:
            raise ValueError("StaticMod needs b^k / 8 <= m < b^k, k <= 24")
        self.m, self.k = m, k
        n = k + 2                       # limbs of V - q m and of R - m
        self.inv_m = 1.0 / float(m)
        i64 = np.int64
        self._np = {
            # high product column k + i folds onto the low k limbs
            "fold": np.stack([int_to_limbs(pow(BASE, k + i, m), k)
                              for i in range(k - 1)]).astype(i64),
            # q m as sum_s q_s (m << 16 s): row s is m's limbs moved up s
            "qm": np.stack([np.roll(np.pad(int_to_limbs(m, k), (0, 2)), s)
                            for s in range(3)]).astype(i64),
            "qsh": np.array([0, 16, 32], dtype=i64),
            "dsh": np.array([0, 16, 32, 48], dtype=i64),
            # sum_j 2^36 b^j - 2^20 b^(j+1) = 0 mod b^n: keeps V - q m's
            # limbs positive (each q m column is below 3 2^32)
            "bias": np.array([1 << 36] + [(1 << 36) - (1 << 20)] * (n - 1),
                             dtype=i64),
            "neg_m_n": int_to_limbs((1 << (W * n)) - m, n).astype(i64),
            "neg_m_k": int_to_limbs((1 << (W * k)) - m, k).astype(i64),
            "m": int_to_limbs(m, k).astype(i64),
            # b^k as MASK in every limb and one more in limb 0: a - b + b^k
            # = a + (not_b - b) with limbs >= 0
            "not_b": np.array([BASE] + [MASK] * (k - 1), dtype=i64),
            "pw": np.left_shift(np.int64(1), np.arange(n, dtype=i64)),
            "sh": np.arange(n, dtype=i64),
            "wf": np.array([float(BASE ** j) for j in range(k)]),
        }
        self._dev = {}

    def _c(self, name, like):
        """Constant `name` on like's device, shaped to broadcast against
        like's batch dims (like: (k, *B))."""
        key = (name, like.device, like.dim())
        t = self._dev.get(key)
        if t is None:
            a = self._np[name]
            t = torch.as_tensor(a, device=like.device).reshape(
                a.shape + (1,) * (like.dim() - 1))
            self._dev[key] = t
        return t

    def const_like(self, v: int, like):
        """v mod m as (k, 1, ..) limbs, cached, broadcasting against like."""
        return cached_const(v % self.m, self.k, like.device, like.dim())

    def _resolve(self, y, a):
        """y: (2, n, *B) limbs below 2^17, so each carry is 0 or 1 ->
        canonical limbs of each y mod b^n, by a carry-lookahead over
        bit-packed generate and propagate words (n <= 26 bits each)."""
        n = y.shape[1]
        low = y & MASK
        g = y >> W
        p = (low + 1) >> W                                   # low == MASK
        gp = (torch.stack([g, p]) * self._c("pw", a)[:n]).sum(2)
        cm = (gp[0] + (gp[0] | gp[1])) ^ gp[1]   # bit i: carry into limb i
        cin = (cm.unsqueeze(1) >> self._c("sh", a)[:n]) & 1
        return (low + cin) & MASK

    def _carry_pass(self, y):
        """One local split along dim 1, the top carry dropped."""
        hi = y >> W
        y = y & MASK
        y[:, 1:] += hi[:, :-1]
        return y

    def mul(self, a, b):
        """(a * b) mod m for a, b < b^k (normalized limbs, broadcastable)."""
        k, n = self.k, self.k + 2
        prod = a.unsqueeze(1) * b.unsqueeze(0)               # (k, k, *B)
        bshape = tuple(prod.shape[2:])
        buf = prod.new_zeros((k, 2 * k) + bshape)
        buf[:, :k] = prod
        t = buf.reshape((2 * k * k,) + bshape)[:k * (2 * k - 1)]
        t = t.reshape((k, 2 * k - 1) + bshape).sum(0)       # < k 2^32
        v = t[:k] + (t[k:].unsqueeze(1) * self._c("fold", t)).sum(0)
        q = ((v.double() * self._c("wf", v)).sum(0) * self.inv_m
             - 0.25).long()                          # floor(V/m) or one low
        ql = (q.unsqueeze(0) >> self._c("qsh", v)) & MASK          # (3, *B)
        r = self._c("bias", v) - (ql.unsqueeze(1) * self._c("qm", v)).sum(0)
        r[:k] += v                                    # V - q m in [0, 2m)
        x = torch.stack([r, r + self._c("neg_m_n", v)])     # (2, n, *B)
        # 16-bit digits summed along their columns, mod b^n: limbs < 2^18
        d = (x.unsqueeze(1) >> self._c("dsh", x[:1, :1])) & MASK
        buf = d.new_zeros((2, 4, n + 4) + bshape)
        buf[:, :, :n] = d
        y = buf.reshape((2, 4 * (n + 4)) + bshape)[:, :4 * (n + 3)]
        y = y.reshape((2, 4, n + 3) + bshape).sum(1)[:, :n]
        z = self._resolve(self._carry_pass(y), v)
        # R - m mod b^n has a zero top limb exactly when R >= m
        return torch.where(z[1, n - 1] == 0, z[1, :k], z[0, :k])

    def sqr(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        """(a + b) mod m for a, b < m."""
        k = self.k
        x = a.new_zeros((2, k + 1) + tuple(torch.broadcast_shapes(
            a.shape, b.shape)[1:]))
        torch.add(a, b, out=x[0, :k])
        torch.add(x[0, :k], self._c("neg_m_k", a), out=x[1, :k])
        z = self._resolve(self._carry_pass(x), a)
        # s + b^k - m reaches b^k exactly when s >= m
        return torch.where(z[1, k] == 1, z[1, :k], z[0, :k])

    def sub(self, a, b):
        """(a - b) mod m for a, b < m."""
        k = self.k
        x = a.new_zeros((2, k + 1) + tuple(torch.broadcast_shapes(
            a.shape, b.shape)[1:]))
        torch.sub(self._c("not_b", a), b, out=x[0, :k])
        x[0, :k] += a                                   # a - b + b^k
        torch.add(x[0, :k], self._c("m", a), out=x[1, :k])
        z = self._resolve(self._carry_pass(x), a)
        # a - b + b^k reaches b^k exactly when a >= b
        return torch.where(z[0, k] == 1, z[0, :k], z[1, :k])

    def pow(self, a, exp: int):
        """a^exp mod m for a static exp > 0: 4-bit fixed windows, MSB
        first (a^0 = 1 is never multiplied in)."""
        if exp <= 0:
            raise ValueError("StaticMod.pow needs exp > 0")
        table = [None, a]
        for _ in range(14):
            table.append(self.mul(table[-1], a))
        nibbles = [(exp >> s) & 0xF for s in
                   range(4 * ((exp.bit_length() - 1) // 4), -1, -4)]
        acc = table[nibbles[0]]
        for nib in nibbles[1:]:
            for _ in range(4):
                acc = self.sqr(acc)
            if nib:
                acc = self.mul(acc, table[nib])
        return acc

    def inv(self, a):
        """a^-1 mod m by Fermat (m prime); inv(0) = 0."""
        return self.pow(a, self.m - 2)

    def reduce(self, a):
        """a mod m for a < b^k."""
        return self.mul(a, self.const_like(1, a))
