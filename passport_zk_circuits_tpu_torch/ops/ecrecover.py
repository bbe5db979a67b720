"""Batched Ethereum-style ECDSA public-key recovery (secp256k1).

Counterpart of ``passport_zk_circuits_tpu/ops/ecrecover.py``, plain
PyTorch (the JAX module is XLA code: no Pallas kernel reaches it), with its
contract (ecrecover.circom's EcRecover): the y^2 candidate from r, the
square root, the curve check, Q = r^-1 (s R - h G).

The square root is (y^2)^((p+1)/4) (secp256k1's p = 3 mod 4), checked by
squaring it back. The arithmetic is ``bignum.StaticMod`` over the curve's
field and order (the ctx's ``fp`` and ``fn``): its results are the
canonical residues that ``mod_pow``, ``mod_mul`` and ``barrett_reduce``
give, in about a quarter of the tensor ops. The parity of y picks y or
p - y by an integer select. The group work is ``ops/weierstrass``'s: the
fixed-base mult of the generator over ``fixed_base_secp256k1.npz`` and the
4-bit windowed mult of R.
"""

from __future__ import annotations

import torch

from . import bignum as bn
from . import weierstrass as wst
from .ecdsa import hash_bits_to_limbs

CURVE = "secp256k1"


def recover(r, s, v_odd, hash_bits):
    """r, s: (16, *B) limbs; v_odd: (*B,) bool or 0/1 (the parity of R's
    y, Ethereum's v - 27); hash_bits: (256, *B) big-endian bits. Returns
    (qx, qy, ok): the recovered affine public key and its validity. Q at
    infinity, r = 0, s = 0, r >= n and s >= n are rejected."""
    c = wst.ctx(CURVE)
    cv = c.curve
    # R's x is r itself (no multiple of n added, as in the reference)
    rx = r
    y2 = c.add(c.mul(c.sqr(rx), rx), c.const_like(cv.b, rx).expand(
        rx.shape))
    y = c.fp.pow(y2, (cv.p + 1) // 4)
    ok = bn.eq(c.sqr(y), y2)

    # the parity: y if its low bit is v_odd, else p - y
    y_other = c.sub(torch.zeros_like(y), y)
    same = (y[0] & 1) == torch.as_tensor(v_odd, device=y.device).long()
    y_sel = torch.where(same.unsqueeze(0), y, y_other)

    h = c.fn.reduce(hash_bits_to_limbs(hash_bits, c.kn))
    r_inv = c.fn.pow(r, cv.n - 2)
    u1, u2 = c.fn.mul(r_inv.unsqueeze(1), c.stack(
        c.fn.sub(torch.zeros_like(h), h), s)).unbind(1)

    # Q = u1 G + u2 R
    Q = wst.jac_add(c, wst.fixed_base_mul(c, u1),
                    wst.scalar_mul_window(c, u2, rx, y_sel))
    qx, qy = wst.to_affine(c, Q)
    n_l = c.n_limbs(r)
    ok = ok & ~wst.is_inf(c, Q) & ~bn.is_zero(r) & ~bn.is_zero(s)
    ok = ok & bn.lt(r, n_l) & bn.lt(s, n_l)
    return qx, qy, ok
