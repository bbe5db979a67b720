"""K11 wrappers: batched fixed-base scalar multiplication [s]G over BN254
G1 and the twist G2 on the card (csrc/fixed_base.cu), for Groth16 setup.

No TPU kernel is replaced: the JAX package leaves these mults to XLA
(``passport_zk_circuits_tpu/groth16/protocol.py:223``, ``:260``). The plain
versions are ``weierstrass.fixed_base_mul`` + ``to_affine`` and
``g2.fixed_base_mul`` + ``g2.to_affine``:

    scalars: (16, B) int64 16-bit limbs -> affine (x, y), each (16[, 2], B),
    infinity (a zero scalar) -> zeros.

An affine point is unique, so the kernel's outputs equal the plain
versions' bit for bit. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. The kernel reads the stride-8 tables of
``weierstrass.fixed_base_table`` (``utils/constants/fixed_base_bn254_
{g1,g2}.npz``), uploaded once a device in Montgomery words by ``table``.
"""

from __future__ import annotations

import functools

import torch

from . import cuda_build
from . import cuda_msm
from . import g2 as _g2
from . import weierstrass as wst

NWIN = 32                   # byte windows
ENTRIES = 256               # table entries a window (entry 0: infinity)


@functools.lru_cache(maxsize=None)
def table(curve: str, device: torch.device):
    """The curve's stride-8 table as (NWIN * ENTRIES, 2 * coord_words)
    int32 Montgomery words on device (cuda_msm.points_plain's layout),
    made on the host once a device; only entry 0 of a window is infinity."""
    g2 = curve == "bn254_g2"
    xs, ys, infs = wst.fixed_base_table(curve, torch.device("cpu"))
    want = torch.zeros_like(infs)
    want[:, 0] = True
    if not torch.equal(infs, want):
        raise ValueError(f"{curve}: a table entry other than 0 is infinity")
    # (NWIN, 16[, 2], ENTRIES) -> (16[, 2], NWIN * ENTRIES), window-major
    flat = [c.movedim(0, -2).reshape(c.shape[1:-1] + (-1,)) for c in (xs, ys)]
    return cuda_msm.points_plain(*flat, g2).to(device)


def mul_plain(scalars, g2: bool):
    """The plain version: weierstrass.fixed_base_mul (or g2's) and
    to_affine."""
    if g2:
        return _g2.to_affine(_g2.fixed_base_mul(scalars))
    c = wst.ctx("bn254_g1")
    return wst.to_affine(c, wst.fixed_base_mul(c, scalars))


def _mul(name, scalars, curve):
    g2 = curve == "bn254_g2"
    if scalars.dim() != 2 or scalars.shape[0] != 16:
        raise ValueError(f"{name}: scalars must be (16, B), got "
                         f"{tuple(scalars.shape)}")
    if not scalars.is_cuda:
        return mul_plain(scalars, g2)
    scalars = scalars.contiguous()
    cuda_build.require_cuda_int64(name, scalars)
    b = scalars.shape[1]
    tbl = table(curve, scalars.device)
    coord = (16, 2) if g2 else (16,)
    x = torch.empty(coord + (b,), dtype=torch.int64, device=scalars.device)
    y = torch.empty_like(x)
    cuda_build.launch(name, "pzk_fixed_base", scalars, int(g2),
                      scalars.data_ptr(), b, tbl.data_ptr(), x.data_ptr(),
                      y.data_ptr())
    return x, y


def mul_g1(scalars):
    """[s]G1 for each column s of scalars (16, B): affine (x, y), each
    (16, B)."""
    out = _mul("mul_g1", scalars, "bn254_g1")
    if scalars.is_cuda:
        mul_g1.launches += 1
    return out


mul_g1.launches = 0


def mul_g2(scalars):
    """[s]G2: affine (x, y), each (16, 2, B)."""
    out = _mul("mul_g2", scalars, "bn254_g2")
    if scalars.is_cuda:
        mul_g2.launches += 1
    return out


mul_g2.launches = 0
