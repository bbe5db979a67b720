"""K5 wrappers: the BabyJubJub double-and-add ladder (csrc/babyjubjub.cu).

Replaces ``ladder`` of ``passport_zk_circuits_tpu/ops/pallas_babyjubjub.py``
and, in its affine entry, the inversion that follows it in the JAX
package's ``scalar_mul``: LSB-first over the scalar's bits, extended
coordinates. ``ladder`` returns canonical extended (X, Y, Z, T);
``ladder_affine`` inverts Z in the kernel (Fermat) and returns canonical
affine (x, y). On the H100 the 254 steps are chains of dependent 256-bit
Montgomery products: the kernel is bound by integer multiply latency and
throughput, not memory. A team of eight threads a lane
(csrc/fr_team.cuh), one warp (four lanes) a block, the whole ladder in one
launch.
"""

from __future__ import annotations

import torch

from . import babyjubjub as bjj
from . import cuda_build
from . import field as fr


def ladder_plain(bits, base_x, base_y):
    """Plain PyTorch version. Each step's two additions (acc + base and
    base + base) run as one batched addition over 2B lanes."""
    B = base_x.shape[1]
    acc = bjj.identity((B,), base_x.device)
    base = bjj.to_extended(base_x, base_y)
    for i in range(bits.shape[0]):
        both = bjj.add(tuple(torch.cat([a, b], 1) for a, b in zip(acc, base)),
                       tuple(torch.cat([b, b], 1) for b in base))
        added = tuple(c[:, :B] for c in both)
        base = tuple(c[:, B:] for c in both)
        acc = bjj.select_point(bits[i], added, acc)
    return acc


def ladder_affine_plain(bits, base_x, base_y):
    """Plain PyTorch version of the affine entry."""
    return bjj.to_affine(ladder_plain(bits, base_x, base_y))


def _launch(name, entry, n_out, bits, base_x, base_y):
    nbits, B = bits.shape
    bits, base_x, base_y = (x.contiguous() for x in (bits, base_x, base_y))
    if base_x.shape != (fr.NLIMBS, B) or base_y.shape != (fr.NLIMBS, B):
        raise ValueError(f"{name}: base must be (16, B)")
    cuda_build.require_cuda_int64(name, bits, base_x, base_y)
    out = torch.empty((n_out, fr.NLIMBS, B), dtype=torch.int64,
                      device=base_x.device)
    cuda_build.launch(name, entry, base_x, bits.data_ptr(),
                      base_x.data_ptr(), base_y.data_ptr(), out.data_ptr(),
                      nbits, B)
    return tuple(out.unbind(0))


def ladder(bits, base_x, base_y):
    """bits: (nbits, B) 0/1, LSB first; base affine (16, B) canonical.
    Returns extended (X, Y, Z, T), canonical. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if not base_x.is_cuda:
        return ladder_plain(bits, base_x, base_y)
    out = _launch("ladder", "pzk_ladder", 4, bits, base_x, base_y)
    ladder.launches += 1
    return out


ladder.launches = 0


def ladder_affine(bits, base_x, base_y):
    """As ``ladder``, but returns affine (x, y), canonical, with the
    inversion of Z done in the kernel (inv(0) = 0 as in ``field.inv``). A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if not base_x.is_cuda:
        return ladder_affine_plain(bits, base_x, base_y)
    out = _launch("ladder_affine", "pzk_ladder_affine", 2, bits, base_x,
                  base_y)
    ladder_affine.launches += 1
    return out


ladder_affine.launches = 0
