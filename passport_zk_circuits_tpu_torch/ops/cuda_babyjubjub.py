"""K5 wrapper: the BabyJubJub double-and-add ladder (csrc/babyjubjub.cu).

Replaces ``ladder`` of ``passport_zk_circuits_tpu/ops/pallas_babyjubjub.py``:
LSB-first over the scalar's bits, extended coordinates, canonical
(X, Y, Z, T) out; the caller does the one affine inversion. On the H100 the
two points (64 words) and an addition's temporaries fit in registers, and
the 254 steps are chains of dependent 256-bit Montgomery products: the
kernel is bound by integer multiply latency and throughput, not memory.
One thread per lane, the whole ladder in one launch.
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


def ladder(bits, base_x, base_y):
    """bits: (nbits, B) 0/1, LSB first; base affine (16, B) canonical.
    Returns extended (X, Y, Z, T), canonical. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if not base_x.is_cuda:
        return ladder_plain(bits, base_x, base_y)
    nbits, B = bits.shape
    bits, base_x, base_y = (x.contiguous() for x in (bits, base_x, base_y))
    if base_x.shape != (fr.NLIMBS, B) or base_y.shape != (fr.NLIMBS, B):
        raise ValueError("ladder: base must be (16, B)")
    cuda_build.require_cuda_int64("ladder", bits, base_x, base_y)
    out = torch.empty((4, fr.NLIMBS, B), dtype=torch.int64,
                      device=base_x.device)
    lib = cuda_build.library()
    with torch.cuda.device(base_x.device):
        rc = lib.pzk_ladder(bits.data_ptr(), base_x.data_ptr(),
                            base_y.data_ptr(), out.data_ptr(), nbits, B,
                            cuda_build.stream_of(base_x))
    cuda_build.check(rc, "ladder")
    ladder.launches += 1
    return tuple(out.unbind(0))


ladder.launches = 0
