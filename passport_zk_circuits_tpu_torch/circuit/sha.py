"""Hash facade for the R1CS gadgets — dispatch by digest width.

Constraint twin of the reference's ShaHashChunks facade
(the reference's circuits/lib/circuits/hasher/hash.circom:32) and of the
witness dispatcher ops/sha2.sha_hash_chunks: 160 -> SHA-1, 224/256 ->
SHA-2-32 (512-bit blocks), 384/512 -> SHA-2-64 (1024-bit blocks).

The port's copy of
``passport_zk_circuits_tpu/circuit/sha.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import List, Sequence

from .builder import Builder, Sig
from . import sha1 as _sha1
from . import sha256 as _sha256
from . import sha512 as _sha512


def block_bits(algo: int) -> int:
    return 1024 if algo in (384, 512) else 512


def sha_hash_chunks(b: Builder, msg_bits: Sequence[Sig], algo: int
                    ) -> List[Sig]:
    if algo == 160:
        return _sha1.sha_hash_chunks(b, msg_bits)
    if algo in (224, 256):
        return _sha256.sha_hash_chunks(b, msg_bits, algo)
    if algo in (384, 512):
        return _sha512.sha_hash_chunks(b, msg_bits, algo)
    raise ValueError(f"unsupported hash width {algo}")
