"""RegisterIdentityLight lowered to R1CS.

Constraint twin of the reference's circuits/identityManagement/
registerIdentityLight.circom:15-92 and of the batched witness program
models/register_identity_light.py: dg1 commitment (4 reversed-bit chunks +
Poseidon1(sk)), BabyJubJub pk hash, and SHA(dg1) truncated to 248 bits.

`build(dg1_blobs, sk_values)` returns (Builder, outputs dict) — the
Builder carries the ConstraintSystem and the ordered batched witness.

The port's copy of
``passport_zk_circuits_tpu/circuit/register_light.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ingest import native
from . import babyjubjub as bjj
from . import poseidon as pose
from . import sha256
from .builder import Builder, Sig


def _blob_bits(b: Builder, blobs: Sequence[bytes], block_bits: int,
               n_blocks: int) -> List[Sig]:
    """Pre-padded message bits as boolean input wires (bool-constrained:
    these are private inputs, so their bitness must be enforced)."""
    words = native.pad_words32_batch(list(blobs), block_bits, n_blocks)
    bits = []
    for w in range(words.shape[0]):
        col = words[w]
        for i in range(31, -1, -1):
            s = b.input([(int(v) >> i) & 1 for v in col], "dg1_bit")
            b.enforce_bool(s)
            bits.append(s)
    return bits


def _bits_value_lsb(b: Builder, bits: Sequence[Sig]) -> Sig:
    """sum bits[j] << j (the reversed Bits2Num wiring of identity.circom:100)."""
    acc = b.const(0)
    for j, s in enumerate(bits):
        acc = acc + s.scale(1 << j)
    return acc


def _bits_value_msb(b: Builder, bits: Sequence[Sig]) -> Sig:
    acc = b.const(0)
    n = len(bits)
    for j, s in enumerate(bits):
        acc = acc + s.scale(1 << (n - 1 - j))
    return acc


def build(dg1_blobs: Sequence[bytes], sk_values: Sequence[int],
          dg_hash_type: int = 256, document_type: int = 3):
    """Lower RegisterIdentityLight for a batch of instances. Returns
    (builder, {dg1_commitment, pk_identity_hash, dg1_hash} Sigs)."""
    assert dg_hash_type in (224, 256), "R1CS light circuit: SHA-2-32 only"
    b = Builder(len(dg1_blobs))

    bits = _blob_bits(b, dg1_blobs, 512, 2)     # 1024 padded bits (2 blocks)
    sk = b.input(sk_values, "sk_identity")

    # dg1 commitment: 4 chunks of 186 (TD3) / 190 (TD1) bits, LSB-first
    chunk = 186 if document_type == 3 else 190
    chunks = [_bits_value_lsb(b, bits[i * chunk:(i + 1) * chunk])
              for i in range(4)]
    sk_hash = pose.poseidon(b, [sk])
    dg1_commitment = pose.poseidon(b, chunks + [sk_hash])

    # pk identity hash
    px, py = bjj.base8_mul(b, sk)
    pk_identity_hash = pose.poseidon(b, [px, py])

    # dg1Hash = digest mod 2^248, big-endian bits
    digest = sha256.sha_hash_chunks(b, bits, dg_hash_type)
    keep = min(248, dg_hash_type)
    dg1_hash = _bits_value_msb(b, digest[dg_hash_type - keep:])

    return b, {"dg1_commitment": dg1_commitment,
               "pk_identity_hash": pk_identity_hash,
               "dg1_hash": dg1_hash}
