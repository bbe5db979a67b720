"""RSA-PSS (EMSA-PSS + MGF1) verification as R1CS constraints.

Constraint twin of the reference's circuits/lib/circuits/signatures/
rsaPss.circom:18-254 (VerifyRsaPssSig: PowerMod -> EM bytes, 0xBC
trailer, MGF1 dbMask, XOR unmask, salt extraction, H' = hash(0^64 ||
mHash || salt) == H) and signatures/mgf1.circom, built on
circuit/bignum.pow_mod and the circuit/sha facade. Witness oracle:
ops/rsapss.verify_pss — bit positions and the top-bit clearing mirror it
exactly.

Strengthened like the witness path (documented delta, ops/rsapss.py:10):
DB's padding bytes are constrained zero and the 0x01 separator present
(RFC 8017 §9.1.2 steps 10-11); the reference only recomputes H'.

The port's copy of
``passport_zk_circuits_tpu/circuit/rsapss.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import List, Sequence

from .builder import Builder, Sig
from .bignum import Big, W
from . import bignum as cbn
from . import sha


def _big_to_bits_msb(b: Builder, big: Big, total_bits: int) -> List[Sig]:
    """Little-endian 64-bit limb bignum -> MSB-first (reading order) bit
    list of the low total_bits bits. One Num2Bits per limb."""
    lsb: List[Sig] = []
    for limb in big.limbs:
        lsb.extend(b.num2bits(limb, W, "em_bit"))
    return [lsb[total_bits - 1 - t] for t in range(total_bits)]


def _byte_lc(b: Builder, bits_msb: Sequence[Sig]) -> Sig:
    acc = b.const(0)
    for i, s in enumerate(bits_msb):
        acc = acc + s.scale(1 << (7 - i))
    return acc


def _pad_bits(b: Builder, bits: List[Sig], algo: int) -> List[Sig]:
    """Standard MD padding over a static-length bit stream (the host-side
    sha2Common padding, fixed at lowering time since lengths are static)."""
    msg_len = len(bits)
    block = sha.block_bits(algo)
    lfield = 128 if block == 1024 else 64
    total = msg_len + 1 + lfield
    nblocks = -(-total // block)
    out = list(bits) + [b.const(1)]
    out += [b.const(0)] * (nblocks * block - msg_len - 1 - lfield)
    out += [b.const((msg_len >> (lfield - 1 - i)) & 1)
            for i in range(lfield)]
    return out


def mgf1(b: Builder, seed_bits: Sequence[Sig], out_len_bytes: int,
         algo: int) -> List[Sig]:
    """MGF1 mask bits: concat of hash(seed || counter_be32) blocks
    (mgf1.circom Mgf1Sha* analog)."""
    h_bytes = algo // 8
    n_blocks = -(-out_len_bytes // h_bytes)
    out: List[Sig] = []
    for c in range(n_blocks):
        ctr = [b.const((c >> (31 - i)) & 1) for i in range(32)]
        msg = list(seed_bits) + ctr
        out.extend(sha.sha_hash_chunks(b, _pad_bits(b, msg, algo), algo))
    return out[:out_len_bytes * 8]


def verify(b: Builder, signature: Big, pubkey: Big,
           sa_hash_bits: Sequence[Sig], hash_len: int, key_bits: int,
           salt_len: int, exp: int):
    """Enforce PSS validity of signature over mHash = sa_hash_bits."""
    em = cbn.pow_mod(b, signature, exp, pubkey)
    n_bytes = key_bits // 8
    h_bytes = hash_len // 8
    db_len = n_bytes - h_bytes - 1

    em_bits = _big_to_bits_msb(b, em, key_bits)
    # trailer == 0xBC (rsaPss.circom:60-63)
    b.enforce_eq(_byte_lc(b, em_bits[-8:]), 0xBC)

    masked_db = em_bits[:db_len * 8]
    h_sig = em_bits[db_len * 8:db_len * 8 + hash_len]

    mask = mgf1(b, h_sig, db_len, hash_len)
    # DB = maskedDB xor dbMask; top (8*emLen - emBits) = 1 bit cleared
    # (ops/rsapss.py:70, rsaPss.circom:118-134)
    db = [b.const(0)] + [b.xor(m, k)
                         for m, k in zip(masked_db[1:], mask[1:])]

    # PS zeros + 0x01 separator (strengthened, RFC 8017 §9.1.2)
    sep = db_len - salt_len - 1
    for j in range(sep):
        b.enforce_zero(_byte_lc(b, db[8 * j:8 * j + 8]))
    b.enforce_eq(_byte_lc(b, db[8 * sep:8 * sep + 8]), 0x01)
    salt = db[8 * (sep + 1):]

    # H' = hash(0^64 || mHash || salt) == H (rsaPss.circom:136-253)
    m_prime = ([b.const(0)] * 64 + list(sa_hash_bits[:hash_len])
               + list(salt))
    h_prime = sha.sha_hash_chunks(b, _pad_bits(b, m_prime, hash_len),
                                  hash_len)
    for s0 in range(0, hash_len, 126):
        acc_a = b.const(0)
        acc_b = b.const(0)
        for i, (x, y) in enumerate(zip(h_sig[s0:s0 + 126],
                                       h_prime[s0:s0 + 126])):
            acc_a = acc_a + x.scale(1 << i)
            acc_b = acc_b + y.scale(1 << i)
        b.enforce_eq(acc_a, acc_b)
    return em
