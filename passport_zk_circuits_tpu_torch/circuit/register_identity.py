"""RegisterIdentity (RSA family) lowered to R1CS — the flagship circuit.

Constraint twin of the reference's circuits/identityManagement/
registerIdentityBuilder.circom:41-196 wiring passportVerificationBuilder
.circom:11-246 (4 SHA hashes, flow shift-equality, RSA PKCS#1 v1.5,
pubkey Poseidon, slave-cert SMT, passportHash) + identity.circom:6-121
(AA key extraction, dg1 commitment, BabyJubJub pk hash), and of the
batched witness programs models/register_identity.py /
passport_verification.py — the oracle this lowering is tested against.

Scope: RSA PKCS#1 v1.5 (SIG_ALGO 1-4) and ECDSA (SIG_ALGO 20-24 via
circuit/ecdsa + circuit/weierstrass) with 32-bit-word SHA-2, RSA and
ECDSA active-authentication key extraction — the flagship config
registerIdentity_1_256_3_4_600_248_1_1496_3_256 in particular.

The port's copy of
``passport_zk_circuits_tpu/circuit/register_identity.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ingest import native
from ..models.params import CircuitParams
from ..ops.curves import CURVES
from ..ops.rsa import DIGEST_INFO
from . import babyjubjub as bjj
from . import bignum as cbn
from . import ecdsa as ce
from . import poseidon as pose
from . import sha
from . import smt as csmt
from . import weierstrass as cw
from .builder import Builder, Sig


def _blob_bits(b: Builder, blobs, block_bits: int, n_blocks: int,
               label: str) -> List[Sig]:
    words = native.pad_words32_batch(list(blobs), block_bits, n_blocks)
    bits = []
    for w in range(words.shape[0]):
        col = words[w]
        for i in range(31, -1, -1):
            s = b.input([(int(v) >> i) & 1 for v in col], label)
            b.enforce_bool(s)
            bits.append(s)
    return bits


def _bits_value_msb(b: Builder, bits: Sequence[Sig]) -> Sig:
    acc = b.const(0)
    n = len(bits)
    for j, s in enumerate(bits):
        acc = acc + s.scale(1 << (n - 1 - j))
    return acc


def _bits_value_lsb(b: Builder, bits: Sequence[Sig]) -> Sig:
    acc = b.const(0)
    for j, s in enumerate(bits):
        acc = acc + s.scale(1 << j)
    return acc


def _enforce_bits_equal(b: Builder, x: Sequence[Sig], y: Sequence[Sig]):
    """Digest-shift equality (passportVerificationFlow.circom:27-61) —
    the bits are individually boolean-constrained, so comparing their
    126-bit-packed recomposition needs one constraint per pack instead of
    one IsEqual per bit."""
    assert len(x) == len(y)
    for s in range(0, len(x), 126):
        b.enforce_eq(_bits_value_msb(b, x[s:s + 126]),
                     _bits_value_msb(b, y[s:s + 126]))


def _rsa_pubkey_hash(b: Builder, pubkey):
    """Poseidon5 of 5 x 192-bit modulus chunks
    (passportVerificationBuilder.circom:182-191)."""
    chunks = []
    for i in range(5):
        chunks.append(pubkey.limbs[3 * i].scale(1 << 128)
                      + pubkey.limbs[3 * i + 1].scale(1 << 64)
                      + pubkey.limbs[3 * i + 2])
    return pose.poseidon(b, chunks)


def build(p: CircuitParams, passports: Sequence[dict]):
    """Lower the full RegisterIdentity circuit for a batch of passports
    (dicts from ingest.synthetic). Returns (builder, outputs dict) with
    the reference's four public outputs plus verdict booleans."""
    sig = p.sig
    assert sig.family in ("rsa", "ecdsa", "rsapss"), sig.family
    b = Builder(len(passports))

    # -- inputs --------------------------------------------------------
    dg1_bits = _blob_bits(b, [pp["dg1"] for pp in passports],
                          p.dg_hash_block_size,
                          1024 // p.dg_hash_block_size, "dg1")
    ec_bits = _blob_bits(b, [pp["ec"] for pp in passports],
                         p.sig_hash_block_size, p.ec_block_number, "ec")
    sa_bits = _blob_bits(b, [pp["sa"] for pp in passports],
                         p.sig_hash_block_size,
                         1024 // p.sig_hash_block_size, "sa")
    if p.aa_signature_algo != 0:
        dg15_bits = _blob_bits(b, [pp["dg15"] for pp in passports],
                               p.dg_hash_block_size, p.dg15_block_number,
                               "dg15")
    k64 = sig.key_bits // 64
    if sig.family in ("rsa", "rsapss"):
        pubkey = cbn.from_input(b, [pp["pubkey"] for pp in passports], k64)
        signature = cbn.from_input(b, [pp["signature"] for pp in passports],
                                   k64)
    else:
        cv = CURVES[sig.curve]
        ec_pk = cw.input_point(b, [pp["pubkey"][0] for pp in passports],
                               [pp["pubkey"][1] for pp in passports], cv)
        sig_r = cbn.from_input(b, [pp["signature"][0] for pp in passports],
                               cw.k64(cv))
        sig_s = cbn.from_input(b, [pp["signature"][1] for pp in passports],
                               cw.k64(cv))
    sk = b.input([pp["sk_identity"] for pp in passports], "sk_identity")
    slave_root = b.input([pp["slave_root"] for pp in passports], "root")
    branches = [b.input([pp["slave_branches"][i] for pp in passports],
                        f"branch{i}") for i in range(80)]

    # -- hashes --------------------------------------------------------
    # EC-hash width quirk: algo 24 hashes the encapsulated content with
    # SHA-256 while signing over SHA-224 (ingest/synthetic.ec_hash_type,
    # ref passportVerificationBuilder EC_HASH_TYPE wiring)
    ec_algo = 256 if p.signature_type == 24 else sig.hash_len
    dg1_hash = sha.sha_hash_chunks(b, dg1_bits, p.dg_hash_type)
    ec_hash = sha.sha_hash_chunks(b, ec_bits, ec_algo)
    sa_hash = sha.sha_hash_chunks(b, sa_bits, sig.hash_len)
    if p.aa_signature_algo != 0:
        dg15_hash = sha.sha_hash_chunks(b, dg15_bits, p.dg_hash_type)

    # -- flow (shift equalities, passportVerificationFlow.circom) ------
    nd = p.dg_hash_type
    _enforce_bits_equal(b, dg1_hash[:nd],
                        ec_bits[p.dg1_shift:p.dg1_shift + nd])
    _enforce_bits_equal(b, ec_hash[:nd],
                        sa_bits[p.ec_shift:p.ec_shift + nd])
    if p.aa_signature_algo != 0:
        _enforce_bits_equal(b, dg15_hash[:nd],
                            ec_bits[p.dg15_shift:p.dg15_shift + nd])
        # 0x0F ASN.1 prefix 24 bits before the dg15 digest (:67-79)
        b.enforce_eq(_bits_value_msb(
            b, ec_bits[p.dg15_shift - 24:p.dg15_shift - 16]), 0x0F)

    if sig.family == "rsa":
        # -- RSA PKCS#1 v1.5 (rsa.circom:16-114, full-EM variant of
        # ops/rsa) ------------------------------------------------------
        em = cbn.pow_mod(b, signature, sig.exp, pubkey)
        n_bytes = sig.key_bits // 8
        h_bytes = sig.hash_len // 8
        prefix = DIGEST_INFO[sig.hash_len]
        ps_len = n_bytes - 3 - len(prefix) - h_bytes
        template = ([0x00, 0x01] + [0xFF] * ps_len + [0x00] + list(prefix)
                    + [None] * h_bytes)
        digest_start = n_bytes - h_bytes
        for i in range(k64):                   # little-endian 64-bit limbs
            acc = b.const(0)
            for byte in range(8):
                bidx = n_bytes - 1 - (8 * i + byte)  # big-endian byte index
                tv = template[bidx]
                if tv is None:
                    dbit = (bidx - digest_start) * 8
                    val = _bits_value_msb(b, sa_hash[dbit:dbit + 8])
                else:
                    val = b.const(tv)
                acc = acc + val.scale(1 << (8 * byte))
            b.enforce_eq(em.limbs[i], acc)
        pubkey_hash = _rsa_pubkey_hash(b, pubkey)
    elif sig.family == "rsapss":
        # -- RSA-PSS (rsaPss.circom:18-254 via circuit/rsapss) -----------
        from . import rsapss as crsapss
        crsapss.verify(b, signature, pubkey, sa_hash, sig.hash_len,
                       sig.key_bits, sig.salt_len, sig.exp)
        pubkey_hash = _rsa_pubkey_hash(b, pubkey)
    else:
        # -- ECDSA (signatures/ecdsa.circom verifyECDSABits via
        # signatureVerification.circom dispatch) -------------------------
        ce.verify(b, sig.curve, ec_pk, sig_r, sig_s,
                  sa_hash[:sig.hash_len])
        # pubkey hash: Poseidon2 of truncated coordinates
        # (passportVerificationBuilder.circom:193-231)
        pubkey_hash = ce.pubkey_hash(b, ec_pk, sig.key_bits // 2, pose)

    # -- slave-cert SMT (verdict returned, not enforced — the reference
    # comments the assert out, passportVerificationBuilder.circom:240) --
    smt_ok = csmt.verify(b, slave_root, pubkey_hash, pubkey_hash, branches)

    # -- passportHash = Poseidon1(reversed first 252 bits of SA hash) --
    zeros = [b.const(0)] * max(0, 252 - sig.hash_len)
    lsb = [sa_hash[i] for i in range(min(252, sig.hash_len))]
    passport_hash = pose.poseidon(b, [_bits_value_lsb(b, zeros + lsb)])

    # -- identity.circom ----------------------------------------------
    # dg15 AA pubkey hash (RSA-1024: 4x200 + 224 big-endian chunks :25-49;
    # ECDSA: truncated X/Y coordinates, :51-84)
    aa = p.aa_signature_algo
    if aa == 0:
        dg15_pubkey_hash = b.const(0)
    elif aa < 20:
        aa_chunks = [
            _bits_value_msb(b, dg15_bits[p.aa_shift + j * 200:
                                         p.aa_shift + (j + 1) * 200])
            for j in range(4)]
        aa_chunks.append(_bits_value_msb(
            b, dg15_bits[p.aa_shift + 800:p.aa_shift + 1024]))
        dg15_pubkey_hash = pose.poseidon(b, aa_chunks)
    else:
        # ECDSA AA: X, Y truncated to min(field, 248) low bits (witness
        # twin models/register_identity.dg15_pubkey_hash)
        field_size, keep = 256, 248
        if aa == 22:
            field_size = 320
        if aa == 23:
            field_size, keep = 192, 192
        xy_shift = field_size - keep
        aa_x = _bits_value_msb(
            b, dg15_bits[p.aa_shift + xy_shift:p.aa_shift + field_size])
        aa_y = _bits_value_msb(
            b, dg15_bits[p.aa_shift + field_size + xy_shift:
                         p.aa_shift + 2 * field_size])
        dg15_pubkey_hash = pose.poseidon(b, [aa_x, aa_y])

    chunk = 186 if p.document_type == 3 else 190
    dg1_chunks = [_bits_value_lsb(b, dg1_bits[i * chunk:(i + 1) * chunk])
                  for i in range(4)]
    sk_hash = pose.poseidon(b, [sk])
    dg1_commitment = pose.poseidon(b, dg1_chunks + [sk_hash])

    px, py = bjj.base8_mul(b, sk)
    pk_identity_hash = pose.poseidon(b, [px, py])

    return b, {
        "dg15_pubkey_hash": dg15_pubkey_hash,
        "passport_hash": passport_hash,
        "dg1_commitment": dg1_commitment,
        "pk_identity_hash": pk_identity_hash,
        "pubkey_hash": pubkey_hash,
        "smt_ok": smt_ok,
    }
