"""Circuit parameterization: the SIG_ALGO registry and the 10-parameter
RegisterIdentity specialization tuple.

The port's own copy of ``passport_zk_circuits_tpu/models/params.py``, kept
to what the port uses; ``tests/test_torch_copies.py`` holds it equal to the
JAX package's registry field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SigAlgo:
    """One row of the VerifySignature dispatch table
    (signatureVerification.circom:9-263)."""
    id: int
    family: str                 # "rsa" | "rsapss" | "ecdsa"
    key_bits: int               # RSA modulus bits or 2*curve bits for ECDSA
    hash_len: int               # 160/224/256/384/512 (digest bits)
    exp: int = 65537            # RSA public exponent
    salt_len: int = 32          # RSA-PSS salt bytes
    curve: Optional[str] = None  # ECDSA curve name


SIG_ALGOS = {a.id: a for a in [
    # RSA PKCS#1 v1.5 (ids 1-4)
    SigAlgo(1, "rsa", 2048, 256),
    SigAlgo(2, "rsa", 4096, 256),
    SigAlgo(3, "rsa", 2048, 160),
    SigAlgo(4, "rsa", 3072, 160, exp=37187),
    # RSA-PSS (ids 10-14)
    SigAlgo(10, "rsapss", 2048, 256, exp=3, salt_len=32),
    SigAlgo(11, "rsapss", 2048, 256, salt_len=32),
    SigAlgo(12, "rsapss", 2048, 256, salt_len=64),
    SigAlgo(13, "rsapss", 2048, 384, salt_len=48),
    SigAlgo(14, "rsapss", 3072, 256, salt_len=32),
    # ECDSA (ids 20-25)
    SigAlgo(20, "ecdsa", 512, 256, curve="p256"),
    SigAlgo(21, "ecdsa", 512, 256, curve="brainpoolP256r1"),
    SigAlgo(22, "ecdsa", 640, 256, curve="brainpoolP320r1"),
    SigAlgo(23, "ecdsa", 384, 160, curve="secp192r1"),
    SigAlgo(24, "ecdsa", 448, 224, curve="secp224r1"),
    SigAlgo(25, "ecdsa", 768, 384, curve="brainpoolP384r1"),
]}


@dataclasses.dataclass(frozen=True)
class CircuitParams:
    """The 10 compile-time parameters of RegisterIdentityBuilder
    (registerIdentityBuilder.circom:41-52), same order as the reference's
    generated-circuit file names
    (registerIdentity_<sig>_<dgHash>_<doc>_<ecBlocks>_<ecShift>_<dg1Shift>_
    <aaAlgo>_<dg15Shift>_<dg15Blocks>_<aaShift>, process_passport.js:783)."""
    signature_type: int          # SIG_ALGO id
    dg_hash_type: int            # 160/224/256/384/512
    document_type: int           # 1 = TD1, 3 = TD3
    ec_block_number: int         # encapsulated-content hash blocks
    ec_shift: int                # bit shift of dg1 digest inside EC
    dg1_shift: int
    aa_signature_algo: int       # 0 = none
    dg15_shift: int
    dg15_block_number: int
    aa_shift: int

    @property
    def sig(self) -> SigAlgo:
        return SIG_ALGOS[self.signature_type]

    @property
    def name(self) -> str:
        return ("registerIdentity_" + "_".join(str(x) for x in (
            self.signature_type, self.dg_hash_type, self.document_type,
            self.ec_block_number, self.ec_shift, self.dg1_shift,
            self.aa_signature_algo, self.dg15_shift,
            self.dg15_block_number, self.aa_shift)))

    @classmethod
    def from_name(cls, name: str) -> "CircuitParams":
        parts = name.split("_")[1:]
        return cls(*(int(p) for p in parts))

    @property
    def dg_hash_block_size(self) -> int:
        return 1024 if self.dg_hash_type in (384, 512) else 512

    @property
    def sig_hash_block_size(self) -> int:
        return 1024 if self.sig.hash_len in (384, 512) else 512
