"""Groth16 proving system over BN254 (snarkjs pipeline equivalent).

    setup(cs, n_public, device=...)  -> (ProvingKey, VerifyingKey)
    prove(pk, cs, witness)           -> [Proof] per batch lane (device
                                        NTT/MSM on the key's device)
    verify(vk, proof, pub)           -> bool (host pairing)
"""

from .protocol import ProvingKey, VerifyingKey, Proof, setup, prove, verify
from . import pairing

__all__ = ["ProvingKey", "VerifyingKey", "Proof", "setup", "prove",
           "verify", "pairing"]
