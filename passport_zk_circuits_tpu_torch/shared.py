"""The JAX package's pure-Python modules that the port shares.

The circuit parameter registry, the Poseidon and BabyJubJub oracles and RSA
key generation import neither jax nor anything that does, so the port uses
them as they are rather than keeping copies. This module is the port's one
point of contact with the JAX package's code (its constants are read from
the JAX package's ``utils/constants/*.npz`` by path).
"""

from passport_zk_circuits_tpu.models import params  # noqa: F401
from passport_zk_circuits_tpu.utils import babyjubjub_ref  # noqa: F401
from passport_zk_circuits_tpu.utils import poseidon_ref  # noqa: F401
from passport_zk_circuits_tpu.utils import rsa_keygen  # noqa: F401
