"""Write the fixtures that hold the PyTorch port against the JAX package.

The port's fast tests cannot run the JAX RegisterIdentity forward live (its
XLA compile on the CPU takes minutes), so this tool runs it once and saves
what the port is held against: inputs at batch 2, built by the JAX
package's synthetic generator and builder from a fixed seed, and every
output of ``register_identity.forward``.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixtures.py [flagship|algos]

- ``tests/fixtures/torch_port_flagship_b2.npz``: the flagship config. Keys
  ``seed``, ``in_<PassportInputs field>``, ``in_sk_identity`` and
  ``out_<output name>`` (uint32 limbs / words, bool verdicts).
- ``tests/fixtures/torch_port_algos_b2.npz``: the configs of ``ALGOS``
  (ECDSA and RSA-PSS with active auth, SHA-1, PSS with SHA-384, ECDSA over
  brainpoolP384r1, and ECDSA active-auth keys over brainpoolP320r1 and
  secp192r1). Key ``configs`` lists the config names; each config's
  arrays carry the prefix ``c<SIG_ALGO>_`` before the keys above.

With no argument both files are written.
"""

import os
import pathlib
import random
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FLAGSHIP = "registerIdentity_1_256_3_4_600_248_1_1496_3_256"
SEED = 20240
BATCH = 2
OUT = ROOT / "tests" / "fixtures" / "torch_port_flagship_b2.npz"

ALGOS = (
    "registerIdentity_21_256_3_4_600_248_20_1496_3_256",  # ECDSA, ECDSA AA
    "registerIdentity_11_256_3_4_600_248_1_1496_3_256",   # RSA-PSS, RSA AA
    "registerIdentity_3_160_3_4_600_248_0_0_1_0",         # RSA, SHA-1
    "registerIdentity_13_256_3_4_200_248_0_0_1_0",        # PSS, SHA-384
    "registerIdentity_25_256_3_4_200_248_0_0_1_0",        # brainpoolP384r1
    "registerIdentity_1_256_3_4_600_248_22_1496_3_256",   # brainpoolP320r1 AA
    "registerIdentity_10_256_3_4_600_248_23_1496_3_256",  # secp192r1 AA
)
ALGOS_SEED = 20246
ALGOS_OUT = ROOT / "tests" / "fixtures" / "torch_port_algos_b2.npz"


def tag(name: str) -> str:
    """Key prefix of a config in the algos file."""
    return f"c{name.split('_')[1]}_"


def jax_arrays(name: str, seed: int) -> dict:
    """Inputs and outputs of the JAX forward on `name` at batch 2."""
    import jax
    from passport_zk_circuits_tpu.ingest import synthetic
    from passport_zk_circuits_tpu.ingest.builder import build_register_inputs
    from passport_zk_circuits_tpu.models import register_identity as ri
    from passport_zk_circuits_tpu.models.params import CircuitParams

    p = CircuitParams.from_name(name)
    rng = random.Random(seed)
    signer = aa = None
    pps = []
    for _ in range(BATCH):
        pp = synthetic.make_synthetic_passport(p, rng, signer_key=signer,
                                               aa_key=aa)
        signer, aa = pp["signer_key"], pp["aa_key"]
        pps.append(pp)
    inp = build_register_inputs(p, pps)
    out = jax.jit(lambda i: ri.forward(p, i))(inp)
    arrays = {"seed": np.array(seed)}
    for f in inp.passport._fields:
        arrays[f"in_{f}"] = np.asarray(getattr(inp.passport, f))
    arrays["in_sk_identity"] = np.asarray(inp.sk_identity)
    for k, v in out.items():
        if v is not None:
            arrays[f"out_{k}"] = np.asarray(v)
    return arrays


def save(path: pathlib.Path, arrays: dict) -> None:
    os.makedirs(path.parent, exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


def main(which=("flagship", "algos")):
    import jax
    jax.config.update("jax_platforms", "cpu")
    if "flagship" in which:
        save(OUT, jax_arrays(FLAGSHIP, SEED))
    if "algos" in which:
        arrays = {"configs": np.array(ALGOS)}
        for i, name in enumerate(ALGOS):
            for k, v in jax_arrays(name, ALGOS_SEED + i).items():
                arrays[tag(name) + k] = v
            print(f"{name}: done", flush=True)
        save(ALGOS_OUT, arrays)


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("flagship", "algos"))
