"""Write tests/fixtures/torch_port_flagship_b2.npz from the JAX package.

The PyTorch port's fast tests cannot run the JAX flagship forward live (its
XLA compile on the CPU takes minutes), so this tool runs it once and saves
what the port is held against: the flagship inputs at batch 2, built by the
JAX package's synthetic generator and builder from a fixed seed, and every
output of ``register_identity.forward``.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixtures.py

Keys: ``seed``, ``in_<PassportInputs field>``, ``in_sk_identity`` and
``out_<output name>`` (uint32 limbs / words, bool verdicts).
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


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from passport_zk_circuits_tpu.ingest import synthetic
    from passport_zk_circuits_tpu.ingest.builder import build_register_inputs
    from passport_zk_circuits_tpu.models import register_identity as ri
    from passport_zk_circuits_tpu.models.params import CircuitParams

    p = CircuitParams.from_name(FLAGSHIP)
    rng = random.Random(SEED)
    signer = aa = None
    pps = []
    for _ in range(BATCH):
        pp = synthetic.make_synthetic_passport(p, rng, signer_key=signer,
                                               aa_key=aa)
        signer, aa = pp["signer_key"], pp["aa_key"]
        pps.append(pp)
    inp = build_register_inputs(p, pps)
    out = jax.jit(lambda i: ri.forward(p, i))(inp)
    arrays = {"seed": np.array(SEED)}
    for f in inp.passport._fields:
        arrays[f"in_{f}"] = np.asarray(getattr(inp.passport, f))
    arrays["in_sk_identity"] = np.asarray(inp.sk_identity)
    for k, v in out.items():
        if v is not None:
            arrays[f"out_{k}"] = np.asarray(v)
    os.makedirs(OUT.parent, exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
