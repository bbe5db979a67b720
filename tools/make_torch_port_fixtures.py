"""Write the fixtures that hold the PyTorch port against the JAX package.

The port's fast tests cannot run the JAX RegisterIdentity forward live (its
XLA compile on the CPU takes minutes), so this tool runs it once and saves
what the port is held against: inputs at batch 2, built by the JAX
package's synthetic generator and builder from a fixed seed, and every
output of ``register_identity.forward``.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixtures.py [flagship|algos|query]

- ``tests/fixtures/torch_port_flagship_b2.npz``: the flagship config. Keys
  ``seed``, ``in_<PassportInputs field>``, ``in_sk_identity`` and
  ``out_<output name>`` (uint32 limbs / words, bool verdicts).
- ``tests/fixtures/torch_port_algos_b2.npz``: the configs of ``ALGOS``
  (ECDSA and RSA-PSS with active auth, SHA-1, PSS with SHA-384, ECDSA over
  brainpoolP384r1, and ECDSA active-auth keys over brainpoolP320r1 and
  secp192r1). Key ``configs`` lists the config names; each config's
  arrays carry the prefix ``c<SIG_ALGO>_`` before the keys above.

- ``tests/fixtures/torch_port_query_b2.npz``: RegisterIdentityLight at
  TD3/SHA-256, TD3/SHA-384 and TD1/SHA-256 (key prefix
  ``light_td<doc>_<hash>_``; ``in_dg1_words``, ``in_sk_identity``,
  ``out_<output>``) and QueryIdentity at TD3 and TD1 with an 80-level
  identity-state path (prefix ``query_td<doc>_``; ``in_<QueryInputs
  field>``, ``out_<output>``, ``check_<check>``). The query inputs come
  from the port's ``ingest/identity`` (MRZ-layout dg1): lane 0 a valid
  witness whose path has 6 live levels, lane 1 one of 3 live levels with
  one check broken (TD3: its sk off by one, the root made from the right
  sk; TD1: its citizenship blacklisted in the mask).

With no argument all three files are written.
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
QUERY_SEED = 20249
QUERY_OUT = ROOT / "tests" / "fixtures" / "torch_port_query_b2.npz"
LIGHT_CONFIGS = ((3, 256), (3, 384), (1, 256))      # (document type, hash)


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


def query_arrays(seed: int) -> dict:
    """Light and query inputs at batch 2 from the port's ingest/identity,
    and the JAX forwards' outputs and checks on them."""
    import dataclasses

    import jax
    from passport_zk_circuits_tpu.models import query_identity as qi
    from passport_zk_circuits_tpu.models import register_identity_light as ril
    from passport_zk_circuits_tpu_torch.ingest import identity
    from passport_zk_circuits_tpu_torch.ops.field import P
    from passport_zk_circuits_tpu_torch.utils.constants.countries import \
        COUNTRIES

    rng = random.Random(seed)
    arrays = {"seed": np.array(seed)}
    for doc, h in LIGHT_CONFIGS:
        dg1s = [identity.make_dg1(rng, doc) for _ in range(BATCH)]
        sks = [rng.randrange(1, P) for _ in range(BATCH)]
        li = identity.light_inputs(dg1s, sks, h, "cpu")
        inp = ril.LightInputs(*(t.numpy().astype(np.uint32) for t in li))
        out = jax.jit(lambda i, h=h, doc=doc: ril.forward(i, h, doc))(inp)
        tag = f"light_td{doc}_{h}_"
        for f in ril.LightInputs._fields:
            arrays[f"{tag}in_{f}"] = np.asarray(getattr(inp, f))
        for k, v in out.items():
            arrays[f"{tag}out_{k}"] = np.asarray(v)
        print(f"light TD{doc}/SHA-{h}: done", flush=True)
    for doc in (3, 1):
        lanes = [identity.QueryLane(
            dg1=identity.make_dg1(rng, doc), sk_identity=rng.randrange(1, P),
            pk_passport_hash=rng.randrange(P), event_id=rng.randrange(P),
            event_data=rng.randrange(P),
            siblings=identity.live_siblings(rng, n_live),
            selector=(1 << 16) - 1 if doc == 3 else (1 << 18) - 1,
            timestamp=1716482295 + j, identity_counter=3 + j)
            for j, n_live in enumerate((6, 3))]
        if doc == 1:
            idx = COUNTRIES.index(int.from_bytes(b"UKR", "big"))
            lanes[1].citizenship_mask = 1 << (239 - idx)
        lanes = identity.with_roots(lanes, doc)
        if doc == 3:
            lanes[1] = dataclasses.replace(
                lanes[1], sk_identity=lanes[1].sk_identity + 1)
        np_inp = identity.query_arrays(lanes)
        inp = qi.QueryInputs(**np_inp)
        out, checks = jax.jit(lambda i, doc=doc: qi.forward(i, doc, 80))(inp)
        tag = f"query_td{doc}_"
        for f in qi.QueryInputs._fields:
            arrays[f"{tag}in_{f}"] = np_inp[f]
        for k, v in out.items():
            arrays[f"{tag}out_{k}"] = np.asarray(v)
        for k, v in checks.items():
            arrays[f"{tag}check_{k}"] = np.asarray(v)
        print(f"query TD{doc}: done", flush=True)
    return arrays


def save(path: pathlib.Path, arrays: dict) -> None:
    os.makedirs(path.parent, exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


def main(which=("flagship", "algos", "query")):
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
    if "query" in which:
        save(QUERY_OUT, query_arrays(QUERY_SEED))


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("flagship", "algos", "query"))
