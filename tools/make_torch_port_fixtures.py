"""Write the fixtures that hold the PyTorch port against the JAX package.

The port's fast tests cannot run the JAX RegisterIdentity forward live (its
XLA compile on the CPU takes minutes), so this tool runs it once and saves
what the port is held against: inputs at batch 2, built by the JAX
package's synthetic generator and builder from a fixed seed, and every
output of ``register_identity.forward``.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixtures.py [flagship|algos|query|prove|lowering|blinded]

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

- ``tests/fixtures/torch_port_prove_b2.npz``: the proving path at batch 2.
  The JAX package's ``msm.msm_affine`` on G1 (N = 16) and G2 (N = 8)
  points with zero scalars, infinity entries ((0, 0) with a zero scalar),
  a point beside its negation and a repeated point (keys ``msm_<g1|g2>_``
  ``px``, ``py``, ``scalars``, ``x``, ``y``); ``ntt`` and ``intt`` at
  n = 1024, batch 2 (``ntt_1024_in``, ``ntt_1024_out``,
  ``intt_1024_out``); ``g2.fixed_base_mul`` to affine
  (``fb_g2_scalars``, ``fb_g2_x``, ``fb_g2_y``); and for the demo
  circuit of ``tests/test_groth16.py`` and the 1,766-wire gadget circuit
  (BabyJubJub identity key + Poseidon) of
  ``tests/test_circuit_lowering.py`` (prefixes ``demo_``, ``gadget_``):
  the triplets (``<m>_rc`` rows and columns, ``<m>_coeff`` limbs for m in
  a, b, c), ``n_vars``, ``n_constraints``, ``n_public``, the witness,
  the public values, ``h_coefficients``, the JAX ``setup``'s keys
  (``pk_<field>``, ``vk_<field>``: points as limbs with an infinity flag)
  and its ``prove``'s proofs (``proof_a``, ``proof_b``, ``proof_c``).
  The JAX gadget setup makes its 1,766 G2 points on the host; the whole
  target takes about an hour on 8 CPU cores.

- ``tests/fixtures/torch_port_lowering.npz``: the RegisterIdentity R1CS
  lowering (``circuit/register_identity.build``) of each config of
  ``LOWERINGS`` at batch 1 on a synthetic passport of the JAX package's
  generator (seed ``LOWERING_SEED`` plus the config's index), finalized
  with the four public outputs in the order of ``LOWERING_PUBLIC``. Key
  ``configs`` lists the config names; each config's arrays carry the
  prefix ``c<SIG_ALGO>_``: ``seed``, ``n_vars``, ``n_constraints``,
  ``n_public``, ``nnz`` (the entries of A, B and C), ``public`` (the
  public values as 16-bit limbs) and ``digest_<part>``, the SHA-256 of
  each part that ``r1cs_digests`` serializes (the triplets of A, B and
  C, the labels, the witness matrix): a 514 k-row system's triplets would
  not fit a small file. ECDSA is lowered over p256 only, whose generator
  table the JAX package ships; on another curve its lowering would write
  a table file into the JAX package's tree. The target takes about 8
  minutes in one process.

- ``tests/fixtures/torch_port_blinded_b2.npz``: ``ops/ecdsa.
  verify_blinded`` (the experimental ecdsaBeta variant) over p256 on
  seven lanes of one key (the JAX package's ``utils/ecdsa_ref``, seed
  ``BLINDED_SEED``): lanes 0 and 1 valid, with blinds beta below 2^80 and
  alpha = beta s^-1 r PK; lane 2 a wrong beta (beta + 1), lane 3 a wrong
  alpha (alpha + G), lane 4 a signature of another digest, lane 5 r = 0,
  lane 6 valid. Keys ``in_pk_x``, ``in_pk_y``, ``in_signature``,
  ``in_words`` (the SHA-256 digests as big-endian 32-bit words),
  ``in_beta``, ``in_alpha_x``, ``in_alpha_y`` and ``out_ok``, the JAX
  function's verdicts (eager: about a minute and a half).

With no argument all six files are written.
"""

import hashlib
import json
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
PROVE_SEED = 20250
PROVE_OUT = ROOT / "tests" / "fixtures" / "torch_port_prove_b2.npz"
LIGHT_CONFIGS = ((3, 256), (3, 384), (1, 256))      # (document type, hash)
LOWERINGS = (
    FLAGSHIP,                                        # RSA-2048, SHA-256
    "registerIdentity_3_160_3_4_600_248_0_0_1_0",    # RSA, SHA-1
    "registerIdentity_11_256_3_4_600_248_0_0_1_0",   # RSA-PSS, SHA-256
    "registerIdentity_13_384_3_4_504_248_0_0_1_0",   # RSA-PSS, SHA-384
    "registerIdentity_20_256_3_4_600_248_0_0_1_0",   # ECDSA p256, SHA-256
)
LOWERING_SEED = 20251
LOWERING_PUBLIC = ("dg15_pubkey_hash", "passport_hash", "dg1_commitment",
                   "pk_identity_hash")
LOWERING_OUT = ROOT / "tests" / "fixtures" / "torch_port_lowering.npz"
BLINDED_SEED = 20252
BLINDED_OUT = ROOT / "tests" / "fixtures" / "torch_port_blinded_b2.npz"


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


def demo_circuit(r1):
    """The demo system of tests/test_groth16.py over ``r1``'s
    ConstraintSystem (public z, w4; private x, y, s and x's 8 bits) and
    its witness rows for lanes (x, y)."""
    cs = r1.ConstraintSystem()
    z = cs.new_var("z")
    w4 = cs.new_var("w4")
    x = cs.new_var("x")
    y = cs.new_var("y")
    cs.constrain({x: 1}, {y: 1}, {z: 1})
    s = cs.new_var("s")
    cs.constrain({x: 1, y: 1}, {0: 1}, {s: 1})
    cs.constrain({s: 1}, {s: 1}, {w4: 1})
    cs.bits(x, 8)
    return cs


def demo_rows(xs, ys, p):
    zs = [x * y % p for x, y in zip(xs, ys)]
    w4s = [(x + y) ** 2 % p for x, y in zip(xs, ys)]
    rows = [1, zs, w4s, xs, ys, [(x + y) % p for x, y in zip(xs, ys)]]
    rows += [[(x >> i) & 1 for x in xs] for i in range(8)]
    return rows, [zs, w4s]


def gadget_circuit(circuit, sks):
    """The gadget circuit of tests/test_circuit_lowering.py over the
    ``circuit`` package given: pk = Base8 * sk, public Poseidon(pk)."""
    from importlib import import_module
    cbjj = import_module(circuit + ".babyjubjub")
    cpose = import_module(circuit + ".poseidon")
    builder = import_module(circuit + ".builder")
    b = builder.Builder(len(sks))
    sk = b.input(sks)
    px, py = cbjj.base8_mul(b, sk)
    pub = b.finalize([cpose.poseidon(b, [px, py])])
    return b, pub


def _limbs(v, k=16):
    from passport_zk_circuits_tpu.ops import bignum as bn
    return bn.int_to_limbs(int(v), k)


def point_arrays(pt) -> np.ndarray:
    """A G1 (int) or G2 (FQ2) affine point -> (2, 16) or (2, 16, 2) limbs;
    infinity -> (2, 16) limbs of 0xFFFF (no coordinate's)."""
    if pt is None:
        return np.full((2, 16), 0xFFFF, np.uint32)
    if hasattr(pt[0], "coeffs"):
        return np.stack([np.stack([_limbs(c) for c in e.coeffs], axis=1)
                         for e in pt])
    return np.stack([_limbs(pt[0]), _limbs(pt[1])])


def prove_arrays(seed: int) -> dict:
    """The JAX package's MSMs, G2 fixed-base mult, h coefficients, keys and
    proofs (see the module docstring)."""
    import jax
    from passport_zk_circuits_tpu import groth16 as g16
    from passport_zk_circuits_tpu.groth16 import pairing as pr
    from passport_zk_circuits_tpu.groth16 import protocol as proto
    from passport_zk_circuits_tpu.ops import bignum as bn
    from passport_zk_circuits_tpu.ops import g2
    from passport_zk_circuits_tpu.ops import msm
    from passport_zk_circuits_tpu.ops import ntt
    from passport_zk_circuits_tpu.r1cs import system as r1

    rng = random.Random(seed)
    arrays = {"seed": np.array(seed)}
    msm_jit = proto._msm_jit            # the JAX prover's own program
    for curve, n in (("g1", 16), ("g2", 8)):
        if curve == "g1":
            pts = [proto._g1_mul(rng.randrange(1, pr.R)) for _ in range(n - 3)]
            neg = (pts[0][0], (proto._Q - pts[0][1]) % proto._Q)
            pts = pts + [neg, pts[1], None]
            q, _ = proto._g1_points_to_limbs(pts)
        else:
            pts = [pr.ec_mul(pr.G2, rng.randrange(1, pr.R))
                   for _ in range(n - 3)]
            pts = pts + [pr.ec_neg(pts[0]), pts[1], None]
            q, _ = g2.points_to_limbs(pts)
        sc = [[rng.randrange(pr.R) for _ in range(n)] for _ in range(BATCH)]
        sc[0][2] = 0                                # a zero scalar
        sc[1][0] = sc[0][0]
        sc[1][n - 3] = sc[1][0]                     # P and -P cancel
        sc[1][n - 2] = sc[1][1]                     # P twice: a doubling
        for lane in sc:
            lane[n - 1] = 0                         # the infinity entry
        sl = np.stack([bn.ints_to_limbs_batch(s, 16) for s in sc], axis=1)
        name = "bn254_g2" if curve == "g2" else "bn254_g1"
        x, y = msm_jit(q[0], q[1], sl, curve=name)
        tag = f"msm_{curve}_"
        arrays.update({tag + "px": q[0], tag + "py": q[1],
                       tag + "scalars": sl, tag + "x": np.asarray(x),
                       tag + "y": np.asarray(y)})
        print(f"msm {curve}: done", flush=True)
    vals = [rng.choice([0, 1, pr.R - 1, rng.randrange(pr.R)])
            for _ in range(1024 * BATCH)]
    a = bn.ints_to_limbs_batch(vals, 16).reshape(16, 1024, BATCH)
    f = jax.jit(ntt.ntt)(a)
    arrays.update({"ntt_1024_in": a, "ntt_1024_out": np.asarray(f),
                   "intt_1024_out": np.asarray(jax.jit(ntt.intt)(f))})
    print("ntt 1024: done", flush=True)
    fb = [rng.randrange(pr.R) for _ in range(3)] + [0, 1, pr.R - 1]
    fl = bn.ints_to_limbs_batch(fb, 16)
    x, y = jax.jit(lambda s: g2.to_affine(g2.fixed_base_mul(s)))(fl)
    arrays.update({"fb_g2_scalars": fl, "fb_g2_x": np.asarray(x),
                   "fb_g2_y": np.asarray(y)})
    print("g2 fixed base: done", flush=True)

    xs = [rng.randrange(1 << 8) for _ in range(BATCH)]
    ys = [rng.randrange(pr.R) for _ in range(BATCH)]
    rows, pub = demo_rows(xs, ys, pr.R)
    sks = [rng.randrange(1, pr.R) for _ in range(BATCH)]
    b, gpub = gadget_circuit("passport_zk_circuits_tpu.circuit", sks)
    circuits = {
        "demo": (demo_circuit(r1), r1.witness_matrix(rows, BATCH), pub, 2,
                 7, 3),
        "gadget": (b.cs, b.witness_matrix(), gpub, 1, 3, 4)}
    for name, (cs, w, pubs, n_pub, s_seed, p_seed) in circuits.items():
        tag = f"{name}_"
        for m in ("a", "b", "c"):
            mat = getattr(cs, m)
            arrays[f"{tag}{m}_rc"] = np.array(
                [(r, c) for r, c, _ in mat], np.int64).reshape(-1, 2)
            arrays[f"{tag}{m}_coeff"] = np.array(
                [_limbs(v) for _, _, v in mat], np.uint32).reshape(-1, 16)
        arrays.update({
            tag + "n_vars": np.array(cs.n_vars),
            tag + "n_constraints": np.array(cs.n_constraints),
            tag + "n_public": np.array(n_pub), tag + "witness": w,
            tag + "public": np.array([[_limbs(v) for v in lane_vals]
                                      for lane_vals in pubs], np.uint32),
            tag + "h": np.asarray(proto.h_coefficients(cs, w))})
        pk, vk = g16.setup(cs, n_public=n_pub, seed=s_seed)
        for f in ("alpha1", "beta1", "delta1", "beta2", "delta2"):
            arrays[f"{tag}pk_{f}"] = point_arrays(getattr(pk, f))
        for f in ("a_query", "b1_query", "k_query", "h_query", "b2_query",
                  "a_inf", "b1_inf", "k_inf", "b2_inf"):
            arrays[f"{tag}pk_{f}"] = np.asarray(getattr(pk, f))
        arrays[tag + "domain_size"] = np.array(pk.domain_size)
        for f in ("alpha1", "beta2", "gamma2", "delta2"):
            arrays[f"{tag}vk_{f}"] = point_arrays(getattr(vk, f))
        arrays[tag + "vk_ic"] = np.stack([point_arrays(p) for p in vk.ic])
        print(f"{name}: setup done", flush=True)
        # the prover's MSMs in chunks of the MSM cases' shapes (16 G1 and 8
        # G2 points, the last G1 chunk 8): XLA compiles each shape once,
        # where at the prover's own 2,048-point bucket a compile takes the
        # CPU hours; an MSM is a unique point whatever its chunks
        chunks = proto._MSM_CHUNK, proto._MSM_CHUNK_G2
        proto._MSM_CHUNK, proto._MSM_CHUNK_G2 = 16, 8
        try:
            proofs = g16.prove(pk, cs, w, seed=p_seed)
        finally:
            proto._MSM_CHUNK, proto._MSM_CHUNK_G2 = chunks
        for f in ("a", "b", "c"):
            arrays[f"{tag}proof_{f}"] = np.stack(
                [point_arrays(getattr(p, f)) for p in proofs])
        print(f"{name}: prove done", flush=True)
    return arrays


def r1cs_digests(b) -> dict:
    """SHA-256 hex digests of a finalized circuit builder's parts: for m in
    a, b, c its triplets (rows and columns as little-endian int64 pairs,
    then the coefficients as 32-byte little-endian ints), its labels (the
    JSON of the (wire, label) pairs in wire order) and its witness matrix
    (the uint32 array's bytes). Either package's builder goes in."""
    out = {}
    for m in ("a", "b", "c"):
        mat = getattr(b.cs, m)
        h = hashlib.sha256(np.array([(r, c) for r, c, _ in mat],
                                    "<i8").reshape(-1, 2).tobytes())
        h.update(b"".join(v.to_bytes(32, "little") for _, _, v in mat))
        out[m] = h.hexdigest()
    out["labels"] = hashlib.sha256(json.dumps(
        sorted(b.cs.labels.items())).encode()).hexdigest()
    w = np.ascontiguousarray(b.witness_matrix(), "<u4")
    out["witness"] = hashlib.sha256(w.tobytes()).hexdigest()
    return out


def lowering_passport(synthetic, p, seed: int) -> dict:
    """The one synthetic passport of a lowering case, from ``synthetic``
    (either package's ingest/synthetic: they draw the same passports)."""
    return synthetic.make_synthetic_passport(p, random.Random(seed))


def lowering_arrays(name: str, seed: int) -> dict:
    """The JAX package's RegisterIdentity lowering of `name` at batch 1,
    finalized with LOWERING_PUBLIC: sizes, public values and digests."""
    from passport_zk_circuits_tpu.circuit import register_identity as cri
    from passport_zk_circuits_tpu.ingest import synthetic
    from passport_zk_circuits_tpu.models.params import CircuitParams

    p = CircuitParams.from_name(name)
    pp = lowering_passport(synthetic, p, seed)
    b, outs = cri.build(p, [pp])
    pub = b.finalize([outs[k] for k in LOWERING_PUBLIC])
    want = synthetic.expected_outputs(p, pp)
    assert pub == [[want[k]] for k in LOWERING_PUBLIC], name
    arrays = {"seed": np.array(seed), "n_vars": np.array(b.cs.n_vars),
              "n_constraints": np.array(b.cs.n_constraints),
              "n_public": np.array(b.n_public),
              "nnz": np.array([len(b.cs.a), len(b.cs.b), len(b.cs.c)]),
              "public": np.array([[_limbs(v) for v in vals] for vals in pub],
                                 np.uint32)}
    for part, digest in r1cs_digests(b).items():
        arrays[f"digest_{part}"] = np.array(digest)
    return arrays


def blinded_arrays(seed: int) -> dict:
    """The inputs of verify_blinded's seven lanes and the JAX package's
    verdicts on them (see the module docstring)."""
    import jax.numpy as jnp
    from passport_zk_circuits_tpu.ops import bitops
    from passport_zk_circuits_tpu.ops import ecdsa
    from passport_zk_circuits_tpu.ops.curves import CURVES
    from passport_zk_circuits_tpu.utils import ecdsa_ref as ref
    rng = random.Random(seed)
    cv = CURVES["p256"]
    d, pub = ref.keygen(cv, rng)
    digests = [hashlib.sha256(bytes([i])).digest() for i in range(7)]
    sigs = [ref.sign(cv, d, dg, rng) for dg in digests]
    betas = [rng.getrandbits(80) | 1 for _ in digests]
    alphas = [ref.scalar_mul(cv, beta * pow(s, cv.n - 2, cv.n) * r % cv.n,
                             pub) for (r, s), beta in zip(sigs, betas)]
    betas[2] += 1
    alphas[3] = ref._add(cv, alphas[3], (cv.gx, cv.gy))
    digests[4] = hashlib.sha256(b"other").digest()
    sigs[5] = (0, sigs[5][1])

    def limbs(ints):
        return np.stack([_limbs(v) for v in ints], axis=-1)
    arrays = {
        "seed": np.array(seed),
        "in_pk_x": limbs([pub[0]] * 7), "in_pk_y": limbs([pub[1]] * 7),
        "in_signature": np.concatenate([limbs([r for r, _ in sigs]),
                                        limbs([s for _, s in sigs])]),
        "in_words": np.stack([np.frombuffer(dg, ">u4").astype(np.uint32)
                              for dg in digests], -1),
        "in_beta": limbs(betas),
        "in_alpha_x": limbs([a[0] for a in alphas]),
        "in_alpha_y": limbs([a[1] for a in alphas])}
    t = {k: jnp.asarray(v) for k, v in arrays.items() if k != "seed"}
    bits = bitops.get_bits(t["in_words"], 0, 256)
    ok = ecdsa.verify_blinded("p256", t["in_pk_x"], t["in_pk_y"],
                              t["in_signature"], bits, t["in_beta"],
                              t["in_alpha_x"], t["in_alpha_y"])
    arrays["out_ok"] = np.asarray(ok)
    return arrays


def save(path: pathlib.Path, arrays: dict) -> None:
    os.makedirs(path.parent, exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


def main(which=("flagship", "algos", "query", "prove", "lowering",
               "blinded")):
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
    if "prove" in which:
        save(PROVE_OUT, prove_arrays(PROVE_SEED))
    if "lowering" in which:
        arrays = {"configs": np.array(LOWERINGS)}
        for i, name in enumerate(LOWERINGS):
            for k, v in lowering_arrays(name, LOWERING_SEED + i).items():
                arrays[tag(name) + k] = v
            print(f"{name}: {int(arrays[tag(name) + 'n_constraints'])} "
                  "constraints, done", flush=True)
        save(LOWERING_OUT, arrays)
    if "blinded" in which:
        save(BLINDED_OUT, blinded_arrays(BLINDED_SEED))


if __name__ == "__main__":
    main(tuple(sys.argv[1:])
         or ("flagship", "algos", "query", "prove", "lowering",
             "blinded"))
