#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

The main path is one batched RegisterIdentity witness step on the flagship
config registerIdentity_1_256_3_4_600_248_1_1496_3_256 (RSA-2048 PKCS#1
v1.5, e = 65537, SHA-256, TD3, RSA-1024 active auth, 80-level SMT) at batch
1024. The script

1. fails unless a CUDA device is present (there is no CPU path);
2. prints the card's name and power limit (nvidia-smi);
3. builds the five hand-written kernels from csrc/ (nvcc, sm_90a);
4. runs each kernel at the flagship shapes and holds it bit for bit
   (tolerance 0: integer arithmetic) against its plain PyTorch version on
   the same CUDA tensors, and on 8+ lanes against the Python-int oracles;
5. builds flagship inputs with the port's ingest, runs
   register_identity.forward on the card, checks the four public outputs
   against the oracles, the verdicts, two tampered lanes, and that every
   kernel's launch counter moved during that forward;
6. times a few chained steps (each step's sk_identity derived from the
   previous outputs);
7. prints the kernels' JSON line, then {"ok": true, "device": ...} last.

Any failed check raises, and the script exits non-zero.
"""

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

from passport_zk_circuits_tpu_torch.ingest import builder, synthetic
from passport_zk_circuits_tpu_torch.models import register_identity as ri
from passport_zk_circuits_tpu_torch.ops import babyjubjub as bjj
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_babyjubjub
from passport_zk_circuits_tpu_torch.ops import cuda_build
from passport_zk_circuits_tpu_torch.ops import cuda_poseidon
from passport_zk_circuits_tpu_torch.ops import cuda_rsa
from passport_zk_circuits_tpu_torch.ops import cuda_sha2
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import sha2
from passport_zk_circuits_tpu_torch.ops import smt
from passport_zk_circuits_tpu_torch.shared import babyjubjub_ref as bref
from passport_zk_circuits_tpu_torch.shared import params
from passport_zk_circuits_tpu_torch.shared import poseidon_ref as pref

FLAGSHIP = "registerIdentity_1_256_3_4_600_248_1_1496_3_256"
BATCH = 1024
CHAINED_STEPS = 3
SEED = 1

# name -> (wrapper, kernel source, TPU kernel's pallas_call it replaces)
KERNELS = {
    "sha2_32_chunks": (cuda_sha2.sha2_32_chunks,
                       "passport_zk_circuits_tpu_torch/csrc/sha256.cu",
                       "passport_zk_circuits_tpu/ops/pallas_sha2.py:70"),
    "pow_mod": (cuda_rsa.pow_mod,
                "passport_zk_circuits_tpu_torch/csrc/rsa.cu",
                "passport_zk_circuits_tpu/ops/pallas_rsa.py:109"),
    "poseidon_ex": (cuda_poseidon.poseidon_ex,
                    "passport_zk_circuits_tpu_torch/csrc/poseidon.cu",
                    "passport_zk_circuits_tpu/ops/pallas_poseidon.py:382"),
    "smt_climb": (cuda_poseidon.smt_climb,
                  "passport_zk_circuits_tpu_torch/csrc/poseidon.cu",
                  "passport_zk_circuits_tpu/ops/pallas_poseidon.py:437"),
    "ladder": (cuda_babyjubjub.ladder,
               "passport_zk_circuits_tpu_torch/csrc/babyjubjub.cu",
               "passport_zk_circuits_tpu/ops/pallas_babyjubjub.py:107"),
}


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Mean device time of fn over reps runs (CUDA events), after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, kernel_fn, plain_fn, reps=10):
    """Run kernel and plain version on the same CUDA inputs; they must be
    bit-equal. Returns (kernel outputs, JSON entry without launches)."""
    k_out, p_out = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if isinstance(k_out, torch.Tensor):
        k_out, p_out = [k_out], [p_out]
    err = max(int((a - b).abs().max()) for a, b in zip(k_out, p_out))
    check(err == 0, f"{name}: kernel differs from plain (max abs {err})")
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, 1)
    _, source, replaces = KERNELS[name]
    print(f"  {name}: bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
    return k_out, {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms}


def words_to_bytes(col) -> bytes:
    return b"".join(int(v).to_bytes(4, "big") for v in col)


def phase_sha(dev, rng):
    """SHA-256 at the flagship's block counts (dg1 2, dg15 3, ec 4, sa 2),
    on real padded messages (words >= 2^31 included); SHA-224 at nb = 2."""
    msgs, words = {}, {}
    for nb in (2, 3, 4):
        msgs[nb] = [bytes(rng.randrange(256) for _ in range(
            64 * nb - 9 - rng.randrange(50))) for _ in range(BATCH)]
        words[nb] = bn.to_tensor(np.stack(
            [sha2.bytes_to_words32(sha2.pad_message(m, 512))
             for m in msgs[nb]], axis=-1), dev)
        check(bool((words[nb] >= 1 << 31).any()), "no word >= 2^31")
    step = [words[2], words[3], words[4], words[2]]
    outs, entry = compare(
        "sha2_32_chunks",
        lambda: torch.cat([cuda_sha2.sha2_32_chunks(w) for w in step]),
        lambda: torch.cat([cuda_sha2.sha2_32_chunks_plain(w) for w in step]))
    digests = outs[0].reshape(4, 8, BATCH)
    for i, nb in enumerate((2, 3, 4)):
        for lane in range(0, BATCH, BATCH // 8):
            check(words_to_bytes(digests[i][:, lane].tolist()) ==
                  sha2.sha_hash_bytes_host(msgs[nb][lane], 256),
                  f"sha256 nb={nb} lane {lane} != hashlib")
    d224 = cuda_sha2.sha2_32_chunks(words[2], 224)
    check(torch.equal(d224, cuda_sha2.sha2_32_chunks_plain(words[2], 224)),
          "sha224 kernel != plain")
    for lane in range(0, BATCH, BATCH // 8):
        check(words_to_bytes(d224[:, lane].tolist()) ==
              sha2.sha_hash_bytes_host(msgs[2][lane], 224),
              f"sha224 lane {lane} != hashlib")
    entry["shape"] = "SHA-256, B=1024, one step's four calls: nb=2,3,4,2"
    return entry


def _rsa_case(dev, rng, k, exp):
    mods = [rng.getrandbits(16 * k - 1) | (1 << (16 * k - 1)) | 1
            for _ in range(BATCH)]
    sigs = [rng.randrange(m) for m in mods]
    args = [bn.to_tensor(bn.ints_to_limbs_batch(sigs, k), dev),
            bn.to_tensor(bn.ints_to_limbs_batch(mods, k), dev),
            bn.to_tensor(bn.barrett_mu_batch(mods, k), dev)]
    return sigs, mods, args


def phase_rsa(dev, rng):
    """RSA-2048 (k = 128) with e = 65537 at B = 1024, then k = 16 with
    e in {3, 65537, 37187}."""
    sigs, mods, args = _rsa_case(dev, rng, 128, 65537)
    outs, entry = compare("pow_mod",
                          lambda: cuda_rsa.pow_mod(*args, 65537),
                          lambda: cuda_rsa.pow_mod_plain(*args, 65537))
    got = bn.limbs_to_ints_batch(outs[0][:, :8])
    check(got == [pow(s, 65537, m) for s, m in zip(sigs[:8], mods[:8])],
          "pow_mod k=128 != pow()")
    for exp in (3, 65537, 37187):
        sigs, mods, args = _rsa_case(dev, rng, 16, exp)
        out = cuda_rsa.pow_mod(*args, exp)
        check(torch.equal(out, cuda_rsa.pow_mod_plain(*args, exp)),
              f"pow_mod k=16 e={exp}: kernel != plain")
        check(bn.limbs_to_ints_batch(out[:, :8]) ==
              [pow(s, exp, m) for s, m in zip(sigs[:8], mods[:8])],
              f"pow_mod k=16 e={exp} != pow()")
    entry["shape"] = "k=128 (RSA-2048), e=65537, B=1024"
    return entry


def rand_fr(dev, rng):
    xs = [rng.randrange(fr.P) for _ in range(BATCH)]
    return xs, bn.to_tensor(fr.batch_to_limbs(xs), dev)


def phase_poseidon(dev, rng):
    """Poseidon at the flagship's widths: one step calls t = 2 twice, t = 3
    and t = 4 once, t = 6 three times."""
    cases = {}
    for t in (2, 3, 4, 6):
        cols, ts = zip(*[rand_fr(dev, rng) for _ in range(t - 1)])
        cases[t] = (cols, torch.stack(ts, 1))
    step = [2, 2, 3, 4, 6, 6, 6]
    outs, entry = compare(
        "poseidon_ex",
        lambda: torch.cat([cuda_poseidon.poseidon_ex(cases[t][1])
                           for t in step], 1),
        lambda: torch.cat([cuda_poseidon.poseidon_ex_plain(cases[t][1])
                           for t in step], 1))
    for j, t in enumerate(step):
        got = fr.batch_from_limbs(outs[0][:, j, :8])
        cols = cases[t][0]
        check(got == [pref.poseidon([c[i] for c in cols]) for i in range(8)],
              f"poseidon t={t} != oracle")
    entry["shape"] = "B=1024, one step's seven calls: t=2,2,3,4,6,6,6"
    return entry


def smt_path_root(key, value, siblings):
    """Python-int root of a one-proof SMT path (siblings[0] root-most)."""
    node = pref.poseidon([key, value, 1])
    last = max((i for i, s in enumerate(siblings) if s), default=-1)
    for i in range(last, -1, -1):
        pair = [siblings[i], node] if (key >> i) & 1 else [node, siblings[i]]
        node = pref.poseidon(pair)
    return node


def phase_smt(dev, rng):
    """The 80-level climb at B = 1024: most lanes with all-zero siblings
    as on the flagship, every eighth lane with non-zero siblings down to
    depths of up to 24."""
    n = 80
    keys, key_t = rand_fr(dev, rng)
    vals, val_t = rand_fr(dev, rng)
    sib_cols = [[0] * n for _ in range(BATCH)]
    for lane in range(1, BATCH, 8):
        depth = rng.randrange(1, 25)
        for i in range(depth):
            sib_cols[lane][i] = rng.randrange(fr.P) if rng.random() < .8 else 0
    sibs = bn.to_tensor(np.stack([fr.batch_to_limbs(c) for c in sib_cols],
                                 axis=-1), dev)            # (16, n, B)
    args = (*smt.climb_inputs(key_t, sibs), key_t, val_t)
    outs, entry = compare("smt_climb",
                          lambda: cuda_poseidon.smt_climb(*args),
                          lambda: cuda_poseidon.smt_climb_plain(*args),
                          reps=3)
    lanes = [0, 1] + list(range(9, BATCH, BATCH // 8))      # 1 mod 8: deep
    got = fr.batch_from_limbs(outs[0][:, lanes])
    want = [smt_path_root(keys[i], vals[i], sib_cols[i]) for i in lanes]
    check(got == want, "smt_climb root != oracle")
    entry["shape"] = "N=80 levels (+ the leaf's t=4 permutation), B=1024"
    return entry


def phase_ladder(dev, rng):
    """The 254-bit Base8 ladder at B = 1024 with sk in {0, 1, P-1} among
    the lanes."""
    sks, _ = rand_fr(dev, rng)
    sks[:3] = [0, 1, fr.P - 1]
    sk_t = bn.to_tensor(fr.batch_to_limbs(sks), dev)
    bits = fr.to_bits(sk_t, 254)
    bx = fr.const(bjj.BASE8_X, (BATCH,), dev)
    by = fr.const(bjj.BASE8_Y, (BATCH,), dev)
    outs, entry = compare("ladder",
                          lambda: cuda_babyjubjub.ladder(bits, bx, by),
                          lambda: cuda_babyjubjub.ladder_plain(bits, bx, by),
                          reps=3)
    ax, ay = bjj.to_affine(tuple(outs))
    lanes = list(range(8))
    got = list(zip(fr.batch_from_limbs(ax[:, lanes]),
                   fr.batch_from_limbs(ay[:, lanes])))
    check(got == [bref.base8_mul(sks[i] % (1 << 254)) for i in lanes],
          "ladder != babyjubjub oracle")
    entry["shape"] = "254 bits, B=1024"
    return entry


def flagship_batch(p, rng):
    """BATCH synthetic passports sharing the signer and AA keys; lane 0
    gets a dg1 byte flipped after signing, lane 1 a flipped signature."""
    signer = aa = None
    pps = []
    for _ in range(BATCH):
        pp = synthetic.make_synthetic_passport(p, rng, signer_key=signer,
                                               aa_key=aa)
        signer, aa = pp["signer_key"], pp["aa_key"]
        pps.append(pp)
    pps[0] = dict(pps[0], dg1=bytes([pps[0]["dg1"][0] ^ 1]) + pps[0]["dg1"][1:])
    pps[1] = dict(pps[1], signature=pps[1]["signature"] ^ 1)
    return pps


def reset_launches():
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def phase_slice(dev, rng, entries):
    p = params.CircuitParams.from_name(FLAGSHIP)
    t0 = time.perf_counter()
    pps = flagship_batch(p, rng)
    inp = builder.build_register_inputs(p, pps, dev)
    print(f"  inputs: {BATCH} passports built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = ri.forward(p, inp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}
    print(f"  forward: {first_s * 1e3:.1f} ms (first call); launches "
          f"{launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the forward")
    for e in entries:
        e["launches"] = launches[e["name"]]

    flow, sig, smt_ok = (out[k].cpu() for k in ("flow_ok", "sig_ok",
                                                "smt_ok"))
    check(not flow[0] and sig[0], "lane 0 (flipped dg1 byte) must fail flow")
    check(flow[1] and not sig[1], "lane 1 (flipped signature) must fail sig")
    check(bool(flow[2:].all() and sig[2:].all()), "flow/sig not all true")
    check(bool(smt_ok.all()), "smt_ok not all true")
    lanes = sorted({*range(min(18, BATCH)),
                    *random.Random(SEED).sample(range(BATCH), 8)})
    for name in ("passport_hash", "dg1_commitment", "pk_identity_hash",
                 "dg15_pubkey_hash"):
        got = fr.batch_from_limbs(out[name][:, lanes])
        want = [synthetic.expected_outputs(p, pps[i])[name] for i in lanes]
        check(got == want, f"{name} != oracle on sampled lanes")
    print(f"  outputs equal the oracles on {len(lanes)} lanes; verdicts ok")
    return p, inp


def chained_steps(p, inp):
    """bench.py's chained method: each step's sk_identity is derived from
    the previous step's outputs, so steps cannot overlap or be skipped."""
    def step(x):
        out = ri.forward(p, x)
        mix = out["passport_hash"] ^ out["pk_identity_hash"]
        sk = x.sk_identity ^ mix
        sk[-1] &= 0x3FF                      # stays a valid (< 2^250) sk
        return x._replace(sk_identity=sk), out

    x, out = step(inp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CHAINED_STEPS):
        x, out = step(x)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / CHAINED_STEPS
    check(bool(out["smt_ok"].all()), "chained: smt_ok not all true")
    check(bool(out["flow_ok"][2:].all() and out["sig_ok"][2:].all()),
          "chained: verdicts changed")
    return dt


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({cuda_build.BUILD_DIR})")

    rng = random.Random(SEED)
    entries = []
    for phase in (phase_sha, phase_rsa, phase_poseidon, phase_smt,
                  phase_ladder):
        print(f"phase {phase.__name__}")
        entries.append(phase(dev, rng))

    print("phase slice")
    p, inp = phase_slice(dev, rng, entries)
    dt = chained_steps(p, inp)
    print(f"chained step: {dt * 1e3:.1f} ms/step, {BATCH / dt:.1f} "
          f"witnesses/s, batch {BATCH}, {CHAINED_STEPS} steps; card: {card}")

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
