"""Every SIG_ALGO id and every active-auth algorithm of RegisterIdentity on
the card, at batch 2, against the pure-Python oracles; and K2 at k = 192
(RSA-3072) with e = 37187 against its plain version. Needs a CUDA device
and skips without one. The machine with the card has no JAX, so run these
without the repository's conftest:

    python -m pytest tests/test_torch_cuda_algos.py --noconftest -q

The configs are those of the JAX package's end-to-end tests:
tests/test_register_all_algos.py (ids 4, 10, 12-14, 21-25),
tests/test_register_more_algos.py (ids 2, 3, 11), test_register_variants.py
(id 20, ECDSA active auth) and the flagship (id 1). Passports of one key
size and exponent share one signer key (Python key generation takes
seconds).
"""

import random

import pytest
import torch

from passport_zk_circuits_tpu_torch.ingest import builder, synthetic
from passport_zk_circuits_tpu_torch.models import params
from passport_zk_circuits_tpu_torch.models import register_identity as ri
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_rsa
from passport_zk_circuits_tpu_torch.ops import cuda_sha2
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.utils import rsa_keygen

pytestmark = pytest.mark.cuda

PUBLIC = ("passport_hash", "dg1_commitment", "pk_identity_hash",
          "dg15_pubkey_hash")
_SIGNERS = {}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (README)")
    return torch.device("cuda:0")


def _params(sig, dg_hash=256, ec_shift=600, aa=0, dg15_shift=0,
            dg15_blocks=1, aa_shift=0):
    return params.CircuitParams(
        signature_type=sig, dg_hash_type=dg_hash, document_type=3,
        ec_block_number=4, ec_shift=ec_shift, dg1_shift=248,
        aa_signature_algo=aa, dg15_shift=dg15_shift,
        dg15_block_number=dg15_blocks, aa_shift=aa_shift)


def _aa(sig, aa):
    return _params(sig, aa=aa, dg15_shift=1496, dg15_blocks=3, aa_shift=256)


CONFIGS = {
    1: _params(1), 2: _params(2), 3: _params(3, dg_hash=160),
    4: _params(4, dg_hash=160), 10: _params(10), 11: _params(11),
    12: _params(12), 13: _params(13, ec_shift=200), 14: _params(14),
    20: _params(20), 21: _params(21), 22: _params(22),
    23: _params(23, dg_hash=160), 24: _params(24),
    25: _params(25, ec_shift=200),
}
assert sorted(CONFIGS) == sorted(params.SIG_ALGOS)


def _signer(sig, rng):
    """One RSA signer key per (key bits, exponent); ECDSA keys are drawn
    by the generator."""
    if sig.family == "ecdsa":
        return None
    key = (sig.key_bits, sig.exp)
    if key not in _SIGNERS:
        _SIGNERS[key] = rsa_keygen.gen_rsa_key(sig.key_bits, rng, sig.exp)
    return _SIGNERS[key]


def _run(p, dev, seed):
    rng = random.Random(seed)
    signer, aa = _signer(p.sig, rng), None
    pps = []
    for _ in range(2):
        pp = synthetic.make_synthetic_passport(p, rng, signer_key=signer,
                                               aa_key=aa)
        signer, aa = pp["signer_key"], pp["aa_key"]
        pps.append(pp)
    # lane 1's signature flipped after signing: only its sig_ok fails
    bad = pps[1]["signature"]
    pps[1] = dict(pps[1], signature=(bad[0], bad[1] ^ 1)
                  if isinstance(bad, tuple) else bad ^ 1)
    inp = builder.build_register_inputs(p, pps, dev)
    before = (cuda_sha2.sha2_32_chunks_many.launches,
              cuda_sha2.sha2_32_chunks.launches, cuda_rsa.pow_mod.launches)
    out = ri.forward(p, inp)
    torch.cuda.synchronize()
    moved = [n - b for n, b in zip(
        (cuda_sha2.sha2_32_chunks_many.launches,
         cuda_sha2.sha2_32_chunks.launches, cuda_rsa.pow_mod.launches),
        before)]
    assert out["flow_ok"].tolist() == [True, True]
    assert out["smt_ok"].tolist() == [True, True]
    assert out["sig_ok"].tolist() == [True, False]
    for name in PUBLIC:
        assert fr.batch_from_limbs(out[name]) == \
            [synthetic.expected_outputs(p, pp)[name] for pp in pps], name
    return moved


@pytest.mark.parametrize("sig_id", sorted(CONFIGS))
def test_every_sig_algo(dev, sig_id):
    p = CONFIGS[sig_id]
    many, per_message, pow_mod = _run(p, dev, 900 + sig_id)
    # K1's many-message launch takes every SHA-224/256 blob; PSS with
    # SHA-256 hashes MGF1 and M' through K1's per-message entry; K2 runs
    # the modexp of the RSA families
    blobs = [p.dg_hash_type, 256 if sig_id == 24 else p.sig.hash_len,
             p.sig.hash_len]
    assert many == int(any(a in (224, 256) for a in blobs))
    assert (per_message > 0) == (p.sig.family == "rsapss"
                                 and p.sig.hash_len == 256)
    assert (pow_mod > 0) == (p.sig.family != "ecdsa")


@pytest.mark.parametrize("aa", [20, 21, 22, 23])
def test_ecdsa_active_auth(dev, aa):
    """RSA-2048 passports whose DG15 carries an ECDSA key (P-256,
    brainpoolP256r1, brainpoolP320r1, secp192r1): dg15_pubkey_hash is
    Poseidon2 of its coordinates cut to 248 bits (192 whole)."""
    _run(_aa(1, aa), dev, 950 + aa)


@pytest.mark.parametrize("n_lanes", [2, 1024])
def test_rsa3072_e37187_kernel(dev, n_lanes):
    """K2 at k = 192 (RSA-3072) with e = 37187 (SIG_ALGO 4), on random
    moduli with the top bit set, against its plain version and pow()."""
    rng = random.Random(192)
    mods = [rng.getrandbits(3071) | (1 << 3071) | 1 for _ in range(n_lanes)]
    sigs = [rng.randrange(m) for m in mods]
    sigs[0] = mods[0] - 1
    args = [bn.to_tensor(bn.ints_to_limbs_batch(sigs, 192), dev),
            bn.to_tensor(bn.ints_to_limbs_batch(mods, 192), dev),
            bn.to_tensor(bn.barrett_mu_batch(mods, 192), dev)]
    before = cuda_rsa.pow_mod.launches
    out = cuda_rsa.pow_mod(*args, 37187)
    assert cuda_rsa.pow_mod.launches == before + 1
    plain = cuda_rsa.pow_mod_plain(*args, 37187)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    lanes = list(range(min(n_lanes, 8)))
    assert bn.limbs_to_ints_batch(out[:, lanes]) == \
        [pow(sigs[i], 37187, mods[i]) for i in lanes]
