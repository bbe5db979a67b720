"""The port's RSA-PSS against its host oracles and the JAX package's.

``verify_pss`` (the modexp, MGF1 and M' hashed on the device through
``sha2.sha_hash_byte_rows``) on lanes signed by the port's ``sign_pss`` and
on tampered lanes, for SIG_ALGO 10-13 at k = 128 (RSA-2048) on the CPU; the
port's EMSA-PSS encoding and MGF1 equal the JAX package's host oracles for
the same salt. The JAX verify_pss tests are slow-tier. Exact equality.
"""

import hashlib
import random

import pytest
import torch

from passport_zk_circuits_tpu.ops import rsapss as jrsapss
from passport_zk_circuits_tpu_torch.models import params
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import rsapss
from passport_zk_circuits_tpu_torch.ops import sha2
from passport_zk_circuits_tpu_torch.utils import rsa_keygen

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(7707)
_PRIMES = []


def _key(bits, exp):
    """(n, exp, d): one RSA-2048 modulus for both exponents of the PSS
    ids (3 and 65537), its primes drawn once from a seed (key generation
    takes seconds in Python)."""
    assert bits == 2048
    if not _PRIMES:
        r = random.Random(7708)
        while True:
            p, q = (rsa_keygen.gen_prime(1024, r, 3) for _ in range(2))
            if (p * q).bit_length() == 2048 and p != q and \
                    (p - 1) % 65537 and (q - 1) % 65537:
                break
        _PRIMES.extend([p, q])
    p, q = _PRIMES
    return p * q, exp, pow(exp, -1, (p - 1) * (q - 1))


@pytest.mark.parametrize("hash_len,salt_len", [(160, 20), (256, 32),
                                               (256, 64), (384, 48),
                                               (512, 64)])
def test_encoding_equals_jax_host_oracle(hash_len, salt_len):
    name = {160: "sha1", 256: "sha256", 384: "sha384", 512: "sha512"}
    mhash = hashlib.new(name[hash_len], b"sa").digest()
    salt = bytes(rng.randrange(256) for _ in range(salt_len))
    assert rsapss.emsa_pss_encode(mhash, 2048, salt) == \
        jrsapss.emsa_pss_encode(mhash, 2048, salt)
    assert rsapss._mgf1_host(mhash, 200, name[hash_len]) == \
        jrsapss._mgf1_host(mhash, 200, name[hash_len])
    n, _, d = _key(2048, 65537)
    assert rsapss.sign_pss(mhash, d, n, 2048, salt_len, random.Random(5)) \
        == jrsapss.sign_pss(mhash, d, n, 2048, salt_len, random.Random(5))


def test_mgf1_on_device_rows_equals_host():
    seeds = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(3)]
    rows = [torch.tensor([s[j] for s in seeds]) for j in range(32)]
    for algo, name in ((256, "sha256"), (384, "sha384")):
        mask = rsapss.mgf1(rows, 223, algo, (3,))
        assert mask.shape == (223, 3)
        for lane, s in enumerate(seeds):
            assert bytes(mask[:, lane].tolist()) == \
                rsapss._mgf1_host(s, 223, name)


@pytest.mark.parametrize("sig_id", [10, 11, 12, 13])
def test_verify_pss_true_and_false_lanes(sig_id):
    """Lanes: valid, signature ^ 1, valid on another message, the valid
    signature of lane 0 against lane 2's digest."""
    sig = params.SIG_ALGOS[sig_id]
    n, _, d = _key(sig.key_bits, sig.exp)
    k = sig.key_bits // 16
    msgs = [b"sa-0", b"sa-1", b"sa-2", b"sa-3"]
    digests = [sha2.sha_hash_bytes_host(m, sig.hash_len) for m in msgs]
    sigs = [rsapss.sign_pss(dg, d, n, sig.key_bits, sig.salt_len, rng)
            for dg in digests]
    sigs[1] ^= 1
    sigs[3] = sigs[0]
    words = torch.tensor([[int.from_bytes(dg[4 * i:4 * i + 4], "big")
                           for dg in digests]
                          for i in range(sig.hash_len // 32)])
    t = lambda a: bn.to_tensor(a, "cpu")          # noqa: E731
    ok = rsapss.verify_pss(t(bn.ints_to_limbs_batch(sigs, k)),
                           t(bn.ints_to_limbs_batch([n] * 4, k)),
                           t(bn.barrett_mu_batch([n] * 4, k)),
                           words, sig.hash_len, sig.key_bits, sig.salt_len,
                           sig.exp)
    assert ok.tolist() == [True, False, True, False]
    if sig.hash_len == 384:
        # the digest as SHA-384's hi/lo word pairs gives the same verdicts
        ok64 = rsapss.verify_pss(
            t(bn.ints_to_limbs_batch(sigs, k)),
            t(bn.ints_to_limbs_batch([n] * 4, k)),
            t(bn.barrett_mu_batch([n] * 4, k)), words.reshape(6, 2, 4),
            sig.hash_len, sig.key_bits, sig.salt_len, sig.exp)
        assert ok64.tolist() == ok.tolist()
