"""The port's RSA modexp and PKCS#1 v1.5 check against the JAX package.

At k = 16 (the size the JAX package's fast parity test uses) the port's
plain modexp and the JAX XLA modexp see the same seeded inputs and must
agree exactly, for the three public exponents the SIG_ALGO table uses.
"""

import hashlib
import random

import numpy as np
import torch

from passport_zk_circuits_tpu.ops import bignum as jbn
from passport_zk_circuits_tpu.ops import rsa as jrsa
from passport_zk_circuits_tpu.utils.rsa_keygen import gen_rsa_key
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_rsa
from passport_zk_circuits_tpu_torch.ops import rsa

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(3303)


def _t(a):
    return bn.to_tensor(a, "cpu")


def test_pow_mod_k16_matches_jax_and_pow():
    k = 16
    for exp in (3, 65537, 37187):
        mods = [rng.getrandbits(255) | (1 << 255) | 1 for _ in range(3)]
        sigs = [rng.randrange(m) for m in mods]
        args = [jbn.ints_to_limbs_batch(sigs, k),
                jbn.ints_to_limbs_batch(mods, k),
                jbn.barrett_mu_batch(mods, k)]
        got = cuda_rsa.pow_mod(*[_t(a) for a in args], exp)
        want = jbn.mod_pow(args[0], exp, args[1], args[2])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bn.limbs_to_ints_batch(got) == \
            [pow(s, exp, m) for s, m in zip(sigs, mods)]


def test_expected_em_matches_jax():
    for hash_len, n_words in ((256, 8), (224, 7), (160, 5)):
        d_np = np.array([[rng.randrange(1 << 32) for _ in range(3)]
                         for _ in range(n_words)], dtype=np.uint32)
        for key_bits in (1024, 2048):
            np.testing.assert_array_equal(
                rsa.expected_em_limbs(_t(d_np), hash_len, key_bits).numpy(),
                np.asarray(jrsa.expected_em_limbs(d_np, hash_len, key_bits)))


def test_verify_pkcs1v15_signed_and_tampered():
    n, e, d = gen_rsa_key(1024, rng)
    k = 64
    msgs = [b"passport %d" % i for i in range(3)]
    digests = [hashlib.sha256(m).digest() for m in msgs]
    sigs = [rsa.sign_pkcs1v15(h, d, n, 1024) for h in digests]
    assert sigs == [jrsa.sign_pkcs1v15(h, d, n, 1024) for h in digests]
    sigs[2] ^= 1
    words = _t(np.stack([np.frombuffer(h, ">u4").astype(np.uint32)
                         for h in digests], axis=-1))
    ok = rsa.verify_pkcs1v15(_t(bn.ints_to_limbs_batch(sigs, k)),
                             _t(bn.ints_to_limbs_batch([n] * 3, k)),
                             _t(bn.barrett_mu_batch([n] * 3, k)),
                             words, 256, 1024, e)
    assert ok.tolist() == [True, True, False]
