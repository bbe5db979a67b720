"""The port's ``ops/ecdsa.verify_blinded`` (the capability twin of the
experimental ecdsaBeta.circom) against the JAX package's and the oracle
``utils/ecdsa_ref``, over p256.

The inputs and the JAX package's verdicts come from
``tests/fixtures/torch_port_blinded_b2.npz`` (``tools/
make_torch_port_fixtures.py blinded``: the JAX function runs eagerly for
about a minute and a half, so the live comparison is slow-tier): lanes 0
and 1 valid, then a wrong beta, a wrong alpha (alpha + G), a signature of
another digest and r = 0, each of which must fail, and lane 6 valid. The
oracle's verdict of a lane: the signature verifies and alpha equals
(beta s^-1 r) PK.
"""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import bitops
from passport_zk_circuits_tpu_torch.ops import ecdsa
from passport_zk_circuits_tpu_torch.ops.curves import CURVES
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref as ref

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

NAME = "p256"
FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_port_blinded_b2.npz")
KEYS = ("pk_x", "pk_y", "signature", "words", "beta", "alpha_x", "alpha_y")


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as d:
        return dict(d)


def _port(fx, lanes):
    t = {k: bn.to_tensor(fx["in_" + k][..., lanes], "cpu") for k in KEYS}
    bits = bitops.get_bits(t.pop("words"), 0, 256)
    return ecdsa.verify_blinded(NAME, t["pk_x"], t["pk_y"], t["signature"],
                                bits, t["beta"], t["alpha_x"],
                                t["alpha_y"]).tolist()


def _oracle(fx, lane):
    cv = CURVES[NAME]
    col = {k: bn.limbs_to_int(fx["in_" + k][..., lane])
           for k in KEYS if k not in ("signature", "words")}
    r = bn.limbs_to_int(fx["in_signature"][:16, lane])
    s = bn.limbs_to_int(fx["in_signature"][16:, lane])
    digest = fx["in_words"][:, lane].astype(">u4").tobytes()
    pub = (col["pk_x"], col["pk_y"])
    if not ref.verify(cv, pub, digest, r, s):
        return False
    k = col["beta"] * pow(s, cv.n - 2, cv.n) * r % cv.n
    return ref.scalar_mul(cv, k, pub) == (col["alpha_x"], col["alpha_y"])


def test_verify_blinded_b2_equals_jax_and_the_oracle(fx):
    got = _port(fx, [0, 1])
    assert got == fx["out_ok"][:2].tolist() == [_oracle(fx, i)
                                                 for i in (0, 1)]
    assert got == [True, True]


def test_verify_blinded_fails_a_wrong_beta_alpha_digest_and_r(fx):
    want = [True, True, False, False, False, False, True]
    assert _port(fx, list(range(7))) == fx["out_ok"].tolist() == want
    assert [_oracle(fx, i) for i in range(7)] == want
    assert hashlib.sha256(bytes([0])).digest() == \
        fx["in_words"][:, 0].astype(">u4").tobytes()


@pytest.mark.slow
def test_verify_blinded_equals_jax_live(fx):
    import jax.numpy as jnp
    from passport_zk_circuits_tpu.ops import bitops as jbitops
    from passport_zk_circuits_tpu.ops import ecdsa as jecdsa
    t = {k: jnp.asarray(fx["in_" + k][..., :2]) for k in KEYS}
    ok = jecdsa.verify_blinded(NAME, t["pk_x"], t["pk_y"], t["signature"],
                               jbitops.get_bits(t["words"], 0, 256),
                               t["beta"], t["alpha_x"], t["alpha_y"])
    assert np.asarray(ok).tolist() == _port(fx, [0, 1])
