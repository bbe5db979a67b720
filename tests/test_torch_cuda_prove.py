"""Groth16 on RegisterIdentityLight at its real size on the card (batch 2):
the Light forward on the card gives the public values, the circuit
(55,438 wires, 55,805 constraints) passes ``check_batched``, and both
lanes' proofs from ``setup``/``prove`` with the device MSMs verify, while
a wrong public input fails. Needs a CUDA device and skips without one;
a whole-system test (about 2 minutes on an H100), so also slow. The
machine with the card has no JAX, so run it without the repository's
conftest:

    python -m pytest tests/test_torch_cuda_prove.py --noconftest -q

On the CPU the same prove takes over an hour (plain PyTorch MSMs over
55,438 points); there the proving path is held to the JAX package on
small circuits (tests/test_torch_groth16.py).
"""

import random

import pytest
import torch

from passport_zk_circuits_tpu_torch.circuit import register_light
from passport_zk_circuits_tpu_torch.groth16 import protocol as g16
from passport_zk_circuits_tpu_torch.ingest import identity
from passport_zk_circuits_tpu_torch.models import register_identity_light as ril
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.r1cs import system as r1

pytestmark = [pytest.mark.cuda, pytest.mark.slow]

OUTS = ("dg1_commitment", "pk_identity_hash", "dg1_hash")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (README)")
    return torch.device("cuda:0")


def test_light_proofs_verify_on_the_card(dev):
    rng = random.Random(71)
    dg1s = [identity.make_dg1(rng, 3) for _ in range(2)]
    sks = [rng.randrange(1, fr.P) for _ in range(2)]
    out = ril.forward(identity.light_inputs(dg1s, sks, 256, dev), 256, 3)
    b, outs = register_light.build(dg1s, sks)
    pub = b.finalize([outs[k] for k in OUTS])
    assert (b.cs.n_vars, b.cs.n_constraints) == (55438, 55805)
    assert [fr.batch_from_limbs(out[k]) for k in OUTS] == pub
    w = bn.to_tensor(b.witness_matrix(), dev)
    ok, _ = r1.check_batched(b.cs, w)
    assert ok.tolist() == [True, True]
    pk, vk = g16.setup(b.cs, b.n_public, seed=5, device=dev)
    proofs = g16.prove(pk, b.cs, w, seed=2)
    lanes = [[pub[j][lane] for j in range(b.n_public)] for lane in range(2)]
    for lane in range(2):
        assert g16.verify(vk, proofs[lane], lanes[lane])
    wrong = [(lanes[1][0] + 1) % fr.P] + lanes[1][1:]
    assert not g16.verify(vk, proofs[1], wrong)
