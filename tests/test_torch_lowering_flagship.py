"""The port's RegisterIdentity R1CS lowering (``circuit/register_identity``)
against the JAX package's, through ``tests/fixtures/torch_port_lowering.npz``,
tolerance 0.

A lowering of one of these configs takes the host 30-120 s a package, so
the JAX package's side was built once by ``tools/make_torch_port_fixtures.py
lowering`` at batch 1, on a synthetic passport of its generator (which the
port's generator draws equal from the same seed), finalized with the four
public outputs. The file holds each circuit's sizes, public values and the
SHA-256 of its triplets, labels and witness matrix (``r1cs_digests``); the
port builds the same circuit and must give the same.

* The flagship ``registerIdentity_1_256_3_4_600_248_1_1496_3_256`` (fast
  tier, one port build of about 35 s): 511,677 wires, 514,800 constraints,
  domain 2^19; its public values also equal the port's flagship forward on
  the CPU on the same passport.
* Slow tier: SIG_ALGO 3 (RSA, SHA-1), 11 (RSA-PSS, SHA-256), 13 (RSA-PSS,
  SHA-384) and 20 (ECDSA over p256: 1,578,650 wires, 1,589,942
  constraints).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu_torch.circuit import register_identity as cri
from passport_zk_circuits_tpu_torch.ingest import builder, synthetic
from passport_zk_circuits_tpu_torch.models import params
from passport_zk_circuits_tpu_torch.models import register_identity as ri
from passport_zk_circuits_tpu_torch.ops import field as fr

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import make_torch_port_fixtures as fx  # noqa: E402

torch.set_num_threads(1)

# the flagship's R1CS: wires, constraints, QAP domain
FLAGSHIP_R1CS = (511677, 514800, 1 << 19)


def build(name):
    """The port's lowering of config `name` on the fixture's passport, and
    the fixture's arrays of that config."""
    with np.load(fx.LOWERING_OUT) as d:
        assert name in d["configs"].tolist()
        t = fx.tag(name)
        want = {k[len(t):]: d[k] for k in d.files if k.startswith(t)}
    p = params.CircuitParams.from_name(name)
    pp = fx.lowering_passport(synthetic, p, int(want["seed"]))
    b, outs = cri.build(p, [pp])
    pub = b.finalize([outs[k] for k in fx.LOWERING_PUBLIC])
    return p, pp, b, pub, want


def assert_equals_fixture(b, pub, want):
    assert (b.cs.n_vars, b.cs.n_constraints, b.n_public) == tuple(
        int(want[k]) for k in ("n_vars", "n_constraints", "n_public"))
    assert [len(b.cs.a), len(b.cs.b), len(b.cs.c)] == want["nnz"].tolist()
    assert [fr.batch_from_limbs(v.T) for v in want["public"]] == pub
    for part, digest in fx.r1cs_digests(b).items():
        assert digest == str(want[f"digest_{part}"]), part


@pytest.fixture(scope="module")
def flagship():
    return build(fx.FLAGSHIP)


def test_flagship_lowering_equals_the_jax_fixture(flagship):
    _, _, b, pub, want = flagship
    assert_equals_fixture(b, pub, want)


def test_flagship_lowering_size(flagship):
    _, _, b, _, _ = flagship
    dom = 1 << (b.cs.n_constraints - 1).bit_length()
    assert (b.cs.n_vars, b.cs.n_constraints, dom) == FLAGSHIP_R1CS


def test_flagship_public_values_equal_the_port_forward(flagship):
    p, pp, _, pub, _ = flagship
    out = ri.forward(p, builder.build_register_inputs(p, [pp], "cpu"))
    assert [fr.batch_from_limbs(out[k]) for k in fx.LOWERING_PUBLIC] == pub
    assert pub == [[synthetic.expected_outputs(p, pp)[k]]
                   for k in fx.LOWERING_PUBLIC]
    assert all(bool(out[k].all()) for k in ("flow_ok", "sig_ok", "smt_ok"))


@pytest.mark.slow
@pytest.mark.parametrize("name", fx.LOWERINGS[1:])
def test_lowering_equals_the_jax_fixture(name):
    _, _, b, pub, want = build(name)
    assert_equals_fixture(b, pub, want)
