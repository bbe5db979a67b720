"""The port's SMT verifier against the JAX package and a Python-int tree.

Non-zero siblings matter here: the flagship's synthetic slave trees have
all-zero sibling paths, which exercise only the leaf-insertion branch of the
level state machine.
"""

import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import field as jfr
from passport_zk_circuits_tpu.ops import smt as jsmt
from passport_zk_circuits_tpu.utils import poseidon_ref as pref
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_poseidon
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import smt

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(5505)
DEPTH = 80


def build_smt_path(key: int, value: int, depth: int, others=()):
    """One-proof tree: root and siblings (index 0 root-most); the leaf sits
    one level past the last non-zero sibling."""
    leaf = pref.poseidon([key, value, 1])
    siblings = [others[i] if i < len(others) else 0 for i in range(depth)]
    last_nz = max((i for i, s in enumerate(siblings) if s), default=-1)
    node = leaf
    for i in range(last_nz, -1, -1):
        if (key >> i) & 1:
            node = pref.poseidon([siblings[i], node])
        else:
            node = pref.poseidon([node, siblings[i]])
    return node, siblings


def _case(others_per_lane):
    keys = [rng.randrange(fr.P) for _ in others_per_lane]
    vals = [rng.randrange(fr.P) for _ in others_per_lane]
    roots, sibs = zip(*[build_smt_path(k, v, DEPTH, o) for k, v, o in
                        zip(keys, vals, others_per_lane)])
    return (fr.batch_to_limbs(roots), fr.batch_to_limbs(keys),
            fr.batch_to_limbs(vals),
            np.stack([fr.batch_to_limbs(s) for s in zip(*sibs)], axis=1))


def _t(a):
    return bn.to_tensor(a, "cpu")


def test_smt_nonzero_siblings_match_jax():
    others = [[rng.randrange(fr.P), rng.randrange(fr.P), 0,
               rng.randrange(fr.P)], [rng.randrange(fr.P)]]
    root, key, val, sib = _case(others)
    ok, computed = smt.verify(*[_t(a) for a in (root, key, val, sib)])
    jok, jcomputed = jsmt.verify(root, key, val, sib)
    np.testing.assert_array_equal(computed.numpy(), np.asarray(jcomputed))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.all()
    assert fr.batch_from_limbs(computed) == jfr.batch_from_limbs(root)


def test_smt_single_leaf_and_wrong_root():
    root, key, val, sib = _case([()] * 4)
    ok, _ = smt.verify(*[_t(a) for a in (root, key, val, sib)])
    assert ok.all()
    bad = fr.batch_to_limbs([r + 1 for r in fr.batch_from_limbs(root)])
    ok2, _ = smt.verify(_t(bad), _t(key), _t(val), _t(sib))
    assert not ok2.any()


def test_smt_topmost_sibling_must_be_zero():
    root, key, val, sib = _case([()] * 2)
    sib[:, DEPTH - 1, 1] = fr.to_limbs(7)
    ok, _ = smt.verify(*[_t(a) for a in (root, key, val, sib)])
    assert ok.tolist() == [True, False]


def test_climb_skips_only_levels_off_the_top_path():
    # the plain climb skips levels where no lane is on the top path; a lane
    # deeper than all others must still get every level it needs
    others = [[rng.randrange(fr.P) for _ in range(6)], []]
    root, key, val, sib = _case(others)
    args = smt.climb_inputs(_t(key), _t(sib))
    assert args[2].sum(1).nonzero().numel() == 6       # levels on top path
    computed = cuda_poseidon.smt_climb_plain(*args, _t(key), _t(val))
    assert fr.batch_from_limbs(computed) == jfr.batch_from_limbs(root)


def _lev_ins_loop(sib_is_zero):
    """SMTLevIns as the JAX package computes it (ops/smt.py), level by
    level from the deepest: the closed form's reference."""
    N = sib_is_zero.shape[0]
    lev = [None] * N
    lev[N - 1] = ~sib_is_zero[N - 2]
    done = lev[N - 1]
    for i in range(N - 2, 0, -1):
        lev[i] = ~done & ~sib_is_zero[i - 1]
        done = done | lev[i]
    lev[0] = ~done
    return torch.stack(lev)


def _zero_pattern(kind, n, batch, g):
    """(n, batch) bool sibling-is-zero patterns; live-prefix lanes have
    non-zero siblings at levels 0..L-1 for L from 0 to n."""
    if kind == "all_zero":
        return torch.ones((n, batch), dtype=torch.bool)
    if kind == "all_nonzero":
        return torch.zeros((n, batch), dtype=torch.bool)
    if kind == "random":
        return torch.rand((n, batch), generator=g) < 0.5
    depth = torch.arange(n + 1).repeat(batch // (n + 1) + 1)[:batch]
    return torch.arange(n).unsqueeze(1) >= depth.unsqueeze(0)


@pytest.mark.parametrize("n", [2, 3, 80])
@pytest.mark.parametrize("kind", ["all_zero", "all_nonzero", "random",
                                  "live_prefix"])
def test_lev_ins_closed_form_matches_the_loop(kind, n):
    g = torch.Generator().manual_seed(n)
    z = _zero_pattern(kind, n, 200, g)
    got = smt._lev_ins(z)
    assert torch.equal(got, _lev_ins_loop(z))
    assert (got.sum(0) == 1).all()          # exactly one level a lane
    # and on a batch of two axes
    z3 = z.reshape(n, 8, 25)
    assert torch.equal(smt._lev_ins(z3), _lev_ins_loop(z3))
