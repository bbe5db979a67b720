"""The port's own copies of the JAX package's pure-Python modules
(models/params, ops/curves, utils/poseidon_ref with its Poseidon2 oracle,
babyjubjub_ref, rsa_keygen, ecdsa_ref, utils/constants/countries) and of
utils/constants/poseidon_bn254.npz, poseidon2_bn254_t3.npz and the nine
fixed_base_<curve>.npz tables (bn254_g1, bn254_g2 and secp256k1 among
them) equal the originals: the registries field by field, the constants
file by file and array by array, the oracles on seeded inputs. The copied
host modules of the proving path (circuit/builder, poseidon, sha256,
babyjubjub, register_light and the other lowerings: bignum, sha, sha1,
sha512, smt, dates, rsapss, weierstrass, ecdsa, register_identity,
query_identity; groth16/pairing and export) and of ingestion
(ingest/asn1, x509, passport, masterlist) hold the original's code,
imports and docstrings aside (their syntax trees without those), with two
exemptions: circuit/sha512 reads the SHA-512 and SHA-384 IVs under the
port's names (``H512``, ``H384`` for ``_H512``, ``_H384``), and
circuit/weierstrass's ``_gen_tables`` computes its tables in memory,
without the original's cache file (and its ``_CACHE_DIR``)."""

import ast
import dataclasses
import pathlib
import random

import numpy as np
import pytest

from passport_zk_circuits_tpu.models import params as jparams
from passport_zk_circuits_tpu.ops import curves as jcurves
from passport_zk_circuits_tpu.utils import babyjubjub_ref as jbref
from passport_zk_circuits_tpu.utils import ecdsa_ref as jecdsa_ref
from passport_zk_circuits_tpu.utils import poseidon_ref as jpref
from passport_zk_circuits_tpu.utils import rsa_keygen as jkeygen
from passport_zk_circuits_tpu.utils.constants import countries as jcountries
from passport_zk_circuits_tpu_torch.models import params
from passport_zk_circuits_tpu_torch.ops import curves
from passport_zk_circuits_tpu_torch.ops import poseidon as pos
from passport_zk_circuits_tpu_torch.ops import weierstrass as wst
from passport_zk_circuits_tpu_torch.utils import babyjubjub_ref as bref
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref
from passport_zk_circuits_tpu_torch.utils import poseidon_ref as pref
from passport_zk_circuits_tpu_torch.utils import rsa_keygen
from passport_zk_circuits_tpu_torch.utils.constants import countries

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_CONST = ROOT / "passport_zk_circuits_tpu" / "utils" / "constants"
JAX_NPZ = JAX_CONST / "poseidon_bn254.npz"
FIXED_BASE = ("p256", "brainpoolP256r1", "brainpoolP320r1",
              "brainpoolP384r1", "secp192r1", "secp224r1", "bn254_g1",
              "bn254_g2", "secp256k1")
HOST_COPIES = ("circuit/__init__.py", "circuit/builder.py",
               "circuit/poseidon.py", "circuit/sha256.py",
               "circuit/babyjubjub.py", "circuit/register_light.py",
               "circuit/bignum.py", "circuit/sha.py", "circuit/sha1.py",
               "circuit/sha512.py", "circuit/smt.py", "circuit/dates.py",
               "circuit/rsapss.py", "circuit/weierstrass.py",
               "circuit/ecdsa.py", "circuit/register_identity.py",
               "circuit/query_identity.py",
               "groth16/pairing.py", "groth16/export.py",
               "ingest/asn1.py", "ingest/x509.py", "ingest/passport.py",
               "ingest/masterlist.py")


def test_sig_algo_registry_field_by_field():
    assert sorted(params.SIG_ALGOS) == sorted(jparams.SIG_ALGOS)
    for i, algo in params.SIG_ALGOS.items():
        assert dataclasses.asdict(algo) == \
            dataclasses.asdict(jparams.SIG_ALGOS[i])


@pytest.mark.parametrize("sig", sorted(jparams.SIG_ALGOS))
def test_circuit_params_field_by_field(sig):
    name = f"registerIdentity_{sig}_256_3_4_600_248_1_1496_3_256"
    p, jp = (m.CircuitParams.from_name(name) for m in (params, jparams))
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.name == jp.name == name
    assert dataclasses.asdict(p.sig) == dataclasses.asdict(jp.sig)
    assert (p.dg_hash_block_size, p.sig_hash_block_size) == \
        (jp.dg_hash_block_size, jp.sig_hash_block_size)


def test_poseidon_npz_equal_array_by_array():
    assert pos.NPZ.read_bytes() == JAX_NPZ.read_bytes()
    with np.load(pos.NPZ) as mine, np.load(JAX_NPZ) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in theirs.files:
            assert np.array_equal(mine[k], theirs[k]), k


def test_poseidon_oracle_equal():
    rng = random.Random(31)
    for t in (2, 3, 6, 17):
        xs = [rng.randrange(pref.P) for _ in range(t - 1)]
        init = rng.randrange(pref.P)
        assert pref.poseidon(xs) == jpref.poseidon(xs)
        assert pref.poseidon_ex(xs, 2, init) == jpref.poseidon_ex(xs, 2, init)


def test_poseidon2_npz_equal_array_by_array():
    from passport_zk_circuits_tpu_torch.ops import poseidon2
    theirs = JAX_CONST / "poseidon2_bn254_t3.npz"
    assert poseidon2.NPZ.read_bytes() == theirs.read_bytes()
    with np.load(poseidon2.NPZ) as mine, np.load(theirs) as other:
        assert sorted(mine.files) == sorted(other.files) == \
            ["external", "internal"]
        for k in other.files:
            assert np.array_equal(mine[k], other[k]), k


def test_poseidon2_oracle_equal():
    rng = random.Random(36)
    for _ in range(3):
        s = [rng.randrange(pref.P) for _ in range(3)]
        assert pref.poseidon2_permutation(s) == \
            jpref.poseidon2_permutation(s)
        assert pref.poseidon2_compression(s[0], s[1]) == \
            jpref.poseidon2_compression(s[0], s[1])
    for n in (1, 2, 5):
        xs = [rng.randrange(pref.P) for _ in range(n)]
        assert pref.poseidon2_sponge(xs) == jpref.poseidon2_sponge(xs)
        assert pref.poseidon2_sponge(xs, 1) == jpref.poseidon2_sponge(xs, 1)


def test_babyjubjub_oracle_equal():
    rng = random.Random(32)
    for _ in range(3):
        s = rng.randrange(1 << 254)
        assert bref.base8_mul(s) == jbref.base8_mul(s)
    p = bref.base8_mul(5)
    assert bref.add(p, p) == jbref.add(p, p)


def test_rsa_keygen_equal():
    assert rsa_keygen.gen_rsa_key(512, random.Random(33)) == \
        jkeygen.gen_rsa_key(512, random.Random(33))


def test_curve_registry_curve_by_curve():
    assert list(curves.CURVES) == list(jcurves.CURVES)
    for name, c in curves.CURVES.items():
        assert dataclasses.asdict(c) == \
            dataclasses.asdict(jcurves.CURVES[name]), name
    assert curves.validate_all()


@pytest.mark.parametrize("name", FIXED_BASE)
def test_fixed_base_npz_equal_file_and_arrays(name):
    mine = wst.CONST_DIR / f"fixed_base_{name}.npz"
    theirs = JAX_CONST / f"fixed_base_{name}.npz"
    assert mine.read_bytes() == theirs.read_bytes()
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == ["inf", "x", "y"]
        for k in b.files:
            assert np.array_equal(a[k], b[k]), k


def test_ecdsa_oracle_equal():
    for name in ("p256", "secp192r1"):
        cv, jcv = curves.CURVES[name], jcurves.CURVES[name]
        key = ecdsa_ref.keygen(cv, random.Random(34))
        assert key == jecdsa_ref.keygen(jcv, random.Random(34))
        digest = bytes(range(32))
        sig = ecdsa_ref.sign(cv, key[0], digest, random.Random(35))
        assert sig == jecdsa_ref.sign(jcv, key[0], digest, random.Random(35))
        assert ecdsa_ref.verify(cv, key[1], digest, *sig) is True
        assert jecdsa_ref.verify(jcv, key[1], digest, *sig) is True
        assert ecdsa_ref.verify(cv, key[1], digest, sig[0], sig[1] ^ 1) == \
            jecdsa_ref.verify(jcv, key[1], digest, sig[0], sig[1] ^ 1)


def test_countries_table_equal_entry_by_entry():
    assert countries.COUNTRIES == jcountries.COUNTRIES
    assert len(countries.COUNTRIES) == 240
    assert len(set(countries.COUNTRIES)) == 240


class _Strip(ast.NodeTransformer):
    """Drops imports and docstrings from a syntax tree."""

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import

    def _body(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        node.body = body or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = _body
    visit_AsyncFunctionDef = _body


class _Rename(ast.NodeTransformer):
    """Renames attributes (``x.old`` -> ``x.new``)."""

    def __init__(self, names):
        self.names = names

    def visit_Attribute(self, node):
        self.generic_visit(node)
        node.attr = self.names.get(node.attr, node.attr)
        return node


class _Drop(ast.NodeTransformer):
    """Drops the module-level functions and assignments of given names."""

    def __init__(self, names):
        self.names = names

    def visit_Module(self, node):
        node.body = [s for s in node.body if not (
            isinstance(s, ast.FunctionDef) and s.name in self.names
            or isinstance(s, ast.Assign) and any(
                isinstance(x, ast.Name) and x.id in self.names
                for x in s.targets))]
        return node


# the one difference a copy may have from its original, applied to both
EXEMPT = {"circuit/sha512.py": _Rename({"_H512": "H512", "_H384": "H384"}),
          "circuit/weierstrass.py": _Drop({"_gen_tables", "_CACHE_DIR"})}


def _code(path: pathlib.Path, edit=None) -> str:
    tree = ast.parse(path.read_text())
    if edit is not None:
        tree = edit.visit(tree)
    return ast.dump(_Strip().visit(tree))


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_equals_the_original_imports_aside(rel):
    mine = ROOT / "passport_zk_circuits_tpu_torch" / rel
    theirs = ROOT / "passport_zk_circuits_tpu" / rel
    assert _code(mine, EXEMPT.get(rel)) == _code(theirs, EXEMPT.get(rel))
    imports = {n.module for n in ast.walk(ast.parse(mine.read_text()))
               if isinstance(n, ast.ImportFrom)}
    # every import is the stdlib's, numpy's or relative (into the port)
    assert all(m is None or m in ("__future__", "typing", "json", "struct",
                                  "numpy") or not m.startswith("passport")
               for m in imports), imports


def test_the_strip_sees_a_changed_statement(tmp_path):
    a, b = tmp_path / "a.py", tmp_path / "b.py"
    a.write_text('"""doc"""\nimport os\n\ndef f():\n    """x"""\n    return 1\n')
    b.write_text('"""other"""\nfrom . import y\n\ndef f():\n    return 1\n')
    assert _code(a) == _code(b)
    b.write_text('def f():\n    return 2\n')
    assert _code(a) != _code(b)


def test_the_exemptions_are_what_they_say():
    sha512 = (ROOT / "passport_zk_circuits_tpu_torch" / "circuit"
              / "sha512.py").read_text()
    assert "_sha2.H512" in sha512 and "_sha2._H512" not in sha512
    mine = ROOT / "passport_zk_circuits_tpu_torch" / "circuit" / \
        "weierstrass.py"
    src = ast.get_source_segment(mine.read_text(), next(
        n for n in ast.parse(mine.read_text()).body
        if isinstance(n, ast.FunctionDef) and n.name == "_gen_tables"))
    assert "_CACHE_DIR" not in mine.read_text()
    for word in ("np.load", "savez", "open(", "pickle"):
        assert word not in src.split('"""')[-1], word
    theirs = ROOT / "passport_zk_circuits_tpu" / "circuit" / "weierstrass.py"
    assert _code(mine) != _code(theirs)
    assert _code(mine, EXEMPT["circuit/weierstrass.py"]) == \
        _code(theirs, EXEMPT["circuit/weierstrass.py"])
