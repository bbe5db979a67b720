"""The port stands alone: it runs where JAX and the JAX package are absent
(as on the machine with the card).

A subprocess, started in a temporary directory that holds only a copy of
the port (without its build directory) and ``chip_smoke.py``, blocks both
``import jax`` and ``import passport_zk_circuits_tpu`` (a ``None`` entry
in ``sys.modules`` makes every import of it raise), imports every module
of the port and ``chip_smoke.py``, and runs a small plain op of each kind.
No file of the JAX package is there to be opened. An AST check refuses
any import of either package in the port's sources and in
``chip_smoke.py``.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "passport_zk_circuits_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["passport_zk_circuits_tpu"] = None
import passport_zk_circuits_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch
from passport_zk_circuits_tpu_torch.ops import bignum as bn, cuda_field, cuda_loop, cuda_probe, field as fr, poseidon as pos, sha2
from passport_zk_circuits_tpu_torch.utils import poseidon_ref as pref
a = bn.to_tensor(fr.batch_to_limbs([3, 5]), "cpu")
assert fr.batch_from_limbs(fr.mul(a, a)) == [9, 25]
assert fr.batch_from_limbs(cuda_field.mul_chain(a, a[:, :1], 2)) == [27, 45]
assert cuda_loop.loop("modmul_mont32", a, a, 1).shape == (16, 2)
cuda_probe.run("mma_s8", "cpu")
cuda_probe.run_battery("cpu")
assert sha2.sha256_chunks(bn.to_tensor(sha2.bytes_to_words32(
    sha2.pad_message(b"abc", 512))[:, None], "cpu")).shape == (8, 1)
assert fr.batch_from_limbs(pos.poseidon([a])) == [pref.poseidon([3]), pref.poseidon([5])]
from passport_zk_circuits_tpu_torch.ops import bitops, ecdsa, rsapss, weierstrass as wst
from passport_zk_circuits_tpu_torch.ops.curves import CURVES
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref
for algo in (160, 384, 512):
    assert sha2.sha_hash_byte_rows([a[0]], algo, (2,)).shape == (algo // 8, 2)
cv = CURVES["secp192r1"]
c = wst.ctx(cv.name)
d, q = ecdsa_ref.keygen(cv, __import__("random").Random(1))
r, s = ecdsa_ref.sign(cv, d, bytes(20), __import__("random").Random(2))
k = c.k
lim = lambda v: bn.to_tensor(bn.ints_to_limbs_batch([v], k), "cpu")
ok = ecdsa.verify(cv.name, lim(q[0]), lim(q[1]), torch.cat([lim(r), lim(s)]),
                  torch.zeros((160, 1), dtype=torch.int64))
assert ok.tolist() == [True]
assert wst.fixed_base_table("p256", torch.device("cpu"))[0].shape == (32, 16, 256)
assert rsapss.emsa_pss_encode(bytes(32), 1024, bytes(32)) > 0
from passport_zk_circuits_tpu_torch.ops import dates
from passport_zk_circuits_tpu_torch.models import query_identity, register_identity_light
from passport_zk_circuits_tpu_torch.utils.constants.countries import COUNTRIES
enc = bn.to_tensor(fr.batch_to_limbs([int.from_bytes(b"900115", "big")]), "cpu")
assert [int(x) for x in dates.decode(enc)] == [15, 1, 90, 1]
assert len(COUNTRIES) == 240
from passport_zk_circuits_tpu_torch.circuit import babyjubjub as cbjj, builder, poseidon as cpose, register_light, sha256 as csha
from passport_zk_circuits_tpu_torch.groth16 import export, pairing, protocol
from passport_zk_circuits_tpu_torch.ingest import native
from passport_zk_circuits_tpu_torch.ops import g2, msm, ntt
from passport_zk_circuits_tpu_torch.r1cs import system as r1
bld = builder.Builder(2)
x = bld.input([3, 4])
bld.finalize([x * x])
ok, _ = r1.check_batched(bld.cs, bld.witness_matrix(), device="cpu")
assert ok.tolist() == [True, True]
assert native.pad_words32_batch([b"abc"], 512, 1).shape == (16, 1)
assert torch.equal(ntt.intt(ntt.ntt(a[:, :2, None])), a[:, :2, None])
g = protocol._g1_points_to_limbs([protocol._g1_mul(2), protocol._g1_mul(7)])[0]
px, py = msm.msm_affine(bn.to_tensor(g[0], "cpu"), bn.to_tensor(g[1], "cpu"),
                        a[:, None, :])
assert (bn.limbs_to_int(px[:, 0]), bn.limbs_to_int(py[:, 0])) == protocol._g1_mul(41)
qx, qy = g2.to_affine(g2.fixed_base_mul(a[:, :1]))
assert g2.limbs_to_point(qx[..., 0], qy[..., 0]) == pairing.ec_mul(pairing.G2, 3)
assert export.public_to_json([1, 2]).count("\n") >= 2
import random
from passport_zk_circuits_tpu_torch import api, entry
from passport_zk_circuits_tpu_torch.ingest import asn1, masterlist, passport, x509
from passport_zk_circuits_tpu_torch.ops import ecrecover, keccak, poseidon2
from passport_zk_circuits_tpu_torch.parallel import distributed, mesh as pmesh
assert bytes(torch.stack(keccak.keccak256_bytes(torch.tensor([[97], [98], [99]])))[:, 0].tolist()).hex().startswith("4e03657a")
z = bn.to_tensor(fr.batch_to_limbs([1]), "cpu")
assert fr.batch_from_limbs(poseidon2.permutation(z, z, z)[0]) == [pref.poseidon2_permutation([1, 1, 1])[0]]
assert wst.fixed_base_table("secp256k1", torch.device("cpu"))[0].shape[1:] == (16, 256)
assert asn1.parse(asn1.seq(asn1.integer(5))).child(0).as_int() == 5
sod, _ = passport.build_sod(bytes(93), None, 20, 256, random.Random(3), with_certificate=False)
params, wit = api.ingest(bytes(93), None, sod, aa_algo=0)
assert params.signature_type == 20 and wit["slave_branches"] == [0] * 80
assert masterlist.SparseMerkleTree(8).root() == 0
assert callable(ecrecover.recover) and callable(x509.parse_spki)
assert callable(entry.dryrun_multichip) and distributed.process_count() == 1
assert len(pmesh.shard_inputs({"x": a}, pmesh.make_mesh(2, device_type="cpu"))) == 2
try:
    api.compile(params)
    raise AssertionError("api.compile ran without a card")
except RuntimeError:
    pass
bad = [m for m, v in sys.modules.items() if v is not None and
       (m.split(".")[0] in ("jax", "passport_zk_circuits_tpu"))]
assert not bad, bad
print("modules", len(names))
"""


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    return mods


def _forbidden(mod: str) -> bool:
    return any(mod == p or mod.startswith(p + ".")
               for p in ("jax", "passport_zk_circuits_tpu"))


@pytest.mark.parametrize("mod,refused", [
    ("jax", True), ("jax.numpy", True), ("passport_zk_circuits_tpu", True),
    ("passport_zk_circuits_tpu.utils.poseidon_ref", True),
    ("passport_zk_circuits_tpu_torch.utils.poseidon_ref", False),
    ("torch", False)])
def test_forbidden_names(mod, refused):
    assert _forbidden(mod) == refused


def test_chip_smoke_imports_only_the_port():
    files = [ROOT / "chip_smoke.py", *sorted(PORT.rglob("*.py"))]
    bad = {str(f.relative_to(ROOT)): sorted(m for m in _imported_modules(f)
                                            if _forbidden(m))
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_port_imports_and_runs_without_jax(tmp_path):
    shutil.copytree(PORT, tmp_path / PORT.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "modules" in proc.stdout
