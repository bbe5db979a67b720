"""The port runs where JAX is absent (as on the machine with the card).

A subprocess blocks ``import jax`` (``sys.modules["jax"] = None`` makes
every import of it raise), imports every module of the port and
``chip_smoke.py``, and runs a small plain op of each kind.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import passport_zk_circuits_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch
from passport_zk_circuits_tpu_torch.ops import bignum as bn, field as fr, poseidon as pos, sha2
a = bn.to_tensor(fr.batch_to_limbs([3, 5]), "cpu")
assert fr.batch_from_limbs(fr.mul(a, a)) == [9, 25]
assert sha2.sha256_chunks(bn.to_tensor(sha2.bytes_to_words32(
    sha2.pad_message(b"abc", 512))[:, None], "cpu")).shape == (8, 1)
assert pos.poseidon([a]).shape == (16, 2)
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
print("modules", len(names))
"""


def test_chip_smoke_imports_only_the_port():
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert not any(m.split(".")[0] in ("jax", "passport_zk_circuits_tpu")
                   for m in mods), mods


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "modules" in proc.stdout
