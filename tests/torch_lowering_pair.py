"""Build one circuit with both packages' lowerings and hold them equal.

The port's tests of ``circuit/*`` (``tests/test_torch_lowering*.py``) build
each case with the port's ``Builder`` and the JAX package's, on the same
seeded inputs at batch 2, and hold the wire and constraint counts, the
triplets (``cs.a``, ``cs.b``, ``cs.c``), the labels, the witness matrix and
the public values equal, tolerance 0.
"""

import importlib

import numpy as np

PORT, JAX = "passport_zk_circuits_tpu_torch", "passport_zk_circuits_tpu"
BATCH = 2


def mods(pkg, *names):
    """The modules ``<pkg>.circuit.<name>``."""
    return [importlib.import_module(f"{pkg}.circuit.{n}") for n in names]


def curve(pkg, name):
    return importlib.import_module(f"{pkg}.ops.curves").CURVES[name]


def build_both(make):
    """make(pkg, builder) -> the signals to make public, for a fresh Builder
    of each package at BATCH; returns [(builder, public values)], the
    port's first."""
    built = []
    for pkg in (PORT, JAX):
        b = importlib.import_module(f"{pkg}.circuit.builder").Builder(BATCH)
        sigs = make(pkg, b)
        built.append((b, b.finalize(sigs)))
    return built


def assert_equal_circuits(built):
    (b, pub), (jb, jpub) = built
    assert b.cs.n_constraints > 0
    assert (b.cs.n_vars, b.cs.n_constraints, b.n_public) == \
        (jb.cs.n_vars, jb.cs.n_constraints, jb.n_public)
    assert b.cs.a == jb.cs.a and b.cs.b == jb.cs.b and b.cs.c == jb.cs.c
    assert b.cs.labels == jb.cs.labels
    w = b.witness_matrix()
    assert w.dtype == np.uint32 and np.array_equal(w, jb.witness_matrix())
    assert pub == jpub
