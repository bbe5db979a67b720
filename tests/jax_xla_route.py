"""Keep the JAX package's references on their XLA route in the port's tests.

The JAX package sends SHA-224/256, Poseidon, the SMT climb, the BabyJubJub
ladder and RSA pow_mod through its Pallas kernels when ``PZK_PALLAS=1``
(``ops/pallas_field.use_pallas``); on the CPU they then run in interpret
mode, which takes minutes to hours a call. ``tests/test_pallas_parity.py``
sets ``PZK_PALLAS=1`` for its whole process when it is imported, and every
pytest-xdist worker imports every test module while collecting, so a
worker's port tests would otherwise take that route, or not, depending on
which files ran before them there (``tests/test_smoke.py`` deletes the
variable). The port's tests hold the port against the XLA route, the one
an unset ``PZK_PALLAS`` gives on the CPU.

Import the fixture into a test module to apply it to each of its tests::

    from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)
"""

import pytest


@pytest.fixture(autouse=True)
def jax_xla_route(monkeypatch):
    """PZK_PALLAS=0 for the test, the previous value restored after it."""
    monkeypatch.setenv("PZK_PALLAS", "0")
