"""Constraint-level circuit lowering: the second half of SURVEY §7's
two-level program model.

`ops/` + `models/` implement the *witness program* (batched PyTorch, the
throughput path). This package implements the *constraint system* view of
the same circuits: every gadget simultaneously (a) evaluates its witness
values (batched Python-int semantics — the bit-exactness oracle) and
(b) emits R1CS constraints into `r1cs.system.ConstraintSystem`, pairing
every hint assignment with its checking constraint exactly as the
reference pairs `<--` with `===` (SURVEY §5 sanitizer discipline).

The resulting (ConstraintSystem, ordered witness vector) feeds
`r1cs.check_batched` (circom checkConstraints analog,
the reference's test/automatisationTest.js:51) and `groth16.setup/prove/
verify` (the snarkjs pipeline analog, circuits/scripts/export-keys.sh).
"""

from .builder import Builder, Sig  # noqa: F401
