"""Circuit builder: signals as linear combinations, eager batched witness
evaluation, R1CS emission.

Mirrors circom's programming model (signals are Fr linear combinations;
only multiplications allocate constraints; `<--` hints must be re-
constrained) on top of `r1cs.system.ConstraintSystem`. Witness values are
evaluated eagerly over numpy *object* arrays of Python ints — one array
slot per batch instance — so the builder yields both the constraint
matrices and the ordered witness vector in a single pass.

Reference semantics: signals/constraints of Circom 2.1.6
(the reference's circuits/lib/circuits/bitify/bitify.circom:10-55 Num2Bits/
Bits2Num, comparators.circom IsZero/IsEqual, utils/switcher.circom).

The port's copy of ``passport_zk_circuits_tpu/circuit/builder.py`` (host
code over Python ints), with the same relative imports, which here name
the port's modules; ``tests/test_torch_copies.py`` holds its code equal
to the original's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from ..ops import field as fr
from ..r1cs.system import ConstraintSystem

P = fr.P


class Sig:
    """A signal: linear combination {wire: coeff} over Fr.

    Supports +, -, * (by constants or by another Sig — the latter
    allocates a multiplication constraint via the owning Builder)."""

    __slots__ = ("b", "lc")

    def __init__(self, b: "Builder", lc: Dict[int, int]):
        self.b = b
        self.lc = lc

    # -- linear ops (free) --------------------------------------------

    def _lin(self, other, sign: int) -> "Sig":
        other = self.b.as_sig(other)
        lc = dict(self.lc)
        for v, c in other.lc.items():
            lc[v] = (lc.get(v, 0) + sign * c) % P
            if lc[v] == 0:
                del lc[v]
        return Sig(self.b, lc)

    def __add__(self, other):
        return self._lin(other, 1)

    __radd__ = __add__

    def __sub__(self, other):
        return self._lin(other, -1)

    def __rsub__(self, other):
        return self.b.as_sig(other) - self

    def __neg__(self):
        return Sig(self.b, {v: (-c) % P for v, c in self.lc.items()})

    def scale(self, k: int) -> "Sig":
        k %= P
        if k == 0:
            return Sig(self.b, {})
        return Sig(self.b, {v: c * k % P for v, c in self.lc.items()})

    def __mul__(self, other):
        if isinstance(other, int):
            return self.scale(other)
        return self.b.mul(self, other)

    def __rmul__(self, other):
        if isinstance(other, int):
            return self.scale(other)
        return NotImplemented

    # -- witness view --------------------------------------------------

    def val(self) -> np.ndarray:
        return self.b.eval_lc(self.lc)

    def ints(self) -> List[int]:
        return [int(x) for x in self.val()]


SigLike = Union[Sig, int]


class Builder:
    """Builds a ConstraintSystem + ordered witness for a fixed batch."""

    def __init__(self, batch: int):
        self.batch = batch
        self.cs = ConstraintSystem()
        ones = np.empty(batch, dtype=object)
        ones[:] = 1
        self.vals: List[np.ndarray] = [ones]     # wire 0 = constant 1
        self.n_public = 0

    # -- signal construction ------------------------------------------

    def const(self, c: int) -> Sig:
        c %= P
        return Sig(self, {0: c} if c else {})

    def as_sig(self, x: SigLike) -> Sig:
        if isinstance(x, Sig):
            return x
        return self.const(x)

    def _vec(self, values) -> np.ndarray:
        out = np.empty(self.batch, dtype=object)
        if isinstance(values, (int, np.integer)):
            out[:] = int(values) % P
        else:
            vs = list(values)
            assert len(vs) == self.batch
            for i, v in enumerate(vs):
                out[i] = int(v) % P
        return out

    def _new_wire(self, values, label: str = "") -> int:
        idx = self.cs.new_var(label)
        self.vals.append(self._vec(values))
        return idx

    def input(self, values, label: str = "in") -> Sig:
        """Private input signal with explicit per-instance values."""
        return Sig(self, {self._new_wire(values, label): 1})

    def eval_lc(self, lc: Dict[int, int]) -> np.ndarray:
        acc = np.empty(self.batch, dtype=object)
        acc[:] = 0
        for v, c in lc.items():
            acc = acc + self.vals[v] * c
        return acc % P

    # -- constraints ---------------------------------------------------

    def enforce(self, a: SigLike, b: SigLike, c: SigLike):
        """a * b = c (one R1CS row); witness-checked eagerly."""
        a, b, c = self.as_sig(a), self.as_sig(b), self.as_sig(c)
        self.cs.constrain(a.lc, b.lc, c.lc)
        if __debug__:
            av, bv, cv = a.val(), b.val(), c.val()
            bad = (av * bv - cv) % P
            assert not bad.any(), "constraint violated at build time"

    def enforce_zero(self, a: SigLike):
        self.enforce(a, 1, 0)

    def enforce_eq(self, a: SigLike, b: SigLike):
        self.enforce(self.as_sig(a) - b, 1, 0)

    def enforce_bool(self, x: SigLike):
        x = self.as_sig(x)
        self.enforce(x, x - 1, 0)

    # -- multiplication / hints ---------------------------------------

    def mul(self, x: SigLike, y: SigLike, label: str = "mul") -> Sig:
        x, y = self.as_sig(x), self.as_sig(y)
        # constant folding: keep pure-linear work out of the matrices
        if not x.lc or x.lc.keys() == {0}:
            return y.scale(x.lc.get(0, 0))
        if not y.lc or y.lc.keys() == {0}:
            return x.scale(y.lc.get(0, 0))
        z = self._new_wire((x.val() * y.val()) % P, label)
        self.cs.constrain(x.lc, y.lc, {z: 1})
        return Sig(self, {z: 1})

    def hint(self, values, label: str = "hint") -> Sig:
        """Unconstrained witness wire (`<--`). The caller MUST pair it
        with checking constraints (the reference's `===` discipline)."""
        return Sig(self, {self._new_wire(values, label): 1})

    def hint_map(self, fn, *sigs: Sig, label: str = "hint") -> Sig:
        """Hint computed per-instance from other signals' values."""
        cols = [s.val() for s in sigs]
        vals = [fn(*(int(c[i]) for c in cols)) for i in range(self.batch)]
        return self.hint(vals, label)

    # -- circom stdlib gadgets ----------------------------------------

    def num2bits(self, x: SigLike, n: int, label: str = "bit") -> List[Sig]:
        """Num2Bits (bitify.circom:10): n bool wires, LSB first, recompose
        constrained. Total n+1 constraints."""
        x = self.as_sig(x)
        xv = x.val()
        bits = []
        for i in range(n):
            b = self.hint([(int(v) >> i) & 1 for v in xv], label)
            self.enforce_bool(b)
            bits.append(b)
        acc = self.const(0)
        for i, b in enumerate(bits):
            acc = acc + b.scale(1 << i)
        self.enforce_eq(acc, x)
        return bits

    def bits2num(self, bits: Sequence[Sig]) -> Sig:
        """Bits2Num (bitify.circom:38): free recompose, LSB first."""
        acc = self.const(0)
        for i, b in enumerate(bits):
            acc = acc + self.as_sig(b).scale(1 << i)
        return acc

    def is_zero(self, x: SigLike) -> Sig:
        """IsZero (comparators.circom:11): inv hint + 2 constraints."""
        x = self.as_sig(x)
        inv = self.hint_map(lambda v: pow(v, P - 2, P) if v else 0, x,
                            label="inv")
        out = self.hint_map(lambda v: 0 if v else 1, x, label="iszero")
        self.enforce(x, inv, self.const(1) - out)
        self.enforce(x, out, 0)
        return out

    def is_equal(self, x: SigLike, y: SigLike) -> Sig:
        return self.is_zero(self.as_sig(x) - y)

    def select(self, sel: Sig, a: SigLike, b: SigLike) -> Sig:
        """sel ? a : b (sel boolean). One constraint (Switcher trick,
        utils/switcher.circom:16-26)."""
        a, b = self.as_sig(a), self.as_sig(b)
        return self.mul(sel, a - b, "select") + b

    def xor(self, a: Sig, b: Sig) -> Sig:
        """a ^ b for boolean signals: a + b - 2ab (1 constraint)."""
        return a + b - self.mul(a, b, "xor").scale(2)

    def and_(self, a: Sig, b: Sig) -> Sig:
        return self.mul(a, b, "and")

    def or_(self, a: Sig, b: Sig) -> Sig:
        return a + b - self.mul(a, b, "or")

    def not_(self, a: Sig) -> Sig:
        return self.const(1) - a

    def lt_const(self, x: Sig, bound: int, n: int) -> Sig:
        """x < bound for x known < 2^n (LessThan, comparators.circom:46:
        decompose x + 2^n - bound; the top bit is the verdict)."""
        shifted = x + self.const((1 << n) - bound)
        bits = self.num2bits(shifted, n + 1, "lt")
        return self.not_(bits[n])

    # -- outputs / export ---------------------------------------------

    def finalize(self, public_sigs: Sequence[Sig]):
        """Bind `public_sigs` to wires 1..n_public (the layout circom and
        our groth16/export expect: [1, outputs/public..., private...],
        groth16.protocol.setup / groth16.export.export_r1cs) by allocating
        one fresh wire + equality constraint per public signal, then
        permuting it to the front. Returns the list of public wire values
        (per-lane ints list of length n_public each)."""
        pub = []
        for s in public_sigs:
            w = self._new_wire(s.val(), "public")
            self.enforce_eq(Sig(self, {w: 1}), s)
            pub.append(w)
        n = self.cs.n_vars
        order = [0] + pub + [i for i in range(1, n) if i not in set(pub)]
        remap = {old: new for new, old in enumerate(order)}
        for mat in (self.cs.a, self.cs.b, self.cs.c):
            for i, (r, cvar, coeff) in enumerate(mat):
                mat[i] = (r, remap[cvar], coeff)
        self.vals = [self.vals[old] for old in order]
        self.cs.labels = {remap[k]: v for k, v in self.cs.labels.items()}
        self.n_public = len(pub)
        return [[int(v) for v in self.vals[1 + j]]
                for j in range(len(pub))]

    def witness_matrix(self) -> np.ndarray:
        """Ordered witness vector, batched: (n_vars, 16, B) uint32 limbs
        (wire 0 = 1) — the export_wtns / check_batched input."""
        n = len(self.vals)
        out = np.zeros((n, fr.NLIMBS, self.batch), np.uint32)
        for i, col in enumerate(self.vals):
            out[i] = fr.batch_to_limbs(list(col))
        return out

    def witness_ints(self, lane: int) -> List[int]:
        return [int(col[lane]) for col in self.vals]
