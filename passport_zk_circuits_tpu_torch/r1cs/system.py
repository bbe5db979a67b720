"""Rank-1 constraint systems with a batched evaluator, in PyTorch.

Counterpart of ``passport_zk_circuits_tpu/r1cs/system.py``:

* ``ConstraintSystem``: the builder of sparse A, B, C (coefficient
  triplets over witness indices) with circom-like gadgets (mul, bool,
  is_zero, bit decomposition), host code over Python ints, the same as the
  JAX package's;
* ``check_batched``: A·w ∘ B·w − C·w over a batched witness
  (n_vars, 16, B) on a device. The per-entry products of a matrix are
  summed per row in overflowed int64 limbs with ``index_add_`` (exact,
  whatever the order), then the low and high halves of the sum are reduced
  apart and recombined, as the JAX package does after its
  ``segment_sum``, and the Hadamard identity is tested.

Witness index 0 is the constant ONE wire, as in circom.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import bignum as bn
from ..ops import field as fr

# entries of a matrix whose products are formed at once: (16, 16, chunk, B)
# int64 partial products stay near 2 GB at B = 1
_NNZ_CHUNK = 1 << 20


@dataclasses.dataclass
class ConstraintSystem:
    n_vars: int = 1                      # wire 0 = constant 1
    a: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    b: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    c: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    n_constraints: int = 0
    labels: Dict[int, str] = dataclasses.field(default_factory=dict)

    # -- wires ---------------------------------------------------------

    def new_var(self, label: str = "") -> int:
        idx = self.n_vars
        self.n_vars += 1
        if label:
            self.labels[idx] = label
        return idx

    # -- raw constraint ------------------------------------------------

    def constrain(self, a_terms, b_terms, c_terms):
        """(sum a_i w_i) * (sum b_i w_i) = (sum c_i w_i); terms are
        {var: coeff} dicts (coeffs are Python ints mod p)."""
        row = self.n_constraints
        self.n_constraints += 1
        for terms, mat in ((a_terms, self.a), (b_terms, self.b),
                           (c_terms, self.c)):
            for var, coeff in terms.items():
                coeff %= fr.P
                if coeff:
                    mat.append((row, var, coeff))
        return row

    # -- circom-style gadgets -----------------------------------------

    def mul(self, x: int, y: int, label: str = "mul") -> int:
        z = self.new_var(label)
        self.constrain({x: 1}, {y: 1}, {z: 1})
        return z

    def enforce_bool(self, x: int):
        # x * (x - 1) = 0
        self.constrain({x: 1}, {x: 1, 0: fr.P - 1}, {})

    def enforce_equal(self, x: int, y: int):
        self.constrain({x: 1, y: fr.P - 1}, {0: 1}, {})

    def lincomb_equal(self, terms, x: int):
        """sum terms = x (1 constraint)."""
        self.constrain(dict(terms), {0: 1}, {x: 1})

    def is_zero(self, x: int) -> int:
        """circom IsZero (comparators.circom:11): out = 1 - x*inv, x*out = 0.
        The inverse is a hint wire the witness builder must fill."""
        inv = self.new_var("iszero_inv_hint")
        out = self.new_var("iszero_out")
        self.constrain({x: 1}, {inv: 1}, {out: fr.P - 1, 0: 1})  # x*inv = 1-out
        self.constrain({x: 1}, {out: 1}, {})                     # x*out = 0
        return out

    def bits(self, x: int, n: int) -> List[int]:
        """Num2Bits (bitify.circom:10): n bool wires + recompose."""
        bit_wires = [self.new_var(f"bit{i}") for i in range(n)]
        for b in bit_wires:
            self.enforce_bool(b)
        self.lincomb_equal({b: 1 << i for i, b in enumerate(bit_wires)}, x)
        return bit_wires

    # -- export --------------------------------------------------------

    def matrices(self):
        """Returns (rows, cols, coeff_limbs) per matrix as numpy arrays
        (int32, int32, (nnz, 16) uint32)."""
        out = []
        for mat in (self.a, self.b, self.c):
            if mat:
                rows = np.fromiter((t[0] for t in mat), np.int32, len(mat))
                cols = np.fromiter((t[1] for t in mat), np.int32, len(mat))
                raw = b"".join((t[2] % fr.P).to_bytes(2 * fr.NLIMBS, "little")
                               for t in mat)
                coeffs = np.frombuffer(raw, dtype="<u2").reshape(
                    len(mat), fr.NLIMBS).astype(np.uint32)
            else:
                rows = np.zeros(0, np.int32)
                cols = np.zeros(0, np.int32)
                coeffs = np.zeros((0, fr.NLIMBS), np.uint32)
            out.append((rows, cols, coeffs))
        return out


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _split(t):
    """One local carry pass along the limb axis (the top limb's carry is
    dropped: callers leave it zero): limbs below 2^62 come out below
    2^16 + 2^46, inside ``bn.carry_normalize``'s 2^47."""
    return (t & bn.MASK) + bn._shift_up(t >> bn.W)


def _sparse_matvec(rows, cols, coeff_limbs, w, n_rows):
    """(A w) for a batched witness w: (n_vars, 16, *B) int64 limbs on a
    device -> (n_rows, 16, *B).

    rows, cols: (nnz,) and coeff_limbs: (nnz, 16), numpy or tensors. The
    entries' products (convolutions, limbs below 2^36) are summed per row
    with index_add_ in int64 (a row of 2^25 terms stays below 2^62), then
    the 32-limb sums are split at limb 16, sum = lo + hi * 2^256, each half
    reduced mod p and recombined with one product by 2^256 mod p."""
    dev = w.device
    bshape = tuple(w.shape[2:])
    sums = w.new_zeros((2 * fr.NLIMBS, n_rows) + bshape)
    rows = _index(rows, dev) if not torch.is_tensor(rows) else rows
    cols = _index(cols, dev) if not torch.is_tensor(cols) else cols
    coeffs = (bn.to_tensor(coeff_limbs, dev)
              if not torch.is_tensor(coeff_limbs) else coeff_limbs)
    bdims = (1,) * len(bshape)
    for lo in range(0, rows.shape[0], _NNZ_CHUNK):
        hi = lo + _NNZ_CHUNK
        gathered = w[cols[lo:hi]].movedim(0, 1)             # (16, n, *B)
        c = coeffs[lo:hi].T.reshape((fr.NLIMBS, -1) + bdims)
        sums.index_add_(1, rows[lo:hi], bn.poly_mul(c, gathered))
    zeros = torch.zeros_like(sums[:fr.NLIMBS])
    lo = fr.reduce_overflowed(_split(torch.cat([sums[:fr.NLIMBS], zeros])))
    hi = fr.reduce_overflowed(_split(torch.cat([sums[fr.NLIMBS:], zeros])))
    shift_c = fr.const((1 << 256) % fr.P, lo.shape[1:], dev)
    return fr.add(lo, fr.mul(hi, shift_c)).movedim(1, 0)   # (n_rows, 16, *B)


def as_witness(witness, device=None) -> torch.Tensor:
    """A (n_vars, 16, *B) witness as int64 limbs on a device: a tensor stays
    where it is unless device names another; a numpy array goes to device,
    the card when none is named."""
    if torch.is_tensor(witness):
        return witness if device is None else witness.to(device)
    return bn.to_tensor(witness, device or "cuda")


def check_batched(cs: ConstraintSystem, witness, row_chunk: int = 131072,
                  device=None):
    """witness: (n_vars, 16, B) Fr limbs (wire 0 must be 1), a tensor or a
    numpy array (placed by ``as_witness``).
    Returns (all_ok (B,), per_constraint_ok (n_constraints, B)) as bool
    tensors on the witness's device.

    Systems past `row_chunk` constraints are evaluated in row slices so
    the intermediate product tensors stay bounded."""
    witness = as_witness(witness, device)
    mats = cs.matrices()
    n = cs.n_constraints
    oks = [_check_rows(mats, witness, lo, min(n, lo + row_chunk))
           for lo in range(0, n, row_chunk)]
    ok = (torch.cat(oks) if oks else
          torch.ones((0,) + tuple(witness.shape[2:]), dtype=torch.bool,
                     device=witness.device))
    return ok.all(0), ok


def _check_rows(mats, witness, lo: int, hi: int):
    parts = []
    for rows, cols, coeffs in mats:
        m = (rows >= lo) & (rows < hi)
        parts.append((rows[m] - lo, cols[m], coeffs[m]))
    n = hi - lo
    az, bz, cz = (_sparse_matvec(r, c, v, witness, n).movedim(0, 1)
                  for r, c, v in parts)                     # (16, n, *B)
    return fr.is_zero(fr.sub(fr.mul(az, bz), cz))           # (n, *B)


def witness_matrix(values, batch: int) -> np.ndarray:
    """Host helper: list of per-wire batched ints (or single ints) ->
    (n_vars, 16, B)."""
    rows = []
    for v in values:
        if isinstance(v, int):
            rows.append(np.repeat(fr.to_limbs(v)[:, None], batch, axis=1))
        else:
            rows.append(fr.batch_to_limbs(list(v)))
    return np.stack(rows, axis=0)
