"""Groth16 zkSNARK over BN254: setup, prove and verify.

Counterpart of ``passport_zk_circuits_tpu/groth16/protocol.py`` (the
reference's snarkjs groth16 setup, prove and verify), over the port's
R1CS (``r1cs.system.ConstraintSystem``):

  * ``setup``: the QAP on the host (Python ints: Lagrange bases at tau from
    a seeded DRBG, TEST/DEV ONLY); the G1 queries and the [v_j(tau)]G2
    query by fixed-base mults on the device (small lists on the host): on
    a card K11 (ops/cuda_fixed_base), on the CPU its plain version
    (ops/weierstrass and ops/g2); the proving key's queries are uploaded to
    the device once, as its declared ``queries`` (on a card also in
    Montgomery words, ``mont``, for K10);
  * ``prove``: Az/Bz/Cz by the batched sparse matvec, h(X) by coset NTTs
    (ops/ntt), the A/B1/K/H MSMs over bn254_g1 and pi_B's MSM over G2 on
    the device, one proof a batch lane: on a card K10 (ops/cuda_msm), on
    the CPU the plain ops/msm; the host adds the blinding terms;
  * ``verify``: the pairing product on the host (groth16/pairing.py).

The two DRBGs are the JAX package's, and every device result is a unique
field element or affine point, so given the same circuit, witness and
seeds the keys and proofs equal the JAX package's. The device is the one
the key's queries live on; nothing falls back to the host when it is a
card (the small-MSM host path below ``host_cutoff`` is the JAX package's,
and gives the same points).

QAP domain: size m = next power of two >= n_constraints, multiplicative
subgroup of Fr. Public wires are 1..n_public (wire 0 is the constant 1).
"""

from __future__ import annotations

import dataclasses
import functools
import random
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import bignum as bn
from ..ops import cuda_fixed_base
from ..ops import cuda_msm
from ..ops import field as fr
from ..ops import g2 as _g2
from ..ops import msm as _msm
from ..ops import ntt as _ntt
from ..ops import weierstrass as wst
from ..r1cs.system import ConstraintSystem, _sparse_matvec, as_witness
from . import pairing as pr

_COSET_G = 5            # Fr multiplicative generator (ops/ntt._GEN)
QUERIES = ("a", "b1", "k", "h", "b2")


# -- key / proof containers ---------------------------------------------------

def _curve(name: str) -> str:
    return "bn254_g2" if name == "b2" else "bn254_g1"


@dataclasses.dataclass
class ProvingKey:
    n_public: int                       # public wires are 1..n_public
    domain_size: int
    alpha1: tuple                       # int affine G1 points (x, y)
    beta1: tuple
    delta1: tuple
    beta2: tuple                        # FQ2 affine G2 points
    delta2: tuple
    a_query: np.ndarray                 # (2, k, n_vars) G1 affine limbs
    b1_query: np.ndarray
    k_query: np.ndarray                 # (2, k, n_vars - n_public - 1)
    h_query: np.ndarray                 # (2, k, m - 1)
    b2_query: np.ndarray                # (2, k, 2, n_vars) [v_j(tau)]G2
    a_inf: np.ndarray                   # bool masks: query point is infinity
    b1_inf: np.ndarray
    k_inf: np.ndarray
    b2_inf: np.ndarray
    # the device the queries live on, and per query name the (x, y) int64
    # limb tensors and the infinity mask there (h has none): filled by to().
    # On a card the points live there only in Montgomery words for K10
    # (mont: cuda_msm.points, converted once a key), so the limbs in
    # queries are None; the host keeps them in the arrays above
    device: torch.device = None
    queries: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)
    mont: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def to(self, device) -> "ProvingKey":
        """A copy whose queries are uploaded to device (the arrays above
        are shared, not copied): on a card in Montgomery words only."""
        device = torch.device(device)
        queries, mont = {}, {}
        for name in QUERIES:
            q = getattr(self, f"{name}_query")
            inf = getattr(self, f"{name}_inf", None)
            x, y = bn.to_tensor(q[0], device), bn.to_tensor(q[1], device)
            if device.type == "cuda":
                if q.shape[-1]:
                    mont[name] = cuda_msm.points(x, y, _curve(name))
                x = y = None
            queries[name] = (x, y, None if inf is None
                             else torch.as_tensor(inf, device=device))
        return dataclasses.replace(self, device=device, queries=queries,
                                   mont=mont)


@dataclasses.dataclass
class VerifyingKey:
    n_public: int
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: list                            # n_public + 1 int affine G1 points


@dataclasses.dataclass
class Proof:
    a: tuple                            # int affine G1
    b: tuple                            # FQ2 affine G2
    c: tuple                            # int affine G1


def _g2_point(pt):
    """A G2 point of any FQ2 class with ``coeffs`` -> the port's."""
    if pt is None:
        return None
    return tuple(pr.FQ2([int(c) for c in el.coeffs]) for el in pt)


def _g1_point(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def keys_from(pk_src, vk_src, device):
    """The port's (ProvingKey, VerifyingKey) on device from another
    implementation's keys with the same fields (the JAX package's, say):
    ints and int tuples, numpy arrays, and G2 points whose FQ2 elements
    carry ``coeffs``. A ConstraintSystem carries across as its triplet
    lists (``ConstraintSystem(n_vars=..., a=..., b=..., c=...,
    n_constraints=...)``)."""
    g1 = ("alpha1", "beta1", "delta1")
    arrays = ("a_query", "b1_query", "k_query", "h_query", "b2_query",
              "a_inf", "b1_inf", "k_inf", "b2_inf")
    pk = ProvingKey(
        n_public=int(pk_src.n_public), domain_size=int(pk_src.domain_size),
        beta2=_g2_point(pk_src.beta2), delta2=_g2_point(pk_src.delta2),
        **{f: _g1_point(getattr(pk_src, f)) for f in g1},
        **{f: np.asarray(getattr(pk_src, f)) for f in arrays})
    vk = VerifyingKey(
        n_public=int(vk_src.n_public), alpha1=_g1_point(vk_src.alpha1),
        beta2=_g2_point(vk_src.beta2), gamma2=_g2_point(vk_src.gamma2),
        delta2=_g2_point(vk_src.delta2),
        ic=[_g1_point(p) for p in vk_src.ic])
    return pk.to(device), vk


# -- host EC helpers (ints / FQ-objects via groth16.pairing) ------------------

_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def _g1_mul_point(base, k: int):
    """[k]base with plain-int Jacobian arithmetic (one final inversion) —
    ~100x faster than the generic field-tower path in groth16/pairing,
    which matters for the host-side setup loops (ic + small queries) and
    the small-MSM host path."""
    k %= fr.P
    if k == 0 or base is None:
        return None
    q = _Q
    X, Y, Z = base[0], base[1], 1
    RX = RY = None
    RZ = 0
    for bit in bin(k)[2:]:
        if RZ:                             # R = 2R (Jacobian, a = 0)
            A = RX * RX % q
            Bb = RY * RY % q
            Cc = Bb * Bb % q
            D = 2 * ((RX + Bb) ** 2 - A - Cc) % q
            E = 3 * A % q
            F = E * E % q
            X3 = (F - 2 * D) % q
            RY, RZ = (E * (D - X3) - 8 * Cc) % q, 2 * RY * RZ % q
            RX = X3
        if bit == "1":
            if not RZ:
                RX, RY, RZ = X, Y, Z
            else:                          # R = R + G (mixed add, Z2 = 1)
                Z1Z1 = RZ * RZ % q
                U2 = X * Z1Z1 % q
                S2 = Y * RZ % q * Z1Z1 % q
                H = (U2 - RX) % q
                R = (S2 - RY) % q
                if H == 0:
                    if R != 0:
                        RZ = 0
                        continue
                    A = RX * RX % q        # doubling fallback
                    Bb = RY * RY % q
                    Cc = Bb * Bb % q
                    D = 2 * ((RX + Bb) ** 2 - A - Cc) % q
                    E = 3 * A % q
                    F = E * E % q
                    X3 = (F - 2 * D) % q
                    RY, RZ = (E * (D - X3) - 8 * Cc) % q, 2 * RY * RZ % q
                    RX = X3
                    continue
                HH = H * H % q
                HHH = H * HH % q
                V = RX * HH % q
                X3 = (R * R - HHH - 2 * V) % q
                RY = (R * (V - X3) - RY * HHH) % q
                RZ = RZ * H % q
                RX = X3
    if not RZ:
        return None
    zi = pow(RZ, q - 2, q)
    zi2 = zi * zi % q
    return (RX * zi2 % q, RY * zi2 % q * zi % q)


def _g1_mul(k: int):
    return _g1_mul_point((1, 2), k)        # G1 generator (1, 2)


def _g1_wrap(pt):
    return None if pt is None else (pr.FQ1([pt[0]]), pr.FQ1([pt[1]]))


def _g1_unwrap(pt):
    return None if pt is None else (pt[0].coeffs[0], pt[1].coeffs[0])


def _g1_points_to_limbs(points) -> Tuple[np.ndarray, np.ndarray]:
    """Affine int points (None = infinity, stored as (0,0)) -> limb array
    (2, k, N) + infinity mask. The MSM path zeroes infinity scalars instead
    (scalar 0 -> jacobian infinity), so (0,0) placeholders never enter adds."""
    c = wst.ctx("bn254_g1")
    n = len(points)
    xs = np.zeros((c.k, n), np.uint32)
    ys = np.zeros((c.k, n), np.uint32)
    inf = np.zeros(n, bool)
    for i, pt in enumerate(points):
        if pt is None:
            inf[i] = True
        else:
            xs[:, i] = bn.int_to_limbs(pt[0], c.k)
            ys[:, i] = bn.int_to_limbs(pt[1], c.k)
    return np.stack([xs, ys]), inf


# -- setup --------------------------------------------------------------------

def _batch_inverse(xs: List[int]) -> List[int]:
    """Montgomery batch inversion: one Fermat pow for the whole list."""
    pref = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        pref[i + 1] = pref[i] * x % fr.P
    inv_all = pow(pref[-1], fr.P - 2, fr.P)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = pref[i] * inv_all % fr.P
        inv_all = inv_all * xs[i] % fr.P
    return out


def _lagrange_at_tau(m: int, tau: int) -> List[int]:
    """L_i(tau) for the size-m subgroup: L_i(tau) = w^i (tau^m - 1)/(m (tau - w^i))."""
    w = _ntt.root_of_unity(m.bit_length() - 1)
    zh = (pow(tau, m, fr.P) - 1) % fr.P
    if zh == 0:
        raise ValueError("tau landed in the domain; re-seed")
    wis = [1] * m
    for i in range(1, m):
        wis[i] = wis[i - 1] * w % fr.P
    denom_inv = _batch_inverse([(tau - wi) % fr.P for wi in wis])
    m_inv = pow(m, fr.P - 2, fr.P)
    scale = zh * m_inv % fr.P
    return [wi * scale % fr.P * di % fr.P
            for wi, di in zip(wis, denom_inv)]


# fixed-base mults a call of the plain version: (k, 3, chunk) points stay
# near 2 GB of temporaries for G1 and 6 GB for G2 (K11 takes a list whole)
_FB_CHUNK = 65536
# at or below these list lengths the host's int mults make a G1 or a G2
# query (the JAX package's cutoffs on its accelerator); longer lists take
# the key's device, whichever it is
_FB_HOST_CUTOFF_G1, _FB_HOST_CUTOFF_G2 = 512, 256


def _fb_chunk(n: int, device: torch.device) -> int:
    return n if device.type == "cuda" else _FB_CHUNK


def _g1_mul_many(scalars: List[int], device, inputs: dict = None,
                 name: str = None) -> Tuple[np.ndarray, np.ndarray]:
    """[s]G1 for a list of Fr scalars -> ((2, k, N) affine limb array,
    infinity mask). Short lists run on the host; long ones take the
    device's stride-8 fixed-base mult (``cuda_fixed_base.mul_g1``: K11 on a
    card, its plain version ops/weierstrass.fixed_base_mul on the CPU, in
    chunks), and inputs[name], when inputs is a dict, gets their (16, N)
    limb tensor."""
    n = len(scalars)
    scalars = [s % fr.P for s in scalars]
    device = torch.device(device)
    if n <= _FB_HOST_CUTOFF_G1:
        return _g1_points_to_limbs([_g1_mul(s) for s in scalars])
    c = wst.ctx("bn254_g1")
    inf = np.array([s == 0 for s in scalars], dtype=bool)
    xs = np.zeros((c.k, n), np.uint32)
    ys = np.zeros((c.k, n), np.uint32)
    sl = bn.to_tensor(bn.ints_to_limbs_batch(scalars, c.kn), device)
    if inputs is not None:
        inputs[name] = sl
    step = _fb_chunk(n, device)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        x, y = cuda_fixed_base.mul_g1(sl[:, lo:hi])
        xs[:, lo:hi] = x.cpu().numpy()
        ys[:, lo:hi] = y.cpu().numpy()
    return np.stack([xs, ys]), inf


def _g2_mul_many(scalars: List[int], device, inputs: dict = None,
                 name: str = None) -> Tuple[np.ndarray, np.ndarray]:
    """[s]G2 for a list of Fr scalars -> ((2, k, 2, N) FQ2 affine limb
    array, infinity mask): the b2_query builder. Short lists run on the
    host (pairing affine ops); long ones take the device's stride-8
    fixed-base mult over the twist (``cuda_fixed_base.mul_g2``: K11 on a
    card, its plain version ops/g2.fixed_base_mul on the CPU, in chunks),
    and inputs[name], when inputs is a dict, gets their (16, N) limb
    tensor."""
    n = len(scalars)
    scalars = [s % fr.P for s in scalars]
    device = torch.device(device)
    if n <= _FB_HOST_CUTOFF_G2:
        return _g2.points_to_limbs([pr.ec_mul(pr.G2, s) for s in scalars])
    inf = np.array([s == 0 for s in scalars], dtype=bool)
    out = np.zeros((2, _g2.K, 2, n), np.uint32)
    sl = bn.to_tensor(bn.ints_to_limbs_batch(scalars, _g2.KN), device)
    if inputs is not None:
        inputs[name] = sl
    step = _fb_chunk(n, device)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        x, y = cuda_fixed_base.mul_g2(sl[:, lo:hi])
        out[0, :, :, lo:hi] = x.cpu().numpy()
        out[1, :, :, lo:hi] = y.cpu().numpy()
    return out, inf


def _timed(times, name, device, fn):
    """fn(); its seconds into times[name] (host clock, the device's work
    fenced by a synchronize) when times is a dict."""
    t0 = time.perf_counter()
    out = fn()
    if times is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = time.perf_counter() - t0
    return out


def setup(cs: ConstraintSystem, n_public: int, seed: int = 0,
          device="cuda", times: dict = None, inputs: dict = None):
    """Build (ProvingKey, VerifyingKey), the key's queries on device.
    Toxic waste from `seed`: dev only. times, when a dict, gets each part's
    seconds: qap (host Lagrange bases and QAP), a_query, b1_query,
    k_query, h_query, b2_query, and rest (ic and the key's points).
    inputs, when a dict, gets the scalars of each query made on the
    device, as the (16, N) limb tensor its fixed-base mult was given
    (a, b1, k, h, b2)."""
    device = torch.device(device)
    rng = random.Random(("groth16-setup", seed).__repr__())
    tau, alpha, beta, gamma, delta = (rng.randrange(1, fr.P) for _ in range(5))

    m = 1 << max(1, (cs.n_constraints - 1).bit_length())

    def qap():
        lag = _lagrange_at_tau(m, tau)
        nv = cs.n_vars
        u = [0] * nv
        v = [0] * nv
        w_ = [0] * nv
        for (acc, mat) in ((u, cs.a), (v, cs.b), (w_, cs.c)):
            for row, col, coeff in mat:
                acc[col] = (acc[col] + coeff * lag[row]) % fr.P
        return u, v, w_

    u, v, w_ = _timed(times, "qap", device, qap)
    nv = cs.n_vars
    gamma_inv = pow(gamma, fr.P - 2, fr.P)
    delta_inv = pow(delta, fr.P - 2, fr.P)
    zh = (pow(tau, m, fr.P) - 1) % fr.P

    k_scalars = [(beta * u[j] + alpha * v[j] + w_[j]) % fr.P * delta_inv % fr.P
                 for j in range(n_public + 1, nv)]
    tau_pows = [1] * (m - 1)
    for i in range(1, m - 1):
        tau_pows[i] = tau_pows[i - 1] * tau % fr.P
    zd = zh * delta_inv % fr.P
    a_q, a_inf = _timed(times, "a_query", device,
                        lambda: _g1_mul_many(u, device, inputs, "a"))
    b1_q, b1_inf = _timed(times, "b1_query", device,
                          lambda: _g1_mul_many(v, device, inputs, "b1"))
    k_q, k_inf = _timed(times, "k_query", device,
                        lambda: _g1_mul_many(k_scalars, device, inputs, "k"))
    h_q, h_inf = _timed(times, "h_query", device, lambda: _g1_mul_many(
        [t * zd % fr.P for t in tau_pows], device, inputs, "h"))
    b2_q, b2_inf = _timed(times, "b2_query", device,
                          lambda: _g2_mul_many(v, device, inputs, "b2"))
    if h_inf.any():
        raise ArithmeticError("an h query point is infinity")

    def rest():
        ic = [_g1_mul((beta * u[j] + alpha * v[j] + w_[j]) % fr.P
                      * gamma_inv % fr.P) for j in range(n_public + 1)]
        pk = ProvingKey(
            n_public=n_public, domain_size=m,
            alpha1=_g1_mul(alpha), beta1=_g1_mul(beta),
            delta1=_g1_mul(delta),
            beta2=pr.ec_mul(pr.G2, beta), delta2=pr.ec_mul(pr.G2, delta),
            a_query=a_q, b1_query=b1_q, k_query=k_q, h_query=h_q,
            b2_query=b2_q, a_inf=a_inf, b1_inf=b1_inf, k_inf=k_inf,
            b2_inf=b2_inf)
        vk = VerifyingKey(
            n_public=n_public, alpha1=pk.alpha1, beta2=pk.beta2,
            gamma2=pr.ec_mul(pr.G2, gamma), delta2=pk.delta2, ic=ic)
        return pk.to(device), vk

    return _timed(times, "rest", device, rest)


# -- prover -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _coset_scale(m: int, inverse: bool) -> np.ndarray:
    g = pow(_COSET_G, fr.P - 2, fr.P) if inverse else _COSET_G
    pows = [1] * m
    for i in range(1, m):
        pows[i] = pows[i - 1] * g % fr.P
    return fr.batch_to_limbs(pows)                      # (16, m)


@functools.lru_cache(maxsize=None)
def _coset_tensor(m: int, inverse: bool, device: torch.device):
    return bn.to_tensor(_coset_scale(m, inverse), device)


def h_coefficients(cs: ConstraintSystem, witness, device=None):
    """h(X) = (Az*Bz - Cz)/Z coefficients on the device.

    witness: (n_vars, 16, *B) Fr limbs (``r1cs.system.as_witness`` places
    it). Returns (16, m-1, *B) int64 on the witness's device."""
    witness = as_witness(witness, device)
    dev = witness.device
    n_con = cs.n_constraints
    m = 1 << max(1, (n_con - 1).bit_length())
    bshape = tuple(witness.shape[2:])
    bdims = (1,) * len(bshape)
    evs = []
    for rows, cols, coeffs in cs.matrices():
        e = _sparse_matvec(rows, cols, coeffs, witness, n_con).movedim(0, 1)
        evs.append(torch.cat([e, e.new_zeros((fr.NLIMBS, m - n_con)
                                             + bshape)], 1))  # (16, m, *B)
    shift = _coset_tensor(m, False, dev).reshape((fr.NLIMBS, m) + bdims)
    unshift = _coset_tensor(m, True, dev).reshape((fr.NLIMBS, m) + bdims)
    zh_inv = pow((pow(_COSET_G, m, fr.P) - 1) % fr.P, fr.P - 2, fr.P)

    def to_coset_evals(e):
        return _ntt.ntt(fr.mul(_ntt.intt(e), shift))

    ac, bc, cc_ = map(to_coset_evals, evs)
    num = fr.sub(fr.mul(ac, bc), cc_)
    h_ev = fr.mul(num, bn.cached_const(zh_inv, fr.NLIMBS, dev, num.dim()))
    return fr.mul(_ntt.intt(h_ev), unshift)[:, :m - 1]


def _g1_add_int(p, q):
    """Host affine addition over plain ints (None = infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % _Q == 0:
            return None
        lam = 3 * x1 * x1 % _Q * pow(2 * y1, _Q - 2, _Q) % _Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, _Q - 2, _Q) % _Q
    x3 = (lam * lam - x1 - x2) % _Q
    return (x3, (lam * (x1 - x3) - y1) % _Q)


_MSM_HOST_CUTOFF = 512


def _msm_lanes_host(query: np.ndarray, scalars: np.ndarray, nb: int,
                    g2f: bool) -> list:
    """Host-int MSM for small queries (one windowed mult + add per point
    per lane)."""
    n = query.shape[-1]
    out = []
    for lane in range(nb):
        ks = [bn.limbs_to_int(scalars[:, lane, j]) for j in range(n)]
        acc = None
        for j, k in enumerate(ks):
            if k == 0:
                continue
            if g2f:
                pt = _g2.limbs_to_point(query[0][..., j], query[1][..., j])
                acc = pr.ec_add(acc, pr.ec_mul(pt, k))
            else:
                xi = bn.limbs_to_int(query[0][:, j])
                yi = bn.limbs_to_int(query[1][:, j])
                if xi or yi:
                    acc = _g1_add_int(acc, _g1_mul_point((xi, yi), k))
        out.append(acc)
    return out


def _window_sums(pk: ProvingKey, name: str, scalars, host_cutoff: int,
                 inputs: dict = None):
    """The MSM of query `name` against per-lane scalars (16, B, N) on the
    key's device (B proof lanes share the query's points): on a card the
    whole MSM by K10 (``cuda_msm.msm_affine`` on the key's Montgomery
    points), read back as a list of host points, one a lane; on the CPU up
    to its window sums (``msm.window_sums``: a tensor); a query of at most
    host_cutoff points takes the host's int MSM instead (a list). inputs,
    when a dict, gets the device's scalars (16, B, N), infinity's masked."""
    g2f = name == "b2"
    query = getattr(pk, f"{name}_query")
    n = query.shape[-1]
    nb = scalars.shape[1]
    if n == 0:
        return [None] * nb
    qx, qy, inf = pk.queries[name]
    if inf is not None and bool(inf.any()):
        scalars = scalars.masked_fill(inf, 0)
    if n <= host_cutoff:
        # tiny MSMs (demo and test circuits): a few hundred host mults
        return _msm_lanes_host(query, scalars.cpu().numpy(), nb, g2f)
    if inputs is not None:
        inputs[name] = scalars
    if pk.device.type == "cuda":
        return _host_points(*cuda_msm.msm_affine(
            None, None, scalars, _curve(name), mont=pk.mont[name]),
            _curve(name))
    return _msm.window_sums(qx, qy, scalars, _curve(name))


def _host_points(x, y, curve: str) -> list:
    """Affine limbs (16[, 2], B) -> B host points: G1 int pairs, G2
    pairing FQ2 pairs; None = infinity."""
    x, y = x.cpu().numpy(), y.cpu().numpy()
    if curve == "bn254_g2":
        return [_g2.limbs_to_point(x[..., j], y[..., j])
                for j in range(x.shape[-1])]
    return [None if not (x[:, j].any() or y[:, j].any()) else
            (bn.limbs_to_int(x[:, j]), bn.limbs_to_int(y[:, j]))
            for j in range(x.shape[-1])]


def _finish(parts: dict, curve: str) -> dict:
    """Host affine points of each lane of each MSM in parts (name -> window
    sums or host points): every window-sum tensor goes through ONE Horner
    chain (``msm.chain_affine``, their lanes side by side)."""
    out = {k: v for k, v in parts.items() if isinstance(v, list)}
    names = [k for k, v in parts.items() if torch.is_tensor(v)]
    if not names:
        return out
    x, y = _msm.chain_affine(torch.cat([parts[k] for k in names], -1), curve)
    lane = 0
    for k in names:
        nb = parts[k].shape[-1]
        out[k] = _host_points(x[..., lane:lane + nb], y[..., lane:lane + nb],
                              curve)
        lane += nb
    return out


def prove(pk: ProvingKey, cs: ConstraintSystem, witness, seed: int = 1,
          host_cutoff: int = _MSM_HOST_CUTOFF, times: dict = None,
          inputs: dict = None):
    """Groth16 prove over a batched witness (n_vars, 16, B) -> [Proof]*B,
    on the device the key's queries live on (``ProvingKey.to``).

    All four G1 MSMs and the pi_B G2 MSM run lane-batched on the device
    (queries of at most host_cutoff points on the host; 0 forces the
    device): on a card each by K10 to its affine point, on the CPU the four
    G1 MSMs' window sums through one Horner chain; the host applies the r/s
    blinding. times, when a dict, gets each stage's seconds: h, msm_a,
    msm_b1, msm_k, msm_h (each the whole MSM read back on a card, up to its
    window sums on the CPU), g1_chain (on the CPU their one chain and
    affine conversion; nothing on a card) and msm_b2. inputs, when a dict,
    gets each device MSM's scalars (16, B, N) by query name (a, b1, k, h,
    b2), as its kernel or plain version was given them."""
    if pk.device is None:
        raise ValueError("the proving key's queries are on no device: "
                         "ProvingKey.to(device)")
    dev = pk.device
    witness = as_witness(witness, dev)
    batch = witness.shape[2]
    rng = random.Random(("groth16-prove", seed).__repr__())

    h = _timed(times, "h", dev, lambda: h_coefficients(cs, witness))
    w_s = witness.permute(1, 2, 0)                    # (16, B, nv)

    g1 = {name: _timed(times, f"msm_{name}", dev, lambda name=name, sc=sc:
                       _window_sums(pk, name, sc, host_cutoff, inputs))
          for name, sc in (("a", w_s), ("b1", w_s),
                           ("k", w_s[:, :, pk.n_public + 1:]),
                           ("h", h.transpose(1, 2)))}
    g1 = _timed(times, "g1_chain", dev, lambda: _finish(g1, "bn254_g1"))
    a_sums, b1_sums, k_sums, h_sums = (g1[k] for k in ("a", "b1", "k", "h"))
    b2_sums = _timed(times, "msm_b2", dev, lambda: _finish(
        {"b2": _window_sums(pk, "b2", w_s, host_cutoff, inputs)},
        "bn254_g2"))["b2"]

    proofs = []
    for lane in range(batch):
        r_rand = rng.randrange(fr.P)
        s_rand = rng.randrange(fr.P)

        # pi_A = alpha + sum w_j u_j(tau) + r delta
        pi_a = pr.ec_add(pr.ec_add(_g1_wrap(pk.alpha1),
                                   _g1_wrap(a_sums[lane])),
                         pr.ec_mul(_g1_wrap(pk.delta1), r_rand))
        # pi_B (G2) = beta + sum w_j [v_j(tau)]G2 + s delta
        pi_b2 = pr.ec_add(pk.beta2, pr.ec_mul(pk.delta2, s_rand))
        pi_b2 = pr.ec_add(pi_b2, b2_sums[lane])
        # pi_B in G1 (for pi_C)
        pi_b1 = pr.ec_add(pr.ec_add(_g1_wrap(pk.beta1),
                                    _g1_wrap(b1_sums[lane])),
                          pr.ec_mul(_g1_wrap(pk.delta1), s_rand))
        # pi_C = K + H + s pi_A + r pi_B1 - r s delta
        pi_c = pr.ec_add(_g1_wrap(k_sums[lane]), _g1_wrap(h_sums[lane]))
        pi_c = pr.ec_add(pi_c, pr.ec_mul(pi_a, s_rand))
        pi_c = pr.ec_add(pi_c, pr.ec_mul(pi_b1, r_rand))
        pi_c = pr.ec_add(pi_c, pr.ec_mul(_g1_wrap(pk.delta1),
                                         (-r_rand * s_rand) % fr.P))
        proofs.append(Proof(a=_g1_unwrap(pi_a), b=pi_b2, c=_g1_unwrap(pi_c)))
    return proofs


# -- verifier -----------------------------------------------------------------

def verify(vk: VerifyingKey, proof: Proof, public_inputs: Sequence[int]) -> bool:
    """e(A, B) == e(alpha, beta) e(IC(pub), gamma) e(C, delta)."""
    if len(public_inputs) != vk.n_public:
        return False
    ic = _g1_wrap(vk.ic[0])
    for j, x in enumerate(public_inputs, start=1):
        ic = pr.ec_add(ic, pr.ec_mul(_g1_wrap(vk.ic[j]), x % fr.P))

    a_pt = _g1_wrap(proof.a)
    c_pt = _g1_wrap(proof.c)
    if not (pr.on_curve(a_pt, pr.B1) and pr.on_curve(c_pt, pr.B1)
            and pr.on_curve(proof.b, pr.B2)):
        return False

    f = pr.miller_loop(pr.twist(proof.b), pr.cast_g1(a_pt))
    f = f * pr.miller_loop(pr.twist(vk.beta2),
                           pr.cast_g1(pr.ec_neg(_g1_wrap(vk.alpha1))))
    f = f * pr.miller_loop(pr.twist(vk.gamma2), pr.cast_g1(pr.ec_neg(ic)))
    f = f * pr.miller_loop(pr.twist(vk.delta2), pr.cast_g1(pr.ec_neg(c_pt)))
    return pr.final_exponentiate(f) == pr.FQ12.one()
