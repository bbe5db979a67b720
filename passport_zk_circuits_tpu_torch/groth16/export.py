"""snarkjs/circom-interop artifact export.

The reference's proving toolchain emits durable artifacts via snarkjs
(the reference's circuits/scripts/export-keys.sh:27-31: zkey ->
verification_key.json + verifier.sol; gen-witness.sh:24: .wtns;
compile-circuit.sh:35: .r1cs). This module produces the same artifact
surface from our in-framework objects so downstream consumers (on-chain
verifiers, snarkjs CLIs, hardhat-zkit flows) can interoperate:

  * `vk_to_json` / `proof_to_json` / `public_to_json` — snarkjs JSON shapes
  * `solidity_verifier` — a self-contained Groth16 verifier contract for the
    exported VerifyingKey (EVM pairing precompiles 0x06/0x07/0x08)
  * `export_wtns` / `import_wtns` — iden3 binfile .wtns (version 2)
  * `export_r1cs` / `import_r1cs` — iden3 binfile .r1cs (version 1)

All byte layouts follow the iden3 binfile conventions: little-endian
integers, 32-byte LE field elements over the BN254 scalar prime.

The port's copy of ``passport_zk_circuits_tpu/groth16/export.py`` (host
code over Python ints), with the same relative imports, which here name
the port's modules; ``tests/test_torch_copies.py`` holds its code equal
to the original's.
"""

from __future__ import annotations

import json
import struct
from typing import List, Sequence, Tuple

from ..ops import field as fr
from ..r1cs.system import ConstraintSystem
from . import pairing as pr
from .protocol import Proof, VerifyingKey


def _fq2_pair(pt) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """FQ2 affine point -> ((x_c0, x_c1), (y_c0, y_c1)) ints."""
    (x, y) = pt
    return (x.coeffs[0], x.coeffs[1]), (y.coeffs[0], y.coeffs[1])


# -- JSON artifacts -----------------------------------------------------------

def _g1_json(pt) -> List[str]:
    if pt is None:
        return ["0", "1", "0"]
    return [str(pt[0]), str(pt[1]), "1"]


def _g2_json(pt) -> List[List[str]]:
    (xc, yc) = _fq2_pair(pt)
    return [[str(xc[0]), str(xc[1])], [str(yc[0]), str(yc[1])],
            ["1", "0"]]


def _fq12_tower_json(f) -> List[List[List[str]]]:
    """Flat FQ12 (basis w^k, w^12 - 18 w^6 + 82 = 0) -> ffjavascript tower
    layout [[F2 x 3] x 2] used by snarkjs for vk_alphabeta_12.

    Tower basis: F12 = F6[w]/(w^2 - v), F6 = F2[v]/(v^3 - (9+u)),
    F2 = Fq[u]/(u^2 + 1); so v = w^2 and u = w^6 - 9. For exponent
    e = i + 2j in 0..5: a1 = c[e+6], a0 = c[e] + 9*c[e+6] (mod q)."""
    c = f.coeffs
    out = []
    for i in range(2):
        row = []
        for j in range(3):
            e = i + 2 * j
            a1 = c[e + 6]
            a0 = (c[e] + 9 * a1) % pr.Q
            row.append([str(a0), str(a1)])
        out.append(row)
    return out


def vk_to_json(vk: VerifyingKey) -> str:
    """snarkjs `verification_key.json` (zkey export verificationkey),
    including the precomputed vk_alphabeta_12 = e(alpha1, beta2) pairing."""
    alphabeta = pr.pairing(vk.beta2, vk.alpha1)
    return json.dumps({
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": vk.n_public,
        "vk_alpha_1": _g1_json(vk.alpha1),
        "vk_beta_2": _g2_json(vk.beta2),
        "vk_gamma_2": _g2_json(vk.gamma2),
        "vk_delta_2": _g2_json(vk.delta2),
        "vk_alphabeta_12": _fq12_tower_json(alphabeta),
        "IC": [_g1_json(p) for p in vk.ic],
    }, indent=1)


def proof_to_json(proof: Proof) -> str:
    """snarkjs `proof.json`."""
    return json.dumps({
        "pi_a": _g1_json(proof.a),
        "pi_b": _g2_json(proof.b),
        "pi_c": _g1_json(proof.c),
        "protocol": "groth16",
        "curve": "bn128",
    }, indent=1)


def public_to_json(public_inputs: Sequence[int]) -> str:
    return json.dumps([str(x % fr.P) for x in public_inputs], indent=1)


def solidity_calldata(proof: Proof, public_inputs: Sequence[int]) -> str:
    """`snarkjs generatecall` parity: hex calldata tuple for verifyProof.

    pB is emitted PRE-SWAPPED (c1, c0) per G2 coordinate — the order the
    generated Solidity verifier copies verbatim into the 0x08 precompile
    buffer. proof.json itself keeps (c0, c1); the swap happens here, in the
    caller-side formatter, exactly as in snarkjs."""
    def h(x: int) -> str:
        return '"0x%064x"' % x

    a = proof.a or (0, 0)
    c = proof.c or (0, 0)
    (bx, by) = _fq2_pair(proof.b)
    pa = f"[{h(a[0])},{h(a[1])}]"
    pb = (f"[[{h(bx[1])},{h(bx[0])}],"
          f"[{h(by[1])},{h(by[0])}]]")
    pc = f"[{h(c[0])},{h(c[1])}]"
    pubs = "[" + ",".join(h(x % fr.P) for x in public_inputs) + "]"
    return ",".join([pa, pb, pc, pubs])


def proof_from_json(s: str) -> Proof:
    d = json.loads(s)
    a = (int(d["pi_a"][0]), int(d["pi_a"][1]))
    c = (int(d["pi_c"][0]), int(d["pi_c"][1]))
    bx = pr.FQ2([int(d["pi_b"][0][0]), int(d["pi_b"][0][1])])
    by = pr.FQ2([int(d["pi_b"][1][0]), int(d["pi_b"][1][1])])
    return Proof(a=a, b=(bx, by), c=c)


# -- Solidity verifier --------------------------------------------------------

_SOL_TEMPLATE = """\
// SPDX-License-Identifier: GPL-3.0
// Groth16 verifier for {name} — generated by passport_zk_circuits_tpu
// (artifact parity with snarkjs `zkey export solidityverifier`,
// reference pipeline: circuits/scripts/export-keys.sh).
pragma solidity >=0.8.0 <0.9.0;

contract {name} {{
    // BN254 base-field and scalar-field moduli
    uint256 constant q = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 constant r = 21888242871839275222246405745257275088548364400416034343698204186575808495617;

    uint256 constant alphax = {alphax};
    uint256 constant alphay = {alphay};
    uint256 constant betax1 = {betax1};
    uint256 constant betax2 = {betax2};
    uint256 constant betay1 = {betay1};
    uint256 constant betay2 = {betay2};
    uint256 constant gammax1 = {gammax1};
    uint256 constant gammax2 = {gammax2};
    uint256 constant gammay1 = {gammay1};
    uint256 constant gammay2 = {gammay2};
    uint256 constant deltax1 = {deltax1};
    uint256 constant deltax2 = {deltax2};
    uint256 constant deltay1 = {deltay1};
    uint256 constant deltay2 = {deltay2};

{ic_constants}

    function negate(uint256 y) internal pure returns (uint256) {{
        return y == 0 ? 0 : q - (y % q);
    }}

    function verifyProof(
        uint256[2] calldata a,
        uint256[2][2] calldata b,
        uint256[2] calldata c,
        uint256[{n_public}] calldata input
    ) public view returns (bool ok) {{
        uint256[2] memory vkx;
        vkx[0] = IC0x;
        vkx[1] = IC0y;
        // vk_x = IC0 + sum input_i * IC_i  (ecMul 0x07 + ecAdd 0x06)
{ic_accum}
        // pairing check (0x08):
        // e(-A, B) e(alpha, beta) e(vk_x, gamma) e(C, delta) == 1
        // `b` is expected PRE-SWAPPED per G2 coordinate (c1, c0), exactly
        // as emitted by `snarkjs generatecall` — copied verbatim into the
        // precompile buffer (imaginary component first).
        uint256[24] memory p;
        p[0] = a[0];
        p[1] = negate(a[1]);
        p[2] = b[0][0]; p[3] = b[0][1];
        p[4] = b[1][0]; p[5] = b[1][1];
        p[6] = alphax; p[7] = alphay;
        p[8] = betax2; p[9] = betax1;
        p[10] = betay2; p[11] = betay1;
        p[12] = vkx[0]; p[13] = vkx[1];
        p[14] = gammax2; p[15] = gammax1;
        p[16] = gammay2; p[17] = gammay1;
        p[18] = c[0]; p[19] = c[1];
        p[20] = deltax2; p[21] = deltax1;
        p[22] = deltay2; p[23] = deltay1;
        uint256[1] memory outv;
        bool success;
        assembly {{
            success := staticcall(gas(), 8, p, 768, outv, 32)
        }}
        return success && outv[0] == 1;
    }}

    function _mulAdd(uint256[2] memory acc, uint256 px, uint256 py,
                     uint256 s) internal view returns (uint256[2] memory) {{
        // snarkjs checkField parity: a public signal >= r is invalid input,
        // not an alias of (s mod r) — reject instead of reducing.
        require(s < r, "public signal >= r");
        uint256[3] memory mulIn;
        mulIn[0] = px; mulIn[1] = py; mulIn[2] = s;
        uint256[2] memory mulOut;
        uint256[4] memory addIn;
        bool success;
        assembly {{
            success := staticcall(gas(), 7, mulIn, 96, mulOut, 64)
        }}
        require(success, "ecMul");
        addIn[0] = acc[0]; addIn[1] = acc[1];
        addIn[2] = mulOut[0]; addIn[3] = mulOut[1];
        assembly {{
            success := staticcall(gas(), 6, addIn, 128, acc, 64)
        }}
        require(success, "ecAdd");
        return acc;
    }}
}}
"""


def solidity_verifier(vk: VerifyingKey, name: str = "Groth16Verifier") -> str:
    """Self-contained Solidity Groth16 verifier with the VK inlined
    (verifier.sol parity, export-keys.sh:31)."""
    beta = _fq2_pair(vk.beta2)
    gamma = _fq2_pair(vk.gamma2)
    delta = _fq2_pair(vk.delta2)
    ic_consts = []
    for i, pt in enumerate(vk.ic):
        x, y = (0, 0) if pt is None else pt
        ic_consts.append(f"    uint256 constant IC{i}x = {x};")
        ic_consts.append(f"    uint256 constant IC{i}y = {y};")
    ic_accum = "\n".join(
        f"        vkx = _mulAdd(vkx, IC{i + 1}x, IC{i + 1}y, input[{i}]);"
        for i in range(vk.n_public))
    return _SOL_TEMPLATE.format(
        name=name, n_public=vk.n_public,
        alphax=vk.alpha1[0], alphay=vk.alpha1[1],
        betax1=beta[0][0], betax2=beta[0][1],
        betay1=beta[1][0], betay2=beta[1][1],
        gammax1=gamma[0][0], gammax2=gamma[0][1],
        gammay1=gamma[1][0], gammay2=gamma[1][1],
        deltax1=delta[0][0], deltax2=delta[0][1],
        deltay1=delta[1][0], deltay2=delta[1][1],
        ic_constants="\n".join(ic_consts),
        ic_accum=ic_accum,
    )


# -- iden3 binfile formats ----------------------------------------------------

_N8 = 32
_PRIME_LE = fr.P.to_bytes(_N8, "little")


def _fe(x: int) -> bytes:
    return (x % fr.P).to_bytes(_N8, "little")


def export_wtns(values: Sequence[int]) -> bytes:
    """Witness vector -> .wtns bytes (binfile magic "wtns", version 2):
    the artifact of the reference's generate_witness.js
    (circuits/scripts/gen-witness.sh:24)."""
    sec1 = struct.pack("<I", _N8) + _PRIME_LE + struct.pack("<I", len(values))
    sec2 = b"".join(_fe(v) for v in values)
    out = [b"wtns", struct.pack("<II", 2, 2)]
    out += [struct.pack("<IQ", 1, len(sec1)), sec1]
    out += [struct.pack("<IQ", 2, len(sec2)), sec2]
    return b"".join(out)


def import_wtns(data: bytes) -> List[int]:
    if data[:4] != b"wtns":
        raise ValueError("not a wtns file")
    _, n_sections = struct.unpack_from("<II", data, 4)
    off = 12
    sections = {}
    for _ in range(n_sections):
        sid, size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections[sid] = data[off:off + size]
        off += size
    n8, = struct.unpack_from("<I", sections[1], 0)
    prime = int.from_bytes(sections[1][4:4 + n8], "little")
    if prime != fr.P:
        raise ValueError("unexpected field prime")
    count, = struct.unpack_from("<I", sections[1], 4 + n8)
    body = sections[2]
    return [int.from_bytes(body[i * n8:(i + 1) * n8], "little")
            for i in range(count)]


def export_r1cs(cs: ConstraintSystem, n_public: int,
                n_outputs: int = 0) -> bytes:
    """ConstraintSystem -> .r1cs bytes (binfile magic "r1cs", version 1):
    the artifact of `circom --r1cs` (compile-circuit.sh:35). Wire order is
    ours: 0 = constant 1, 1..n_public = public, rest private."""
    n_pub_in = n_public - n_outputs
    n_prv = cs.n_vars - n_public - 1
    sec1 = (struct.pack("<I", _N8) + _PRIME_LE +
            struct.pack("<IIIIQI", cs.n_vars, n_outputs, n_pub_in, n_prv,
                        cs.n_vars, cs.n_constraints))
    # group per-constraint coefficient lists for each matrix
    rows: List[List[List[Tuple[int, int]]]] = [
        [[] for _ in range(cs.n_constraints)] for _ in range(3)]
    for mi, mat in enumerate((cs.a, cs.b, cs.c)):
        for row, col, coeff in mat:
            rows[mi][row].append((col, coeff))
    parts = []
    for ci in range(cs.n_constraints):
        for mi in range(3):
            terms = rows[mi][ci]
            parts.append(struct.pack("<I", len(terms)))
            for col, coeff in terms:
                parts.append(struct.pack("<I", col) + _fe(coeff))
    sec2 = b"".join(parts)
    sec3 = b"".join(struct.pack("<Q", i) for i in range(cs.n_vars))
    out = [b"r1cs", struct.pack("<II", 1, 3)]
    out += [struct.pack("<IQ", 1, len(sec1)), sec1]
    out += [struct.pack("<IQ", 2, len(sec2)), sec2]
    out += [struct.pack("<IQ", 3, len(sec3)), sec3]
    return b"".join(out)


def import_r1cs(data: bytes) -> ConstraintSystem:
    """Parse a .r1cs binfile back into a ConstraintSystem (accepts our
    exports and circom-emitted files over the BN254 scalar field)."""
    if data[:4] != b"r1cs":
        raise ValueError("not an r1cs file")
    _, n_sections = struct.unpack_from("<II", data, 4)
    off = 12
    sections = {}
    for _ in range(n_sections):
        sid, size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections.setdefault(sid, data[off:off + size])
        off += size
    hdr = sections[1]
    n8, = struct.unpack_from("<I", hdr, 0)
    prime = int.from_bytes(hdr[4:4 + n8], "little")
    if prime != fr.P:
        raise ValueError("unexpected field prime")
    n_vars, _, _, _, _, n_cons = struct.unpack_from("<IIIIQI", hdr, 4 + n8)
    cs = ConstraintSystem()
    while cs.n_vars < n_vars:
        cs.new_var()
    body = sections[2]
    pos = 0
    for _ in range(n_cons):
        terms3 = []
        for _ in range(3):
            nnz, = struct.unpack_from("<I", body, pos)
            pos += 4
            terms: dict = {}
            for _ in range(nnz):
                col, = struct.unpack_from("<I", body, pos)
                coeff = int.from_bytes(body[pos + 4:pos + 4 + n8], "little")
                pos += 4 + n8
                terms[col] = (terms.get(col, 0) + coeff) % fr.P
            terms3.append(terms)
        cs.constrain(*terms3)
    return cs
