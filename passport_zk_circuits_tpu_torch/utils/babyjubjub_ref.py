"""Pure-Python BabyJubJub oracle (affine formulas with modular inverses),
matching circomlib semantics, for tests and host-side fixture construction.
The port's own copy of ``passport_zk_circuits_tpu/utils/babyjubjub_ref.py``."""

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
A = 168700
D = 168696
BASE8 = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)


def add(p, q):
    x1, y1 = p
    x2, y2 = q
    beta = x1 * y2 % P
    gamma = y1 * x2 % P
    delta = (y1 * x1 % P) * (y2 * x2 % P) % P
    tau = delta  # x1 y1 x2 y2
    x3 = (beta + gamma) * pow(1 + D * tau % P, P - 2, P) % P
    y3 = (y1 * y2 - A * x1 * x2) * pow((1 - D * tau) % P, P - 2, P) % P
    return x3, y3


def scalar_mul(s, p):
    acc = (0, 1)
    base = p
    while s:
        if s & 1:
            acc = add(acc, base)
        base = add(base, base)
        s >>= 1
    return acc


def base8_mul(s):
    return scalar_mul(s, BASE8)
