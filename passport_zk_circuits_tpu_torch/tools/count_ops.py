"""Count the tensor ops that launch work in the plain modular arithmetic,
in the point formulas over BN254 G1 and G2 (the prover's MSMs are made of
them), and in one ECDSA verify, and time the verify on the host clock.

    python -m passport_zk_circuits_tpu_torch.tools.count_ops [--device cpu]
        [--batch 4] [--curves p256,brainpoolP256r1]   # --curves "": none

Every op the plain ECDSA check issues is one CUDA kernel on the card, so
on the CPU the count predicts the kernels of a forward that the card's
profiler sees (``chip_smoke.device_profile``). Views and metadata ops
(slices, reshapes, selects, ...) launch nothing and are not counted. The
device's timing comes from ``chip_smoke.py``; on a CPU tensor the time
printed here is the CPU's.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import random
import time

import numpy as np
import torch

from ..ops import bignum as bn
from ..ops import bitops
from ..ops import ecdsa
from ..ops import g2
from ..ops import weierstrass as wst
from ..ops.curves import CURVES
from ..utils import ecdsa_ref

# ops that make no new data: no kernel on the card
VIEWS = {"aten::" + n for n in (
    "slice", "select", "unsqueeze", "reshape", "view", "expand", "alias",
    "unbind", "lift_fresh", "detach", "_unsafe_view", "as_strided",
    "transpose", "permute", "squeeze", "narrow", "item",
    "_local_scalar_dense", "is_nonzero", "empty", "result_type")}


def launching_ops(fn):
    """(ops that make new data, by name) of one warm call of fn: fn runs
    once before the profiled call, so the count leaves out what a first
    call does once (a StaticMod builds and caches its constants) and is
    the count of the call the card repeats."""
    fn()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    names = collections.Counter(ev.name for ev in prof.events()
                                if ev.cpu_parent is None
                                and ev.name not in VIEWS)
    return sum(names.values()), names


def verify_case(name, batch, device):
    """verify's arguments for `batch` lanes signed with seeded keys."""
    cv, c = CURVES[name], wst.ctx(name)
    rng = random.Random(5)
    keys = [ecdsa_ref.keygen(cv, rng) for _ in range(batch)]
    digests = [hashlib.sha256(bytes([i])).digest() for i in range(batch)]
    sigs = [ecdsa_ref.sign(cv, d, m, rng)
            for (d, _), m in zip(keys, digests)]

    def limbs(ints, k):
        return bn.to_tensor(bn.ints_to_limbs_batch(ints, k), device)
    words = bn.to_tensor(np.stack([np.frombuffer(m, ">u4").astype(np.uint32)
                                   for m in digests], -1), device)
    return (limbs([q[0] for _, q in keys], c.k),
            limbs([q[1] for _, q in keys], c.k),
            torch.cat([limbs([s[0] for s in sigs], c.kn),
                       limbs([s[1] for s in sigs], c.kn)]),
            bitops.get_bits(words, 0, 256))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--curves", default="p256,brainpoolP256r1")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    m = CURVES["p256"].p
    sm = bn.StaticMod(m, 16)
    x = bn.to_tensor(bn.ints_to_limbs_batch([m - 1] * args.batch, 16), dev)
    p_l = bn.to_tensor(bn.int_to_limbs(m, 16)[:, None], dev)
    mu = bn.to_tensor(bn.int_to_limbs((1 << 512) // m, 17)[:, None], dev)
    for what, fn in (("bignum.mod_mul (Barrett)",
                      lambda: bn.mod_mul(x, x, p_l, mu)),
                     ("bignum.add_mod", lambda: bn.add_mod(x, x, p_l)),
                     ("StaticMod.mul", lambda: sm.mul(x, x)),
                     ("StaticMod.add", lambda: sm.add(x, x)),
                     ("StaticMod.sub", lambda: sm.sub(x, x))):
        fn()
        print(f"{what}: {launching_ops(fn)[0]} ops (k = 16)")
    for c in (wst.ctx("bn254_g1"), g2.ctx()):
        name = "bn254_g2" if c is g2.ctx() else "bn254_g1"
        tmpl = x.new_zeros((c.k,) + (2,) * (c.ax - 1) + (args.batch,))
        f = c.const_like(1, tmpl).expand(tmpl.shape)
        pt = c.stack(f, f, f)
        for what, fn in (("jac_add", lambda: wst.jac_add(c, pt, pt)),
                         ("jac_double", lambda: wst.jac_double(c, pt)),
                         ("to_affine", lambda: wst.to_affine(c, pt))):
            print(f"weierstrass.{what} {name}: {launching_ops(fn)[0]} ops "
                  f"(k = 16)")
    for name in filter(None, args.curves.split(",")):
        case = verify_case(name, args.batch, dev)
        ok = ecdsa.verify(name, *case)                   # warm the caches
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ecdsa.verify(name, *case)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n, names = launching_ops(lambda: ecdsa.verify(name, *case))
        top = ", ".join(f"{k.removeprefix('aten::')} {v}"
                        for k, v in names.most_common(6))
        print(f"ecdsa.verify {name}, B = {args.batch}: {n} ops ({top}); "
              f"{dt:.3f} s on {dev} (host clock); verdicts {ok.tolist()}")


if __name__ == "__main__":
    main()
