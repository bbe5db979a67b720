"""Time K10 (ops/cuda_msm: the MSM over BN254 G1 and G2) on one CUDA card
at the sizes of the ECDSA p256 and RegisterIdentityLight proves, on
synthetic scalars, step by step.

    python -m passport_zk_circuits_tpu_torch.tools.msm_bench \\
        [--cells h,witness,b2] [--reps 3] [--check 2048] [--seed 1]

Cells, at the point counts of registerIdentity_20_256_3_4_600_248_0_0_1_0's
proving key (one proof lane) and of RegisterIdentityLight's (two lanes,
as its prove at B = 2):

- h: G1, 2,097,151 points, scalars uniform below r (as the h
  coefficients);
- witness: G1, 1,578,650 points, witness-like scalars (WITNESS_MIX: mostly
  0 and 1, some below 2^16, some uniform below r);
- b2: G2, 1,578,650 points, the same kind of scalars;
- uniform-b2: G2, 1,578,650 points, uniform scalars (not the default);
- light-a, light-h, light-b2: G1 55,438 witness-like, G1 65,535 uniform
  and G2 55,438 witness-like, two lanes each (not the default).

The points are [k]G for random k (K11, ops/cuda_fixed_base). Each cell
prints K10's window width, items, non-empty buckets, affine rounds and
passes of runs; the glue's milliseconds (``cuda_msm.Schedule``, host
clock, fenced; cold, then twice warm); each step of ``execute`` (CUDA
events around its launch, by kernel); the whole ``execute`` and the whole
wrapper with its glue (``cuda_msm.msm_affine`` on the points' Montgomery
words, as a prove calls it) (CUDA events, mean of --reps). K10 is held
bit-equal to the plain MSM (ops/msm.msm_affine) on the cell's first
--check points. ``--profile`` adds the glue's PyTorch operations by
device time (torch.profiler, one warm ``Schedule``); ``--set NAME=VALUE``
sets one of ops/cuda_msm's constants (ROUND_MIN_ADDS, PER_MAX, RUN_MIN,
GROUP, HOST_PLAN, ...) for the run, to try a plan. Needs a card.
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from ..ops import bignum as bn
from ..ops import cuda_build
from ..ops import cuda_fixed_base
from ..ops import cuda_msm
from ..ops import field as fr
from ..ops import msm

# name: (G2, points, scalars, lanes)
CELLS = {"h": (False, 2_097_151, "uniform", 1),
         "witness": (False, 1_578_650, "witness", 1),
         "b2": (True, 1_578_650, "witness", 1),
         "uniform-b2": (True, 1_578_650, "uniform", 1),
         "light-a": (False, 55_438, "witness", 2),
         "light-h": (False, 65_535, "uniform", 2),
         "light-b2": (True, 55_438, "witness", 2)}
# probabilities of 0, 1, a value below 2^16 and one below r: about the
# p256 witness's items and non-empty buckets over b2_query (920,314 and
# 47,679 with 16-bit windows)
WITNESS_MIX = (0.45, 0.50, 0.048, 0.002)


def scalars(rng, n, kind, lanes, dev):
    """(16, lanes, n) limbs: uniform below r, or drawn from WITNESS_MIX."""
    def draw():
        if kind == "uniform":
            return rng.randrange(fr.P)
        u = rng.random()
        if u < WITNESS_MIX[0]:
            return 0
        if u < WITNESS_MIX[0] + WITNESS_MIX[1]:
            return 1
        if u < 1 - WITNESS_MIX[3]:
            return rng.randrange(1 << 16)
        return rng.randrange(fr.P)
    return torch.stack([bn.to_tensor(fr.batch_to_limbs(
        [draw() for _ in range(n)]), dev) for _ in range(lanes)], 1)


def points(rng, n, is_g2, dev):
    """n affine points [k]G of random k, by K11."""
    k = bn.to_tensor(fr.batch_to_limbs([rng.randrange(1, fr.P)
                                        for _ in range(n)]), dev)
    return (cuda_fixed_base.mul_g2 if is_g2 else cuda_fixed_base.mul_g1)(k)


def events_ms(fn, reps):
    """Mean ms of fn over reps calls, CUDA events around them."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_call(inner, marks):
    """``execute``'s call with CUDA events around each launch."""
    def call(entry, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        inner(entry, *args)
        end.record()
        marks.append((entry, start, end))
    return call


def profile_glue(sc, is_g2):
    """The glue's PyTorch operations by device time, one warm Schedule."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cuda_msm.Schedule(sc, is_g2)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=12, max_name_column_width=40))


def run_cell(name, dev, rng, reps, check, profile=False):
    is_g2, n, kind, lanes = CELLS[name]
    curve = "bn254_g2" if is_g2 else "bn254_g1"
    px, py = points(rng, n, is_g2, dev)
    sc = scalars(rng, n, kind, lanes, dev)
    glue, sched = [], None
    for _ in range(3):
        del sched
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched = cuda_msm.Schedule(sc, is_g2)
        torch.cuda.synchronize()
        glue.append((time.perf_counter() - t0) * 1e3)
    print(f"{name}: {'G2' if is_g2 else 'G1'}, {n} points, {lanes} lanes, "
          f"{kind} scalars; {sched.c}-bit windows, {sched.items} items, "
          f"{sched.nonempty} non-empty buckets, {sched.rounds} affine "
          f"rounds, {sched.passes} passes of runs; glue {glue[0]:.2f} ms "
          f"cold, then {glue[1]:.2f}, {glue[2]:.2f}")
    if profile:
        profile_glue(sc, is_g2)
    mont = cuda_msm.points(px, py, curve)
    call = cuda_msm.cuda_call(f"msm_bench {name}", sc)
    cuda_msm.execute(sched, mont, call)                         # warm
    marks = []
    cuda_msm.execute(sched, mont, timed_call(call, marks))
    torch.cuda.synchronize()
    for (entry, s, e), (_, args) in zip(marks, sched.steps):
        sizes = [a for a in args if isinstance(a, int)]
        print(f"  {entry} {sizes}: {s.elapsed_time(e):.3f} ms")
    ms = events_ms(lambda: cuda_msm.execute(sched, mont, call), reps)
    whole = events_ms(lambda: cuda_msm.msm_affine(None, None, sc, curve,
                                                  mont=mont), reps)
    print(f"  execute: {ms:.3f} ms; the wrapper with its glue: {whole:.3f} "
          f"ms (means of {reps}); card: {torch.cuda.get_device_name(0)}")
    cut = slice(0, check)
    pc = (px[..., cut].contiguous(), py[..., cut].contiguous())
    sc_c = sc[..., cut].contiguous()
    want = msm.msm_affine(*pc, sc_c, curve)
    got = cuda_msm.msm_affine(*pc, sc_c, curve)
    ok = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"  K10 on the first {check} points bit-equal to the plain MSM: "
          f"{ok}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="h,witness,b2")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args(argv)
    for kv in args.set:
        k, v = kv.split("=")
        if not isinstance(getattr(cuda_msm, k), int):
            raise ValueError(f"--set: {k} is not a constant of cuda_msm")
        setattr(cuda_msm, k, int(v))
        print(f"cuda_msm.{k} = {v}")
    if not torch.cuda.is_available():
        raise SystemExit("msm_bench: needs a CUDA card")
    dev = torch.device("cuda:0")
    cuda_build.library()
    report = cuda_build.ptxas_report(
        (cuda_build.BUILD_DIR / "build.log").read_text())
    for k, (regs, st, ld) in sorted(report.items()):
        if k.startswith("msm_"):
            print(f"ptxas {k}: {regs} registers, spill stores {st} B, "
                  f"loads {ld} B")
    rng = random.Random(args.seed)
    ok = all([run_cell(c, dev, rng, args.reps, args.check, args.profile)
              for c in args.cells.split(",")])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
