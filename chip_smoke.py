#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

The port's paths, each driven through its user entry point with every
launch counter set to 0 just before it and read just after:

* the witness step: one batched RegisterIdentity witness step on the
  flagship config registerIdentity_1_256_3_4_600_248_1_1496_3_256
  (RSA-2048 PKCS#1 v1.5, e = 65537, SHA-256, TD3, RSA-1024 active auth,
  80-level SMT) at batch 1024: K1's many-message entry (the step's four
  SHA messages in one launch), K2-K4 and K5's affine entry;
* the ECDSA path: the same step on
  registerIdentity_21_256_3_4_600_248_20_1496_3_256 (ECDSA over
  brainpoolP256r1 with SHA-256, a P-256 active-auth key) at batch 1024:
  K1's many-message entry, K3, K4 and K5's affine entry, the ECDSA check
  in plain PyTorch; no K2;
* the RSA-PSS path: registerIdentity_11_256_3_4_600_248_1_1496_3_256
  (RSA-2048 PSS, SHA-256, salt 32, RSA-1024 active auth) at batch 1024:
  K1's many-message entry, K1's per-message entry (MGF1 and M'), K2-K4 and
  K5's affine entry;
* the field-muls/s path: tools/microbench_field at batch 1024, 256
  chained products a call: K6, K7, K8;
* the probe battery: tools/probe_nvcc: K9, each probe alone in a launch of
  its own (the entry probe), then the kernel probes together in one launch
  (the entry probe_battery);
* RegisterIdentityLight: register_identity_light.forward on TD3 dg1 at
  batch 1024 with SHA-256 (K1's per-message entry, K3, K5's affine entry),
  and at batch 64 with SHA-384 (plain SHA-384; K3, K5);
* QueryIdentity: query_identity.forward at batch 1024, TD3 and TD1, on
  80-level identity-state proofs of 18-24 live levels a lane (one lane
  none, one 79), with four tampered lanes: K3, K4 (the climb, with live
  levels) and K5's affine entry;
* the register -> query chain: a TD3 query (nullifier only) of the
  flagship step's own identities, their identity state built from the
  step's outputs: K3, K4, K5's affine entry;
* Groth16 on RegisterIdentityLight at its real size (55,438 wires,
  55,805 constraints, domain 65,536), batch 2: the Light forward on the
  card (K1's per-message entry, K3, K5's affine entry) gives the public
  values; r1cs.check_batched, groth16.setup (K11: the fixed-base mults
  over G1 and G2; K10's conversion of the key's points), prove (K10: the
  MSMs over G1 and G2) and verify; every setup and prove below runs the
  same kernels;
* Groth16 on QueryIdentity TD3 (26,706 wires, 27,025 constraints, domain
  32,768), batch 2: the Query forward on the card (K3, K4, K5's affine
  entry) gives the public values;
* Groth16 on the flagship RegisterIdentity circuit at its real size
  (511,677 wires, 514,800 constraints, domain 524,288), batch 1: the
  witness step's forward above (K1's many-message entry, K2-K4, K5's
  affine entry) gives the public values of its lane 2;
* Groth16 on the ECDSA p256 RegisterIdentity circuit
  registerIdentity_20_256_3_4_600_248_0_0_1_0 (1,578,650 wires, 1,589,942
  constraints, domain 2,097,152), batch 1: its ECDSA forward on the card
  (K1's many-message entry, K3-K5) gives the public values;
* the user's path, ``api``: 1,024 passports whose SODs are built by
  ``ingest/passport.build_sod`` and read back by ``api.ingest`` against
  a 256-certificate master list (``ingest/masterlist``), then
  ``api.compile`` and ``api.generate_witness`` on the card
  (registerIdentity_1_256_3_2_336_232_1_544_3_256: K1's many-message
  entry, K2-K4 with live levels, K5's affine entry), and SIG_ALGO 11
  (RSA-PSS) and 20 (ECDSA P-256) at batch 64 the same way;
* the primitives the JAX package leaves to XLA, plain PyTorch here:
  Keccak-256 / SHA3-256 and the Ethereum address, Poseidon2 and secp256k1
  ecrecover, at batch 1024;
* the sharding: ``entry.dryrun_multichip`` over the machine's cards and
  ``parallel/distributed.throughput_harness`` in a NCCL world of one
  spawned process a card (the flagship at batch 1024 a rank).

The script

1. fails unless a CUDA device is present (there is no CPU path);
2. prints the card's name and power limit (nvidia-smi);
3. builds the hand-written kernels from csrc/ (nvcc, sm_90a, one
   process per source, all at once);
4. runs each kernel at its path's shapes and holds it bit for bit
   (tolerance 0: integer arithmetic) against its plain PyTorch version on
   the same CUDA tensors, and on 8+ lanes against the Python-int oracles;
   times both, and computes the kernel's bound from this run's shapes and
   data (K4: the live levels of four depth profiles), and the
   critical-path floor of K1 (a lane's rounds), K6 (a lane's two team
   products) and K8 (n steps of one chain); K1's one launch beside its
   four-call route and its per-message entry at the RSA-PSS path's shapes
   (MGF1's seven blocks and M'); K2 also at k = 256 and with an
   even-modulus lane, K3 also width by width; K6 and K8 on every lane
   against the Python ints, K6 also with a broadcast column of each edge
   value; the device time of one call of K1 (three routes), K6, K7, K8
   and K9 (the battery's one launch, and each of its roles alone) from
   torch.profiler, each held to its kernels' names, and every
   launch of that session to its kernel record; K10's and K11's at the
   ECDSA p256 circuit's shapes (with K10's glue, cuda_msm.Schedule,
   timed apart, and K10's bound under the least Pippenger work and under
   the first design's count); registers and spills of K1, K6, K7, K10
   and K11 from nvcc's -Xptxas -v (none may spill: K10's G2 arithmetic
   runs an Fq2 element over two threads);
5. builds flagship inputs with the port's ingest, runs
   register_identity.forward on the card, checks the four public outputs
   against the oracles, the verdicts, two tampered lanes, and that the
   launch counters of K1's many-message entry (once), K2-K4 and K5's
   affine entry moved during that forward (K1's per-message entry and K5's
   extended one not at all); counts the CUDA kernels of one forward
   (torch.profiler) and times its stages;
   builds the ECDSA and RSA-PSS paths' inputs, runs their forwards and
   checks every lane's four public outputs against the oracles (computed
   in a pool of worker processes, stopped with the script), the verdicts
   (one lane with a flipped signature must fail sig_ok) and the launch
   counters (K2 off the ECDSA path, K1's per-message entry on the PSS
   path only), times one warm forward of each and holds K2 at k = 192
   (RSA-3072) with e = 37187 against its plain version; the profiler's
   session counts the CUDA kernels of one forward of each path, with the
   device time of each hand-written kernel in it;
   then the Light, Query and chain paths: the outputs against the oracles
   on sampled lanes (ingest/identity; identity-state roots built in the
   pool), each tampered query lane failing exactly its own check, every
   other check holding, the launch counters, one warm forward of each
   timed (mean of 3); the profiler's session also counts the CUDA kernels
   of one forward of Light and of each Query, and K4's device time on the
   query's proofs beside its flagship and registry profiles and its bound;
   then phase prove: the Light circuit built from the card's forward
   inputs at batch 2 (its size and its public values against the
   forward's), check_batched (both lanes true; a tampered wire of lane 0
   fails exactly the rows whose Python-int value it breaks), setup timed
   by part, the device G1 and G2 MSMs against the host's ints on strided
   samples of 512 and 12,289 G1 points (the second in two window groups
   of unequal size) and 64 G2 points, K10 against that plain MSM on those
   samples and on mostly 0 and 1 scalars over 3,001 points, all-zero
   scalars, a masked infinity point and 1,001 G2 points (and the host's
   ints on the small ones), K11 against the plain fixed-base mults on
   4,096 scalars with 0, 1 and r - 1 (the first 8 against the host's
   ints), two proves timed by stage that must be equal, verify in the
   pool (both lanes true, a wrong input false), the phase under 300 s;
   then phase prove_query (QueryIdentity TD3 at batch 2, two lanes of
   18-24 live levels: the circuit's size and its public values against
   the card's Query forward, check_batched with the q_root wire of lane 0
   tampered, setup and one prove timed, verify in the pool; under 90 s)
   and phase prove_flagship (the flagship circuit of the witness step's
   lane 2, built in the pool while the phases above ran: its size against
   the JAX package's lowering in tests/fixtures/torch_port_lowering.npz,
   its four public values against the card's forward, check_batched with
   a tampered private wire, setup, one prove timed by stage beside each
   MSM's bound, verify in the pool, the peak device memory; under 600 s)
   and phase prove_p256 (the ECDSA p256 circuit of
   make_synthetic_passport(p, Random(21)), built in the pool from its
   start: its size against tests/fixtures/torch_port_lowering.npz, its
   four public values against the oracle and the card's ECDSA forward, a
   tampered private wire, setup (seed 22), one prove (seed 23) timed by
   stage beside each MSM's bound, verify in the pool, the peak device
   memory, K10's and K11's launches; under 300 s); every setup must launch
   K11 and K10's point conversion and no MSM, every prove K10 over G1 and
   G2 and neither of the others; the whole script must end within 1,200
   s;
   phases ingest, primitives and multichip (after chain, their host
   inputs and oracles built from the pool's start in a pool of their own,
   INGEST_WORKERS processes): every lane of the api path against the
   oracles, lane 1's flipped signature bit failing sig_ok alone, a signer
   outside the master list refused (KeyError), the launch counters, K1
   against its plain version at the ingested config's block counts, K4's
   live levels a lane; every lane of Keccak-256 (keccak_ref), SHA3-256
   (hashlib), the address, Poseidon2 (poseidon_ref) and ecrecover (each
   signer's key; s + 1 another key, r = 0 refused), one warm call of
   each; dryrun_multichip and the NCCL harness, every witness valid; the
   SIG_ALGO 1 and 11 api forwards (PROFILED_API) and each primitive's
   call join the profiler's session (their CUDA kernels and device time,
   K4's on the master-list proofs);
6. times a few chained steps (each step's sk_identity derived from the
   previous outputs);
7. runs the field-muls/s path (K6-K8 must launch) and the probe battery
   (K9 must launch for each probe alone and once for the battery, every
   probe must pass), and prints K7's field-muls/s;
8. prints the floors' JSON line (models, apart from the measurements),
   the kernels' JSON line, then {"ok": true, "device": ...} last.

Any failed check raises, and the script exits non-zero.
"""

import dataclasses
import hashlib
import json
import multiprocessing
import os
import random
import socket
import subprocess
import sys
import threading
import time
from queue import Empty

import numpy as np
import torch

from passport_zk_circuits_tpu_torch import api
from passport_zk_circuits_tpu_torch import entry
from passport_zk_circuits_tpu_torch.circuit import query_identity
from passport_zk_circuits_tpu_torch.circuit import register_identity
from passport_zk_circuits_tpu_torch.circuit import register_light
from passport_zk_circuits_tpu_torch.circuit.builder import Builder
from passport_zk_circuits_tpu_torch.groth16 import pairing as g16pr
from passport_zk_circuits_tpu_torch.groth16 import protocol as g16p
from passport_zk_circuits_tpu_torch.ingest import builder, identity, synthetic
from passport_zk_circuits_tpu_torch.ingest import masterlist, passport, x509
from passport_zk_circuits_tpu_torch.models import params
from passport_zk_circuits_tpu_torch.models import passport_verification as pv
from passport_zk_circuits_tpu_torch.models import query_identity as qi
from passport_zk_circuits_tpu_torch.models import register_identity as ri
from passport_zk_circuits_tpu_torch.models import register_identity_light as ril
from passport_zk_circuits_tpu_torch.ops import babyjubjub as bjj
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_babyjubjub
from passport_zk_circuits_tpu_torch.ops import cuda_build
from passport_zk_circuits_tpu_torch.ops import cuda_field
from passport_zk_circuits_tpu_torch.ops import cuda_fixed_base
from passport_zk_circuits_tpu_torch.ops import cuda_loop
from passport_zk_circuits_tpu_torch.ops import cuda_msm
from passport_zk_circuits_tpu_torch.ops import cuda_poseidon
from passport_zk_circuits_tpu_torch.ops import cuda_probe
from passport_zk_circuits_tpu_torch.ops import cuda_rsa
from passport_zk_circuits_tpu_torch.ops import cuda_sha2
from passport_zk_circuits_tpu_torch.ops import ecrecover
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import g2
from passport_zk_circuits_tpu_torch.ops import keccak
from passport_zk_circuits_tpu_torch.ops import msm
from passport_zk_circuits_tpu_torch.ops import poseidon as pos
from passport_zk_circuits_tpu_torch.ops import poseidon2
from passport_zk_circuits_tpu_torch.ops import rsa
from passport_zk_circuits_tpu_torch.ops import sha2
from passport_zk_circuits_tpu_torch.ops import smt
from passport_zk_circuits_tpu_torch.ops.curves import CURVES
from passport_zk_circuits_tpu_torch.parallel import distributed
from passport_zk_circuits_tpu_torch.r1cs import system as r1
from passport_zk_circuits_tpu_torch.tools import microbench_field
from passport_zk_circuits_tpu_torch.tools import probe_nvcc
from passport_zk_circuits_tpu_torch.utils import babyjubjub_ref as bref
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref
from passport_zk_circuits_tpu_torch.utils import keccak_ref
from passport_zk_circuits_tpu_torch.utils import poseidon_ref as pref
from passport_zk_circuits_tpu_torch.utils import profiling
from passport_zk_circuits_tpu_torch.utils import rsa_keygen
from passport_zk_circuits_tpu_torch.utils.constants.countries import COUNTRIES

FLAGSHIP = "registerIdentity_1_256_3_4_600_248_1_1496_3_256"
ECDSA_PATH = "registerIdentity_21_256_3_4_600_248_20_1496_3_256"
PSS_PATH = "registerIdentity_11_256_3_4_600_248_1_1496_3_256"
BATCH = 1024
CHAINED_STEPS = 3
SCAN_LEN = 256                  # products per call on the field-muls/s path
SEED = 1

# name -> (wrapper, kernel source, TPU kernel's pallas_call it replaces)
KERNELS = {
    "sha2_32_chunks_many": (cuda_sha2.sha2_32_chunks_many,
                            "passport_zk_circuits_tpu_torch/csrc/sha256.cu",
                            "passport_zk_circuits_tpu/ops/pallas_sha2.py:70"),
    "sha2_32_chunks": (cuda_sha2.sha2_32_chunks,
                       "passport_zk_circuits_tpu_torch/csrc/sha256.cu",
                       "passport_zk_circuits_tpu/ops/pallas_sha2.py:70"),
    "pow_mod": (cuda_rsa.pow_mod,
                "passport_zk_circuits_tpu_torch/csrc/rsa.cu",
                "passport_zk_circuits_tpu/ops/pallas_rsa.py:109"),
    "poseidon_ex": (cuda_poseidon.poseidon_ex,
                    "passport_zk_circuits_tpu_torch/csrc/poseidon.cu",
                    "passport_zk_circuits_tpu/ops/pallas_poseidon.py:382"),
    "smt_climb": (cuda_poseidon.smt_climb,
                  "passport_zk_circuits_tpu_torch/csrc/poseidon.cu",
                  "passport_zk_circuits_tpu/ops/pallas_poseidon.py:437"),
    "ladder": (cuda_babyjubjub.ladder,
               "passport_zk_circuits_tpu_torch/csrc/babyjubjub.cu",
               "passport_zk_circuits_tpu/ops/pallas_babyjubjub.py:107"),
    "ladder_affine": (cuda_babyjubjub.ladder_affine,
                      "passport_zk_circuits_tpu_torch/csrc/babyjubjub.cu",
                      "passport_zk_circuits_tpu/ops/pallas_babyjubjub.py:107"),
    "mul": (cuda_field.mul,
            "passport_zk_circuits_tpu_torch/csrc/field.cu",
            "passport_zk_circuits_tpu/ops/pallas_field.py:260"),
    "mul_chain": (cuda_field.mul_chain,
                  "passport_zk_circuits_tpu_torch/csrc/field.cu",
                  "passport_zk_circuits_tpu/ops/pallas_field.py:283"),
    "run_loop": (cuda_loop.loop,
                 "passport_zk_circuits_tpu_torch/csrc/loop_bench.cu",
                 "tools/microbench_kernel.py:69"),
    "probe": (cuda_probe.probe,
              "passport_zk_circuits_tpu_torch/csrc/probe.cu",
              "tools/probe_mosaic.py:38"),
    "probe_battery": (cuda_probe.battery,
                      "passport_zk_circuits_tpu_torch/csrc/probe.cu",
                      "tools/probe_mosaic.py:38"),
    # the Groth16 prover's kernels (K10, K11) replace no TPU kernel: the
    # JAX package leaves these functions to XLA, and "replaces" names them
    "msm_points": (cuda_msm.points,
                   "passport_zk_circuits_tpu_torch/csrc/msm.cu",
                   "passport_zk_circuits_tpu/ops/msm.py:122"),
    "msm_g1": (cuda_msm.msm_g1,
               "passport_zk_circuits_tpu_torch/csrc/msm.cu",
               "passport_zk_circuits_tpu/ops/msm.py:122"),
    "msm_g2": (cuda_msm.msm_g2,
               "passport_zk_circuits_tpu_torch/csrc/msm.cu",
               "passport_zk_circuits_tpu/ops/msm.py:122"),
    "fixed_base_g1": (cuda_fixed_base.mul_g1,
                      "passport_zk_circuits_tpu_torch/csrc/fixed_base.cu",
                      "passport_zk_circuits_tpu/groth16/protocol.py:223"),
    "fixed_base_g2": (cuda_fixed_base.mul_g2,
                      "passport_zk_circuits_tpu_torch/csrc/fixed_base.cu",
                      "passport_zk_circuits_tpu/groth16/protocol.py:260"),
}
# a setup on the card runs K11 and converts its key's points for K10 once;
# a prove runs K10 on those points
SETUP_ON = ("msm_points", "fixed_base_g1", "fixed_base_g2")
PROVE_ON = ("msm_g1", "msm_g2")
WITNESS_KERNELS = ("sha2_32_chunks_many", "pow_mod", "poseidon_ex",
                   "smt_climb", "ladder_affine")
# held against their plain versions only: the witness step takes the
# many-message K1 entry and K5's affine one
OFF_PATH = ("sha2_32_chunks", "ladder")
FIELD_KERNELS = ("mul", "mul_chain", "run_loop")
# the other SIG_ALGO paths: (config, kernels that must launch, kernels that
# must not)
ALGO_PATHS = {
    "ecdsa": (ECDSA_PATH, ("sha2_32_chunks_many", "poseidon_ex", "smt_climb",
                           "ladder_affine"),
              ("pow_mod", "sha2_32_chunks", "ladder")),
    "rsa-pss": (PSS_PATH, ("sha2_32_chunks_many", "sha2_32_chunks",
                           "pow_mod", "poseidon_ex", "smt_climb",
                           "ladder_affine"), ("ladder",)),
}
# the hand-written kernels' symbols in a profile -> their KERNELS name
KERNEL_OF_SYMBOL = {"sha256_many_kernel": "sha2_32_chunks_many",
                    "sha256_kernel": "sha2_32_chunks",
                    "rsa_pow_kernel": "pow_mod",
                    "poseidon_kernel": "poseidon_ex",
                    "smt_climb_kernel": "smt_climb",
                    "ladder_kernel": "ladder_affine"}
# K9's one kernel: a probe alone and the battery both launch it
PROBE_KERNEL = "probe_battery_kernel"

# -- the least time the card could take (bound_ms) ---------------------------
# The larger of the bytes a kernel must move (each int64 input read once,
# each output written once) over HBM3's 3.35 TB/s, and its 32-bit integer
# instructions over 64 a clock per SM (compute capability 9.0) x the SMs x
# the SM clock nvidia-smi reports as clocks.max.sm; mma.sync int8 products
# over the 1979 TOP/s int8 tensor-core peak (NVIDIA H100 SXM data sheet).
# Instruction counts are the least the function needs, not those of the
# code as written:
HBM_BYTES_PER_S = 3.35e12
INT8_MMA_OPS_PER_S = 1979e12
INT_OPS_PER_CLOCK_PER_SM = 64
CARD = {}                       # int_ops_per_s, filled in by main()
FLOORS = []     # (entry, floor_ms) of each kernel whose latency is modelled
PROFILED = []   # (entry, fn, kernel symbols) for device_profile
OPS_PARTIAL = 2         # a 32x32->64 partial product accumulated with its
                        # carries: mad.lo.cc + madc.hi.cc
OPS_MONT_MUL = 128 * OPS_PARTIAL + 8 + 16   # CIOS: 64 a*b and 64 m*p
                                            # partials, 8 low m = t0*inv;
                                            # final subtract and select
OPS_MONT_SQR = 100 * OPS_PARTIAL + 8 + 16 + 16  # a*a: 28 cross partials
                                                # once, doubled (16), and 8
                                                # squares; then as a product
OPS_SMALL_MUL = 17 * OPS_PARTIAL + 16   # by a constant below 2^32 (the
                                        # curve's a and d): 8 partials, a
                                        # one-word quotient, 8 of q*P, then
                                        # the final subtract and select
OPS_FR_ADD = 24         # fr::add / sub: 8 add-with-carry, 8 subtract, select
OPS_SHA_BLOCK = 64 * 15 + 48 * 10       # 64 rounds, 48 schedule words
# A lane's SHA rounds are one dependent chain. Its least length a round:
# e's rotations (SHF), their XOR with ch (LOP3), the three-input add into
# the next e (IADD3), h + K + w being ready beforehand; 4 clocks each, the
# latency of a dependent integer instruction on the SM (Volta to Hopper).
SHA_ROUND_CHAIN_CLOCKS = 3 * 4
# A product of a lane on a team of threads (frs::Slice::mul: K6, K7 and K8's
# modmul_mont32) is 8 word steps, whatever the team's W. A step's dependent
# chain: IMAD.WIDE (t0 + a_i b_0), IMAD (m = t0 (-P^-1)), the shuffle that
# brings m to the team, IMAD.WIDE (+ m p_c) and IADD3 into the column below.
# Then the carries (a shuffle, two ballots, an add) and the final subtract
# (two ballots, a select). Each is taken at 4 clocks, a dependent integer
# instruction's latency; a shuffle's and a ballot's are longer (not measured
# here), so the model is a floor.
TEAM_STEP_CHAIN_CLOCKS = 5 * 4
TEAM_CARRY_CLOCKS = 4 * 4
TEAM_SUBTRACT_CLOCKS = 3 * 4
# One step of a K8 body's chain: the elementwise bodies' limb, IMAD (x c + 1)
# then LOP3 (& 0xFFFF), or IADD (x + (c >> 1), the shift hoisted) then LOP3,
# 4 clocks each; modmul_mont32's team product without its final subtract
# (frs::Slice::mul_lazy). The TPU's 16-bit bodies have no model.
LOOP_STEP_CHAIN_CLOCKS = {
    "u32_mul_add": 2 * 4, "i32_mul_add": 2 * 4, "mask_shift_add": 2 * 4,
    "modmul_mont32": 8 * TEAM_STEP_CHAIN_CLOCKS + TEAM_CARRY_CLOCKS}
# BabyJubJub in extended coordinates: the addition add-2008-hwcd, 9
# products, the products by a and by d, 7 additions; the doubling
# dbl-2008-hwcd, 4 products, 4 squarings, the product by a, 7 additions; the
# unified addition of a point to itself, 4 products, 5 squarings, 2 by the
# constants, 7 additions
OPS_BJJ_ADD = 9 * OPS_MONT_MUL + 2 * OPS_SMALL_MUL + 7 * OPS_FR_ADD
OPS_BJJ_DBL = (4 * OPS_MONT_MUL + 4 * OPS_MONT_SQR + OPS_SMALL_MUL
               + 7 * OPS_FR_ADD)
OPS_BJJ_DBL_UNIFIED = (4 * OPS_MONT_MUL + 5 * OPS_MONT_SQR
                       + 2 * OPS_SMALL_MUL + 7 * OPS_FR_ADD)


def bound(nbytes, int_ops, mma_ops=0):
    """(bound_ms, bound_by) for a kernel's bytes and operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (int_ops / CARD["int_ops_per_s"] +
             mma_ops / INT8_MMA_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def poseidon_ops(t, n_outs=1):
    """int32 instructions of the least work of one PoseidonEx permutation
    per lane (the schedule of csrc/poseidon.cuh), with the entry and exit
    conversions: an S-box x^5 is two squarings and a product; a full round
    t S-boxes and a t x t mix, the last one only for the n_outs outputs; a
    partial round one S-box, the 2t - 1 products of the s0 row and s1
    column."""
    nP = pos.N_ROUNDS_P[t - 2]
    sboxes = 8 * t + nP
    muls = (sboxes + 7 * t * t + n_outs * t + nP * (2 * t - 1)
            + t + n_outs)
    adds = 8 * t + 7 * t * (t - 1) + n_outs * (t - 1) + nP * (2 * t - 1)
    return (2 * sboxes * OPS_MONT_SQR + muls * OPS_MONT_MUL
            + adds * OPS_FR_ADD)


def modexp_ops(K, e):
    """int32 instructions of the least work of one K2 lane, x^e mod n on
    K-word numbers: left to right, a squaring for each bit of e below the
    top one and a product for each further set bit, each with its
    reduction mod n. A product is K^2 partials, a squaring K(K+1)/2 (cross
    terms once) and 2K to double them. A reduction takes the cheaper of
    Montgomery's (K^2 partials of m * n and K quotient words m) and
    Barrett's with the lane's mu (the top K + 1 words of q1 * mu, K^2/2 +
    5K/2 + 1 partials, and q3 * n mod b^(K+1), K^2/2 + 3K/2), and a
    compare, subtract and select of about 3K. No conversion is counted:
    Barrett with the given mu needs none, and in Montgomery form the exit
    can ride on the last product (csrc/bignum.cuh's bnw spends R^2 mod n,
    the entry and the exit on top of this)."""
    if e == 1:
        return 0                                  # x itself
    montgomery = K * K * OPS_PARTIAL + K
    barrett = (K * K + 4 * K + 1) * OPS_PARTIAL
    red = min(montgomery, barrett) + 3 * K
    mul = K * K * OPS_PARTIAL + red
    sqr = K * (K + 1) // 2 * OPS_PARTIAL + 2 * K + red
    return ((e.bit_length() - 1) * sqr + (bin(e).count("1") - 1) * mul)


def window_chain_muls(e):
    """Products, squarings apart, of the shortest sliding-window chain for
    x^e over window widths 1-8: the odd powers x^3 .. x^(2^w - 1) (after
    one squaring) take 2^(w-1) - 1, each window after the first one."""
    bits = bin(e)[2:]
    best = None
    for w in range(1, 9):
        i = windows = 0
        while i < len(bits):
            if bits[i] == "0":
                i += 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            windows, i = windows + 1, j
        muls = 2 ** (w - 1) - 1 + windows - 1
        best = muls if best is None else min(best, muls)
    return best


# Z^-1 = Z^(P-2): 253 squarings (and x^2 for the window's table), products
# of the chain above: 254 squarings and 56 products for BN254's Fr
OPS_FR_INV = ((fr.P - 2).bit_length() * OPS_MONT_SQR
              + window_chain_muls(fr.P - 2) * OPS_MONT_MUL)

# The Groth16 prover's group arithmetic (K10, K11) over BN254's base field
# q (8 words, CIOS: a product, squaring and addition cost as Fr's above)
# and Fq2 (a product Karatsuba's 3 products and 5 additions, a squaring 2
# products and 3 additions, an addition 2); csrc/bn254_curve.cuh's
# formulas: the mixed add 8 products, 3 squarings, 7 additions, the full
# add 12, 4 and 7, the doubling (a = 0) 2, 5 and 12; to_affine an
# inversion, a squaring and 3 products (an Fq2 inversion: 2 squarings, 2
# products and 2 additions of Fq around an Fq inversion); an affine add
# whose inversion is shared by many (Montgomery's trick) 2 products, a
# squaring and 6 additions, and 3 products for its share of the inversion.
OPS_FQ_INV = ((g2.Q - 2).bit_length() * OPS_MONT_SQR
              + window_chain_muls(g2.Q - 2) * OPS_MONT_MUL)


def _ec_ops(mul, sqr, add, inv):
    return {"madd": 8 * mul + 3 * sqr + 7 * add,
            "add": 12 * mul + 4 * sqr + 7 * add,
            "dbl": 2 * mul + 5 * sqr + 12 * add,
            "affine": inv + sqr + 3 * mul,
            "batch_add": 5 * mul + sqr + 6 * add}


EC_OPS = {
    False: _ec_ops(OPS_MONT_MUL, OPS_MONT_SQR, OPS_FR_ADD, OPS_FQ_INV),
    True: _ec_ops(3 * OPS_MONT_MUL + 5 * OPS_FR_ADD,
                  2 * OPS_MONT_MUL + 3 * OPS_FR_ADD, 2 * OPS_FR_ADD,
                  OPS_FQ_INV + 2 * OPS_MONT_SQR + 2 * OPS_MONT_MUL
                  + 2 * OPS_FR_ADD)}
MSM_WIDTHS = range(4, 21)       # the window widths msm_ops tries


def _window_digits(sc, c, signed):
    """(16, lanes, n) limbs of scalars below 2^254 -> their c-bit digits a
    window, (lanes, n) each: unsigned, ceil(254 / c) windows, or signed
    (the carry taken into the next window when a digit is above 2^(c-1)),
    ceil(255 / c)."""
    pad = torch.cat([sc, torch.zeros_like(sc[:3])])
    carry = torch.zeros_like(sc[0])
    for w in range(-(-(255 if signed else 254) // c)):
        k, off = divmod(w * c, 16)
        v = ((pad[k] | (pad[k + 1] << 16) | (pad[k + 2] << 32)) >> off) & (
            (1 << c) - 1)
        if signed:
            v = v + carry
            carry = (v > 1 << (c - 1)).to(v.dtype)
            v = v - (carry << c)
        yield v


def msm_work(scalars, is_g2, c, signed):
    """int32 instructions of Pippenger's bucket method with c-bit windows
    (signed or unsigned digits) on these scalars (16, *L, N): in each
    window of each lane, a bucket add an item (a non-zero digit) less one a
    non-empty bucket, each at the cheaper of the mixed add and the
    batched-affine add; the running sums, two full adds a digit below the
    window's largest |digit|; a lane's Horner chain from its top non-empty
    window (c doublings a window below it, an add a non-empty window below
    it) and its affine conversion."""
    e = EC_OPS[is_g2]
    bucket_add = min(e["madd"], e["batch_add"])
    sc = scalars.reshape(16, -1, scalars.shape[-1]).long()
    lanes = sc.shape[1]
    lane_key = torch.arange(lanes, device=sc.device)[:, None] << c
    adds, running, nonempty_w = [], [], []
    for d in _window_digits(sc, c, signed):
        a = d.abs()
        nonempty = (torch.bincount((lane_key + a).reshape(-1),
                                   minlength=lanes << c)
                    .reshape(lanes, -1)[:, 1:] > 0).sum()
        adds.append((a != 0).sum() - nonempty)
        running.append((a.amax(1) - 1).clamp(min=0).sum() * 2)
        nonempty_w.append(a.amax(1) > 0)
    nz = torch.stack(nonempty_w)                        # (windows, lanes)
    windows = torch.arange(1, nz.shape[0] + 1, device=nz.device)[:, None]
    top = (nz * windows).amax(0)                        # 1 + top window
    adds, running, dbls, chain_adds, live = torch.stack([
        sum(adds), sum(running), ((top - 1) * c).clamp(min=0).sum(),
        (nz.sum(0) - 1).clamp(min=0).sum(), (top > 0).sum()]).tolist()
    return (adds * bucket_add + running * e["add"] + dbls * e["dbl"]
            + chain_adds * e["add"] + live * e["affine"])


def msm_ops(scalars, is_g2):
    """int32 instructions of the least Pippenger work on this run's
    scalars (16, *L, N): msm_work's minimum over the window widths
    MSM_WIDTHS and unsigned or signed digits, whatever plan the kernel
    follows (K10's bound)."""
    return min(msm_work(scalars, is_g2, c, signed)
               for c in MSM_WIDTHS for signed in (False, True))


def msm_ops_16bit(scalars, is_g2):
    """int32 instructions of the first K10 design's least work (its
    bound, kept for continuity): a mixed add an item (a non-zero 16-bit
    digit) less one a non-empty bucket; a window's running sums, two full
    adds a bucket from its highest digit down; a lane's Horner chain (15
    windows of 16 doublings and an add) and its affine conversion."""
    e = EC_OPS[is_g2]
    sc = scalars.reshape(16, -1, scalars.shape[-1])
    items = int((sc != 0).sum())
    nonempty = running = 0
    for w in range(sc.shape[0]):
        for lane in range(sc.shape[1]):
            d = sc[w, lane][sc[w, lane] != 0]
            if d.numel():
                nonempty += int(torch.unique(d).numel())
                running += 2 * (int(d.max()) - 1)
    chain = sc.shape[1] * (15 * (16 * e["dbl"] + e["add"]) + e["affine"])
    return (items - nonempty) * e["madd"] + running * e["add"] + chain


def msm_bytes(scalars, is_g2):
    """Each point's Montgomery words read once, the scalars read once, the
    affine limbs written once."""
    n, cw = scalars.shape[-1], cuda_msm.coord_words(is_g2)
    lanes = scalars[0, ..., 0].numel()
    return n * 2 * cw * 4 + scalars.numel() * 8 + lanes * 2 * 2 * cw * 8


def fixed_base_ops(scalars, is_g2):
    """int32 instructions of K11's least work on this run's scalars (16,
    B): a mixed add a non-zero byte but a scalar's first, and the affine
    conversion of each non-zero scalar."""
    e = EC_OPS[is_g2]
    nz = torch.stack([scalars & 0xFF, scalars >> 8], 1).ne(0).sum((0, 1))
    return (int((nz - 1).clamp(min=0).sum()) * e["madd"]
            + int((nz > 0).sum()) * e["affine"])


def fixed_base_bytes(scalars, is_g2):
    """The scalars and the table read once, the affine limbs written once."""
    cw = cuda_msm.coord_words(is_g2)
    return (scalars.numel() * 8 + 32 * 256 * 2 * cw * 4
            + scalars.shape[1] * 2 * 2 * cw * 8)


def ladder_ops(bits, affine):
    """int32 instructions of K5's least work on this run's scalars, bits
    (254, B) LSB first. A lane whose top set bit is bit k needs k
    doublings of the base, an addition for each set bit (acc is kept where
    the bit is 0) and base's T = x*y; a lane with no set bit gives the
    identity and needs nothing. The extended output's representative is
    that of the unified addition, so its doublings are unified; the affine
    output is unique, so it takes the doubling formula, the inversion of Z
    and two products by 1/Z."""
    bits = bits.cpu()
    tops = (bits * torch.arange(1, bits.shape[0] + 1)[:, None]).max(0).values
    adds = int(bits.sum())
    dbls = int((tops - 1).clamp(min=0).sum())
    lanes = int((tops > 0).sum())
    if affine:
        return (adds * OPS_BJJ_ADD + dbls * OPS_BJJ_DBL
                + lanes * (3 * OPS_MONT_MUL + OPS_FR_INV))
    return (adds * OPS_BJJ_ADD + dbls * OPS_BJJ_DBL_UNIFIED
            + lanes * OPS_MONT_MUL)


def sha_floor_ms(nb):
    """The critical-path floor of a lane of nb SHA blocks: its 64 nb
    rounds, one after another, at SHA_ROUND_CHAIN_CLOCKS each."""
    return 64 * nb * SHA_ROUND_CHAIN_CLOCKS / CARD["sm_hz"] * 1e3


def fr_mul_floor_ms():
    """The critical-path floor of a K6 lane: its two dependent team
    products, mont(a, R^2) then mont(b, a R), each 8 team steps, its
    carries and its final subtract."""
    product = (8 * TEAM_STEP_CHAIN_CLOCKS + TEAM_CARRY_CLOCKS
               + TEAM_SUBTRACT_CLOCKS)
    return 2 * product / CARD["sm_hz"] * 1e3


def loop_floor_ms(body, n):
    """The critical-path floor of K8's body at n steps: n steps of one
    chain, LOOP_STEP_CHAIN_CLOCKS each; None for a body with no model."""
    clocks = LOOP_STEP_CHAIN_CLOCKS.get(body)
    return None if clocks is None else n * clocks / CARD["sm_hz"] * 1e3


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Mean device time of fn over reps runs (CUDA events), after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn's output, its device ms) of one call, CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(k_out, p_out):
    if isinstance(k_out, torch.Tensor):
        k_out, p_out = [k_out], [p_out]
    return max(int((a - b).abs().max()) for a, b in zip(k_out, p_out))


def compare(name, kernel_fn, plain_fn, nbytes, int_ops, reps=10,
            mma_ops=0, plain_once=False, plain_lanes=None, floor_ms=None):
    """Run kernel and plain version on the same CUDA inputs; they must be
    bit-equal. The plain version is timed after a warm-up run, or, with
    plain_once (plain versions that take seconds), on the one run that is
    compared. With plain_lanes = m, plain_fn computes the batch's first m
    lanes only (the batch is every output's last dimension) and the
    kernel's outputs are compared on those. floor_ms: the kernel's
    critical-path floor, a latency model computed from this run's clock and
    shapes like the bound (None where none is modelled); a model, not a
    measurement, so it goes to FLOORS and not into the entry. Returns
    (kernel outputs, JSON entry without launches)."""
    k_out = kernel_fn()
    p_out, plain_ms = timed_once(plain_fn)
    if isinstance(k_out, torch.Tensor):
        k_out, p_out = [k_out], [p_out]
    err = max_abs_err([k[..., :plain_lanes] for k in k_out], p_out)
    on = "" if plain_lanes is None else f" on {plain_lanes} lanes"
    check(err == 0, f"{name}: kernel differs from plain{on} (max abs {err})")
    ms = cuda_ms(kernel_fn, reps)
    if not plain_once:
        plain_ms = cuda_ms(plain_fn, 1)
    _, source, replaces = KERNELS[name]
    bound_ms, bound_by = bound(nbytes, int_ops, mma_ops)
    floor = "" if floor_ms is None else f", floor {floor_ms:.6f} ms"
    print(f"  {name}: bit-equal{on}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms{on}, bound {bound_ms:.6f} ms ({bound_by})"
          f"{floor}")
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}
    if plain_lanes is not None:
        entry["plain_lanes"] = plain_lanes
    if floor_ms is not None:
        FLOORS.append((entry, floor_ms))
    return k_out, entry


def to_profile(entry, fn, symbols):
    """Mark entry's kernel for device_profile: one call of fn launches the
    kernels named symbols, in that order."""
    PROFILED.append((entry, fn, list(symbols)))


def kernel_symbol(name):
    """A profiler kernel name without return type, template arguments and
    parameters: 'void loop_limb_kernel<loopb::U32MulAdd>(long const*, ...)'
    -> 'loop_limb_kernel'."""
    return name.split("(")[0].removeprefix("void ").split("<")[0]


def device_profile(forwards):
    """One torch.profiler session (CPU and CUDA activities; a session after
    another lost its first kernels on the card): each forward of forwards
    ((label, fn) pairs) inside a record_function range of its own, then
    every marked entry's fn twice over, a warm round and a timed one, each
    call fenced by a synchronize, so the session's last kernels in order of
    start are the timed calls' in turn, and those before the warm round
    the forwards'. A kernel belongs to the forward whose range holds its
    launch (the host event with the kernel record's correlation id). A
    launch of the session without its kernel record, a forward's kernel
    without its launch, or a warm or timed call whose kernels are not the
    ones its entry names, fails the run: a lost record would shift every
    later time onto the wrong entry. Records each marked kernel's device
    microseconds in its entry: the time of the short kernels whose
    CUDA-event times measure the host that issues them. Returns, for each
    forward, its CUDA kernels, their summed device ms, its wall ms (host
    clock; the device's idle share is 1 - device / wall) and the count and
    device us of each hand-written kernel in it. Memory copies and sets
    are not counted as kernels."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    wall_ms = {}
    with torch.profiler.profile(activities=acts) as prof:
        for label, fn in forwards:
            with torch.profiler.record_function(f"chip_smoke:{label}"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms[label] = (time.perf_counter() - t0) * 1e3
        for _, fn, _ in PROFILED + PROFILED:
            fn()
            torch.cuda.synchronize()
    # the session's raw records, read once (building the profiler's
    # FunctionEvent tree over a few million records took minutes)
    cpu_dev = torch.autograd.DeviceType.CPU
    cuda_dev = torch.autograd.DeviceType.CUDA
    ranges, launch_at, launched, kernels = {}, {}, set(), []
    for ev in prof.profiler.kineto_results.events():
        if getattr(ev, "is_hidden_event", lambda: False)():
            continue                # as the profiler's own reading skips
        name, kind = ev.name(), ev.device_type()
        if kind == cpu_dev:
            if name.startswith("chip_smoke:"):
                ranges[name.removeprefix("chip_smoke:")] = (ev.start_ns(),
                                                            ev.end_ns())
            elif name.startswith("cu"):
                # a launch and its kernel record share the correlation id
                launch_at[ev.correlation_id()] = ev.start_ns()
                if name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
                    launched.add(ev.correlation_id())
        elif kind == cuda_dev and not name.startswith(
                ("Memcpy", "Memset", "chip_smoke:")):
            # the device side of a record_function range is an annotation,
            # not a kernel
            if name.startswith("_Z"):
                name = torch._C._demangle(name)
            kernels.append((ev.start_ns(), ev.duration_ns() / 1e3, name,
                            ev.correlation_id()))
    kernels.sort(key=lambda k: k[0])
    lost = launched - {k[3] for k in kernels}
    check(not lost, f"profiler lost the kernel records of {len(lost)} "
          "launch(es)")
    expected = [s for _, _, symbols in PROFILED for s in symbols]
    n_short = len(expected)
    check(len(kernels) > 2 * n_short,
          f"profiler saw {len(kernels)} kernels, not the forwards' and "
          f"2 x {n_short}")
    forward, warm, short = (kernels[:-2 * n_short],
                            kernels[-2 * n_short:-n_short],
                            kernels[-n_short:])
    for got in (warm, short):
        names = [kernel_symbol(k[2]) for k in got]
        check(names == expected, f"profiler's short kernels {names}, not "
              f"{expected}")
    for e, _, symbols in PROFILED:
        n = len(symbols)
        e["profiler_device_us"] = [k[1] for k in short[:n]]
        short = short[n:]
        print(f"  {e['name']}: {n} launch(es), device "
              f"{sum(e['profiler_device_us']):.3f} us (torch.profiler; "
              f"{', '.join(sorted(set(symbols)))})")
    check(sorted(ranges) == sorted(wall_ms), f"profiler ranges {ranges}")
    stats = {label: {"kernels": 0, "device_us": 0.0, "by_kernel": {}}
             for label in wall_ms}
    for start, us, kname, corr in forward:
        t = launch_at.get(corr)
        check(t is not None, f"kernel {kname} without its launch")
        label = next((lb for lb, (lo, hi) in ranges.items()
                      if lo <= t <= hi), None)
        check(label is not None, f"kernel {kname} launched outside the "
              "forwards")
        st = stats[label]
        st["kernels"] += 1
        st["device_us"] += us
        name = KERNEL_OF_SYMBOL.get(kernel_symbol(kname))
        if name:
            n, t_us = st["by_kernel"].get(name, (0, 0.0))
            st["by_kernel"][name] = (n + 1, t_us + us)
    return {label: {"kernels": st["kernels"],
                    "device_ms": st["device_us"] / 1e3,
                    "wall_ms": wall_ms[label], "by_kernel": st["by_kernel"]}
            for label, st in stats.items()}


def words_to_bytes(col) -> bytes:
    return b"".join(int(v).to_bytes(4, "big") for v in col)


def phase_sha(dev, rng):
    """SHA-256 at the flagship's block counts (dg1 2, dg15 3, ec 4, sa 2)
    on real padded messages (words >= 2^31 included): the step's one
    many-message launch (sha2_32_chunks_many) timed beside the route of one
    launch a message (sha2_32_chunks, four calls), both against their plain
    versions and hashlib; then SA under SHA-224 (SIG_ALGO 24) in the
    many-message entry and alone, and a list of three (no dg15). Then the
    per-message entry alone at the RSA-PSS path's shapes, as
    sha2.sha_hash_byte_rows calls it there: MGF1's seven blocks (nb = 1)
    and M' (nb = 2), one launch each."""
    def messages(nb):
        ms = [bytes(rng.randrange(256) for _ in range(
            64 * nb - 9 - rng.randrange(50))) for _ in range(BATCH)]
        return ms, bn.to_tensor(np.stack(
            [sha2.bytes_to_words32(sha2.pad_message(m, 512)) for m in ms],
            axis=-1), dev)

    msgs, words = {}, {}
    for nb in (2, 3, 4):
        msgs[nb], words[nb] = messages(nb)
        check(bool((words[nb] >= 1 << 31).any()), "no word >= 2^31")
    nbs = (2, 3, 4, 2)
    step = [words[nb] for nb in nbs]
    algos = [256] * 4
    work = dict(nbytes=8 * sum(w.numel() + 8 * BATCH for w in step),
                int_ops=sum(nbs) * OPS_SHA_BLOCK * BATCH)
    # one launch: its longest lane; launches on one stream run one after
    # another, so theirs add up
    outs, many = compare(
        "sha2_32_chunks_many",
        lambda: cuda_sha2.sha2_32_chunks_many(step, algos),
        lambda: cuda_sha2.sha2_32_chunks_many_plain(step, algos),
        floor_ms=sha_floor_ms(max(nbs)), **work)
    four_outs, four = compare(
        "sha2_32_chunks", lambda: [cuda_sha2.sha2_32_chunks(w) for w in step],
        lambda: [cuda_sha2.sha2_32_chunks_plain(w) for w in step],
        floor_ms=sha_floor_ms(sum(nbs)), **work)
    check(all(torch.equal(a, b) for a, b in zip(outs, four_outs)),
          "the two K1 routes differ")
    for nb, digest in zip(nbs, outs):
        for lane in range(0, BATCH, BATCH // 8):
            check(words_to_bytes(digest[:, lane].tolist()) ==
                  sha2.sha_hash_bytes_host(msgs[nb][lane], 256),
                  f"sha256 nb={nb} lane {lane} != hashlib")
    mixed = cuda_sha2.sha2_32_chunks_many(step, algos[:3] + [224])
    check(all(torch.equal(a, b) for a, b in zip(
        mixed, cuda_sha2.sha2_32_chunks_many_plain(step, algos[:3] + [224]))),
        "sha2_32_chunks_many with SHA-224 sa: kernel != plain")
    d224 = cuda_sha2.sha2_32_chunks(words[2], 224)
    check(torch.equal(d224, cuda_sha2.sha2_32_chunks_plain(words[2], 224))
          and torch.equal(d224, mixed[3]), "sha224 kernel != plain")
    for lane in range(0, BATCH, BATCH // 8):
        check(words_to_bytes(mixed[3][:, lane].tolist()) ==
              sha2.sha_hash_bytes_host(msgs[2][lane], 224),
              f"sha224 lane {lane} != hashlib")
    three = [words[2], words[4], words[2]]
    check(all(torch.equal(a, b) for a, b in zip(
        cuda_sha2.sha2_32_chunks_many(three, [256, 256, 224]),
        cuda_sha2.sha2_32_chunks_many_plain(three, [256, 256, 224]))),
        "sha2_32_chunks_many, three messages: kernel != plain")
    to_profile(many, lambda: cuda_sha2.sha2_32_chunks_many(step, algos),
               ["sha256_many_kernel"])
    to_profile(four, lambda: [cuda_sha2.sha2_32_chunks(w) for w in step],
               ["sha256_kernel"] * len(step))
    # a model of the chain's latency, not a measurement
    print(f"  K1 critical-path floor (a lane's {64 * max(nbs)} rounds x "
          f"{SHA_ROUND_CHAIN_CLOCKS} clocks): {sha_floor_ms(max(nbs)):.6f} "
          f"ms; the four launches' {64 * sum(nbs)} rounds: "
          f"{sha_floor_ms(sum(nbs)):.6f} ms")
    print("  K1's per-message entry at the RSA-PSS path's shapes (MGF1 "
          "7 x nb=1, M' nb=2):")
    mgf = [messages(1) for _ in range(7)]
    pss_msgs = [m for m, _ in mgf] + [msgs[2]]
    pss_words = [w for _, w in mgf] + [words[2]]
    pss_outs, pss = compare(
        "sha2_32_chunks",
        lambda: [cuda_sha2.sha2_32_chunks(w) for w in pss_words],
        lambda: [cuda_sha2.sha2_32_chunks_plain(w) for w in pss_words],
        nbytes=8 * sum(w.numel() + 8 * BATCH for w in pss_words),
        int_ops=9 * OPS_SHA_BLOCK * BATCH, floor_ms=sha_floor_ms(7 + 2))
    for ms, digest in zip(pss_msgs, pss_outs):
        for lane in range(0, BATCH, BATCH // 8):
            check(words_to_bytes(digest[:, lane].tolist()) ==
                  sha2.sha_hash_bytes_host(ms[lane], 256),
                  f"sha256 PSS-path message, lane {lane} != hashlib")
    to_profile(pss, lambda: [cuda_sha2.sha2_32_chunks(w) for w in pss_words],
               ["sha256_kernel"] * len(pss_words))
    many["shape"] = ("SHA-256, B=1024, the step's four messages nb=2,3,4,2 "
                     "in one launch")
    four["shape"] = ("SHA-256, B=1024, the same four messages, one launch "
                     "each (off the step)")
    pss["shape"] = ("SHA-256, B=1024, the RSA-PSS path's eight messages, "
                    "MGF1 7 x nb=1 and M' nb=2, one launch each")
    four["pss_path"] = pss
    return [many, four]


def _rsa_case(dev, rng, k, exp, even_lane=None):
    """BATCH random odd k-limb moduli with the top bit set (the lane
    even_lane made even) and signatures below them."""
    mods = [rng.getrandbits(16 * k - 1) | (1 << (16 * k - 1)) | 1
            for _ in range(BATCH)]
    if even_lane is not None:
        mods[even_lane] ^= 1
    sigs = [rng.randrange(m) for m in mods]
    args = [bn.to_tensor(bn.ints_to_limbs_batch(sigs, k), dev),
            bn.to_tensor(bn.ints_to_limbs_batch(mods, k), dev),
            bn.to_tensor(bn.barrett_mu_batch(mods, k), dev)]
    return sigs, mods, args


def rsa_bytes(args, k):
    return 8 * (sum(a.numel() for a in args) + k * BATCH)


def phase_rsa(dev, rng):
    """RSA-2048 (k = 128) with e = 65537 at B = 1024 (the JSON entry), then
    RSA-4096 (k = 256) timed beside it, a k = 128 batch with one
    even-modulus lane (Barrett on one thread of its warp), and k = 16 with
    e in {3, 65537, 37187}."""
    sigs, mods, args = _rsa_case(dev, rng, 128, 65537)
    outs, entry = compare("pow_mod",
                          lambda: cuda_rsa.pow_mod(*args, 65537),
                          lambda: cuda_rsa.pow_mod_plain(*args, 65537),
                          nbytes=rsa_bytes(args, 128),
                          int_ops=modexp_ops(64, 65537) * BATCH)
    got = bn.limbs_to_ints_batch(outs[0][:, :8])
    check(got == [pow(s, 65537, m) for s, m in zip(sigs[:8], mods[:8])],
          "pow_mod k=128 != pow()")
    sigs, mods, args = _rsa_case(dev, rng, 256, 65537)
    outs, e256 = compare("pow_mod",
                         lambda: cuda_rsa.pow_mod(*args, 65537),
                         lambda: cuda_rsa.pow_mod_plain(*args, 65537),
                         nbytes=rsa_bytes(args, 256),
                         int_ops=modexp_ops(128, 65537) * BATCH)
    check(bn.limbs_to_ints_batch(outs[0][:, :8]) ==
          [pow(s, 65537, m) for s, m in zip(sigs[:8], mods[:8])],
          "pow_mod k=256 != pow()")
    entry["k256"] = {key: e256[key] for key in
                     ("ms", "plain_ms", "bound_ms", "bound_by")}
    sigs, mods, args = _rsa_case(dev, rng, 128, 65537, even_lane=5)
    out = cuda_rsa.pow_mod(*args, 65537)
    check(torch.equal(out, cuda_rsa.pow_mod_plain(*args, 65537)),
          "pow_mod k=128 with an even-modulus lane: kernel != plain")
    check(bn.limbs_to_ints_batch(out[:, :8]) ==
          [pow(s, 65537, m) for s, m in zip(sigs[:8], mods[:8])],
          "pow_mod k=128 with an even-modulus lane != pow()")
    entry["even_lane_ms"] = cuda_ms(lambda: cuda_rsa.pow_mod(*args, 65537),
                                    10)
    print(f"  pow_mod: a batch with one even-modulus lane bit-equal, "
          f"{entry['even_lane_ms']:.4f} ms")
    for exp in (3, 65537, 37187):
        sigs, mods, args = _rsa_case(dev, rng, 16, exp)
        out = cuda_rsa.pow_mod(*args, exp)
        check(torch.equal(out, cuda_rsa.pow_mod_plain(*args, exp)),
              f"pow_mod k=16 e={exp}: kernel != plain")
        check(bn.limbs_to_ints_batch(out[:, :8]) ==
              [pow(s, exp, m) for s, m in zip(sigs[:8], mods[:8])],
              f"pow_mod k=16 e={exp} != pow()")
    entry["shape"] = ("k=128 (RSA-2048), e=65537, B=1024; k256: RSA-4096; "
                      "even_lane_ms: k=128 with lane 5 even")
    return entry


def rand_fr(dev, rng):
    xs = [rng.randrange(fr.P) for _ in range(BATCH)]
    return xs, bn.to_tensor(fr.batch_to_limbs(xs), dev)


def phase_poseidon(dev, rng):
    """Poseidon at the flagship's widths: one step calls t = 2 twice, t = 3
    and t = 4 once, t = 6 three times. The step's seven calls are the JSON
    entry; each width is also timed alone."""
    cases = {}
    for t in (2, 3, 4, 6):
        cols, ts = zip(*[rand_fr(dev, rng) for _ in range(t - 1)])
        cases[t] = (cols, torch.stack(ts, 1))
    step = [2, 2, 3, 4, 6, 6, 6]
    outs, entry = compare(
        "poseidon_ex",
        lambda: torch.cat([cuda_poseidon.poseidon_ex(cases[t][1])
                           for t in step], 1),
        lambda: torch.cat([cuda_poseidon.poseidon_ex_plain(cases[t][1])
                           for t in step], 1),
        nbytes=sum(8 * 16 * (t + 1) * BATCH
                   + 4 * cuda_poseidon._pack(t, dev).numel() for t in step),
        int_ops=sum(poseidon_ops(t) for t in step) * BATCH)
    for j, t in enumerate(step):
        got = fr.batch_from_limbs(outs[0][:, j, :8])
        cols = cases[t][0]
        check(got == [pref.poseidon([c[i] for c in cols]) for i in range(8)],
              f"poseidon t={t} != oracle")
    entry["widths_ms"] = {}
    for t in (2, 3, 4, 6):
        ms = cuda_ms(lambda: cuda_poseidon.poseidon_ex(cases[t][1]), 10)
        bound_ms, _ = bound(8 * 16 * (t + 1) * BATCH
                            + 4 * cuda_poseidon._pack(t, dev).numel(),
                            poseidon_ops(t) * BATCH)
        entry["widths_ms"][t] = ms
        print(f"  poseidon_ex t={t} alone: {ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms")
    entry["shape"] = "B=1024, one step's seven calls: t=2,2,3,4,6,6,6"
    return entry


SMT_LEVELS = 80
SMT_PLAIN_LANES = 128       # the deep profiles' plain runs: a slice
# identity-state paths: a uniform-key SMT of about 2^20 identities puts a
# leaf near depth log2 N, about 20 (an estimate, not a registry figure), so
# each lane draws its live levels from 18..24 (the query's lane 2 holds
# none, its lane 3 79)
LIVE_LEVELS = (18, 24)


def smt_bound(args):
    """K4's bound from the live (lane, level) pairs of this batch (its top
    flags): those levels need a permutation, the sibling's conversion and
    the sibling and key bit; every level needs its top and inew flags;
    every lane the leaf's t = 4 permutation, key and value in, the root
    out and two conversions."""
    top = args[2]
    n, batch = top.shape
    live = int(top.sum())
    nbytes = 8 * (2 * n * batch + live * 17 + 3 * 16 * batch)
    int_ops = (live * (poseidon_ops(3) + OPS_MONT_MUL)
               + (poseidon_ops(4) + 2 * OPS_MONT_MUL) * batch)
    return live, nbytes, int_ops


def smt_case(dev, keys_t, vals_t, sib_cols):
    """The climb's inputs for one sibling path a lane (index 0 root-most)."""
    sibs = bn.to_tensor(np.stack([fr.batch_to_limbs(c) for c in sib_cols],
                                 axis=-1), dev)             # (16, n, B)
    return (*smt.climb_inputs(keys_t, sibs), keys_t, vals_t)


def phase_smt(dev, rng):
    """The 80-level climb at B = 1024 in four depth profiles: mixed (most
    lanes with all-zero siblings as on the flagship, every eighth lane
    with non-zero siblings down to depths of up to 24; the JSON entry),
    flagship (all zero: no live level), registry (every lane 18-24 live
    levels, as the query's identity-state proofs but without their lane
    of 79) and full (every sibling but the topmost, which a proof holds
    zero, non-zero: 79 live levels a lane, the deepest level holding the
    leaf). The registry and full-depth plain versions run on the first
    128 lanes."""
    n = SMT_LEVELS
    keys, key_t = rand_fr(dev, rng)
    vals, val_t = rand_fr(dev, rng)
    sib_cols = [[0] * n for _ in range(BATCH)]
    for lane in range(1, BATCH, 8):
        depth = rng.randrange(1, 25)
        for i in range(depth):
            sib_cols[lane][i] = rng.randrange(fr.P) if rng.random() < .8 else 0
    full_cols = [[rng.randrange(1, fr.P) for _ in range(n - 1)] + [0]
                 for _ in range(BATCH)]
    registry_cols = [identity.live_siblings(
        rng, rng.randrange(LIVE_LEVELS[0], LIVE_LEVELS[1] + 1), n)
        for _ in range(BATCH)]
    cases = {"mixed": sib_cols, "flagship": [[0] * n] * BATCH,
             "registry": registry_cols, "full": full_cols}
    profiles = []
    for profile, cols in cases.items():
        args = smt_case(dev, key_t, val_t, cols)
        live, nbytes, int_ops = smt_bound(args)
        m = SMT_PLAIN_LANES if profile in ("registry", "full") else None
        sl = tuple(a[:, :m].contiguous() for a in args)
        outs, e = compare("smt_climb",
                          lambda: cuda_poseidon.smt_climb(*args),
                          lambda: cuda_poseidon.smt_climb_plain(*sl),
                          nbytes=nbytes, int_ops=int_ops, reps=3,
                          plain_once=True, plain_lanes=m)
        if profile == "mixed":
            entry = e
        rec = {k: v for k, v in e.items() if k in (
            "ms", "plain_ms", "plain_lanes", "bound_ms", "bound_by",
            "max_abs_err")}
        rec.update(profile=profile, live_pairs=live)
        profiles.append(rec)
        print(f"  smt_climb [{profile}]: {live} live (lane, level) pairs")
        lanes = [0, 1] + list(range(9, BATCH, BATCH // 8))  # 1 mod 8: deep
        got = fr.batch_from_limbs(outs[0][:, lanes])
        want = [identity.smt_root(keys[i], vals[i], cols[i])
                for i in lanes]
        check(got == want, f"smt_climb [{profile}] root != oracle")
    entry["shape"] = ("N=80 levels (+ the leaf's t=4 permutation), B=1024, "
                      "the mixed profile; profiles: flagship, mixed, "
                      "registry, full")
    entry["profiles"] = profiles
    return entry


def phase_ladder(dev, rng):
    """The 254-bit Base8 ladder at B = 1024 with sk in {0, 1, P-1} among
    the lanes, both entries: extended, and affine with the inversion."""
    sks, _ = rand_fr(dev, rng)
    sks[:3] = [0, 1, fr.P - 1]
    sk_t = bn.to_tensor(fr.batch_to_limbs(sks), dev)
    bits = fr.to_bits(sk_t, 254)
    bx = fr.const(bjj.BASE8_X, (BATCH,), dev)
    by = fr.const(bjj.BASE8_Y, (BATCH,), dev)
    outs, entry = compare("ladder",
                          lambda: cuda_babyjubjub.ladder(bits, bx, by),
                          lambda: cuda_babyjubjub.ladder_plain(bits, bx, by),
                          nbytes=8 * (bits.numel() + 6 * 16 * BATCH),
                          int_ops=ladder_ops(bits, affine=False), reps=3)
    lanes = list(range(8))
    want = [bref.base8_mul(sks[i] % (1 << 254)) for i in lanes]
    ax, ay = bjj.to_affine(tuple(outs))
    got = list(zip(fr.batch_from_limbs(ax[:, lanes]),
                   fr.batch_from_limbs(ay[:, lanes])))
    check(got == want, "ladder != babyjubjub oracle")
    entry["shape"] = "254 bits, B=1024, extended out"
    outs, e_aff = compare(
        "ladder_affine",
        lambda: cuda_babyjubjub.ladder_affine(bits, bx, by),
        lambda: cuda_babyjubjub.ladder_affine_plain(bits, bx, by),
        nbytes=8 * (bits.numel() + 4 * 16 * BATCH),
        int_ops=ladder_ops(bits, affine=True), reps=3, plain_once=True)
    got = list(zip(fr.batch_from_limbs(outs[0][:, lanes]),
                   fr.batch_from_limbs(outs[1][:, lanes])))
    check(got == want, "ladder_affine != babyjubjub oracle")
    e_aff["shape"] = "254 bits, B=1024, affine out (inversion in the kernel)"
    return [entry, e_aff]


def _edge_lanes(dev, rng):
    """(ints, (16, B) limbs): lanes 0-4 are 0, 1, P-1, P and 2^256-1 (the
    kernels take any value below 2^256), the rest random 256-bit values."""
    xs = [0, 1, fr.P - 1, fr.P, (1 << 256) - 1]
    xs += [rng.getrandbits(256) for _ in range(BATCH - len(xs))]
    return xs, bn.to_tensor(bn.ints_to_limbs_batch(xs, 16), dev)


def phase_field(dev, rng):
    """K6 on (16, B) x (16, B) with edge lanes on both sides, and with a
    broadcast (16, 1) column of each edge value and of a random one, on
    every lane against its plain version and Python ints; K7 at n = 256
    (the field-muls/s shape), n = 0 (a unchanged) and n = 5."""
    xs, a = _edge_lanes(dev, rng)
    ys, b = _edge_lanes(dev, rng)
    ys, b = ys[::-1], b.flip(1).contiguous()
    # two products a lane: mont(a, R^2) = a*R mod P, then mont(b, a*R) =
    # a*b mod P, for any a, b < 2^256
    outs, e6 = compare("mul", lambda: cuda_field.mul(a, b),
                       lambda: cuda_field.mul_plain(a, b),
                       nbytes=8 * 3 * 16 * BATCH,
                       int_ops=2 * OPS_MONT_MUL * BATCH,
                       floor_ms=fr_mul_floor_ms())
    check(fr.batch_from_limbs(outs[0]) ==
          [x * y % fr.P for x, y in zip(xs, ys)], "K6 != Python ints")
    for y in xs[:5] + [ys[5]]:
        c = bn.to_tensor(bn.ints_to_limbs_batch([y], 16), dev)
        out = cuda_field.mul(a, c)
        check(torch.equal(out, cuda_field.mul_plain(a, c)),
              f"K6 broadcast {y:#x} != plain")
        check(fr.batch_from_limbs(out) == [x * y % fr.P for x in xs],
              f"K6 broadcast {y:#x} != Python ints")
    lanes = list(range(5)) + list(range(5, BATCH, BATCH // 8))
    c = bn.to_tensor(fr.to_limbs(microbench_field.C)[:, None], dev)
    cv = microbench_field.C
    # n products a lane, x kept out of Montgomery form against
    # to_mont(c), computed once for the broadcast column
    outs, e7 = compare(
        "mul_chain", lambda: cuda_field.mul_chain(a, c, SCAN_LEN),
        lambda: cuda_field.mul_chain_plain(a, c, SCAN_LEN),
        nbytes=8 * (2 * 16 * BATCH + 16),
        int_ops=(SCAN_LEN * BATCH + 1) * OPS_MONT_MUL,
        floor_ms=loop_floor_ms("modmul_mont32", SCAN_LEN))  # K8's chain
    check(fr.batch_from_limbs(outs[0][:, lanes]) ==
          [xs[i] * pow(cv, SCAN_LEN, fr.P) % fr.P for i in lanes],
          "K7 n=256 != Python ints")
    check(torch.equal(cuda_field.mul_chain(a, c, 0), a), "K7 n=0 != a")
    out5 = cuda_field.mul_chain(a, b, 5)
    check(torch.equal(out5, cuda_field.mul_chain_plain(a, b, 5)),
          "K7 n=5 != plain")
    check(fr.batch_from_limbs(out5[:, lanes]) ==
          [xs[i] * pow(ys[i], 5, fr.P) % fr.P for i in lanes],
          "K7 n=5 != Python ints")
    to_profile(e6, lambda: cuda_field.mul(a, b), ["fr_mul_kernel"])
    to_profile(e7, lambda: cuda_field.mul_chain(a, c, SCAN_LEN),
               ["fr_mul_chain_kernel"])
    e6["shape"] = "(16, 1024) x (16, 1024), edge lanes 0, 1, P-1, P, 2^256-1"
    e7["shape"] = "n=256, (16, 1024) x (16, 1) column"
    return [e6, e7]


def phase_loop(dev, rng):
    """K8: every body at B = 1024 against its plain version and on every
    lane against Python ints; timed on the field-muls/s path's shape, the
    raw u32 chain of 256 x 16 steps."""
    a = bn.to_tensor(np.array([[rng.randrange(1 << 16) for _ in range(BATCH)]
                               for _ in range(16)]), dev)
    c = bn.to_tensor(np.array([[rng.randrange(1, 1 << 16)
                                for _ in range(BATCH)] for _ in range(16)]),
                     dev)
    a_ints = bn.limbs_to_ints_batch(a)
    c_ints = bn.limbs_to_ints_batch(c)
    n = 64
    for body in cuda_loop.BODIES:
        out = cuda_loop.loop(body, a, c, n)
        check(torch.equal(out, cuda_loop.loop_plain(body, a, c, n)),
              f"K8 {body}: kernel != plain")
        check(bn.limbs_to_ints_batch(out) ==
              [cuda_loop.body_ints(body, x, y, n)
               for x, y in zip(a_ints, c_ints)],
              f"K8 {body} != Python ints")
    n = SCAN_LEN * 16
    raw_c = torch.full_like(a, microbench_field.RAW_C)
    _, entry = compare("run_loop",
                       lambda: cuda_loop.loop("u32_mul_add", a, raw_c, n),
                       lambda: cuda_loop.loop_plain("u32_mul_add", a, raw_c,
                                                    n),
                       nbytes=8 * 3 * 16 * BATCH,
                       int_ops=2 * n * 16 * BATCH, reps=3,
                       floor_ms=loop_floor_ms("u32_mul_add", n))
    to_profile(entry, lambda: cuda_loop.loop("u32_mul_add", a, raw_c, n),
               ["loop_limb_kernel"])
    entry["shape"] = "u32_mul_add, n=4096, (16, 1024)"
    return entry


def phase_probe(dev, rng):
    """K9 through its entry point (tools/probe_nvcc): every probe alone,
    one launch each, then the kernel probes together in one launch; every
    probe must pass and both counters must move (the battery's by one).
    Then the kernel probes less the refused launch, on the same inputs,
    timed in one launch (probe_battery) and one launch each (probe): the
    profiler's times of the latter are each role's time alone."""
    reset_launches()
    results = probe_nvcc.run_all(dev)
    failed = {k: v for k, v in results.items() if v}
    check(not failed, f"probes failed: {failed}")
    launches = {"probe": cuda_probe.probe.launches,
                "probe_battery": cuda_probe.battery.launches}
    print(f"  the probe battery: launches {launches}")
    check(launches["probe"] > 0, "no probe launched K9 alone")
    check(launches["probe_battery"] == 1,
          "the battery did not run its kernel probes in one K9 launch")
    ins = {n: cuda_probe.inputs(n, dev) for n in cuda_probe.BATTERY}

    def plain():
        return [cuda_probe.plain(n, *pair) for n, pair in ins.items()]
    work = dict(
        nbytes=8 * sum(sum(x.numel() for x in pair if x is not None)
                       + out.numel() for pair, out in zip(ins.values(),
                                                          plain())),
        int_ops=(4 * ins["basic"][0].numel() + 3 * ins["mul_wide"][0].numel()
                 + 17 * 5 * ins["shfl_carry"][0].numel()),
        mma_ops=2 * 16 * 8 * 32 * cuda_probe.MMA_TILES)

    def one_launch():
        outs = cuda_probe.battery(ins)
        return [outs[n] for n in ins]

    def launch_each():
        return [cuda_probe.probe(n, *pair) for n, pair in ins.items()]
    _, one = compare("probe_battery", one_launch, plain, **work)
    _, each = compare("probe", launch_each, plain, **work)
    to_profile(one, one_launch, [PROBE_KERNEL])
    to_profile(each, launch_each, [PROBE_KERNEL] * len(ins))
    plan = cuda_probe.battery_plan(ins)
    for e in (one, each):
        e["launches_by_path"] = {"the probe battery": launches[e["name"]]}
        e["launches"] = launches[e["name"]]
    one["shape"] = (f"{len(ins)} kernel probes in one launch of "
                    f"{sum(p[3] for p in plan)} blocks of "
                    f"{cuda_probe.THREADS} threads")
    each["shape"] = f"the same {len(ins)} kernel probes, one launch each"
    print(f"  K9 roles (name, n, first block, blocks): {plan}")
    print(f"  probes passed: {', '.join(results)}")
    return [one, each]


def probe_roles(entries):
    """After device_profile: each K9 role's device time alone (the probe
    entry's launches, in BATTERY's order) beside the battery's one launch;
    the slowest role's time goes into the battery's entry as
    slowest_role_ms, a measurement that the one launch cannot beat."""
    one = next(e for e in entries if e["name"] == "probe_battery")
    each = next(e for e in entries if e["name"] == "probe")
    roles = dict(zip(cuda_probe.BATTERY, each["profiler_device_us"]))
    each["role_device_us"] = roles
    for name, us in roles.items():
        print(f"  K9 role {name}: {us:.3f} us device alone")
    slowest = max(roles, key=roles.get)
    one["slowest_role_ms"] = roles[slowest] / 1e3
    print(f"  K9 battery: one launch {one['profiler_device_us'][0]:.3f} us "
          f"device, its roles alone {sum(roles.values()):.3f} us in all; "
          f"slowest role {slowest} {roles[slowest]:.3f} us; bound "
          f"{one['bound_ms'] * 1e3:.3f} us; card: {CARD['name']}")


def flagship_batch(p, rng):
    """BATCH synthetic passports sharing the signer and AA keys; lane 0
    gets a dg1 byte flipped after signing, lane 1 a flipped signature."""
    signer = aa = None
    pps = []
    for _ in range(BATCH):
        pp = synthetic.make_synthetic_passport(p, rng, signer_key=signer,
                                               aa_key=aa)
        signer, aa = pp["signer_key"], pp["aa_key"]
        pps.append(pp)
    pps[0] = dict(pps[0], dg1=bytes([pps[0]["dg1"][0] ^ 1]) + pps[0]["dg1"][1:])
    pps[1] = dict(pps[1], signature=pps[1]["signature"] ^ 1)
    return pps


def reset_launches():
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def read_launches(names, entries, path, off_path=(), own=()):
    """Check that each kernel in names launched on the path just run and
    that none in off_path did; record every kernel's count on the path in
    its JSON entry (launches_by_path), and as launches for the kernels in
    own, whose own path this is (the witness step for K1-K5, the
    field-muls/s path for K6-K8; the probe battery sets K9's)."""
    launches = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}
    print(f"  {path}: launches "
          f"{ {n: launches[n] for n in (*names, *off_path)} }")
    for name in names:
        check(launches[name] > 0, f"kernel {name} was not launched by {path}")
    for name in off_path:
        check(launches[name] == 0, f"kernel {name} launched on {path}, "
              "which does not run it")
    for e in entries:
        by_path = e.setdefault("launches_by_path", {})
        by_path[path] = launches[e["name"]]
        if e["name"] in own:
            e["launches"] = launches[e["name"]]


def sampled_lanes(n):
    """The first 18 lanes (the tampered and edge ones among them) and 8
    drawn from the rest."""
    return sorted({*range(min(18, n)), *random.Random(SEED).sample(range(n),
                                                                     8)})


def counted(path, entries, on, off, fn, own=()):
    """fn() with every launch counter zeroed just before and read just
    after: the kernels in on must launch, those in off must not
    (read_launches); returns fn's output."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    read_launches(on, entries, path, off_path=off, own=own)
    return out


def run_path(path, entries, on, fn, off=(), own=()):
    """counted(fn) on a forward path, its time printed; returns its
    output."""
    t0 = time.perf_counter()
    out = counted(path, entries, on, off, fn, own=own)
    print(f"  {path} forward: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          "(first call)")
    return out


def phase_slice(dev, rng, entries):
    p = params.CircuitParams.from_name(FLAGSHIP)
    t0 = time.perf_counter()
    pps = flagship_batch(p, rng)
    inp = builder.build_register_inputs(p, pps, dev)
    print(f"  inputs: {BATCH} passports built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    out = run_path("the witness step", entries, WITNESS_KERNELS,
                   lambda: ri.forward(p, inp), off=OFF_PATH,
                   own=WITNESS_KERNELS + OFF_PATH)
    check(cuda_sha2.sha2_32_chunks_many.launches == 1,
          "the witness step did not hash its messages in one K1 launch")

    flow, sig, smt_ok = (out[k].cpu() for k in ("flow_ok", "sig_ok",
                                                "smt_ok"))
    check(not flow[0] and sig[0], "lane 0 (flipped dg1 byte) must fail flow")
    check(flow[1] and not sig[1], "lane 1 (flipped signature) must fail sig")
    check(bool(flow[2:].all() and sig[2:].all()), "flow/sig not all true")
    check(bool(smt_ok.all()), "smt_ok not all true")
    lanes = sampled_lanes(BATCH)
    for name in ("passport_hash", "dg1_commitment", "pk_identity_hash",
                 "dg15_pubkey_hash"):
        got = fr.batch_from_limbs(out[name][:, lanes])
        want = [synthetic.expected_outputs(p, pps[i])[name] for i in lanes]
        check(got == want, f"{name} != oracle on sampled lanes")
    print(f"  outputs equal the oracles on {len(lanes)} lanes; verdicts ok")
    return p, pps, inp, out


def _expected_chunk(name, pps):
    """The oracles' four public outputs of passports of config `name` (run
    in a pool's worker process)."""
    p = params.CircuitParams.from_name(name)
    return [synthetic.expected_outputs(p, pp) for pp in pps]


def algo_batch(p, rng):
    """BATCH synthetic passports sharing the signer and AA keys; lane 1
    gets a bit of its signature (s for ECDSA) flipped after signing."""
    signer = aa = None
    pps = []
    for _ in range(BATCH):
        pp = synthetic.make_synthetic_passport(p, rng, signer_key=signer,
                                               aa_key=aa)
        signer, aa = pp["signer_key"], pp["aa_key"]
        pps.append(pp)
    sig = pps[1]["signature"]
    pps[1] = dict(pps[1], signature=(sig[0], sig[1] ^ 1)
                  if isinstance(sig, tuple) else sig ^ 1)
    return pps


PUBLIC = ("passport_hash", "dg1_commitment", "pk_identity_hash",
          "dg15_pubkey_hash")


def phase_algo_paths(dev, rng, entries, pool):
    """The ECDSA and RSA-PSS paths at batch 1024, each through
    register_identity.forward: launch counters zeroed just before the
    first forward and read just after, the verdicts, every lane's four
    public outputs against the oracles (the pool computes them while the
    card runs), then one warm forward timed (host clock, synchronized).
    Then K2 at k = 192 (RSA-3072, SIG_ALGO 4 and 14) with e = 37187 against
    its plain version. Returns {path: (params, inputs, warm ms)}."""
    runs = {}
    for path, (name, on, off) in ALGO_PATHS.items():
        p = params.CircuitParams.from_name(name)
        t0 = time.perf_counter()
        pps = algo_batch(p, rng)
        oracles = pool.starmap_async(
            _expected_chunk, [(name, pps[i:i + 64])
                              for i in range(0, BATCH, 64)])
        inp = builder.build_register_inputs(p, pps, dev)
        print(f"  {path}: {BATCH} passports of {name} built in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        out = run_path(path, entries, on, lambda: ri.forward(p, inp),
                       off=off)
        flow, sig, smt_ok = (out[k].cpu() for k in ("flow_ok", "sig_ok",
                                                    "smt_ok"))
        check(bool(flow.all() and smt_ok.all()),
              f"{path}: flow_ok / smt_ok not all true")
        check(bool(sig[0]) and not sig[1] and bool(sig[2:].all()),
              f"{path}: sig_ok must be false on lane 1 (flipped signature) "
              "only")
        want = [o for chunk in oracles.get() for o in chunk]
        for key in PUBLIC:
            check(fr.batch_from_limbs(out[key]) == [w[key] for w in want],
                  f"{path}: {key} != oracle")
        print(f"  {path}: every lane's four public outputs equal the "
              "oracles; verdicts ok (lane 1's sig_ok false)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ri.forward(p, inp)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        print(f"  {path}: one warm forward {warm_ms:.1f} ms (host clock, "
              f"synchronized), batch {BATCH}; card: {CARD['name']}")
        runs[path] = (p, inp, warm_ms)
    sigs, mods, args = _rsa_case(dev, rng, 192, 37187)
    outs, e192 = compare("pow_mod",
                         lambda: cuda_rsa.pow_mod(*args, 37187),
                         lambda: cuda_rsa.pow_mod_plain(*args, 37187),
                         nbytes=rsa_bytes(args, 192),
                         int_ops=modexp_ops(96, 37187) * BATCH)
    check(bn.limbs_to_ints_batch(outs[0][:, :8]) ==
          [pow(s, 37187, m) for s, m in zip(sigs[:8], mods[:8])],
          "pow_mod k=192 e=37187 != pow()")
    entry = next(e for e in entries if e["name"] == "pow_mod")
    entry["k192_e37187"] = {key: e192[key] for key in
                            ("ms", "plain_ms", "bound_ms", "bound_by")}
    return runs


# -- RegisterIdentityLight and QueryIdentity ---------------------------------

LIGHT_SMALL_BATCH = 64          # the plain SHA-384 route: a small batch
LIGHT_ON = ("sha2_32_chunks", "poseidon_ex", "ladder_affine")
LIGHT_OFF = ("sha2_32_chunks_many", "pow_mod", "smt_climb", "ladder")
QUERY_ON = ("poseidon_ex", "smt_climb", "ladder_affine")
QUERY_OFF = ("sha2_32_chunks", "sha2_32_chunks_many", "pow_mod", "ladder")
# tampered query lanes -> the one check each must fail
TAMPERED = {4: "identity_state", 5: "citizenship_not_blacklisted",
            6: "expiration_lower", 7: "timestamp_upper"}


def _light_oracles(dg1s, sks, doc, hash_type):
    """Light's oracle outputs of some lanes (run in a pool's worker)."""
    return [identity.expected_light_outputs(d, s, doc, hash_type)
            for d, s in zip(dg1s, sks)]


def _chain_roots(rows):
    """Identity-state roots from the registration's outputs (run in a
    pool's worker): rows of (pk_passport_hash, pk_identity_hash,
    dg1_commitment, identity_counter, timestamp, siblings)."""
    return [identity.smt_root(pref.poseidon([pkp, pkid]),
                              identity.identity_value(commit, idc, ts), sibs)
            for pkp, pkid, commit, idc, ts, sibs in rows]


def pool_map(pool, fn, items, *args, chunk=32):
    """fn over items in chunks on the pool, flattened, in order."""
    parts = pool.starmap(fn, [(items[i:i + chunk], *args)
                              for i in range(0, len(items), chunk)])
    return [x for part in parts for x in part]


def timed_call(fn):
    """Host-clock ms of one call of fn, fenced by synchronizes (fn ran
    once before: a warm call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def warm_ms(fn, reps=3):
    """Mean host-clock ms of fn, each call fenced by a synchronize, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_light(dev, rng, entries, pool):
    """register_identity_light.forward on TD3 dg1 at batch 1024 with
    SHA-256 (K1's per-message entry, K3, K5's affine entry; no K2, K4 or
    K1's many-message entry), and at batch 64 with SHA-384 (the plain
    SHA-384 route: no K1 at all); the three outputs against the oracles on
    sampled lanes (SHA-384: every lane). Returns {label: (fn, warm ms)}."""
    runs = {}
    for hash_type, batch in ((256, BATCH), (384, LIGHT_SMALL_BATCH)):
        label = f"light TD3/SHA-{hash_type}"
        dg1s = [identity.make_dg1(rng, 3) for _ in range(batch)]
        sks = [rng.randrange(1, fr.P) for _ in range(batch)]
        lanes = sampled_lanes(batch) if batch == BATCH else list(range(batch))
        chunks = [lanes[k:k + 8] for k in range(0, len(lanes), 8)]
        oracles = pool.starmap_async(_light_oracles, [
            ([dg1s[i] for i in c], [sks[i] for i in c], 3, hash_type)
            for c in chunks])
        inp = identity.light_inputs(dg1s, sks, hash_type, dev)
        on = LIGHT_ON if hash_type == 256 else LIGHT_ON[1:]
        off = LIGHT_OFF if hash_type == 256 else LIGHT_OFF + LIGHT_ON[:1]
        out = run_path(label, entries, on,
                       lambda: ril.forward(inp, hash_type, 3), off=off)
        if hash_type == 256:
            check(cuda_sha2.sha2_32_chunks.launches == 1,
                  "light: dg1's SHA-256 is not one K1 launch")
        want = [o for part in oracles.get() for o in part]
        for key in want[0]:
            check(fr.batch_from_limbs(out[key][:, lanes]) ==
                  [w[key] for w in want], f"{label}: {key} != oracle")
        ms = warm_ms(lambda: ril.forward(inp, hash_type, 3))
        print(f"  {label}: the three outputs equal the oracles on "
              f"{len(lanes)} lanes; one warm forward {ms:.2f} ms (host "
              f"clock, mean of 3), batch {batch}; card: {CARD['name']}")
        runs[label] = (lambda inp=inp, h=hash_type: ril.forward(inp, h, 3),
                       ms, batch)
    return runs


def query_lanes(rng, doc, n):
    """n query lanes on MRZ dg1 of document type doc, each on a path of
    18-24 live levels (lane 2: none, lane 3: 79), selector bits 0-15 (TD1:
    0-17); the TAMPERED lanes each break one check."""
    lanes = []
    ukr = COUNTRIES.index(int.from_bytes(b"UKR", "big"))
    for j in range(n):
        n_live = {2: 0, 3: 79}.get(j, rng.randrange(LIVE_LEVELS[0],
                                                     LIVE_LEVELS[1] + 1))
        lane = identity.QueryLane(
            dg1=identity.make_dg1(rng, doc,
                                  expiry=b"240101" if j == 6 else b"301231"),
            sk_identity=rng.randrange(1, fr.P),
            pk_passport_hash=rng.randrange(fr.P), event_id=rng.randrange(fr.P),
            event_data=rng.randrange(fr.P),
            siblings=identity.live_siblings(rng, n_live, SMT_LEVELS),
            selector=(1 << 16) - 1 if doc == 3 else (1 << 18) - 1)
        if j == 5:
            lane.citizenship_mask = 1 << (239 - ukr)
        if j == 7:
            lane.timestamp = lane.timestamp_upper
        lanes.append(lane)
    return lanes


def check_verdicts(label, checks, broken):
    """Each lane in broken fails exactly its check; every other check holds
    on every lane. broken: {lane: check}; checks: {name: (B,) bool}."""
    for name, ok in checks.items():
        bad = sorted(int(i) for i in (~ok).nonzero().flatten().tolist())
        want = sorted(lane for lane, c in broken.items() if c == name)
        check(bad == want, f"{label}: check {name} fails on lanes {bad[:8]}, "
              f"not {want}")


def query_bound(inp):
    """K4's bound on the query's identity-state proofs: smt_bound over the
    top flags of its paths (the key's bits do not change the count)."""
    args = smt.climb_inputs(torch.zeros_like(inp.id_state_root),
                            inp.id_state_siblings)
    live, nbytes, int_ops = smt_bound(args)
    return live, *bound(nbytes, int_ops)


def phase_query(dev, rng, entries, pool):
    """query_identity.forward at batch 1024, TD3 and TD1, on 80-level
    identity-state paths with live levels (roots built in the pool from
    each lane's final inputs; the wrong-sk lane's from the right sk): the
    tampered lanes fail exactly their checks, every other check holds,
    the gated outputs equal the oracles on sampled lanes, and K3, K4 and
    K5's affine entry launch (K1, K2 do not). Returns {label: (fn, warm
    ms)}."""
    runs = {}
    for doc in (3, 1):
        label = f"query TD{doc}"
        t0 = time.perf_counter()
        lanes = pool_map(pool, identity.with_roots,
                         query_lanes(rng, doc, BATCH), doc)
        lanes[4] = dataclasses.replace(
            lanes[4], sk_identity=lanes[4].sk_identity + 1)
        inp = identity.query_inputs(identity.query_arrays(lanes), dev)
        live = [sum(1 for s in ln.siblings if s) for ln in lanes]
        print(f"  {label}: {BATCH} lanes, identity-state roots built in "
              f"{time.perf_counter() - t0:.1f} s (host, pool); live levels "
              f"a lane {min(live[4:])}-{max(live[4:])}, lane 2 {live[2]}, "
              f"lane 3 {live[3]}")
        out, checks = run_path(label, entries, QUERY_ON,
                               lambda: qi.forward(inp, doc, SMT_LEVELS),
                               off=QUERY_OFF)
        check(cuda_poseidon.smt_climb.launches == 1,
              f"{label}: the identity-state climb is not one K4 launch")
        check_verdicts(label, checks, TAMPERED)
        lanes_s = sampled_lanes(BATCH)
        got = {k: fr.batch_from_limbs(v[:, lanes_s]) for k, v in out.items()}
        for i, j in enumerate(lanes_s):
            check({k: v[i] for k, v in got.items()} ==
                  identity.expected_query_outputs(lanes[j], doc),
                  f"{label}: lane {j} outputs != oracle")
        ms = warm_ms(lambda: qi.forward(inp, doc, SMT_LEVELS))
        n_live, bound_ms, bound_by = query_bound(inp)
        print(f"  {label}: tampered lanes fail exactly their checks, every "
              f"other check holds; outputs equal the oracles on "
              f"{len(lanes_s)} lanes; one warm forward {ms:.2f} ms (host "
              f"clock, mean of 3), batch {BATCH}; K4 bound at its "
              f"{n_live} live (lane, level) pairs {bound_ms:.6f} ms "
              f"({bound_by}); card: {CARD['name']}")
        e = next(e for e in entries if e["name"] == "smt_climb")
        e.setdefault("query_paths", {})[label] = {
            "live_pairs": n_live, "bound_ms": bound_ms,
            "bound_by": bound_by, "live_levels_a_lane": list(LIVE_LEVELS)}
        runs[label] = (lambda inp=inp, doc=doc: qi.forward(inp, doc,
                                                            SMT_LEVELS),
                       ms, BATCH)
    return runs


def phase_chain(dev, rng, entries, pool, pps, inp, out):
    """The register -> query chain on the flagship step's own inputs and
    outputs at batch 1024: the identity state from its dg15_pubkey_hash,
    pk_identity_hash and dg1_commitment on paths of 18-24 live levels, then
    a TD3 query of the same sk with only the nullifier (selector bit 0)
    disclosed: identity_state holds on every lane, every gated check
    holds, the other outputs are zero, and the nullifier equals the
    oracle's on sampled lanes. citizenship_in_table and
    citizenship_not_blacklisted are not gated by the selector and the
    flagship's synthetic dg1 has no real citizenship, so neither is
    asserted."""
    pkp, pkid, commit = (fr.batch_from_limbs(out[k]) for k in (
        "dg15_pubkey_hash", "pk_identity_hash", "dg1_commitment"))
    sibs = [identity.live_siblings(rng, rng.randrange(LIVE_LEVELS[0],
                                                      LIVE_LEVELS[1] + 1),
                                   SMT_LEVELS) for _ in range(BATCH)]
    base = identity.QueryLane(dg1=b"", sk_identity=0, pk_passport_hash=0,
                              event_id=0, event_data=0, siblings=[])
    idc, ts = base.identity_counter, base.timestamp
    roots = pool_map(pool, _chain_roots, list(zip(
        pkp, pkid, commit, [idc] * BATCH, [ts] * BATCH, sibs)))
    sks = fr.batch_from_limbs(inp.sk_identity)
    lanes = [dataclasses.replace(
        base, dg1=pps[j]["dg1"], sk_identity=sks[j], pk_passport_hash=pkp[j],
        event_id=rng.randrange(fr.P), event_data=rng.randrange(fr.P),
        siblings=sibs[j], selector=1, root=roots[j]) for j in range(BATCH)]
    qinp = identity.query_inputs(identity.query_arrays(lanes), dev)
    check(torch.equal(qinp.sk_identity, inp.sk_identity),
          "chain: the query's sk is not the registration's")
    qout, checks = run_path("chain", entries, QUERY_ON,
                            lambda: qi.forward(qinp, 3, SMT_LEVELS),
                            off=QUERY_OFF)
    check_verdicts("chain", {k: v for k, v in checks.items()
                             if not k.startswith("citizenship")}, {})
    for k, v in qout.items():
        if k != "nullifier":
            check(not v.any(), f"chain: {k} not gated to zero")
    lanes_s = sampled_lanes(BATCH)
    check(fr.batch_from_limbs(qout["nullifier"][:, lanes_s]) ==
          [identity.expected_query_outputs(lanes[j], 3)["nullifier"]
           for j in lanes_s], "chain: nullifier != oracle")
    print(f"  chain: identity_state holds on all {BATCH} registered lanes; "
          f"the nullifier equals the oracle on {len(lanes_s)} lanes")


# -- the user's path (api), the primitives and the devices' sharding ----------

INGEST_SIGNERS = 16             # RSA-2048 document signers, 64 passports each
INGEST_CERTS = 256              # the master list: 16 RSA + 240 ECDSA
INGEST_SMALL = 64               # the SIG_ALGO 11 and 20 api paths' batch
INGEST_ALGOS = {"rsa-pss (api)": (11, "rsa-pss"),
                "ecdsa p256 (api)": (20, "ecdsa")}
INGEST_WITH_CERT = 4            # ECDSA lanes that carry a DS certificate
INGEST_WORKERS = 2              # the pool that builds these inputs
KECCAK_LENGTHS = (0, 1, 55, 135, 136, 137, 200, 271, 272, 300)
ECRECOVER_KEYS = 16
P2_SPONGE = (1, 2, 3, 4, 5)
P2_LEAVES = 16
MULTICHIP_S = 300               # the ranks' start and their harness
# the api forwards that join the profiler's session with every primitive's
# call: the SIG_ALGO 20 forward would add the ECDSA path's ~210,000 kernels
# again, and the session's records cost it time
PROFILED_API = ("ingest (api)", "rsa-pss (api)")


class ProofCache:
    """A master list whose proofs are computed once a key: every passport
    of one signer asks the tree for the same proof (SparseMerkleTree.prove
    hashes the whole tree off the path, ~0.4 s a call in Python)."""

    def __init__(self, tree):
        self.tree = tree
        self.proofs = {}

    def prove(self, key):
        if key not in self.proofs:
            self.proofs[key] = self.tree.prove(key)
        return self.proofs[key]


def _rsa_key(bits, seed):
    """An RSA key of bits from its own seed (run in a pool's worker)."""
    return rsa_keygen.gen_rsa_key(bits, random.Random(seed))


def _ec_certs(csca, seeds):
    """ECDSA DS certificates, P-256 and brainpoolP256r1 in turns, issued
    by the CSCA key (run in a pool's worker)."""
    out = []
    for s in seeds:
        name = ("p256", "brainpoolP256r1")[s % 2]
        _, (qx, qy) = ecdsa_ref.keygen(CURVES[name], random.Random(s))
        out.append(x509.build_certificate(x509.ec_spki(name, qx, qy),
                                          f"DS-{s}", "CSCA", csca,
                                          serial=s))
    return out


def _master_list(certs):
    """build_master_list over the certificates, its root computed (run in
    a pool's worker: the tree travels back with its root)."""
    tree = masterlist.build_master_list(certs)
    tree.root()
    return tree


def flip_signature_bit(sod, signature: int, key_bytes: int):
    """The SOD with the lowest bit of its RSA signature flipped."""
    at = sod.index(signature.to_bytes(key_bytes, "big")) + key_bytes - 1
    return sod[:at] + bytes([sod[at] ^ 1]) + sod[at + 1:]


def _ingest_chunk(lanes, dg1s, signer, aa, tree, tampered):
    """SIG_ALGO 1 passports of one signer through the user's path (run in
    a pool's worker): DG15 of the AA key, build_sod, a flipped signature
    bit on the lanes in tampered, api.ingest against the master list; the
    oracles' four outputs. Returns [(params, witness, outputs)], seconds."""
    t0 = time.perf_counter()
    dg15 = passport.build_dg15_rsa(aa[0])
    proofs = ProofCache(tree)
    out = []
    for lane, dg1 in zip(lanes, dg1s):
        sod, _ = passport.build_sod(dg1, dg15, 1, 256,
                                    random.Random(SEED * 7919 + lane),
                                    signer_key=signer)
        if lane in tampered:
            sod = flip_signature_bit(sod, passport.parse_sod(sod)[
                "signature"], 256)
        p, w = api.ingest(dg1, dg15, sod, master_list=proofs)
        out.append((p, w, synthetic.expected_outputs(p, w)))
    return out, time.perf_counter() - t0


def _algo_chunk(sig, lanes, dg1s, signer, tampered):
    """SIG_ALGO sig (11: RSA-PSS, 20: ECDSA P-256) passports without DG15
    through build_sod and api.ingest (the fabricated one-leaf SMT), the
    first INGEST_WITH_CERT ECDSA lanes with a DS certificate (it draws an
    RSA-2048 key), the rest with the bare SPKI; a flipped bit of the
    signature (s for ECDSA) on the lanes in tampered (run in a pool's
    worker). Returns [(params, witness, outputs)]."""
    out = []
    for lane, dg1 in zip(lanes, dg1s):
        rng = random.Random(SEED * 104729 + sig * 4096 + lane)
        sod, _ = passport.build_sod(
            dg1, None, sig, 256, rng, signer_key=signer,
            with_certificate=sig != 20 or lane < INGEST_WITH_CERT)
        p, w = api.ingest(dg1, None, sod, aa_algo=0)
        if lane in tampered:
            s = w["signature"]
            w = dict(w, signature=(s[0], s[1] ^ 1) if isinstance(s, tuple)
                     else s ^ 1)
        out.append((p, w, synthetic.expected_outputs(p, w)))
    return out


def _keccak_oracles(msgs):
    """keccak_ref's Keccak-256 of each message (run in a pool's worker)."""
    return [keccak_ref.keccak256(m) for m in msgs]


def _ecrecover_case(keys, lanes):
    """One signature a lane over SHA-256 of the lane's message, by key
    lane % len(keys), R's x below n (run in a pool's worker): [(r, s,
    v_odd, digest)]."""
    cv = CURVES["secp256k1"]
    out = []
    for lane in lanes:
        d, _ = keys[lane % len(keys)]
        rng = random.Random(SEED * 15485863 + lane)
        dg = hashlib.sha256(lane.to_bytes(4, "big")).digest()
        h = int.from_bytes(dg, "big")
        while True:
            k = rng.randrange(1, cv.n)
            R = ecdsa_ref.scalar_mul(cv, k, (cv.gx, cv.gy))
            r, s = R[0] % cv.n, pow(k, -1, cv.n) * (h + R[0] * d) % cv.n
            if r and s and R[0] < cv.n:
                out.append((r, s, R[1] & 1, dg))
                break
    return out


def _poseidon2_oracles(cols, sponge_ins, leaves):
    """utils/poseidon_ref's Poseidon2 of some lanes (run in a pool's
    worker): permutation of (cols[0], cols[1], cols[2]), compression of
    (cols[0], cols[1]), the sponge of each prefix length in P2_SPONGE and
    the Merkle root of the leaves."""
    out = []
    for j in range(len(cols[0])):
        a, b, c = (col[j] for col in cols)
        level = [lf[j] for lf in leaves]
        while len(level) > 1:
            level = [pref.poseidon2_compression(x, y)
                     for x, y in zip(level[0::2], level[1::2])]
        out.append((pref.poseidon2_permutation([a, b, c]),
                    pref.poseidon2_compression(a, b),
                    [pref.poseidon2_sponge([x[j] for x in sponge_ins[:n]])
                     for n in P2_SPONGE], level[0]))
    return out


def host_work(pool, batch, small, result):
    """The new phases' host inputs, built in pool (its own workers) from
    the pool's start while the card runs the earlier phases; run on a
    thread of the main process, which only waits. Fills result with the
    keys, the master list, the ingested lanes of each path and their
    oracles, the primitives' inputs and oracles, and the seconds each
    stage took (host clock)."""
    try:
        t0 = time.perf_counter()
        rng = random.Random(SEED)
        per = batch // INGEST_SIGNERS
        specs = ([(2048, SEED * 31 + i) for i in range(INGEST_SIGNERS + 1)]
                 + [(1024, SEED * 37 + i) for i in range(INGEST_SIGNERS)])
        keys = pool.starmap(_rsa_key, specs, chunksize=1)
        csca, signers = keys[0], keys[1:INGEST_SIGNERS + 1]
        aas = keys[INGEST_SIGNERS + 1:]
        result["keys_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        n_ec = INGEST_CERTS - INGEST_SIGNERS
        seeds = list(range(SEED * 1000, SEED * 1000 + n_ec))
        ec = pool.starmap(_ec_certs, [(csca, seeds[i:i + 16])
                                      for i in range(0, n_ec, 16)])
        certs = [x509.build_certificate(x509.rsa_spki(n, e), f"DS-RSA-{i}",
                                        "CSCA", csca, serial=i + 1)
                 for i, (n, e, _) in enumerate(signers)]
        certs += [c for part in ec for c in part]
        tree = pool.apply(_master_list, (certs,))
        result.update(csca=csca, signers=signers, tree=tree,
                      certs_s=time.perf_counter() - t1)
        # the register path: dg1s from random.Random(SEED), lane 1 tampered
        t2 = time.perf_counter()
        dg1s = [bytes(rng.randrange(256) for _ in range(93))
                for _ in range(batch)]
        jobs = [pool.apply_async(_ingest_chunk, (
            list(range(i * per, (i + 1) * per)), dg1s[i * per:(i + 1) * per],
            signers[i], aas[i], tree, {1})) for i in range(INGEST_SIGNERS)]
        small_dg1s = [bytes(rng.randrange(256) for _ in range(93))
                      for _ in range(small)]
        algo_jobs = {path: [pool.apply_async(_algo_chunk, (
            sig, list(range(i, min(small, i + 16))),
            small_dg1s[i:i + 16], signers[0] if sig == 11 else None, {1}))
            for i in range(0, small, 16)]
            for path, (sig, _) in INGEST_ALGOS.items()}
        parts = [j.get() for j in jobs]
        result["ingest"] = [lane for part, _ in parts for lane in part]
        result["ingest_s"] = time.perf_counter() - t2
        result["ingest_cpu_s"] = sum(s for _, s in parts)
        result["algos"] = {path: [lane for j in js for lane in j.get()]
                           for path, js in algo_jobs.items()}
        # the primitives
        t3 = time.perf_counter()
        nrng = np.random.default_rng(SEED)
        msgs = {n: [bytes(r) for r in nrng.integers(0, 256, (batch, n),
                                                     dtype=np.uint8)]
                for n in KECCAK_LENGTHS}
        kec = {n: pool.apply_async(_keccak_oracles, (msgs[n],))
               for n in KECCAK_LENGTHS}
        eckeys = [ecdsa_ref.keygen(CURVES["secp256k1"],
                                   random.Random(SEED * 257 + i))
                  for i in range(ECRECOVER_KEYS)]
        pks = [q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
               for _, q in eckeys]
        sigs = pool.starmap_async(_ecrecover_case, [
            (eckeys, list(range(i, min(batch, i + 128))))
            for i in range(0, batch, 128)])
        fr_col = lambda: [rng.randrange(pref.P)  # noqa: E731
                          for _ in range(batch)]
        cols = [fr_col() for _ in range(3)]
        sponge_ins = [fr_col() for _ in range(max(P2_SPONGE))]
        leaves = [fr_col() for _ in range(P2_LEAVES)]
        p2 = pool.starmap_async(_poseidon2_oracles, [
            ([c[i:i + 64] for c in cols], [x[i:i + 64] for x in sponge_ins],
             [lf[i:i + 64] for lf in leaves]) for i in range(0, batch, 64)])
        result.update(
            msgs=msgs, keccak={n: j.get() for n, j in kec.items()},
            eckeys=eckeys, pks=pks,
            eth=[keccak_ref.eth_address(pk) for pk in pks],
            sigs=[x for part in sigs.get() for x in part],
            p2_in=(cols, sponge_ins, leaves),
            p2=[x for part in p2.get() for x in part],
            primitives_s=time.perf_counter() - t3)
        result["total_s"] = time.perf_counter() - t0
    except BaseException as exc:          # re-raised on the main thread
        result["error"] = exc


def host_result(job, result, what):
    """Wait for host_work and return its result; its failure fails the
    run."""
    t0 = time.perf_counter()
    job.join()
    if "error" in result:
        raise result["error"]
    print(f"  {what}: waited {time.perf_counter() - t0:.1f} s for the "
          "host inputs")
    return result


def live_levels(witnesses):
    """The non-zero siblings of each lane's master-list proof."""
    return [sum(1 for s in w["slave_branches"] if s) for w in witnesses]


def check_outputs(label, out, want, sig_fail=(1,)):
    """Every lane's four public outputs against the oracles; flow_ok and
    smt_ok true on every lane, sig_ok false exactly on sig_fail."""
    flow, sig, smt_ok = (out[k].cpu() for k in ("flow_ok", "sig_ok",
                                                "smt_ok"))
    check(bool(flow.all() and smt_ok.all()),
          f"{label}: flow_ok / smt_ok not all true")
    bad = [i for i, v in enumerate(sig.tolist()) if not v]
    check(bad == list(sig_fail), f"{label}: sig_ok false on lanes {bad}, "
          f"not {list(sig_fail)}")
    for key in PUBLIC:
        check(fr.batch_from_limbs(out[key]) == [w[key] for w in want],
              f"{label}: {key} != oracle")
    print(f"  {label}: every lane's four public outputs equal the oracles; "
          f"sig_ok false on lane(s) {list(sig_fail)} only")


def phase_ingest(dev, entries, job, host):
    """The user's path at batch 1024: 1,024 TD3 passports (dg1s from
    random.Random(SEED)) of 16 RSA-2048 signers and 16 RSA-1024 AA keys,
    each SOD built by passport.build_sod and read back by api.ingest
    against a master list of 256 certificates (the 16 signers' and 240
    ECDSA ones, build_master_list), all built in the ingest pool from its
    start; lane 1's SOD has a flipped signature bit. api.compile, then
    api.generate_witness on the card with the launch counters zeroed just
    before and read just after (K1's many-message entry, K2-K4, K5's
    affine entry must launch; K1's per-message entry and K5's extended one
    must not). Every lane's outputs against the oracles (the pool's),
    the verdicts, K1 against its plain version at this config's block
    counts, a signer not in the list refused by KeyError, one warm forward
    timed. Then SIG_ALGO 11 and 20 at batch 64 through the same path.
    Returns {label: (circuit, witnesses)} for the profiler's session."""
    res = host_result(job, host, "ingest")
    lanes = res["ingest"]
    params0 = lanes[0][0]
    check(all(p == params0 for p, _, _ in lanes),
          "ingest: the lanes' circuit parameters differ")
    wits = [w for _, w, _ in lanes]
    live = live_levels(wits)
    print(f"  ingest: {len(lanes)} passports of {params0.name} (the "
          f"flagship is {FLAGSHIP}); keys {res['keys_s']:.1f} s, "
          f"certificates and master list {res['certs_s']:.1f} s, build_sod"
          f" + api.ingest + oracles {res['ingest_s']:.1f} s "
          f"({res['ingest_cpu_s']:.1f} s of worker time) in the pool "
          f"({INGEST_WORKERS} workers, host); master list of "
          f"{len(res['tree'].leaves)} certificates, root "
          f"{res['tree'].root():#x}; K4's live levels a lane "
          f"{min(live)}-{max(live)}")
    check(len(res["tree"].leaves) == INGEST_CERTS,
          "master list does not hold every certificate")
    check(all(w["slave_root"] == res["tree"].root() for w in wits),
          "ingest: a lane's slave root is not the master list's")
    check(min(live) > 0, "ingest: a lane's proof has no live level")
    # a signer not in the list: the CSCA key signs a passport
    stray, _ = passport.build_sod(wits[0]["dg1"], None, 1, 256,
                                  random.Random(SEED), signer_key=res["csca"])
    try:
        api.ingest(wits[0]["dg1"], None, stray, aa_algo=0,
                   master_list=res["tree"])
        check(False, "ingest: a signer outside the master list was taken")
    except KeyError:
        print("  ingest: a passport of a signer not in the master list "
              "raises KeyError")

    circuit = api.compile(params0)
    check(circuit.device.type == "cuda", "api.compile did not pick the card")
    out = run_path("ingest (api)", entries, WITNESS_KERNELS,
                   lambda: api.generate_witness(circuit, wits), off=OFF_PATH)
    check(cuda_sha2.sha2_32_chunks_many.launches == 1,
          "ingest: the step's messages were not hashed in one K1 launch")
    check_outputs("ingest (api)", out, [o for _, _, o in lanes])
    k1_at_ingest_shapes(entries, circuit, wits)
    ms = warm_ms(lambda: api.generate_witness(circuit, wits))
    print(f"  ingest (api): one warm api.generate_witness {ms:.2f} ms (host "
          f"clock, mean of 3; inputs built from the witness dicts inside), "
          f"batch {len(wits)}; card: {CARD['name']}")
    runs = {"ingest (api)": (circuit, wits)}
    for label, (sig, algo_path) in INGEST_ALGOS.items():
        got = res["algos"][label]
        p = got[0][0]
        check(all(q == p for q, _, _ in got), f"{label}: params differ")
        c = api.compile(p)
        _, on, off = ALGO_PATHS[algo_path]
        w = [x for _, x, _ in got]
        out = run_path(f"{label}: {p.name}", entries, on,
                       lambda: api.generate_witness(c, w), off=off)
        check_outputs(label, out, [o for _, _, o in got])
        ms = timed_call(lambda: api.generate_witness(c, w))
        print(f"  {label}: one warm api.generate_witness {ms:.2f} ms (host "
              f"clock), batch {len(w)}; card: {CARD['name']}")
        runs[label] = (c, w)
    return runs


def k1_at_ingest_shapes(entries, circuit, wits):
    """K1's many-message entry at the ingested config's block counts (the
    step's messages: dg1, dg15, ec, sa) against its plain version on the
    same CUDA tensors, and each digest against hashlib on sampled lanes;
    recorded in K1's entry as ingest_path."""
    pp = builder.build_register_inputs(circuit.params, wits,
                                       circuit.device).passport
    msgs = [pp.dg1_words, pp.dg15_words, pp.ec_words, pp.sa_words]
    nbs = [m.shape[0] // 16 for m in msgs]
    algos = [256] * 4
    outs, e = compare(
        "sha2_32_chunks_many",
        lambda: cuda_sha2.sha2_32_chunks_many(msgs, algos),
        lambda: cuda_sha2.sha2_32_chunks_many_plain(msgs, algos),
        nbytes=8 * sum(m.numel() + 8 * m.shape[1] for m in msgs),
        int_ops=sum(nbs) * OPS_SHA_BLOCK * msgs[0].shape[1])
    for lane in sampled_lanes(len(wits)):
        w = wits[lane]
        for key, d in zip(("dg1", "dg15", "ec", "sa"), outs):
            check(words_to_bytes(d[:, lane].tolist()) ==
                  hashlib.sha256(w[key]).digest(),
                  f"K1 at the ingest shapes: {key} lane {lane} != hashlib")
    e["shape"] = (f"SHA-256, B={len(wits)}, {circuit.params.name}'s four "
                  f"messages nb={','.join(map(str, nbs))} in one launch")
    next(x for x in entries if x["name"] == "sha2_32_chunks_many")[
        "ingest_path"] = e
    print(f"  K1 at {e['shape']}: bit-equal to its plain version and "
          "hashlib")


def _bytes_of(out):
    d = torch.stack(out).cpu()
    return [bytes(d[:, j].tolist()) for j in range(d.shape[1])]


def phase_primitives(dev, job, host):
    """Keccak-256 and SHA3-256 at batch 1024 on messages of 0-300 bytes
    (across the 136-byte rate), every lane against hashlib.sha3_256 and
    utils/keccak_ref (and the two vectors of tests/test_keccak.py); the
    Ethereum address of 1024 secp256k1 keys; Poseidon2 (permutation,
    compression, the sponge over 1-5 inputs, the root of 16 leaves) on
    every lane against utils/poseidon_ref; ecrecover of one signature a
    lane by 16 keys, every lane's key against its signer, lane 1 with s + 1
    (another key) and lane 2 with r = 0 (refused). The inputs' oracles
    come from the ingest pool. One warm call of each timed. Returns
    {label: fn} for the profiler's session."""
    res = host_result(job, host, "primitives")
    card = CARD["name"]
    calls = {}
    for n in KECCAK_LENGTHS:
        msgs = res["msgs"][n]
        rows = torch.tensor(np.frombuffer(b"".join(msgs), np.uint8).reshape(
            len(msgs), n).T.astype(np.int64), device=dev)
        sha3 = _bytes_of(keccak.keccak256_bytes(rows, sha3=True))
        kec = _bytes_of(keccak.keccak256_bytes(rows))
        check(sha3 == [hashlib.sha3_256(m).digest() for m in msgs],
              f"sha3_256 of {n} bytes != hashlib")
        check(kec == res["keccak"][n], f"keccak256 of {n} bytes != oracle")
        if n == max(KECCAK_LENGTHS):
            calls["keccak256 (300 B)"] = lambda r=rows: \
                keccak.keccak256_bytes(r)
            calls["sha3_256 (300 B)"] = lambda r=rows: \
                keccak.keccak256_bytes(r, sha3=True)
    vec = _bytes_of(keccak.keccak256_bytes(torch.tensor(
        [[97, 97], [98, 98], [99, 99]], device=dev)))
    empty = _bytes_of(keccak.keccak256_bytes(
        torch.zeros((0, 2), dtype=torch.int64, device=dev)))
    check(vec[0].hex().startswith("4e03657aea45a94f") and
          empty[0].hex().startswith("c5d2460186f7233c"),
          "keccak256 known vectors")
    batch = len(res["msgs"][0])
    pks = [res["pks"][j % ECRECOVER_KEYS] for j in range(batch)]
    pk_rows = torch.tensor(np.frombuffer(b"".join(pks), np.uint8).reshape(
        batch, 64).T.astype(np.int64), device=dev)
    check(_bytes_of(keccak.eth_address_from_pubkey(pk_rows)) ==
          [res["eth"][j % ECRECOVER_KEYS] for j in range(batch)],
          "eth_address_from_pubkey != oracle")
    calls["eth_address_from_pubkey"] = lambda: \
        keccak.eth_address_from_pubkey(pk_rows)
    print(f"  keccak: Keccak-256 and SHA3-256 of {batch} messages at each of "
          f"{len(KECCAK_LENGTHS)} lengths ({min(KECCAK_LENGTHS)}-"
          f"{max(KECCAK_LENGTHS)} bytes) equal keccak_ref and hashlib on "
          "every lane; the two known vectors; the Ethereum address of "
          f"{batch} secp256k1 keys equals keccak_ref's")

    cols, sponge_ins, leaves = res["p2_in"]
    t = lambda xs: bn.to_tensor(fr.batch_to_limbs(xs), dev)  # noqa: E731
    st = [t(c) for c in cols]
    sp = [t(x) for x in sponge_ins]
    lv = torch.stack([t(x) for x in leaves], 1)
    want = res["p2"]
    got = [fr.batch_from_limbs(x) for x in poseidon2.permutation(*st)]
    check([list(v) for v in zip(*got)] == [w[0] for w in want],
          "poseidon2 permutation != oracle")
    check(fr.batch_from_limbs(poseidon2.compression(st[0], st[1])) ==
          [w[1] for w in want], "poseidon2 compression != oracle")
    for i, n in enumerate(P2_SPONGE):
        check(fr.batch_from_limbs(poseidon2.sponge_hash(sp[:n])) ==
              [w[2][i] for w in want], f"poseidon2 sponge of {n} != oracle")
    check(fr.batch_from_limbs(poseidon2.merkle_root(lv)) ==
          [w[3] for w in want], "poseidon2 merkle_root != oracle")
    calls["poseidon2 permutation"] = lambda: poseidon2.permutation(*st)
    calls["poseidon2 compression"] = lambda: poseidon2.compression(st[0],
                                                                   st[1])
    calls["poseidon2 sponge (5 inputs)"] = lambda: poseidon2.sponge_hash(sp)
    calls[f"poseidon2 merkle_root ({P2_LEAVES} leaves)"] = lambda: \
        poseidon2.merkle_root(lv)
    print(f"  poseidon2: permutation, compression, the sponge over "
          f"{min(P2_SPONGE)}-{max(P2_SPONGE)} inputs and the root of "
          f"{P2_LEAVES} leaves equal poseidon_ref on all {batch} lanes")

    sigs = list(res["sigs"])
    r1, s1, v1, d1 = sigs[1]
    sigs[1] = (r1, s1 + 1, v1, d1)
    r2, s2, v2, d2 = sigs[2]
    sigs[2] = (0, s2, v2, d2)
    lim = lambda xs: bn.to_tensor(bn.ints_to_limbs_batch(xs, 16), dev)  # noqa
    bits = torch.tensor(np.unpackbits(np.frombuffer(
        b"".join(d for *_, d in sigs), np.uint8).reshape(batch, 32),
        axis=1).T.astype(np.int64), device=dev)
    args = (lim([x[0] for x in sigs]), lim([x[1] for x in sigs]),
            torch.tensor([x[2] for x in sigs], dtype=torch.bool, device=dev),
            bits)
    qx, qy, ok = ecrecover.recover(*args)
    ok = ok.cpu().tolist()
    keys = list(zip(bn.limbs_to_ints_batch(qx), bn.limbs_to_ints_batch(qy)))
    signer = [res["eckeys"][j % ECRECOVER_KEYS][1] for j in range(batch)]
    check(ok[2] is False and all(ok[j] for j in range(batch) if j != 2),
          "ecrecover: ok must be false on lane 2 (r = 0) only")
    check(keys[1] != signer[1] and ok[1],
          "ecrecover: lane 1 (s + 1) recovered its signer")
    check(all(keys[j] == signer[j] for j in range(batch) if j not in (1, 2)),
          "ecrecover: a lane's key is not its signer's")
    calls["ecrecover.recover"] = lambda: ecrecover.recover(*args)
    print(f"  ecrecover: {batch} signatures by {ECRECOVER_KEYS} keys, every "
          "lane's key its signer's; lane 1 (s + 1) another key, lane 2 "
          "(r = 0) refused")
    for label, fn in calls.items():
        ms = timed_call(fn)           # each ran once above, checked
        print(f"  {label}: one warm call {ms:.3f} ms (host clock, "
              f"synchronized), batch {batch}; card: {card}")
    print(f"  primitives' host inputs and oracles: {res['primitives_s']:.1f}"
          " s in the ingest pool (host)")
    return calls


def _multichip_rank(rank, world, port, pps, queue):
    """One rank of the multichip phase (a spawned process a GPU): NCCL over
    tcp://localhost:port, the flagship on pps a rank (shard_global_inputs
    of the world's global batch, pps once a rank), the chained harness;
    rank 0 puts its stats on queue."""
    torch.cuda.set_device(rank)
    distributed.init_distributed(f"localhost:{port}", world, rank, "nccl")
    try:
        p = params.CircuitParams.from_name(FLAGSHIP)
        mesh = distributed.hybrid_mesh()
        shards = distributed.shard_global_inputs(
            builder.build_register_inputs_numpy(p, pps * world), mesh)
        stats = distributed.throughput_harness(
            lambda i: ri.forward(p, i), shards, mesh, iters=CHAINED_STEPS)
        if rank == 0:
            queue.put(stats)
    finally:
        torch.distributed.destroy_process_group()


def phase_multichip(dev, pps):
    """entry.dryrun_multichip over every card of the machine, then
    distributed.throughput_harness in a NCCL world of one spawned process
    a card, the flagship at batch 1024 a rank (the witness step's
    passports, its two tampered lanes replaced by copies of lanes 2-3):
    every witness valid."""
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    check(entry.dryrun_multichip(n) == 2 * n, "dryrun_multichip")
    print(f"  entry.dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s "
          "(host clock, its inputs built inside)")
    good = [pps[2], pps[3]] + pps[2:]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_multichip_rank, args=(
        r, n, port, good, queue)) for r in range(n)]
    for pr in procs:
        pr.start()
    stats = None
    try:
        while stats is None:
            try:
                stats = queue.get(timeout=5)
            except Empty:
                check(all(pr.exitcode in (None, 0) for pr in procs),
                      "multichip: a rank exited "
                      f"{[pr.exitcode for pr in procs]}")
                check(time.perf_counter() - t0 < MULTICHIP_S,
                      f"multichip: no result in {MULTICHIP_S} s")
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.kill()
    check(all(pr.exitcode == 0 for pr in procs),
          f"multichip ranks exited {[pr.exitcode for pr in procs]}")
    print(f"  throughput_harness: {stats}")
    check(stats["valid"] == stats["batch"] == len(good) * n,
          f"multichip: {stats['valid']} valid of {stats['batch']}")
    print(f"multichip: {stats['witnesses_per_sec']:.1f} witnesses/s "
          f"({stats['sec_per_step'] * 1e3:.2f} ms/step, chained, "
          f"{CHAINED_STEPS} steps) over {stats['processes']} NCCL rank(s), "
          f"{stats['devices']} device(s), batch {stats['batch']}; "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start; card: "
          f"{CARD['name']}")


PROVE_BATCH = 2
PROVE_SETUP_SEED = 5            # tools/prove_light_tpu.py's setup seed
PROVE_SEED = 1
LIGHT_OUTS = ("dg1_commitment", "pk_identity_hash", "dg1_hash")
# RegisterIdentityLight's R1CS: wires, constraints, QAP domain
LIGHT_R1CS = (55438, 55805, 65536)
# (query, points) vs host ints; 12,289 G1 points at B = 2 need two window
# groups (42 + 22 windows), each halved once with an odd point carried
MSM_SAMPLES = (("a", 512), ("a", 12289), ("b2", 64))
PROVE_STAGES = ("h", "msm_a", "msm_b1", "msm_k", "msm_h", "g1_chain",
                "msm_b2")
SETUP_PARTS = ("qap", "a_query", "b1_query", "k_query", "h_query",
               "b2_query", "rest")


def _rows_failing(cs, w_ints, rows):
    """The rows of cs among rows whose Python-int A w * B w != C w."""
    acc = {r: [0, 0, 0] for r in rows}
    for m, mat in enumerate((cs.a, cs.b, cs.c)):
        for row, col, coeff in mat:
            if row in acc:
                acc[row][m] = (acc[row][m] + coeff * w_ints[col]) % fr.P
    return {r for r, (a, b, c) in acc.items() if a * b % fr.P != c}


def tamper_check(cs, n_public, w, w_np, rng, wire=None):
    """check_batched on the card: every lane true on the good witness
    (w: a tensor on the card, w_np the same as numpy); then one wire + 1
    on lane 0 (wire, else a private wire drawn whose +1 breaks some row)
    must fail exactly the rows whose Python-int value it breaks, and every
    other lane must stay true."""
    lanes = w.shape[2]
    ok, per = r1.check_batched(cs, w)
    check(ok.tolist() == [True] * lanes and bool(per.all()),
          "check_batched: a lane fails on the good witness")
    good = [bn.limbs_to_int(w_np[i, :, 0]) for i in range(cs.n_vars)]
    want, pick = set(), wire is None
    while not want:         # a wire whose +1 breaks some row
        if pick:
            wire = n_public + 1 + rng.randrange(cs.n_vars - n_public - 1)
        lane0 = list(good)
        lane0[wire] = (lane0[wire] + 1) % fr.P
        reading = sorted({r for mat in (cs.a, cs.b, cs.c)
                          for r, c, _ in mat if c == wire})
        want = _rows_failing(cs, lane0, reading)
        check(pick or bool(want), f"wire {wire} + 1 breaks no row")
    bad = w.clone()
    bad[wire, :, 0] = bn.to_tensor(fr.to_limbs(lane0[wire]), w.device)
    t0 = time.perf_counter()
    ok2, per2 = r1.check_batched(cs, bad)
    torch.cuda.synchronize()
    t_check = time.perf_counter() - t0
    failing = set(torch.nonzero(~per2[:, 0]).flatten().tolist())
    check(failing == want, f"check_batched: wire {wire} broke rows "
          f"{sorted(failing)[:8]}, not {sorted(want)[:8]}")
    check(ok2.tolist() == [False] + [True] * (lanes - 1)
          and bool(per2[:, 1:].all()),
          "check_batched: an untampered lane fails")
    shown = sorted(want) if len(want) <= 8 else f"{len(want)} rows"
    print(f"  check_batched: {'every lane' if lanes > 1 else 'the lane'} "
          f"true; wire {wire} ({cs.labels.get(wire, 'unlabelled')}, +1 on "
          f"lane 0, read by {len(reading)} rows) fails exactly rows {shown} "
          f"on lane 0{', the others true' if lanes > 1 else ''}; "
          f"{t_check:.3f} s a check (host clock); card: {CARD['name']}")


def _host_msm(pool, query, scalars, g2f):
    """protocol._msm_lanes_host over the pool, the points in 16 chunks;
    the chunks' per-lane sums added on the host."""
    n, nb = query.shape[-1], scalars.shape[1]
    step = -(-n // 16)
    parts = pool.starmap(g16p._msm_lanes_host, [
        (query[..., lo:lo + step], scalars[..., lo:lo + step], nb, g2f)
        for lo in range(0, n, step)])
    add = g16pr.ec_add if g2f else g16p._g1_add_int
    out = [None] * nb
    for part in parts:
        out = [add(a, b) for a, b in zip(out, part)]
    return out


def _g1_ints(x, y, lane):
    x, y = x[:, lane], y[:, lane]
    return None if not (x.any() or y.any()) else (bn.limbs_to_int(x),
                                                  bn.limbs_to_int(y))


def phase_prove(dev, rng, entries, pool):
    """Groth16 on RegisterIdentityLight at its real size, batch 2, on the
    card: the Light forward (K1's per-message entry, K3, K5's affine
    entry), the circuit (55,438 wires, 55,805 constraints, domain 65,536)
    whose public values must equal the forward's, check_batched (every
    lane true; a tampered wire of lane 0 fails exactly the rows whose
    Python-int value it breaks, lane 1 still passes), setup timed by part,
    the device G1 and G2 MSMs against the host's ints on samples of
    a_query (one of them in several window groups) and b2_query, K10's and
    K11's edge cases, two proves (cold, warm) timed by stage that must be
    equal, and verify (host pairing, in the pool): each lane true, a public
    input plus one false; then K10 and K11 against their plain versions on
    the very scalars the prove and the setup gave them. (The warm
    12,289-point G1 MSM left the profiler's session: its Horner chain's
    ~175,000 kernels took about a minute of the session, and the script
    its 1,200 s.)"""
    card = CARD["name"]
    started = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    dg1s = [identity.make_dg1(rng, 3) for _ in range(PROVE_BATCH)]
    sks = [rng.randrange(1, fr.P) for _ in range(PROVE_BATCH)]
    inp = identity.light_inputs(dg1s, sks, 256, dev)
    out = run_path("prove: light TD3/SHA-256, B = 2", entries, LIGHT_ON,
                   lambda: ril.forward(inp, 256, 3), off=LIGHT_OFF)

    t0 = time.perf_counter()
    b, outs = register_light.build(dg1s, sks)
    pub = b.finalize([outs[k] for k in LIGHT_OUTS])
    cs = b.cs
    w_np = b.witness_matrix()
    dom = 1 << (cs.n_constraints - 1).bit_length()
    print(f"  light circuit: {cs.n_vars} wires, {cs.n_constraints} "
          f"constraints, domain {dom}, nnz A {len(cs.a)} B {len(cs.b)} C "
          f"{len(cs.c)}; built in {time.perf_counter() - t0:.1f} s (host)")
    check((cs.n_vars, cs.n_constraints, dom) == LIGHT_R1CS,
          f"light circuit is not {LIGHT_R1CS}")
    check([fr.batch_from_limbs(out[k]) for k in LIGHT_OUTS] == pub,
          "light circuit's public values != the card's Light forward")
    print(f"  light circuit: its {b.n_public} public values equal the "
          f"card's forward ({', '.join(LIGHT_OUTS)}) on both lanes")

    w = bn.to_tensor(w_np, dev)
    tamper_check(cs, b.n_public, w, w_np, rng)

    setup_in, prove_in = {}, {}
    pk, vk, setup_total = timed_setup(cs, b.n_public, PROVE_SETUP_SEED, dev,
                                      entries, "prove (light)",
                                      inputs=setup_in)

    scal = w.permute(1, 2, 0)                          # (16, B, n_vars)
    most_groups = 0
    samples = {}
    for name, n in MSM_SAMPLES:
        # every (n_vars // n)-th point: the dg1 bits' 0/1 scalars and the
        # hashes' full-width ones
        g2f = name == "b2"
        curve = "bn254_g2" if g2f else "bn254_g1"
        cut = slice(None, (cs.n_vars // n) * n, cs.n_vars // n)
        nwin = scal.shape[0] * 16 // msm.WINDOW       # 4-bit digits
        groups = -(-nwin // msm.window_group(curve, nwin, PROVE_BATCH, n))
        most_groups = max(most_groups, 0 if g2f else groups)
        qx, qy, inf = (t[..., cut] for t in key_points(pk, name))
        sc = scal[..., cut].masked_fill(inf, 0)
        t0 = time.perf_counter()
        x, y = msm.msm_affine(qx, qy, sc, curve)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        samples[name, n] = (qx, qy, sc, x, y)
        x, y = x.cpu().numpy(), y.cpu().numpy()
        got = [g2.limbs_to_point(x[..., i], y[..., i]) if g2f
               else _g1_ints(x, y, i) for i in range(PROVE_BATCH)]
        t0 = time.perf_counter()
        want = _host_msm(pool, getattr(pk, f"{name}_query")[..., cut],
                         sc.cpu().numpy(), g2f)
        check(got == want, f"device {name} MSM on {n} points != host ints")
        print(f"  MSM {'G2' if g2f else 'G1'} on {n} points of {name}_query "
              f"(every {cut.step}th, {groups} window group"
              f"{'s' if groups > 1 else ''}), both lanes: device equals host "
              f"ints (device {t_dev:.2f} s, host "
              f"{time.perf_counter() - t0:.2f} s in the pool)")
    check(most_groups > 1, "no G1 MSM sample ran in several window groups")
    k10_checks(pk, scal, samples, rng, pool)
    k11_checks(dev, rng)

    proofs, prove_s, _ = zip(*(timed_prove(pk, cs, w, PROVE_SEED, label,
                                           entries, "prove (light)",
                                           inputs=prove_in)
                               for label in ("cold", "warm")))
    check(all(p.a == q.a and p.c == q.c and p.b == q.b
              for p, q in zip(*proofs)), "the cold and warm proofs differ")
    t_verify = pool_verify(pool, vk, proofs[1], pub)
    print("  the cold and warm proofs are equal")
    k10_at_prove_shapes(pk, prove_in, entries)
    k11_at_setup_shapes(setup_in, entries)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    total = time.perf_counter() - started
    print(f"groth16 light B = {PROVE_BATCH}: setup {setup_total:.2f} s, "
          f"prove cold {prove_s[0]:.2f} s, warm {prove_s[1]:.2f} s, "
          f"verify {t_verify:.2f} s (3 proofs, pool); peak device memory "
          f"{peak:.2f} GiB; phase {total:.1f} s; card: {card}")
    check(total < 300, f"phase prove took {total:.1f} s, not under 300")


K10_SKEWED_N = 3001             # points of the skewed sample: not 2^k
K10_ZERO_N = 1000
K10_G2_N = 1001
K11_N = 4096


def key_points(pk, name):
    """A query's affine limbs (x, y) and infinity mask on the key's device:
    a card's key keeps its points there in Montgomery words only, so the
    limbs are uploaded from the key's host arrays."""
    q = getattr(pk, f"{name}_query")
    dev = pk.device
    return bn.to_tensor(q[0], dev), bn.to_tensor(q[1], dev), \
        pk.queries[name][2]


def same(label, got, want):
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{label}: differs from the plain version")
    print(f"  {label}: bit-equal to the plain version")


def k10_checks(pk, scal, samples, rng, pool):
    """K10 (cuda_msm.msm_g1, msm_g2) bit-equal to the plain msm.msm_affine
    on the same CUDA tensors, every case at B = 2: MSM_SAMPLES (whose plain
    results equal the host's ints above); 3,001 points (not a power of
    two) of mostly 0 and 1 scalars, lane 0 all 1 but a few (one bucket over
    many runs and passes), also against the host's ints; 1,000 points
    whose scalars are all zero; the 512-point sample with its first point
    made infinity ((0, 0), its scalar masked), also against the host's
    ints; 1,001 points of b2_query (G2) with the witness's scalars (scal).
    (K10 at the prove's own shapes: k10_at_prove_shapes.)"""
    def host_equal(label, got, query, sc):
        x, y = (t.cpu().numpy() for t in got)
        want = _host_msm(pool, query, sc.cpu().numpy(), False)
        check([_g1_ints(x, y, i) for i in range(PROVE_BATCH)] == want,
              f"{label}: differs from the host's ints")
        print(f"  {label}: equal to the host's ints (pool)")

    for (name, n), (qx, qy, sc, x, y) in samples.items():
        curve = "bn254_g2" if name == "b2" else "bn254_g1"
        same(f"K10 {name}_query, {n} points (B = 2)",
             cuda_msm.msm_affine(qx, qy, sc, curve), (x, y))
    qx, qy, inf = key_points(pk, "a")
    dev = qx.device
    n = K10_SKEWED_N
    vals = [[1 if rng.random() < 0.99 else rng.randrange(fr.P)
             for _ in range(n)],
            [rng.choice((0, 0, 0, 1, 1, 1, 1, 2, rng.randrange(1 << 20),
                         rng.randrange(fr.P))) for _ in range(n)]]
    sc = bn.to_tensor(np.stack([fr.batch_to_limbs(v) for v in vals], 1),
                      dev).masked_fill(inf[:n], 0)
    got = cuda_msm.msm_g1(qx[:, :n], qy[:, :n], sc)
    label = (f"K10 a_query, {n} points, mostly 0 and 1 (lane 0 all 1 but a "
             "few)")
    same(label, got, msm.msm_affine(qx[:, :n], qy[:, :n], sc))
    host_equal(label, got, pk.a_query[..., :n], sc)
    zero = torch.zeros((16, PROVE_BATCH, K10_ZERO_N), dtype=torch.int64,
                       device=dev)
    got = cuda_msm.msm_g1(qx[:, :K10_ZERO_N], qy[:, :K10_ZERO_N], zero)
    check(not (got[0].any() or got[1].any()), "K10: zero scalars are not "
          "infinity")
    same(f"K10 a_query, {K10_ZERO_N} points, every scalar zero (infinity)",
         got, msm.msm_affine(qx[:, :K10_ZERO_N], qy[:, :K10_ZERO_N], zero))
    px5, py5, sc5, _, _ = samples[MSM_SAMPLES[0]]
    px5, py5, sc5 = px5.clone(), py5.clone(), sc5.clone()
    px5[:, 0] = py5[:, 0] = sc5[:, :, 0] = 0
    got = cuda_msm.msm_g1(px5, py5, sc5)
    label = (f"K10 the {MSM_SAMPLES[0][1]}-point sample, point 0 infinity "
             "(its scalar masked)")
    same(label, got, msm.msm_affine(px5, py5, sc5))
    host_equal(label, got, torch.stack([px5, py5]).cpu().numpy(), sc5)
    n_vars = scal.shape[-1]
    cut = slice(None, (n_vars // K10_G2_N) * K10_G2_N, n_vars // K10_G2_N)
    bx, by, binf = (t[..., cut] for t in key_points(pk, "b2"))
    sc2 = scal[..., cut].masked_fill(binf, 0)
    same(f"K10 b2_query, {K10_G2_N} points (every {cut.step}th wire, G2)",
         cuda_msm.msm_g2(bx, by, sc2),
         msm.msm_affine(bx, by, sc2, "bn254_g2"))


def k11_checks(dev, rng):
    """K11 (cuda_fixed_base.mul_g1, mul_g2) bit-equal to the plain
    fixed-base mults on the same K11_N CUDA scalars, 0, 1 and r - 1 first;
    the first 8 also against the host's ints (protocol._g1_mul,
    pairing.ec_mul). (K11 at the setup's own shapes:
    k11_at_setup_shapes.)"""
    ss = [0, 1, fr.P - 1] + [rng.randrange(fr.P) for _ in range(K11_N - 3)]
    sc = bn.to_tensor(fr.batch_to_limbs(ss), dev)
    for name, fn, is_g2 in (("fixed_base_g1", cuda_fixed_base.mul_g1, False),
                            ("fixed_base_g2", cuda_fixed_base.mul_g2, True)):
        x, y = fn(sc)
        same(f"{name} on {K11_N} scalars (0, 1, r - 1 first)", (x, y),
             cuda_fixed_base.mul_plain(sc, is_g2))
        x, y = x.cpu().numpy(), y.cpu().numpy()
        if is_g2:
            got = [g2.limbs_to_point(x[..., i], y[..., i]) for i in range(8)]
            want = [g16pr.ec_mul(g16pr.G2, s) for s in ss[:8]]
        else:
            got = [_g1_ints(x, y, i) for i in range(8)]
            want = [g16p._g1_mul(s) for s in ss[:8]]
        check(got == want, f"{name}: differs from the host's ints")
        print(f"  {name}: its first 8 (0, 1, r - 1, ...) equal the host's "
              "ints")


def k10_at_prove_shapes(pk, prove_in, entries):
    """K10 on the whole of the Light key's a_query, h_query and b2_query
    (its Montgomery points, pk.mont) with the scalars the prove gave each
    (prove_in: the witness at B = 2, the h coefficients), bit-equal to the
    plain msm.msm_affine on the same tensors. Adds the msm_points (a_query),
    msm_g1 (a_query; h_query under "h_query") and msm_g2 (b2_query)
    entries, timed at these shapes."""
    ax, ay, _ = key_points(pk, "a")
    e_points = compare(
        "msm_points", lambda: cuda_msm.points(ax, ay),
        lambda: cuda_msm.points_plain(ax, ay, False),
        ax.numel() * 8 * 2 + ax.shape[-1] * 16 * 4,
        ax.shape[-1] * 2 * OPS_MONT_MUL, reps=10)[1]
    check(torch.equal(pk.mont["a"], cuda_msm.points_plain(ax, ay, False)),
          "the key's Montgomery points of a_query != the plain conversion")
    e_points["shape"] = f"a_query, {ax.shape[-1]} points"
    found = {}
    for name in ("a", "h", "b2"):
        is_g2 = name == "b2"
        curve = "bn254_g2" if is_g2 else "bn254_g1"
        px, py, _ = key_points(pk, name)
        sc, mont = prove_in[name], pk.mont[name]
        fn = cuda_msm.msm_g2 if is_g2 else cuda_msm.msm_g1
        e = compare("msm_g2" if is_g2 else "msm_g1",
                    lambda f=fn, s=sc, m=mont: f(None, None, s, mont=m),
                    lambda x=px, y=py, s=sc, c=curve: msm.msm_affine(
                        x, y, s, c),
                    msm_bytes(sc, is_g2), msm_ops(sc, is_g2), reps=3,
                    plain_once=True)[1]
        e["shape"] = (f"{name}_query, {sc.shape[-1]} points, the Light "
                      f"prove's {'h coefficients' if name == 'h' else 'witness'}"
                      f", B = {sc.shape[1]}, the key's Montgomery points")
        e["bound_16bit_ms"] = bound(msm_bytes(sc, is_g2),
                                    msm_ops_16bit(sc, is_g2))[0]
        found[name] = e
        del px, py
    found["a"]["h_query"] = {k: found["h"][k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "bound_16bit_ms",
        "max_abs_err")}
    entries.extend([e_points, found["a"], found["b2"]])


def k11_at_setup_shapes(setup_in, entries):
    """K11 on the whole lists of scalars the Light setup gave it (setup_in:
    a_query's and h_query's over G1, b2_query's over G2), bit-equal to
    cuda_fixed_base.mul_plain on the same tensors. Adds the fixed_base_g1
    (h_query's list; a_query's under "a_query") and fixed_base_g2
    (b2_query's) entries, timed at these shapes."""
    found = {}
    for name in ("a", "h", "b2"):
        is_g2 = name == "b2"
        sc = setup_in[name]
        fn = cuda_fixed_base.mul_g2 if is_g2 else cuda_fixed_base.mul_g1
        e = compare("fixed_base_g2" if is_g2 else "fixed_base_g1",
                    lambda f=fn, s=sc: f(s),
                    lambda s=sc, g=is_g2: cuda_fixed_base.mul_plain(s, g),
                    fixed_base_bytes(sc, is_g2), fixed_base_ops(sc, is_g2),
                    reps=10, plain_once=True)[1]
        e["shape"] = (f"{name}_query's {sc.shape[-1]} scalars of the Light "
                      "setup")
        found[name] = e
    found["h"]["a_query"] = {k: found["a"][k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    entries.extend([found["h"], found["b2"]])


def record_msms(label, pk, prove_in, st, entries):
    """Each MSM of one prove on the card: its points, K10's window width
    and items (non-zero signed digits of the scalars the prove gave it,
    prove_in), its stage's seconds (host clock, fenced) and K10's bound on
    those scalars (and the first design's, msm_ops_16bit). Kept in the
    msm_g1 / msm_g2 entries under "proves"."""
    for name in g16p.QUERIES:
        sc = prove_in[name]
        is_g2 = name == "b2"
        b_ms, by = bound(msm_bytes(sc, is_g2), msm_ops(sc, is_g2))
        b16 = bound(msm_bytes(sc, is_g2), msm_ops_16bit(sc, is_g2))[0]
        c = cuda_msm.window_bits(sc.shape[-1])
        items = int((cuda_msm.signed_digits(sc, c) != 0).sum())
        t = st[f"msm_{name}"]
        print(f"  {label} MSM {name}: {sc.shape[-1]} points, {c}-bit "
              f"windows, {items} items, {t:.3f} s (K10 with its glue and "
              f"read-back, host clock), bound {b_ms:.3f} ms ({by}; 16-bit "
              f"count {b16:.3f} ms); card: {CARD['name']}")
        e = next(e for e in entries
                 if e["name"] == ("msm_g2" if is_g2 else "msm_g1"))
        e.setdefault("proves", {})[f"{label} {name}"] = {
            "points": sc.shape[-1], "window_bits": c, "items": items,
            "stage_s": t, "bound_ms": b_ms, "bound_by": by,
            "bound_16bit_ms": b16}


def profile_prover(pk, prove_in, setup_in, entries):
    """Mark K10 and K11 for the profiler's one session at this circuit's
    shapes, on the inputs its prove and setup gave them: K10 over G1 on
    h_query with the h coefficients, over G2 on b2_query with the witness,
    K10's point conversion of a_query, K11 over G1 on h_query's scalars and
    over G2 on b2_query's. The closures keep only these tensors."""
    by_name = {e["name"]: e for e in entries}
    for name, q, is_g2 in (("msm_g1", "h", False), ("msm_g2", "b2", True)):
        sc, mont = prove_in[q], pk.mont[q]
        glue = []
        for _ in range(2):              # the second one warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sched = cuda_msm.Schedule(sc, is_g2)
            torch.cuda.synchronize()
            glue.append((time.perf_counter() - t0) * 1e3)
        call = cuda_msm.cuda_call(name, sc)
        to_profile(by_name[name],
                   lambda s=sched, m=mont, c=call: cuda_msm.execute(s, m, c),
                   sched.symbols())
        by_name[name]["profile_shape"] = (
            f"{q}_query, {sc.shape[-1]} points, the prove's "
            f"{'h coefficients' if q == 'h' else 'witness'}, {sched.c}-bit "
            f"windows, {sched.items} items, {sched.nonempty} non-empty "
            f"buckets, {sched.rounds} affine rounds, {sched.passes} passes "
            f"of runs")
        by_name[name]["profile_symbols"] = sched.symbols()
        by_name[name]["profile_glue_ms"] = glue[-1]
        by_name[name]["profile_bound_ms"] = bound(msm_bytes(sc, is_g2),
                                                  msm_ops(sc, is_g2))[0]
        by_name[name]["profile_bound_16bit_ms"] = bound(
            msm_bytes(sc, is_g2), msm_ops_16bit(sc, is_g2))[0]
        print(f"  K10 {name} at the {q}_query's shape: the glue "
              f"(cuda_msm.Schedule, host clock, fenced) {glue[0]:.2f} ms "
              f"cold, {glue[1]:.2f} ms warm, apart from the kernels' device "
              f"time (the profiler's session); "
              f"{by_name[name]['profile_shape']}; card: {CARD['name']}")
    ax, ay, _ = key_points(pk, "a")
    to_profile(by_name["msm_points"], lambda: cuda_msm.points(ax, ay),
               ["msm_points_kernel"])
    by_name["msm_points"]["profile_shape"] = f"a_query, {ax.shape[-1]} points"
    for name, q, fn, is_g2 in (
            ("fixed_base_g1", "h", cuda_fixed_base.mul_g1, False),
            ("fixed_base_g2", "b2", cuda_fixed_base.mul_g2, True)):
        sc = setup_in[q]
        to_profile(by_name[name], lambda f=fn, s=sc: f(s),
                   ["fixed_base_kernel"])
        by_name[name]["profile_shape"] = (f"{q}_query's {sc.shape[-1]} "
                                          "scalars of the setup")
        by_name[name]["profile_bound_ms"] = bound(
            fixed_base_bytes(sc, is_g2), fixed_base_ops(sc, is_g2))[0]


P256 = "registerIdentity_20_256_3_4_600_248_0_0_1_0"
# tools/prove_ecdsa_tpu.py's seeds: the passport, setup, prove
P256_PASSPORT_SEED, P256_SETUP_SEED, P256_PROVE_SEED = 21, 22, 23
P256_DOMAIN = 1 << 21
P256_PHASE_S = 300


def p256_circuit():
    """The ECDSA p256 RegisterIdentity R1CS (SIG_ALGO 20, SHA-256, TD3, no
    AA) of make_synthetic_passport(p, Random(21)), built by the port's
    circuit/register_identity in a pool's worker process and finalized
    with FLAGSHIP_PUBLIC: (cs, witness matrix, public values, n_public,
    host seconds, (wires, constraints) before finalize, the passport,
    seconds and GiB of one pickling of the result)."""
    import pickle
    p = params.CircuitParams.from_name(P256)
    pp = synthetic.make_synthetic_passport(
        p, random.Random(P256_PASSPORT_SEED))
    t0 = time.perf_counter()
    b, outs = register_identity.build(p, [pp])
    pre = (b.cs.n_vars, b.cs.n_constraints)
    pub = b.finalize([outs[k] for k in FLAGSHIP_PUBLIC])
    w = b.witness_matrix()
    t_build = time.perf_counter() - t0
    out = (b.cs, w, pub, b.n_public, t_build, pre, pp)
    t0 = time.perf_counter()
    size = len(pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL))
    return out + (time.perf_counter() - t0, size / 2 ** 30)


def phase_prove_p256(dev, rng, entries, job, pool):
    """Groth16 on the ECDSA p256 RegisterIdentity circuit
    (registerIdentity_20_256_3_4_600_248_0_0_1_0, tools/prove_ecdsa_tpu.py's
    config and seeds) at batch 1 on the card, through K10 and K11: the
    circuit (job: p256_circuit, built in the pool from its start), its size
    against the JAX package's lowering (LOWERING_FIXTURE, c20_) and domain
    2^21, its four public values against the oracle
    (synthetic.expected_outputs) and the card's ECDSA forward of the same
    passport at B = 1 (K1's many-message entry, K3-K5's; no K2),
    check_batched (a private wire + 1 fails exactly its rows), setup (seed
    22) timed by part (K11, K10's point conversion), one prove (seed 23)
    timed by stage (K10) beside each MSM's bound, verify in the pool (true,
    a public input plus one false), the peak device memory; the phase
    under P256_PHASE_S. Then marks K10 and K11 for the profiler's session
    at this circuit's shapes."""
    card = CARD["name"]
    started = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    (cs, w_np, pub, n_public, t_build, pre, pp, t_pickle,
     gib) = job.get()
    waited = time.perf_counter() - started
    dom = 1 << (cs.n_constraints - 1).bit_length()
    with np.load(LOWERING_FIXTURE) as d:
        want = (int(d["c20_n_vars"]), int(d["c20_n_constraints"]))
    print(f"  p256 circuit: {pre[0]} wires and {pre[1]} constraints before "
          f"finalize; {cs.n_vars} wires, {cs.n_constraints} constraints, "
          f"domain {dom}, nnz A {len(cs.a)} B {len(cs.b)} C {len(cs.c)}; "
          f"built with its witness in {t_build:.1f} s (host, a worker of "
          f"the pool), its result {gib:.2f} GiB pickled ({t_pickle:.1f} s "
          f"to pickle once in the worker); waited {waited:.1f} s for it")
    check((cs.n_vars, cs.n_constraints) == want and dom == P256_DOMAIN,
          f"p256 circuit is not {want} at domain {P256_DOMAIN}, as the JAX "
          "package's lowering")
    p = params.CircuitParams.from_name(P256)
    oracle = synthetic.expected_outputs(p, pp)
    check(pub == [[oracle[k]] for k in FLAGSHIP_PUBLIC],
          "p256 circuit's public values != the oracle's")
    inp = builder.build_register_inputs(p, [pp], dev)
    _, on, off = ALGO_PATHS["ecdsa"]
    t0 = time.perf_counter()
    out = counted("prove_p256: the ECDSA p256 forward, B = 1", entries, on,
                  off, lambda: ri.forward(p, inp))
    t_fwd = time.perf_counter() - t0
    check(all(bool(out[k].all()) for k in ("flow_ok", "sig_ok", "smt_ok")),
          "p256 forward: a verdict fails")
    check([fr.batch_from_limbs(out[k]) for k in FLAGSHIP_PUBLIC] == pub,
          "p256 circuit's public values != the card's ECDSA forward")
    print(f"  p256 circuit: its {n_public} public values equal the oracle's "
          f"and the card's ECDSA forward ({t_fwd:.2f} s, first call) "
          f"({', '.join(FLAGSHIP_PUBLIC)})")
    w = bn.to_tensor(w_np, dev)
    tamper_check(cs, n_public, w, w_np, rng)
    setup_in, prove_in = {}, {}
    pk, vk, setup_total = timed_setup(cs, n_public, P256_SETUP_SEED, dev,
                                      entries, "prove_p256", own=SETUP_ON,
                                      inputs=setup_in)
    setup_in = {k: setup_in[k] for k in ("h", "b2")}   # the profile's
    proofs, prove_total, st = timed_prove(pk, cs, w, P256_PROVE_SEED,
                                          "one call", entries, "prove_p256",
                                          own=PROVE_ON, inputs=prove_in)
    record_msms("p256", pk, prove_in, st, entries)
    t_verify = pool_verify(pool, vk, proofs, pub)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    total = time.perf_counter() - started
    launches = {e["name"]: e["launches"] for e in entries
                if e["name"] in SETUP_ON + PROVE_ON}
    print(f"groth16 p256 B = 1 ({cs.n_constraints} constraints, domain "
          f"{dom}): host build {t_build:.1f} s (pool), setup "
          f"{setup_total:.2f} s, prove {prove_total:.2f} s, verify "
          f"{t_verify:.2f} s (2 proofs, pool); peak device memory "
          f"{peak:.2f} GiB; K10/K11 launches {launches}; phase "
          f"{total:.1f} s; card: {card}")
    check(total < P256_PHASE_S, f"phase prove_p256 took {total:.1f} s, "
          f"not under {P256_PHASE_S}")
    profile_prover(pk, prove_in, setup_in, entries)


def timed_setup(cs, n_public, seed, dev, entries, path, own=(),
                inputs=None):
    """groth16.setup on the card, timed by part, K11 and K10's point
    conversion launched (SETUP_ON) and no MSM; inputs as setup's; returns
    (pk, vk, s)."""
    parts = {}
    t0 = time.perf_counter()
    pk, vk = counted(f"{path}: setup", entries, SETUP_ON, PROVE_ON,
                     lambda: g16p.setup(cs, n_public, seed=seed, device=dev,
                                        times=parts, inputs=inputs),
                     own=own)
    total = time.perf_counter() - t0
    print(f"  setup: {total:.2f} s ("
          + ", ".join(f"{k} {parts[k]:.2f}" for k in SETUP_PARTS)
          + f" s; host clock, each part fenced); card: {CARD['name']}")
    return pk, vk, total


def timed_prove(pk, cs, w, seed, label, entries, path, own=(),
                inputs=None):
    """One groth16.prove call on the card, timed by stage, K10 launched
    over G1 and G2 (PROVE_ON) and neither K11 nor a point conversion (the
    key's Montgomery points are reused); inputs as prove's; returns
    (proofs, s, stage seconds)."""
    st = {}
    t0 = time.perf_counter()
    proofs = counted(f"{path}: prove", entries, PROVE_ON, SETUP_ON,
                     lambda: g16p.prove(pk, cs, w, seed=seed, times=st,
                                        inputs=inputs), own=own)
    total = time.perf_counter() - t0
    print(f"  prove ({label}, B = {w.shape[2]}): {total:.2f} s ("
          + ", ".join(f"{k} {st[k]:.2f}" for k in PROVE_STAGES)
          + f" s; host clock, each stage fenced); card: {CARD['name']}")
    return proofs, total, st


def pool_verify(pool, vk, proofs, pub):
    """groth16.verify in the pool (host pairing): each lane's proof on its
    public values true, lane 0's with its first public value plus one
    false; returns the seconds of all of them."""
    lanes = len(proofs)
    pubs = [[vals[lane] for vals in pub] for lane in range(lanes)]
    wrong = [(pubs[0][0] + 1) % fr.P] + pubs[0][1:]
    t0 = time.perf_counter()
    verdicts = pool.starmap(g16p.verify, [(vk, proofs[lane], pubs[lane])
                                          for lane in range(lanes)]
                            + [(vk, proofs[0], wrong)])
    t_verify = time.perf_counter() - t0
    check(verdicts == [True] * lanes + [False],
          f"verify: {verdicts}, not every lane true and the wrong input "
          "false")
    print(f"  verify: {'every lane' if lanes > 1 else 'the lane'} true, "
          f"lane 0 with a public input plus one false; {t_verify:.2f} s for "
          f"the {lanes + 1} in the pool (host)")
    return t_verify


QUERY_R1CS = (26706, 27025, 32768)      # QueryIdentity TD3 at B = 2
QUERY_PHASE_S = 90
# the flagship's public outputs, in tools/prove_flagship_tpu.py's order
FLAGSHIP_PUBLIC = ("dg15_pubkey_hash", "passport_hash", "dg1_commitment",
                   "pk_identity_hash")
FLAGSHIP_LANE = 2               # phase_slice's first untampered passport
FLAGSHIP_SETUP_SEED, FLAGSHIP_PROVE_SEED = 11, 12
FLAGSHIP_DOMAIN = 1 << 19
FLAGSHIP_PHASE_S = 600
# the JAX package's lowering of the flagship: its sizes (prefix c1_)
LOWERING_FIXTURE = "tests/fixtures/torch_port_lowering.npz"
SCRIPT_S = 1200


def flagship_circuit(pp):
    """The flagship's R1CS on one passport, built by the port's
    circuit/register_identity in a pool's worker process and finalized
    with FLAGSHIP_PUBLIC: (cs, witness matrix, public values, n_public,
    host seconds, (wires, constraints) before finalize)."""
    p = params.CircuitParams.from_name(FLAGSHIP)
    t0 = time.perf_counter()
    b, outs = register_identity.build(p, [pp])
    pre = (b.cs.n_vars, b.cs.n_constraints)
    pub = b.finalize([outs[k] for k in FLAGSHIP_PUBLIC])
    w = b.witness_matrix()
    return b.cs, w, pub, b.n_public, time.perf_counter() - t0, pre


def phase_prove_query(dev, rng, entries, pool):
    """Groth16 on QueryIdentity TD3 at batch 2 on the card: two untampered
    lanes on identity-state paths of 18-24 live levels (roots from
    ingest/identity), the Query forward on the card (K3, K4, K5's affine
    entry; every check true), the circuit (circuit/query_identity on the
    same lanes: 26,706 wires, 27,025 constraints, domain 32,768) whose
    public values, the nine gated outputs, must equal the forward's,
    check_batched (both lanes true; the q_root wire + 1 on lane 0 fails
    exactly the rows its Python-int value breaks, lane 1 true), setup
    timed by part, one prove timed by stage, verify in the pool (both
    lanes true, a public input plus one false); the phase under 90 s."""
    card = CARD["name"]
    started = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    lanes = identity.with_roots(query_lanes(rng, 3, PROVE_BATCH), 3)
    live = [sum(1 for s in ln.siblings if s) for ln in lanes]
    inp = identity.query_inputs(identity.query_arrays(lanes), dev)
    out, checks = run_path(f"prove: query TD3, B = {PROVE_BATCH}", entries,
                           QUERY_ON, lambda: qi.forward(inp, 3, SMT_LEVELS),
                           off=QUERY_OFF)
    check_verdicts("prove: query TD3", checks, {})
    names = list(out)
    t0 = time.perf_counter()
    b = Builder(PROVE_BATCH)
    outs = query_identity.build(b, identity.lowering_inputs(lanes), 3)
    pre = (b.cs.n_vars, b.cs.n_constraints)
    pub = b.finalize([outs[k] for k in names])
    cs = b.cs
    w_np = b.witness_matrix()
    dom = 1 << (cs.n_constraints - 1).bit_length()
    print(f"  query circuit (live levels {live}): {pre[0]} wires and "
          f"{pre[1]} constraints before finalize; {cs.n_vars} wires, "
          f"{cs.n_constraints} constraints, domain {dom}, nnz A {len(cs.a)} "
          f"B {len(cs.b)} C {len(cs.c)}; built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    check((cs.n_vars, cs.n_constraints, dom) == QUERY_R1CS,
          f"query circuit is not {QUERY_R1CS}")
    check([fr.batch_from_limbs(out[k]) for k in names] == pub,
          "query circuit's public values != the card's Query forward")
    print(f"  query circuit: its {b.n_public} public values equal the card's "
          f"forward ({', '.join(names)}) on both lanes")
    w = bn.to_tensor(w_np, dev)
    root = next(i for i, lbl in cs.labels.items() if lbl == "q_root")
    tamper_check(cs, b.n_public, w, w_np, rng, wire=root)
    pk, vk, setup_total = timed_setup(cs, b.n_public, PROVE_SETUP_SEED, dev,
                                      entries, "prove_query")
    proofs, prove_total, _ = timed_prove(pk, cs, w, PROVE_SEED, "one call",
                                         entries, "prove_query")
    t_verify = pool_verify(pool, vk, proofs, pub)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    total = time.perf_counter() - started
    print(f"groth16 query TD3 B = {PROVE_BATCH}: setup {setup_total:.2f} s, "
          f"prove {prove_total:.2f} s, verify {t_verify:.2f} s (3 proofs, "
          f"pool); peak device memory {peak:.2f} GiB; phase {total:.1f} s; "
          f"card: {card}")
    check(total < QUERY_PHASE_S, f"phase prove_query took {total:.1f} s, "
          f"not under {QUERY_PHASE_S}")


def phase_prove_flagship(dev, rng, out, job, pool, entries):
    """Groth16 on the flagship RegisterIdentity circuit at its real size,
    batch 1, on the card: the circuit of phase_slice's passport
    FLAGSHIP_LANE (job: flagship_circuit, built in the pool while the
    earlier phases ran), its size against the JAX package's lowering
    (LOWERING_FIXTURE) and domain 2^19, its four public values against
    lane FLAGSHIP_LANE of the card's flagship forward (out), check_batched
    (true; a private wire + 1 fails exactly the rows its Python-int value
    breaks), setup (seed 11) timed by part (K11), one prove (seed 12)
    timed by stage (K10) beside each MSM's bound, verify in the pool (true,
    a public input plus one false), the peak device memory; the phase
    under 600 s."""
    card = CARD["name"]
    started = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cs, w_np, pub, n_public, t_build, pre = job.get()
    dom = 1 << (cs.n_constraints - 1).bit_length()
    with np.load(LOWERING_FIXTURE) as d:
        want = (int(d["c1_n_vars"]), int(d["c1_n_constraints"]))
    print(f"  flagship circuit: {pre[0]} wires and {pre[1]} constraints "
          f"before finalize; {cs.n_vars} wires, {cs.n_constraints} "
          f"constraints, domain {dom}, nnz A {len(cs.a)} B {len(cs.b)} C "
          f"{len(cs.c)}; built with its witness in {t_build:.1f} s (host, a "
          f"worker of the pool, beside the earlier phases; waited "
          f"{time.perf_counter() - started:.1f} s for it)")
    check((cs.n_vars, cs.n_constraints) == want and dom == FLAGSHIP_DOMAIN,
          f"flagship circuit is not {want} at domain {FLAGSHIP_DOMAIN}, as "
          "the JAX package's lowering")
    lane = slice(FLAGSHIP_LANE, FLAGSHIP_LANE + 1)
    check([fr.batch_from_limbs(out[k][:, lane]) for k in FLAGSHIP_PUBLIC]
          == pub, "flagship circuit's public values != lane "
          f"{FLAGSHIP_LANE} of the card's flagship forward")
    print(f"  flagship circuit: its {n_public} public values equal lane "
          f"{FLAGSHIP_LANE} of the card's flagship forward "
          f"({', '.join(FLAGSHIP_PUBLIC)})")
    w = bn.to_tensor(w_np, dev)
    tamper_check(cs, n_public, w, w_np, rng)
    pk, vk, setup_total = timed_setup(cs, n_public, FLAGSHIP_SETUP_SEED, dev,
                                      entries, "prove_flagship")
    prove_in = {}
    proofs, prove_total, st = timed_prove(pk, cs, w, FLAGSHIP_PROVE_SEED,
                                          "one call", entries,
                                          "prove_flagship", inputs=prove_in)
    record_msms("flagship", pk, prove_in, st, entries)
    del prove_in
    t_verify = pool_verify(pool, vk, proofs, pub)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    total = time.perf_counter() - started
    print(f"groth16 flagship B = 1 ({cs.n_constraints} constraints, domain "
          f"{dom}): host build {t_build:.1f} s (pool), setup "
          f"{setup_total:.2f} s, prove {prove_total:.2f} s (cold), verify "
          f"{t_verify:.2f} s (2 proofs, pool); peak device memory "
          f"{peak:.2f} GiB; phase {total:.1f} s; card: {card}")
    check(total < FLAGSHIP_PHASE_S, f"phase prove_flagship took "
          f"{total:.1f} s, not under {FLAGSHIP_PHASE_S}")


def stage_ms(p, inp, reps=3):
    """Mean ms of each stage of the witness step called alone on the
    flagship inputs through its public function, host clock around work
    fenced with torch.cuda.synchronize()."""
    pp = inp.passport
    pv_out = pv.forward(p, pp)
    sig = p.sig
    stages = {
        "forward": lambda: ri.forward(p, inp),
        "passport_verification.forward": lambda: pv.forward(p, pp),
        "rsa.verify_pkcs1v15 (K2)": lambda: rsa.verify_pkcs1v15(
            pp.signature, pp.pubkey, pp.pubkey_mu, pv_out["sa_hash_words"],
            sig.hash_len, sig.key_bits, sig.exp),
        "smt.verify (K3 leaf + K4)": lambda: smt.verify(
            pp.slave_root, pv_out["pubkey_hash"], pv_out["pubkey_hash"],
            pp.slave_branches),
        "dg15_pubkey_hash": lambda: ri.dg15_pubkey_hash(p, pp.dg15_words),
        "dg1_commitment": lambda: ri.dg1_commitment(p, pp.dg1_words,
                                                    inp.sk_identity),
        "pk_identity_hash": lambda: ri.pk_identity_hash(inp.sk_identity),
        "babyjubjub.base8_mul (K5 affine)": lambda: bjj.base8_mul(
            inp.sk_identity),
    }
    timer = profiling.StageTimer()
    for fn in stages.values():
        fn()
    for _ in range(reps):
        for name, fn in stages.items():
            with timer.stage(name, block_on=inp.sk_identity):
                fn()
    return {k: v * 1e3 / reps for k, v in timer.times.items()}


def chained_steps(p, inp):
    """bench.py's chained method: each step's sk_identity is derived from
    the previous step's outputs, so steps cannot overlap or be skipped."""
    def step(x):
        out = ri.forward(p, x)
        mix = out["passport_hash"] ^ out["pk_identity_hash"]
        sk = x.sk_identity ^ mix
        sk[-1] &= 0x3FF                      # stays a valid (< 2^250) sk
        return x._replace(sk_identity=sk), out

    x, out = step(inp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CHAINED_STEPS):
        x, out = step(x)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / CHAINED_STEPS
    check(bool(out["smt_ok"].all()), "chained: smt_ok not all true")
    check(bool(out["flow_ok"][2:].all() and out["sig_ok"][2:].all()),
          "chained: verdicts changed")
    return dt


def field_path(dev, entries):
    """The field-muls/s path through its entry point; returns K7's
    field-muls/s."""
    torch.cuda.synchronize()
    reset_launches()
    res = microbench_field.run(dev, BATCH, SCAN_LEN)
    torch.cuda.synchronize()
    read_launches(FIELD_KERNELS, entries, "the field-muls/s path",
                  own=FIELD_KERNELS)
    microbench_field.report(res, BATCH, SCAN_LEN)
    return microbench_field.field_muls_per_s(res["k7_fused"], BATCH,
                                             SCAN_LEN)


PROVER_SYMBOLS = ("msm_points_kernel", "msm_round_kernel", "msm_sum_kernel",
                  "msm_reduce_kernel", "msm_horner_kernel",
                  "fixed_base_kernel")
# every instance of K10 and K11: K10 over G1 on fq::F1Call (Fq with its
# product a call on the device), its G2 point conversion on fq::F2, its G2
# arithmetic on fq::F2Pair (an Fq2 element over two threads); K11 on fq::F1
# and fq::F2
PROVER_INSTANCES = tuple(
    [f"{k}<fq::{f}>" for k in PROVER_SYMBOLS[:-1]
     for f in ("F1Call", "F2" if k == "msm_points_kernel" else "F2Pair")]
    + ["fixed_base_kernel<fq::F1>", "fixed_base_kernel<fq::F2>"])


def ptxas_check():
    """Print the registers and spills nvcc's -Xptxas -v gave K1's, K6's and
    K7's kernels and K10's and K11's in this build (build.log). None may
    spill (K10's G2 arithmetic runs an Fq2 element over two threads: a G2
    point is then 24 words a thread, as a G1 point is)."""
    report = cuda_build.ptxas_report(
        (cuda_build.BUILD_DIR / "build.log").read_text())
    for name in sorted(report):
        if name.split("<")[0] in PROVER_SYMBOLS:
            print(f"  ptxas {name}: {report[name][0]} registers, spill "
                  f"stores {report[name][1]} B, loads {report[name][2]} B")
    for name in ("sha256_many_kernel", "sha256_kernel", "fr_mul_kernel",
                 "fr_mul_chain_kernel") + PROVER_INSTANCES:
        check(name in report, f"no -Xptxas -v entry for {name}")
        regs, st, ld = report[name]
        if not name.endswith(">"):
            print(f"  ptxas {name}: {regs} registers, spill stores {st} B, "
                  f"loads {ld} B")
        check(st == ld == 0, f"{name} spills")
    spilled = sorted(k for k, (_, st, ld) in report.items() if st or ld)
    print(f"  ptxas: {len(report)} kernels, spilling: "
          f"{', '.join(spilled) or 'none'}")


def card_rates(card):
    """Fill CARD with the card's 32-bit integer instruction rate."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["int_ops_per_s"] = INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6
    CARD["sm_hz"] = mhz * 1e6
    CARD["name"] = card
    print(f"bound model: {sms} SMs x {mhz:.0f} MHz (clocks.max.sm) x "
          f"{INT_OPS_PER_CLOCK_PER_SM} int32 ops/clock = "
          f"{CARD['int_ops_per_s']:.4g} int32 ops/s; HBM "
          f"{HBM_BYTES_PER_S:.3g} B/s; card: {card}")


def k4_at_depth(entries, prof):
    """Print K4 alone in phase_smt's registry and flagship profiles, then
    its device time on each query path's proofs (prof: device_profile's
    result) beside its bound there, and record that time in the entry."""
    k4 = next(e for e in entries if e["name"] == "smt_climb")
    reg, flag = (next(r for r in k4["profiles"] if r["profile"] == name)
                 for name in ("registry", "flagship"))
    print(f"K4 alone, registry profile ({LIVE_LEVELS[0]}-{LIVE_LEVELS[1]} "
          f"live levels every lane): {reg['ms']:.4f} ms (CUDA events), "
          f"bound {reg['bound_ms']:.6f} ms ({reg['bound_by']}), "
          f"{reg['live_pairs']} live pairs; flagship profile (none): "
          f"{flag['ms']:.4f} ms; card: {CARD['name']}")
    for label, q in k4["query_paths"].items():
        q["device_us"] = prof[label]["by_kernel"]["smt_climb"][1]
        print(f"K4 on {label}'s identity-state proofs ({LIVE_LEVELS[0]}-"
              f"{LIVE_LEVELS[1]} live levels a lane, one lane 79: a warp "
              f"climbs as deep as its deepest lane): {q['device_us']:.3f} "
              f"us device, bound {q['bound_ms'] * 1e3:.3f} us "
              f"({q['bound_by']}); on the witness step (no live level): "
              f"{prof['witness step']['by_kernel']['smt_climb'][1]:.3f} us "
              f"device; card: {CARD['name']}")


def main():
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    card_rates(card)

    t0 = time.perf_counter()
    cuda_build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({cuda_build.BUILD_DIR}); nvcc processes done at "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(
              cuda_build.BUILD_SECONDS.items(), key=lambda kv: kv[1])))
    ptxas_check()

    def announce(what):
        print(f"{what} (at {time.perf_counter() - started:.1f} s)")

    rng = random.Random(SEED)
    entries = []
    for phase in (phase_sha, phase_rsa, phase_poseidon, phase_smt,
                  phase_ladder, phase_field, phase_loop, phase_probe):
        announce(f"phase {phase.__name__}")
        got = phase(dev, rng)
        entries.extend(got if isinstance(got, list) else [got])

    announce("phase slice")
    p, pps, inp, out = phase_slice(dev, rng, entries)
    announce("phase algo_paths (ECDSA, RSA-PSS)")
    workers = max(1, min(8, (os.cpu_count() or 2) - 2))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool, ctx.Pool(INGEST_WORKERS) as ingest_pool:
        host = {}
        host_job = threading.Thread(target=host_work, args=(
            ingest_pool, BATCH, INGEST_SMALL, host), daemon=True)
        host_job.start()
        flagship_job = pool.apply_async(flagship_circuit,
                                        (pps[FLAGSHIP_LANE],))
        p256_job = pool.apply_async(p256_circuit)
        runs = phase_algo_paths(dev, rng, entries, pool)
        announce("phase light (RegisterIdentityLight)")
        id_runs = phase_light(dev, rng, entries, pool)
        announce("phase query (QueryIdentity TD3 and TD1)")
        id_runs.update(phase_query(dev, rng, entries, pool))
        announce("phase chain (register -> query on the flagship step)")
        phase_chain(dev, rng, entries, pool, pps, inp, out)
        announce("phase ingest (the api path: SOD -> params -> witness, "
                 "a 256-certificate master list)")
        api_runs = phase_ingest(dev, entries, host_job, host)
        announce("phase primitives (Keccak, Poseidon2, ecrecover)")
        prim_calls = phase_primitives(dev, host_job, host)
        announce("phase multichip (dryrun_multichip, the NCCL harness)")
        phase_multichip(dev, pps)
        announce("phase prove (Groth16 on RegisterIdentityLight, B = 2)")
        phase_prove(dev, rng, entries, pool)
        announce("phase prove_query (Groth16 on QueryIdentity TD3, B = 2)")
        phase_prove_query(dev, rng, entries, pool)
        announce("phase prove_flagship (Groth16 on RegisterIdentity, the "
                 "flagship, B = 1)")
        phase_prove_flagship(dev, rng, out, flagship_job, pool, entries)
        announce("phase prove_p256 (Groth16 on the ECDSA p256 "
                 "RegisterIdentity circuit, B = 1)")
        phase_prove_p256(dev, rng, entries, p256_job, pool)
    announce("one forward of each path, then one call of each short kernel, "
             "under torch.profiler")
    forwards = [("witness step", lambda: ri.forward(p, inp))] + [
        (path, lambda q=q, x=x: ri.forward(q, x))
        for path, (q, x, _) in runs.items()] + [
        (label, fn) for label, (fn, _, batch) in id_runs.items()
        if batch == BATCH]
    api_inputs = {label: (c, builder.build_register_inputs(c.params, w, dev))
                  for label, (c, w) in api_runs.items()}
    forwards += [(label, lambda c=c, x=x: c(x))
                 for label, (c, x) in api_inputs.items()
                 if label in PROFILED_API]
    forwards += list(prim_calls.items())
    t0 = time.perf_counter()
    prof = device_profile(forwards)
    print(f"  the profiler's session and its events: "
          f"{time.perf_counter() - t0:.1f} s (host)")
    probe_roles(entries)
    for label, st in prof.items():
        print(f"one {label} forward under torch.profiler: {st['kernels']} "
              f"CUDA kernels, {st['device_ms']:.2f} ms device, "
              f"{st['wall_ms']:.1f} ms wall, device idle "
              f"{100 * (1 - st['device_ms'] / st['wall_ms']):.1f} %; card: "
              f"{card}")
        for name, (n, us) in sorted(st["by_kernel"].items()):
            print(f"  {label}: {name} {n} launch(es), {us:.3f} us device")
            e = next(e for e in entries if e["name"] == name)
            e.setdefault("forward_device_us_by_path", {})[label] = us
        if label in id_runs:
            print(f"  {label}: one warm forward {id_runs[label][1]:.2f} ms "
                  f"(host clock, mean of 3), batch {id_runs[label][2]}")
    k4_at_depth(entries, prof)
    live = live_levels(api_runs["ingest (api)"][1])
    print(f"K4 on the api path's master-list proofs ({min(live)}-{max(live)} "
          f"live levels a lane, {INGEST_CERTS} certificates): "
          f"{prof['ingest (api)']['by_kernel']['smt_climb'][1]:.3f} us "
          f"device; card: {card}")
    ms = warm_ms(lambda: api_inputs["ingest (api)"][0](
        api_inputs["ingest (api)"][1]))
    print(f"ingest (api): one warm forward {ms:.2f} ms (host clock, mean of "
          f"3, inputs on the card), batch {BATCH}; card: {card}")
    for name, ms in stage_ms(p, inp).items():
        print(f"  stage {name}: {ms:.2f} ms (mean of 3)")
    dt = chained_steps(p, inp)
    print(f"chained step: {dt * 1e3:.1f} ms/step, {BATCH / dt:.1f} "
          f"witnesses/s, batch {BATCH}, {CHAINED_STEPS} steps; card: {card}")

    print("path field-muls/s")
    rate = field_path(dev, entries)
    print(f"BN254 field-muls/s (K7, batch {BATCH}, n {SCAN_LEN}): {rate:.6g};"
          f" witness-equivalent (cost-model estimate: field_mul_cost "
          f"{profiling.field_mul_cost(p)} x {BATCH / dt:.1f} witnesses/s): "
          f"{profiling.witnesses_to_field_muls(p, BATCH / dt):.6g} "
          f"field-muls/s; card: {card}")
    check(len(entries) == len(KERNELS) and
          all("launches" in e for e in entries), "a kernel has no launches")
    total = time.perf_counter() - started
    print(f"chip_smoke: {total:.1f} s in all, the build included (host "
          "clock)")
    check(total < SCRIPT_S, f"chip_smoke took {total:.1f} s, not under "
          f"{SCRIPT_S}")

    # the floors are models, not measurements: a line of their own
    print(json.dumps({"floors": [
        {"name": e["name"], "shape": e.get("shape"), "floor_ms": f}
        for e, f in FLOORS]}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
