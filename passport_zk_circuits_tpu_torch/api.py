"""The port's public entry point, as the JAX package's ``api.py``:

    compile(params, device=None)     -> CompiledCircuit (params + a device)
    ingest(dg1, dg15, sod, **kw)     -> (params, witness dict)
    generate_witness(cc, passports)  -> batched outputs (the throughput path)
    check(cs, witness)               -> batched R1CS satisfaction

A user of the reference's pipeline (processPassport -> circom -> witness)
maps onto ingest -> compile -> generate_witness. There is no jit and no
executable cache to hold: ``compile`` fixes the circuit's parameters and
the device its witnesses are computed on, the card unless the caller names
another. It raises where there is no card and none was named; nothing
falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .ingest import passport as _passport
from .ingest.builder import build_register_inputs
from .models import register_identity as _ri
from .models.params import CircuitParams


@dataclasses.dataclass(frozen=True)
class CompiledCircuit:
    """A RegisterIdentity program specialised to one parameter tuple (the
    counterpart of one generated registerIdentity_<...>.circom and its
    witness generator), on one device."""
    params: CircuitParams
    device: torch.device

    def __call__(self, inputs):
        return _ri.forward(self.params, inputs)


def resolve_device(device=None) -> torch.device:
    """device, or the card when None; a CUDA device where there is no card
    raises (nothing falls back to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass torch.device('cpu') to run "
                           "on the CPU")
    return device


def compile(params: CircuitParams, device=None) -> CompiledCircuit:  # noqa: A001
    """Specialise the batched witness program to params on device (the
    card, ``cuda``, when None; raises if there is none)."""
    return CompiledCircuit(params, resolve_device(device))


def ingest(dg1: bytes, dg15: Optional[bytes], sod: bytes, **kw):
    """processPassport: parse the SOD, detect the SIG_ALGO, find the
    shifts; returns (CircuitParams, witness dict). ``master_list`` (an
    ``ingest.masterlist.SparseMerkleTree``) gives a real inclusion proof
    of the signer's key; a signer not in it raises KeyError."""
    return _passport.process_passport(dg1, dg15, sod, **kw)


def generate_witness(circuit: CompiledCircuit, passports: List[dict]):
    """Batched witness generation, the throughput path: the witness dicts
    (from ``ingest`` or ``ingest.synthetic``) as tensors on the circuit's
    device, then one RegisterIdentity forward."""
    return circuit(build_register_inputs(circuit.params, passports,
                                         circuit.device))


def check(cs, witness):
    """Batched R1CS satisfaction (Az o Bz - Cz == 0): (all_ok (B,),
    per-constraint ok) from ``r1cs.system.check_batched`` (a witness
    tensor is checked where it lies, a numpy one on the card)."""
    from .r1cs.system import check_batched
    return check_batched(cs, witness)
