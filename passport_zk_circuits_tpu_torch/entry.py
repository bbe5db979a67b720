"""Entry points of the port: the flagship forward with example inputs, and
a dry run of the batch-sharded witness step over n devices.

Counterpart of the repository root's ``__graft_entry__.py`` (``entry``
and ``dryrun_multichip``). Both run on the card unless the caller names
the CPU; there is no input cache: a batch of synthetic passports is built
anew (the signer and active-auth keys drawn once and shared).
"""

from __future__ import annotations

import random

FLAGSHIP = "registerIdentity_1_256_3_4_600_248_1_1496_3_256"


def flagship_inputs(batch: int, device=None):
    """(params, RegisterIdentityInputs of batch synthetic flagship
    passports, sharing their keys, on device: the card when None)."""
    from .api import resolve_device
    from .ingest import synthetic
    from .ingest.builder import build_register_inputs
    from .models.params import CircuitParams

    p = CircuitParams.from_name(FLAGSHIP)
    rng = random.Random(1)
    signer = aa = None
    pps = []
    for _ in range(batch):
        pp = synthetic.make_synthetic_passport(p, rng, signer_key=signer,
                                               aa_key=aa)
        signer, aa = pp["signer_key"], pp["aa_key"]
        pps.append(pp)
    return p, build_register_inputs(p, pps, resolve_device(device))


def entry(device=None):
    """(fn, example_args): the flagship forward, one batched
    RegisterIdentity witness step, and its inputs at batch 8."""
    from .models import register_identity as ri

    p, inputs = flagship_inputs(8, device)

    def fn(inp):
        return ri.forward(p, inp)

    return fn, (inputs,)


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> int:
    """Lay a mesh over n devices (the first n CUDA devices; n slices on
    the CPU with device_type "cpu"), shard a batch of 2n flagship
    passports over it, run the witness step on every shard and count the
    valid witnesses, which must be all 2n. Returns the count."""
    from .models import register_identity as ri
    from .parallel import mesh as pmesh

    mesh = pmesh.make_mesh(n_devices, device_type=device_type)
    p, inputs = flagship_inputs(2 * n_devices, "cpu")
    fwd = pmesh.sharded_forward(lambda i: ri.forward(p, i), inputs, mesh)
    n_ok = int(pmesh.count_valid(fwd(inputs), mesh))
    if n_ok != 2 * n_devices:
        raise AssertionError(f"expected all {2 * n_devices} valid, got "
                             f"{n_ok}")
    print(f"dryrun_multichip({n_devices}): ok, {n_ok} witnesses valid")
    return n_ok
