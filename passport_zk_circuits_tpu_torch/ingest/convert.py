"""Numpy <-> torch conversion of the RegisterIdentity inputs and outputs.

The system has no learned weights: what crosses between the JAX package and
the port is inputs (and the constant files both read). ``inputs_from_numpy``
turns any RegisterIdentityInputs with numpy fields, the JAX package's as
``build_register_inputs`` returns them or the port's own, into the port's
RegisterIdentityInputs of int64 tensors on `device`.
"""

from __future__ import annotations

import numpy as np

from ..models.passport_verification import PassportInputs
from ..models.register_identity import RegisterIdentityInputs
from ..ops.bignum import to_tensor


def inputs_from_numpy(np_inputs, device) -> RegisterIdentityInputs:
    """Numpy-field RegisterIdentityInputs -> the port's, as tensors."""
    passport = PassportInputs(**{
        f: to_tensor(getattr(np_inputs.passport, f), device)
        for f in PassportInputs._fields})
    return RegisterIdentityInputs(
        passport=passport,
        sk_identity=to_tensor(np_inputs.sk_identity, device))


def outputs_to_numpy(out: dict) -> dict:
    """Forward outputs -> numpy: limb and word tensors as uint32 (the JAX
    package's dtype), verdicts as bool; None stays None."""
    res = {}
    for k, v in out.items():
        if v is None:
            res[k] = None
        else:
            a = np.asarray(v.detach().cpu())
            res[k] = a if a.dtype == np.bool_ else a.astype(np.uint32)
    return res
