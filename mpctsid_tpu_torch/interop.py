"""State carried across: numpy dictionaries <-> the port's state dataclasses.

The system has no weights; what crosses between the JAX package and the port
is the model constants (held equal by the tests) and the rollout state.  Each
`*_from_numpy` takes a dictionary {field name: numpy array}, as
`{f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}`
gives it from the JAX dataclass of the same name, with a leading scenario
axis on every array, and builds the port's dataclass on an explicit device in
an explicit dtype.  `*_to_numpy` is the inverse.  Integer fields
(`ControllerState.phase`) keep int32 whatever the float dtype.

This module imports nothing from the JAX package: the extraction on the JAX
side is the caller's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpctsid_tpu_torch.cascade.engine import ControllerState
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.est.filter import EstimatorState
from mpctsid_tpu_torch.utils import resolve_device

__all__ = ["controller_state_from_numpy", "controller_state_to_numpy",
           "plant_state_from_numpy", "plant_state_to_numpy",
           "contact_params_from_numpy", "contact_params_to_numpy",
           "estimator_state_from_numpy", "estimator_state_to_numpy"]

_INT_FIELDS = {"phase"}


def _from_numpy(cls, arrays: dict, device, dtype):
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in arrays]
    extra = [n for n in arrays if n not in names]
    if missing or extra:
        raise KeyError(f"{cls.__name__}: missing fields {missing}, "
                       f"unknown fields {extra}")
    out = {}
    for n in names:
        a = np.array(arrays[n])     # a copy: the source may be read-only
        want = torch.int32 if n in _INT_FIELDS else dtype
        out[n] = torch.as_tensor(a).to(device=dev, dtype=want)
    batch = {t.shape[0] if t.dim() else None for t in out.values()}
    if len(batch) != 1 or None in batch:
        raise ValueError(f"{cls.__name__}: every field needs the same "
                         f"leading scenario axis, got sizes {batch}")
    return cls(**out)


def _to_numpy(state) -> dict:
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}


def controller_state_from_numpy(arrays: dict, device="cuda",
                                dtype=torch.float32) -> ControllerState:
    return _from_numpy(ControllerState, arrays, device, dtype)


def plant_state_from_numpy(arrays: dict, device="cuda",
                           dtype=torch.float32) -> PlantState:
    return _from_numpy(PlantState, arrays, device, dtype)


def contact_params_from_numpy(arrays: dict, device="cuda",
                              dtype=torch.float32) -> ContactParams:
    return _from_numpy(ContactParams, arrays, device, dtype)


def estimator_state_from_numpy(arrays: dict, device="cuda",
                               dtype=torch.float32) -> EstimatorState:
    return _from_numpy(EstimatorState, arrays, device, dtype)


controller_state_to_numpy = _to_numpy
plant_state_to_numpy = _to_numpy
contact_params_to_numpy = _to_numpy
estimator_state_to_numpy = _to_numpy
