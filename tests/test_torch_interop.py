"""interop.py: numpy dictionaries <-> the port's state dataclasses."""

import dataclasses

import numpy as np
import pytest
import torch

from mpctsid_tpu_torch import interop
from mpctsid_tpu_torch.cascade.engine import (CascadeConfigured,
                                              init_controller)
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.solo12 import SOLO12

from _torch_port_util import standing_q0

B = 3


def _states():
    cfg = EngineConfig()
    cc = CascadeConfigured(SOLO12, cfg)
    q0 = standing_q0(B)
    ctl = init_controller(SOLO12, cfg, cc.tree, q0,
                          np.array([0, 1, 4], np.int32), device="cpu")
    return ctl, PlantState.init(q0, device="cpu"), \
        ContactParams.default(B, device="cpu")


@pytest.mark.parametrize("which", [0, 1, 2])
def test_round_trip(which):
    state = _states()[which]
    to_np = [interop.controller_state_to_numpy, interop.plant_state_to_numpy,
             interop.contact_params_to_numpy][which]
    from_np = [interop.controller_state_from_numpy,
               interop.plant_state_from_numpy,
               interop.contact_params_from_numpy][which]
    arrays = to_np(state)
    assert list(arrays) == [f.name for f in dataclasses.fields(state)]
    assert all(isinstance(a, np.ndarray) for a in arrays.values())
    back = from_np(arrays, device="cpu")
    assert type(back) is type(state)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(back, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_dtype_is_explicit_and_phase_stays_int32():
    arrays = interop.controller_state_to_numpy(_states()[0])
    arrays = {k: (a.astype(np.float64) if a.dtype.kind == "f"
                  else a.astype(np.int64)) for k, a in arrays.items()}
    ctl = interop.controller_state_from_numpy(arrays, device="cpu")
    assert ctl.f_plan.dtype == torch.float32
    assert ctl.phase.dtype == torch.int32
    ctl64 = interop.controller_state_from_numpy(arrays, device="cpu",
                                                dtype=torch.float64)
    assert ctl64.f_plan.dtype == torch.float64
    assert ctl64.phase.dtype == torch.int32


def test_wrong_fields_and_ragged_batches_raise():
    arrays = interop.plant_state_to_numpy(_states()[1])
    with pytest.raises(KeyError, match="missing"):
        interop.plant_state_from_numpy(
            {k: a for k, a in arrays.items() if k != "anchor"}, device="cpu")
    with pytest.raises(KeyError, match="unknown"):
        interop.plant_state_from_numpy({**arrays, "extra": arrays["q"]},
                                       device="cpu")
    with pytest.raises(ValueError, match="scenario axis"):
        interop.plant_state_from_numpy({**arrays, "v": arrays["v"][:2]},
                                       device="cpu")


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        interop.plant_state_from_numpy(
            interop.plant_state_to_numpy(_states()[1]))


def test_read_only_source_arrays_are_copied():
    arrays = interop.contact_params_to_numpy(_states()[2])
    for a in arrays.values():
        a.setflags(write=False)
    cp = interop.contact_params_from_numpy(arrays, device="cpu")
    cp.mu.add_(1.0)                       # must not touch the source
    assert arrays["mu"][0] == np.float32(0.7)
