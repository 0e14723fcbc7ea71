"""interop.py: numpy dictionaries <-> the port's state dataclasses; and the
host-side plant interface (env/interface.py) against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpctsid_tpu.env import SimPlant as JSimPlant
from mpctsid_tpu.est import filter as jfilter
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu_torch import interop
from mpctsid_tpu_torch.env import Plant, Sensors, SimPlant
from mpctsid_tpu_torch.est.filter import EstimatorState, estimator_init
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.cascade.engine import (CascadeConfigured,
                                              init_controller)
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.solo12 import SOLO12

from _torch_port_util import fields_to_numpy, npy, random_qv, standing_q0

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


def test_estimator_state_from_the_jax_package_and_back():
    """The JAX side's estimator state (vmapped: (B, 19), (B, 18)) as numpy
    goes in, the port's state comes out, and back, bit for bit."""
    q, v = random_qv(3, B)
    j_est = jfilter.EstimatorState(q=jnp.asarray(q), v=jnp.asarray(v))
    arrays = fields_to_numpy(j_est)
    est = interop.estimator_state_from_numpy(arrays, device="cpu")
    assert type(est) is EstimatorState
    assert est.q.dtype == est.v.dtype == torch.float32
    assert tuple(est.q.shape) == (B, 19) and tuple(est.v.shape) == (B, 18)
    back = interop.estimator_state_to_numpy(est)
    assert list(back) == ["q", "v"]
    np.testing.assert_array_equal(back["q"], q)
    np.testing.assert_array_equal(back["v"], v)
    j_back = jfilter.EstimatorState(**{k: jnp.asarray(a)
                                       for k, a in back.items()})
    np.testing.assert_array_equal(np.asarray(j_back.q), np.asarray(j_est.q))


def test_estimator_state_round_trip_and_checks():
    est = estimator_init(standing_q0(B), device="cpu")
    arrays = interop.estimator_state_to_numpy(est)
    back = interop.estimator_state_from_numpy(arrays, device="cpu")
    assert torch.equal(back.q, est.q) and torch.equal(back.v, est.v)
    with pytest.raises(KeyError, match="missing"):
        interop.estimator_state_from_numpy({"q": arrays["q"]}, device="cpu")
    with pytest.raises(ValueError, match="scenario axis"):
        interop.estimator_state_from_numpy(
            {"q": arrays["q"], "v": arrays["v"][:2]}, device="cpu")
    est64 = interop.estimator_state_from_numpy(arrays, device="cpu",
                                               dtype=torch.float64)
    assert est64.q.dtype == torch.float64


def test_sim_plant_read_and_apply_match_jax_over_five_ticks():
    """The simulated `Plant` at B = 1 against the JAX package's: the same
    torques for 5 ticks from a tilted, moving state; every sensor field after
    every tick within 2e-5 (measured: q 1.5e-8, v 1.6e-6 at joint velocities
    up to 12 rad/s, accel 1.2e-7), and the final state within the one-tick
    budget of tests/test_torch_plant.py (q 2e-6, v 2e-4): the same
    arithmetic in another summation order."""
    q, v = random_qv(11, 1, spread=0.1)
    r = np.random.default_rng(4)
    taus = (r.normal(size=(5, 12)) * 0.5).astype(np.float32)
    jp = JSimPlant(j_build_tree(J_SOLO12), jnp.asarray(q[0]))
    tp = SimPlant(build_tree(SOLO12), q[0], device="cpu")
    assert isinstance(tp, Plant)
    # a moving start: both plants take the same initial twist
    jp.state = dataclasses.replace(jp.state, v=jnp.asarray(v[0]))
    tp.state = dataclasses.replace(tp.state, v=torch.tensor(v))
    for tau in taus:
        js, ts = jp.read(), tp.read()
        assert isinstance(ts, Sensors)
        for f in dataclasses.fields(Sensors):
            got, want = npy(getattr(ts, f.name)), npy(getattr(js, f.name))
            assert got.shape == want.shape, f.name
            np.testing.assert_allclose(got, want, atol=2e-5, err_msg=f.name)
        jp.apply(jnp.asarray(tau))
        tp.apply(tau)
    np.testing.assert_allclose(npy(tp.state.q[0]), npy(jp.state.q),
                               atol=2e-6)
    np.testing.assert_allclose(npy(tp.state.v[0]), npy(jp.state.v),
                               atol=2e-4)


def test_sim_plant_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        SimPlant(build_tree(SOLO12), standing_q0(1)[0])
