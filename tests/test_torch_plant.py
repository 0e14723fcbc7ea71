"""Port parity: env/plant.py (batched PyTorch) vs the JAX plant under
jax.vmap: states with feet in and out of contact, per-scenario friction, new
contacts, sliding feet, payload.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu import dyn as jdyn
from mpctsid_tpu.env import plant as jplant
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu_torch import dyn as tdyn
from mpctsid_tpu_torch import interop
from mpctsid_tpu_torch.env import plant as tplant
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree

from _torch_port_util import (fields_to_numpy, jj, npy, random_qv,
                              standing_q0, tt)

JTREE = j_build_tree(J_SOLO12)
TTREE = build_tree(SOLO12)
B = 6


@pytest.fixture(scope="module")
def case():
    q, v = random_qv(0, B, spread=0.2)
    q[:, 2] -= 0.004                       # press the feet into the ground
    q[0] = standing_q0(1)[0]
    v[0] = 0.0
    v[1, 0:2] = [1.5, -1.0]                # a sliding scenario
    r = np.random.default_rng(1)
    feet = npy(tdyn.foot_positions(TTREE, tt(q)))
    state = dict(q=q, v=v,
                 anchor=(feet[..., 0:2] + r.normal(size=(B, 4, 2)) * 0.002),
                 in_contact=r.integers(0, 2, size=(B, 4)).astype(np.float32))
    state = {k: np.asarray(a, np.float32) for k, a in state.items()}
    params = dict(kp_n=np.full(B, 8000.0), kd_n=np.full(B, 100.0),
                  kp_t=np.full(B, 2000.0), kd_t=np.full(B, 30.0),
                  mu=np.linspace(0.3, 1.0, B))
    params = {k: np.asarray(a, np.float32) for k, a in params.items()}
    tau = (r.normal(size=(B, 12)) * 0.5).astype(np.float32)
    payload = r.uniform(0.0, 0.4, size=B).astype(np.float32)
    return state, params, tau, payload


def _check(st_t, f_t, st_j, f_j):
    # one step: positions move by v*dt ~ 1e-4, so q agrees to ~1e-6;
    # velocities come through two f32 inverses of 18x18 matrices with
    # stiff contact terms (kp 8000, kd 100): 2e-4
    want = fields_to_numpy(st_j)
    got = interop.plant_state_to_numpy(st_t)
    np.testing.assert_allclose(got["q"], want["q"], atol=2e-6)
    np.testing.assert_allclose(got["v"], want["v"], atol=2e-4)
    np.testing.assert_allclose(got["anchor"], want["anchor"], atol=2e-5)
    np.testing.assert_array_equal(got["in_contact"], want["in_contact"])
    np.testing.assert_allclose(npy(f_t), npy(f_j), atol=5e-3)


@pytest.mark.parametrize("with_payload", [False, True])
def test_plant_step(case, with_payload):
    state, params, tau, payload = case
    st_j = jplant.PlantState(**{k: jj(a) for k, a in state.items()})
    cp_j = jplant.ContactParams(**{k: jj(a) for k, a in params.items()})
    st_t = interop.plant_state_from_numpy(state, device="cpu")
    cp_t = interop.contact_params_from_numpy(params, device="cpu")
    if with_payload:
        new_j, f_j = jax.vmap(lambda s, t, p, m: jplant.plant_step(
            JTREE, s, t, params=p,
            extra_base_inertia=jdyn.point_mass_spatial(m)))(
                st_j, jj(tau), cp_j, jj(payload))
        new_t, f_t = tplant.plant_step(
            TTREE, st_t, tt(tau), params=cp_t,
            extra_base_inertia=tdyn.point_mass_spatial(tt(payload)))
    else:
        new_j, f_j = jax.vmap(lambda s, t, p: jplant.plant_step(
            JTREE, s, t, params=p))(st_j, jj(tau), cp_j)
        new_t, f_t = tplant.plant_step(TTREE, st_t, tt(tau), params=cp_t)
    assert f_t.shape == (B, 4, 3)
    _check(new_t, f_t, new_j, f_j)
    # the case does exercise contact, clamping and free flight
    assert 0 < npy(f_t)[..., 2].astype(bool).sum() < 4 * B


def test_ten_steps_from_standing_settle_on_the_ground():
    """Default parameters, both packages, 10 steps of a standing robot under
    gravity-compensating-ish zero torque: the trajectories stay together."""
    q0 = standing_q0(2)
    st_j = jax.vmap(jplant.PlantState.init)(jj(q0))
    st_t = tplant.PlantState.init(q0, device="cpu")
    tau = np.zeros((2, 12), np.float32)
    step_j = jax.jit(jax.vmap(lambda s, t: jplant.plant_step(JTREE, s, t)))
    for _ in range(10):
        st_j, f_j = step_j(st_j, jj(tau))
        st_t, f_t = tplant.plant_step(TTREE, st_t, tt(tau))
    np.testing.assert_allclose(npy(st_t.q), npy(st_j.q), atol=1e-5)
    np.testing.assert_allclose(npy(st_t.v), npy(st_j.v), atol=2e-3)
    assert npy(f_t)[..., 2].sum() > 0.0


def test_state_constructors_need_an_explicit_cpu_here():
    """Constructors default to the GPU and raise when there is none, as every
    entry point of the port does; a machine with a GPU skips this check."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        tplant.PlantState.init(standing_q0(1))
    with pytest.raises(RuntimeError, match="cuda"):
        tplant.ContactParams.default(1)
    assert tplant.ContactParams.default(3, device="cpu").mu.shape == (3,)
