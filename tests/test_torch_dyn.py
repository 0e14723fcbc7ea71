"""Port parity: dyn/rigid_body.py (batched PyTorch) vs the JAX functions
under jax.vmap, on random states near standing (B = 5).

Both sides evaluate the same closed-form recursions in float32; the results
differ by a few ulp of the largest intermediate (inertia ~1e-2..1, velocities
~0.3), so 2e-5 absolute holds everywhere, 1e-4 on accelerations (terms ~10).
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu import dyn as jdyn
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu_torch import dyn as tdyn
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree

from _torch_port_util import jj, npy, random_qv, tt

JTREE = j_build_tree(J_SOLO12)
TTREE = build_tree(SOLO12)
B = 5


@pytest.fixture(scope="module")
def state():
    q, v = random_qv(0, B)
    r = np.random.default_rng(1)
    a = (r.normal(size=(B, 18)) * 2.0).astype(np.float32)
    payload = r.uniform(0.0, 0.5, size=B).astype(np.float32)
    offset = (r.normal(size=(B, 3)) * 0.05).astype(np.float32)
    return q, v, a, payload, offset


def test_quat_to_rot(state):
    q = state[0]
    want = jax.vmap(jdyn.quat_to_rot)(jj(q[:, 3:7]))
    np.testing.assert_allclose(npy(tdyn.quat_to_rot(tt(q[:, 3:7]))),
                               npy(want), atol=1e-6)


def test_fk_and_foot_positions(state):
    q = state[0]
    want = jax.vmap(lambda q_: jdyn.foot_positions(JTREE, q_))(jj(q))
    got = tdyn.foot_positions(TTREE, tt(q))
    assert got.shape == (B, 4, 3)
    np.testing.assert_allclose(npy(got), npy(want), atol=1e-6)
    kin_j = jax.vmap(lambda q_: jdyn.fk(JTREE, q_).R_lower)(jj(q))
    np.testing.assert_allclose(npy(tdyn.fk(TTREE, tt(q)).R_lower),
                               npy(kin_j), atol=1e-6)


def test_point_mass_spatial(state):
    _, _, _, payload, offset = state
    want = jax.vmap(lambda m, r: jdyn.point_mass_spatial(m, r))(
        jj(payload), jj(offset))
    got = tdyn.point_mass_spatial(tt(payload), tt(offset))
    np.testing.assert_allclose(npy(got), npy(want), atol=1e-7)
    want0 = jax.vmap(lambda m: jdyn.point_mass_spatial(m))(jj(payload))
    np.testing.assert_allclose(npy(tdyn.point_mass_spatial(tt(payload))),
                               npy(want0), atol=0)


@pytest.mark.parametrize("with_payload", [False, True])
def test_rnea(state, with_payload):
    q, v, a, payload, offset = state
    if with_payload:
        want = jax.vmap(lambda q_, v_, a_, m, r: jdyn.rnea(
            JTREE, q_, v_, a_,
            extra_base_inertia=jdyn.point_mass_spatial(m, r)))(
                jj(q), jj(v), jj(a), jj(payload), jj(offset))
        got = tdyn.rnea(TTREE, tt(q), tt(v), tt(a),
                        extra_base_inertia=tdyn.point_mass_spatial(
                            tt(payload), tt(offset)))
    else:
        want = jax.vmap(lambda q_, v_, a_: jdyn.rnea(JTREE, q_, v_, a_))(
            jj(q), jj(v), jj(a))
        got = tdyn.rnea(TTREE, tt(q), tt(v), tt(a))
    assert got.shape == (B, 18)
    np.testing.assert_allclose(npy(got), npy(want), atol=2e-5)


@pytest.mark.parametrize("with_payload", [False, True])
def test_crba(state, with_payload):
    q, _, _, payload, offset = state
    if with_payload:
        want = jax.vmap(lambda q_, m, r: jdyn.crba(
            JTREE, q_, extra_base_inertia=jdyn.point_mass_spatial(m, r)))(
                jj(q), jj(payload), jj(offset))
        got = tdyn.crba(TTREE, tt(q),
                        extra_base_inertia=tdyn.point_mass_spatial(
                            tt(payload), tt(offset)))
    else:
        want = jax.vmap(lambda q_: jdyn.crba(JTREE, q_))(jj(q))
        got = tdyn.crba(TTREE, tt(q))
    assert got.shape == (B, 18, 18)
    np.testing.assert_allclose(npy(got), npy(want), atol=2e-6)
    # symmetric, and the legs couple only through the base
    np.testing.assert_allclose(npy(got), npy(got).transpose(0, 2, 1),
                               atol=2e-6)
    assert np.abs(npy(got)[:, 6:9, 9:12]).max() == 0.0


def test_rnea_is_consistent_with_crba(state):
    """M(q) a = rnea(q, v, a) - rnea(q, v, 0): ties the two ported
    recursions to each other, independent of the reference."""
    q, v, a, _, _ = state
    M = tdyn.crba(TTREE, tt(q))
    lhs = torch.bmm(M, tt(a)[:, :, None])[:, :, 0]
    rhs = (tdyn.rnea(TTREE, tt(q), tt(v), tt(a))
           - tdyn.rnea(TTREE, tt(q), tt(v), torch.zeros(B, 18)))
    np.testing.assert_allclose(npy(lhs), npy(rhs), atol=5e-5)


def test_foot_jacobians_and_velocities(state):
    q, v = state[0], state[1]
    want = jax.vmap(lambda q_: jdyn.foot_jacobians(JTREE, q_))(jj(q))
    got = tdyn.foot_jacobians(TTREE, tt(q))
    assert got.shape == (B, 4, 3, 18)
    np.testing.assert_allclose(npy(got), npy(want), atol=1e-6)
    want_v = jax.vmap(lambda q_, v_: jdyn.foot_velocities(JTREE, q_, v_))(
        jj(q), jj(v))
    np.testing.assert_allclose(npy(tdyn.foot_velocities(TTREE, tt(q), tt(v))),
                               npy(want_v), atol=2e-6)


def test_foot_drifts(state):
    q, v = state[0], state[1]
    want = jax.vmap(lambda q_, v_: jdyn.foot_drifts(JTREE, q_, v_))(
        jj(q), jj(v))
    got = tdyn.foot_drifts(TTREE, tt(q), tt(v))
    np.testing.assert_allclose(npy(got), npy(want), atol=1e-5)


@pytest.mark.parametrize("dt", [0.0005, 0.02])
def test_integrate_q(state, dt):
    q, v = state[0], state[1].copy()
    v[0, 3:6] = 0.0          # the small-angle branch of the sinc
    want = jax.vmap(lambda q_, v_: jdyn.integrate_q(q_, v_, dt))(
        jj(q), jj(v))
    got = tdyn.integrate_q(tt(q), tt(v), dt)
    np.testing.assert_allclose(npy(got), npy(want), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(npy(got)[:, 3:7], axis=1), 1.0,
                               atol=1e-6)


def test_constants_are_built_once_per_device_and_dtype():
    from mpctsid_tpu_torch.dyn import rigid_body as rb
    q = tt(random_qv(3, 2)[0])
    c1 = rb._consts(TTREE, q)
    c2 = rb._consts(TTREE, q.clone())
    c64 = rb._consts(TTREE, q.double())
    assert c1 is c2 and c64 is not c1
    assert c64.I_base.dtype == torch.float64
    assert tdyn.foot_positions(TTREE, q.double()).dtype == torch.float64
