"""Port parity for the kernel-backed WBC stage as a whole: one
`cascade_period` per WBC backend against the JAX cascade with the SAME
`wbc_backend`.

The JAX package (jit + vmap) rolls three scenarios (trot, walk, bound; three
friction values, one payload) three periods from standing on its default
backends; from that mid-gait state both packages run the fourth period with
`wbc_backend` "pallas_vpu", "pallas_packed", "fused" and "pallas" in turn,
and once with `mpc_backend="pallas"`.  On the CPU the JAX side runs its Pallas
kernels in interpret mode and the port runs the plain versions of its CUDA
kernels (chip_smoke.py holds the kernels themselves against those on the
card).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpctsid_tpu.cascade import engine as jengine
from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.env import plant as jplant
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.qp import admm as jadmm
from mpctsid_tpu.wbc import tsid as jtsid
from mpctsid_tpu_torch import interop
from mpctsid_tpu_torch.cascade import engine as tengine
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.qp import kernels

from _torch_port_util import fields_to_numpy, jj, npy, standing_q0, tt

B = 3
GID = np.array([GAIT_IDS[g] for g in ("trot", "walk", "bound")], np.int32)
V_CMD = np.array([[0.3, 0.0, 0.0], [0.2, 0.0, 0.1], [0.25, 0.0, 0.0]],
                 np.float32)
MU = np.array([0.5, 0.7, 0.9], np.float32)
PAYLOAD = np.array([0.0, 0.3, 0.0], np.float32)
WARM_PERIODS = 3
BACKENDS = ["pallas_vpu", "pallas_packed", "fused", "pallas"]
MPC_PALLAS = "mpc_backend=pallas"      # key of the period with the MPC on it


def _params_numpy():
    one = np.ones(B, np.float32)
    return dict(kp_n=8000.0 * one, kd_n=100.0 * one, kp_t=2000.0 * one,
                kd_t=30.0 * one, mu=MU)


@pytest.fixture(scope="module")
def jax_side():
    """(state before the 4th period, {backend: state and metrics after}).

    The JAX `solve_wbc` and `cascade_period` have no switch for Pallas
    interpret mode, and on the CPU its kernels run only interpreted: the
    switch is set from outside, for this module only.  Nothing in the JAX
    package changes."""
    cfg = JEngineConfig()
    cc = jengine.CascadeConfigured(J_SOLO12, cfg)
    q0 = jj(standing_q0(B))
    ctl = jax.vmap(lambda q, g, m: jengine.init_controller(
        J_SOLO12, cfg, cc.tree, q, g, payload=m))(
            q0, jnp.asarray(GID), jj(PAYLOAD))
    plant = jax.vmap(jplant.PlantState.init)(q0)
    cp = jplant.ContactParams(**{k: jj(a) for k, a in _params_numpy().items()})
    args = (jnp.asarray(GID), jj(V_CMD), cp, jj(PAYLOAD))

    def period_fn(**kw):
        return jax.jit(jax.vmap(
            lambda c, p, g, v, k, m: jengine.cascade_period(
                cc, c, p, g, v, k, payload=m, **kw)))

    warm = period_fn()
    for _ in range(WARM_PERIODS):
        ctl, plant, _, _ = warm(ctl, plant, *args)
    before = (fields_to_numpy(ctl), fields_to_numpy(plant))

    originals = (jtsid.admm_solve, jengine.admm_solve)
    jtsid.admm_solve = jengine.admm_solve = functools.partial(
        jadmm.admm_solve, backend_interpret=True)
    try:
        after = {}
        runs = [(b, dict(wbc_backend=b)) for b in BACKENDS]
        runs.append((MPC_PALLAS, dict(mpc_backend="pallas")))
        for key, kw in runs:
            ctl2, plant2, _, metrics = period_fn(**kw)(ctl, plant, *args)
            after[key] = (fields_to_numpy(ctl2), fields_to_numpy(plant2),
                          {k: npy(v) for k, v in metrics.items()})
    finally:
        jtsid.admm_solve, jengine.admm_solve = originals
    return before, after


def _port_period(before, backend, **kw):
    ctl_np, plant_np = before
    cc = tengine.CascadeConfigured(SOLO12, EngineConfig())
    ctl = interop.controller_state_from_numpy(ctl_np, device="cpu")
    plant = interop.plant_state_from_numpy(plant_np, device="cpu")
    cp = interop.contact_params_from_numpy(_params_numpy(), device="cpu")
    ctl2, plant2, _, metrics = tengine.cascade_period(
        cc, ctl, plant, torch.as_tensor(GID), tt(V_CMD), cp,
        payload=tt(PAYLOAD), wbc_backend=backend, **kw)
    return ctl2, plant2, metrics


@pytest.fixture(scope="module")
def port_side(jax_side):
    counters = [kernels.admm_iterate_vpu, kernels.admm_iterate_vpu_packed,
                kernels.admm_solve_fused, kernels.admm_iterate_m2,
                kernels.admm_iterate]
    launches = [f.launches for f in counters]
    out = {b: _port_period(jax_side[0], b) for b in BACKENDS + ["xla"]}
    out[MPC_PALLAS] = _port_period(jax_side[0], "xla", mpc_backend="pallas")
    assert [f.launches for f in counters] == launches    # CPU: plain versions
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_period_with_wbc_backend_matches_jax_same_backend(jax_side, port_side,
                                                          backend):
    """20 WBC ticks + plant steps from the same mid-gait state, the same WBC
    backend in both packages.  Budgets are those of
    tests/test_torch_cascade.py for the plain backend, for its reasons: q 2e-3
    and v 5e-2 on trot and walk (what the JAX package gives itself against its
    float64 oracle over one period), v 0.3 on the bound scenario caught at
    touchdown, where the WBC's f32 noise is amplified.  The MPC of the period
    is untouched by the WBC backend: f_plan 1e-3 N."""
    ctl_j, plant_j, met_j = jax_side[1][backend]
    ctl_t, plant_t, met_t = port_side[backend]
    np.testing.assert_allclose(npy(ctl_t.f_plan), ctl_j["f_plan"], atol=1e-3)
    np.testing.assert_allclose(npy(plant_t.q), plant_j["q"], atol=2e-3)
    np.testing.assert_allclose(npy(plant_t.v)[:2], plant_j["v"][:2],
                               atol=5e-2)
    np.testing.assert_allclose(npy(plant_t.v)[2:], plant_j["v"][2:], atol=0.3)
    np.testing.assert_array_equal(npy(plant_t.in_contact),
                                  plant_j["in_contact"])
    np.testing.assert_allclose(npy(met_t["wbc_ok_frac"]),
                               met_j["wbc_ok_frac"], atol=0)
    assert npy(met_t["wbc_ok_frac"]).min() == 1.0
    np.testing.assert_allclose(npy(met_t["tau_rms"]), met_j["tau_rms"],
                               atol=5e-2)
    np.testing.assert_allclose(npy(met_t["fz_sum"]), met_j["fz_sum"],
                               atol=1.0)
    # warm starts follow the last WBC solution and carry its f32 noise
    np.testing.assert_allclose(npy(ctl_t.wbc_warm_x), ctl_j["wbc_warm_x"],
                               atol=10.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_period_with_wbc_backend_matches_the_plain_wbc(port_side, backend):
    """Within the port: the fallbacks on `sol.ok` and the warm starts behave
    the same with each backend: every tick ok, the same contacts, and the
    plant within the noise budgets above of the plain-WBC period."""
    ctl_p, plant_p, met_p = port_side["xla"]
    ctl_k, plant_k, met_k = port_side[backend]
    assert torch.equal(met_k["wbc_ok_frac"], met_p["wbc_ok_frac"])
    assert torch.equal(plant_k.in_contact, plant_p.in_contact)
    assert torch.equal(ctl_k.f_plan, ctl_p.f_plan)       # same MPC solve
    np.testing.assert_allclose(npy(plant_k.q), npy(plant_p.q), atol=2e-3)
    np.testing.assert_allclose(npy(plant_k.v)[:2], npy(plant_p.v)[:2],
                               atol=5e-2)
    np.testing.assert_allclose(npy(plant_k.v)[2:], npy(plant_p.v)[2:],
                               atol=0.3)


def test_packed_and_vpu_backends_are_one_function_on_the_cpu(port_side):
    """Kernels 2 and 3 compute the same function; on CPU tensors both
    backends run the one plain version, so their periods agree bit for bit."""
    _, plant_v, _ = port_side["pallas_vpu"]
    _, plant_p, _ = port_side["pallas_packed"]
    assert torch.equal(plant_v.q, plant_p.q)
    assert torch.equal(plant_v.v, plant_p.v)


@pytest.mark.parametrize("backend", ["vpu", "packed", "fused", "mma"])
def test_poisoned_scenario_with_wbc_backend_falls_back_alone(backend):
    """Failure policy with a kernel backend in the WBC stage: a NaN command
    poisons scenario 1; it falls back to joint impedance and stays finite,
    while scenarios 0 and 2 are bit-identical to a run without it."""
    cfg = EngineConfig()
    cc = tengine.CascadeConfigured(SOLO12, cfg)
    q0 = standing_q0(3)
    gid = np.full((3,), GAIT_IDS["trot"], np.int32)
    ctl = tengine.init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    cp = ContactParams.default(3, device="cpu")
    v = np.tile([[0.3, 0.0, 0.0]], (3, 1)).astype(np.float32)
    kw = dict(n_periods=2, device="cpu", wbc_backend=backend)
    clean = tengine.cascade_rollout(cc, ctl, plant, gid, v, cp, **kw)
    assert npy(clean[2]["wbc_ok_frac"]).min() == 1.0
    v_bad = v.copy()
    v_bad[1] = np.nan
    ctl_b, plant_b, met_b = tengine.cascade_rollout(cc, ctl, plant, gid,
                                                    v_bad, cp, **kw)
    assert npy(met_b["wbc_ok_frac"])[1].max() == 0.0
    assert npy(met_b["wbc_ok_frac"])[[0, 2]].min() == 1.0
    assert torch.isfinite(plant_b.q).all() and torch.isfinite(plant_b.v).all()
    keep = [0, 2]
    assert torch.equal(plant_b.q[keep], clean[1].q[keep])
    assert torch.equal(ctl_b.wbc_warm_x[keep], clean[0].wbc_warm_x[keep])


def test_period_with_mpc_backend_pallas_matches_jax_and_the_plain_mpc(
        jax_side, port_side):
    """The MPC stage on the dot-product iteration (n = 192, m = 320, 30
    iterations in each of 2 rounds), the WBC on its default: the plan within
    the 1e-3 N that two MPC backends are given (tests/test_torch_cascade.py),
    of JAX with the same backend and of the port's plain MPC; the rest of the
    period within the plain period's budgets."""
    ctl_j, plant_j, met_j = jax_side[1][MPC_PALLAS]
    ctl_t, plant_t, met_t = port_side[MPC_PALLAS]
    ctl_p, _, _ = port_side["xla"]
    np.testing.assert_allclose(npy(ctl_t.f_plan), ctl_j["f_plan"], atol=1e-3)
    np.testing.assert_allclose(npy(ctl_t.f_plan), npy(ctl_p.f_plan),
                               atol=1e-3)
    np.testing.assert_allclose(npy(ctl_t.mpc_warm_x), ctl_j["mpc_warm_x"],
                               atol=1e-3)
    assert npy(met_t["mpc_ok"]).all() and met_j["mpc_ok"].all()
    np.testing.assert_allclose(npy(met_t["mpc_prim_res"]),
                               met_j["mpc_prim_res"], atol=1e-3)
    np.testing.assert_allclose(npy(plant_t.q), plant_j["q"], atol=2e-3)
    np.testing.assert_allclose(npy(plant_t.v)[:2], plant_j["v"][:2],
                               atol=5e-2)
    np.testing.assert_allclose(npy(plant_t.v)[2:], plant_j["v"][2:], atol=0.3)
    assert npy(met_t["wbc_ok_frac"]).min() == 1.0


def test_pallas_and_vpu_wbc_periods_differ_only_by_rounding(port_side):
    """Kernel 5 applies K as given, kernels 2/3 transposed: two plain
    versions on the CPU, so the periods need not be bit-equal, but K is
    symmetric up to rounding and they stay within the WBC-noise budgets."""
    _, plant_v, _ = port_side["pallas_vpu"]
    _, plant_m, _ = port_side["pallas"]
    np.testing.assert_allclose(npy(plant_m.q), npy(plant_v.q), atol=2e-3)
    np.testing.assert_allclose(npy(plant_m.v)[:2], npy(plant_v.v)[:2],
                               atol=5e-2)
