"""The port's own copy of the float64 oracle (mpctsid_tpu_torch/oracle/)
against the JAX package's (mpctsid_tpu/oracle/).

Each module must equal its original once the package name is replaced (only
`__init__.py` may add a paragraph to its docstring), import neither torch nor
jax nor the JAX package, and give the same arrays, bit for bit, on seeded
calls: both copies run the same numpy code on equal config values and models.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import mpctsid_tpu.oracle.cascade as j_cascade
import mpctsid_tpu.oracle.dynamics as j_dyn
import mpctsid_tpu.oracle.estimator as j_est
import mpctsid_tpu.oracle.mpc as j_mpc
import mpctsid_tpu.oracle.planner as j_planner
import mpctsid_tpu.oracle.qp as j_qp
import mpctsid_tpu.oracle.sim as j_sim
import mpctsid_tpu.oracle.wbc as j_wbc
import mpctsid_tpu_torch.oracle.cascade as t_cascade
import mpctsid_tpu_torch.oracle.dynamics as t_dyn
import mpctsid_tpu_torch.oracle.estimator as t_est
import mpctsid_tpu_torch.oracle.mpc as t_mpc
import mpctsid_tpu_torch.oracle.planner as t_planner
import mpctsid_tpu_torch.oracle.qp as t_qp
import mpctsid_tpu_torch.oracle.sim as t_sim
import mpctsid_tpu_torch.oracle.wbc as t_wbc
from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.gaits import GAITS as J_GAITS
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.gaits import GAITS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree

from _torch_port_util import random_qp, random_qv, standing_q0

ROOT = Path(__file__).resolve().parents[1]
J_ORACLE = ROOT / "mpctsid_tpu" / "oracle"
T_ORACLE = ROOT / "mpctsid_tpu_torch" / "oracle"
MODULES = ["cascade.py", "dynamics.py", "estimator.py", "mpc.py",
           "planner.py", "qp.py", "sim.py", "wbc.py"]
IMPORT = re.compile(r"^\s*(import|from)\s+(\S+)")

JCFG, CFG = JEngineConfig(), EngineConfig()
JTREE, TTREE = j_build_tree(J_SOLO12), build_tree(SOLO12)


def _same(a, b, path="out"):
    """Equal bit for bit: arrays by their bytes, dataclasses field by
    field, sequences item by item, scalars by value."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), path


def test_the_copy_has_every_module():
    assert sorted(p.name for p in J_ORACLE.glob("*.py")) == sorted(
        MODULES + ["__init__.py"])
    assert sorted(p.name for p in T_ORACLE.glob("*.py")) == sorted(
        MODULES + ["__init__.py"])


@pytest.mark.parametrize("name", MODULES)
def test_module_is_byte_equal_after_the_package_rename(name):
    want = (J_ORACLE / name).read_text().replace("mpctsid_tpu.",
                                                 "mpctsid_tpu_torch.")
    assert (T_ORACLE / name).read_bytes() == want.encode()


def test_init_adds_only_a_docstring_paragraph():
    want = (J_ORACLE / "__init__.py").read_text()
    got = (T_ORACLE / "__init__.py").read_text()
    assert got.startswith(want.rstrip('"\n'))
    assert got.endswith('"""\n') and got.count('"""') == 2
    assert "copy" in got[len(want) - 4:]


@pytest.mark.parametrize("name", MODULES + ["__init__.py"])
def test_module_imports_only_numpy_and_the_ports_own_modules(name):
    """numpy float64 and the port's config / model / oracle: no torch, no
    jax, nothing of the JAX package."""
    allowed = ("__future__", "dataclasses", "numpy", "mpctsid_tpu_torch.")
    for line in (T_ORACLE / name).read_text().splitlines():
        m = IMPORT.match(line)
        if m is None:
            continue
        mod = m.group(2)
        assert mod.startswith(allowed), line
        assert not mod.startswith(("mpctsid_tpu_torch.qp",
                                   "mpctsid_tpu_torch.utils")), line
        assert "torch" not in mod.replace("mpctsid_tpu_torch", ""), line


def test_solve_qp_bit_for_bit():
    for seed in range(3):
        P, q, A, l, u = [a.astype(np.float64)
                         for a in random_qp(seed, n=12, m=20)]
        _same(t_qp.solve_qp(P, q, A, l, u), j_qp.solve_qp(P, q, A, l, u))


def _mpc_problem(seed, gait, model, cfg, planner, mpc):
    r = np.random.default_rng(seed)
    x0 = np.zeros(12)
    x0[2] = model.h_ref + r.normal() * 0.01
    x0[6:8] = r.normal(size=2) * 0.2
    x0[3:5] = r.normal(size=2) * 0.05
    vc = np.array([r.uniform(-0.5, 0.5), r.uniform(-0.2, 0.2),
                   r.uniform(-0.5, 0.5)])
    g = planner.GaitScheduler(gait, phase=int(r.integers(0, 16)))
    feet0 = model.shoulder_offsets.copy()
    feet0[:, 2] = 0.0
    fsteps, td = planner.plan_footsteps_horizon(model, cfg.mpc, cfg.cascade,
                                                g, x0, vc, feet0)
    xref = mpc.reference_rollout(model, cfg.mpc, x0, vc)
    return (x0, xref, fsteps, g.horizon(cfg.mpc.horizon)), td


@pytest.mark.parametrize("gait", ["trot", "bound"])
def test_build_and_solve_mpc_bit_for_bit(gait):
    with threadpool_limits(1):
        pt, td_t = _mpc_problem(0, GAITS[gait], SOLO12, CFG, t_planner, t_mpc)
        pj, td_j = _mpc_problem(0, J_GAITS[gait], J_SOLO12, JCFG, j_planner,
                                j_mpc)
        _same(pt, pj)
        _same(td_t, td_j)
        _same(t_mpc.build_mpc_qp(SOLO12, CFG.mpc, *pt),
              j_mpc.build_mpc_qp(J_SOLO12, JCFG.mpc, *pj))
        _same(t_mpc.solve_mpc(SOLO12, CFG.mpc, CFG.solver, *pt),
              j_mpc.solve_mpc(J_SOLO12, JCFG.mpc, JCFG.solver, *pj))


def test_swing_foot_ref_and_gait_scheduler_bit_for_bit():
    r = np.random.default_rng(1)
    for _ in range(5):
        p0, p1 = r.normal(size=(2, 3)) * 0.2
        s, T = r.uniform(0, 1), r.uniform(0.04, 0.2)
        _same(t_planner.swing_foot_ref(p0, p1, s, T, 0.05),
              j_planner.swing_foot_ref(p0, p1, s, T, 0.05))
    for gait in GAITS:
        gt = t_planner.GaitScheduler(GAITS[gait], phase=3)
        gj = j_planner.GaitScheduler(J_GAITS[gait], phase=3)
        for _ in range(16):
            gt.roll()
            gj.roll()
            _same(gt.horizon(16), gj.horizon(16))
            _same([gt.swing_progress(i, 0.4) for i in range(4)],
                  [gj.swing_progress(i, 0.4) for i in range(4)])


def test_rigid_body_dynamics_bit_for_bit():
    q, v = random_qv(0, 3)
    a = np.random.default_rng(2).normal(size=(3, 18))
    for b in range(3):
        qb, vb = q[b].astype(np.float64), v[b].astype(np.float64)
        qb[3:7] /= np.linalg.norm(qb[3:7])
        st_t, st_j = t_dyn.DynState(TTREE, qb), j_dyn.DynState(JTREE, qb)
        _same(t_dyn.crba(TTREE, st_t), j_dyn.crba(JTREE, st_j))
        _same(t_dyn.rnea(TTREE, st_t, vb, a[b]),
              j_dyn.rnea(JTREE, st_j, vb, a[b]))
        _same(st_t.foot_positions(), st_j.foot_positions())
        for leg in range(4):
            _same(t_dyn.foot_jacobian(TTREE, st_t, leg),
                  j_dyn.foot_jacobian(JTREE, st_j, leg))
            _same(t_dyn.foot_drift(TTREE, st_t, vb, leg),
                  j_dyn.foot_drift(JTREE, st_j, vb, leg))
        _same(t_dyn.integrate_q(qb, vb, 0.02), j_dyn.integrate_q(qb, vb, 0.02))


def _wbc_refs(module, model, r):
    contacts = np.array([1.0, 0.0, 0.0, 1.0])
    f = r.normal(size=(4, 3)) * 3.0
    f[:, 2] = np.abs(f[:, 2]) + 8.0
    return module.WbcRefs(
        contacts=contacts, f_mpc=f * contacts[:, None],
        foot_pos_ref=r.normal(size=(4, 3)) * 0.1,
        foot_vel_ref=r.normal(size=(4, 3)) * 0.2,
        foot_acc_ref=r.normal(size=(4, 3)),
        q_posture=model.q_stand, base_rpy_ref=np.zeros(2), h_ref=model.h_ref)


def test_solve_wbc_bit_for_bit():
    with threadpool_limits(1):
        q, v = random_qv(3, 2, spread=0.2)
        for b in range(2):
            qb, vb = q[b].astype(np.float64), v[b].astype(np.float64)
            qb[3:7] /= np.linalg.norm(qb[3:7])
            rt = _wbc_refs(t_wbc, SOLO12, np.random.default_rng(b))
            rj = _wbc_refs(j_wbc, J_SOLO12, np.random.default_rng(b))
            _same(t_wbc.solve_wbc(TTREE, CFG.wbc, qb, vb, rt),
                  j_wbc.solve_wbc(JTREE, JCFG.wbc, qb, vb, rj))


def test_sim_step_and_imu_bit_for_bit():
    q, v = random_qv(4, 3, spread=0.2)
    r = np.random.default_rng(5)
    for b in range(3):
        qb, vb = q[b].astype(np.float64), v[b].astype(np.float64)
        qb[3:7] /= np.linalg.norm(qb[3:7])
        qb[2] -= 0.004
        tau = r.normal(size=12)
        st_t = t_sim.SimState.init(qb, vb)
        st_j = j_sim.SimState.init(qb, vb)
        for _ in range(3):
            st_t, f_t = t_sim.step(TTREE, st_t, tau,
                                   params=t_sim.ContactParams(mu=0.4))
            st_j, f_j = j_sim.step(JTREE, st_j, tau,
                                   params=j_sim.ContactParams(mu=0.4))
            _same((st_t, f_t), (st_j, f_j))
        qdd = r.normal(size=18)
        _same(t_sim.imu_readings(TTREE, st_t, qdd),
              j_sim.imu_readings(JTREE, st_j, qdd))
        _same(t_sim.imu_readings(TTREE, st_t), j_sim.imu_readings(JTREE, st_j))


def test_complementary_estimator_bit_for_bit():
    q0 = standing_q0(1)[0].astype(np.float64)
    et = t_est.ComplementaryEstimator(TTREE, q0)
    ej = j_est.ComplementaryEstimator(JTREE, q0)
    r = np.random.default_rng(6)
    for k in range(30):
        gyro = r.normal(size=3) * 0.1
        accel = np.array([0.0, 0.0, 9.81]) + r.normal(size=3) * 0.05
        qj = SOLO12.q_stand + r.normal(size=12) * 0.01
        qdj = r.normal(size=12) * 0.1
        contacts = np.array([1.0, 0.0, 0.0, 1.0]) if k % 2 else np.ones(4)
        hint = r.normal(size=3) if k % 3 == 0 else None
        _same(et.update(gyro, accel, qj, qdj, contacts, hint),
              ej.update(gyro, accel, qj, qdj, contacts, hint))


def test_oracle_controller_twenty_ticks_bit_for_bit():
    """One period of the reference Controller.compute() loop on each copy's
    own simulator: the torques, logs and states of every tick."""
    with threadpool_limits(1):
        q0 = standing_q0(1)[0].astype(np.float64)
        cfg_t = EngineConfig(gait="bound", v_ref=(0.25, 0.0, 0.1))
        cfg_j = JEngineConfig(gait="bound", v_ref=(0.25, 0.0, 0.1))
        ct = t_cascade.OracleController(SOLO12, cfg_t, q0)
        cj = j_cascade.OracleController(J_SOLO12, cfg_j, q0)
        st_t, st_j = t_sim.SimState.init(q0), j_sim.SimState.init(q0)
        for _ in range(20):
            cmd_t, log_t = ct.compute(st_t.q, st_t.v)
            cmd_j, log_j = cj.compute(st_j.q, st_j.v)
            _same((cmd_t, log_t), (cmd_j, log_j))
            tau_t = cmd_t.torque(st_t.q[7:], st_t.v[6:])
            tau_j = cmd_j.torque(st_j.q[7:], st_j.v[6:])
            _same(tau_t, tau_j)
            st_t, _ = t_sim.step(TTREE, st_t, tau_t)
            st_j, _ = j_sim.step(JTREE, st_j, tau_j)
            _same(st_t, st_j)
        _same(ct.v_int, cj.v_int)
        _same(ct.f_plan, cj.f_plan)
