"""The state estimator's kernels on the CPU: the cascade's estimator tick
(`est.filter.estimator_tick`: the plant's IMU model and one complementary-
filter update, the kernel `est_step` of dyn/csrc/est_step.cu) and the update
alone (`estimator_update`, the kernel's second entry point `est_update`).

The body, dyn/csrc/est_step.h over rbd.h's leg kinematics and integration
step, is built with g++ (`_torch_port_util.build_est_step_harness`: a block
of S scenarios at a time on NaN-filled shared memory, each phase's units one
after another between the barriers, in order, reversed or shuffled) and
driven by the wrappers' own packing (`est.filter.run_est_step`,
`run_est_update`).  Contact patterns: none in stance, all in stance, the
trot pairs, a single foot; the update also with an accelerometer reading at
and under 1e-6 (the tilt gain 0); with and without the position hint;
float32 and float64; S = 1, 7 and 32 over a partial last block.  The legs'
odometry terms, formed in the base frame, against the first design's
(a warp a scenario, the term rotated back by R0'; its est_step.h lives in
scripts/probe_est_designs.py, `_torch_port_util.build_first_est_harness`).

Tolerances, against the plain versions (`estimator_tick_reference`,
`estimator_update_reference`) on the same inputs, of each output's largest
entry: one tick within 1e-5 (float32) / 1e-12 (float64), the period
head's tolerances for the same reasons (on the card the rotations are
rbd.h's products, not `torch.matmul`, and sin, cos and sqrt the CUDA math
library's); 60 chained ticks on recorded plant states (open loop) within
1e-4 / 1e-11.  The host build takes the plain chain's operations in its
order but for the legs' terms, formed in the base frame, so on this CPU it
meets them with room (measured: within 4e-8 / 4e-17).  The base-frame
odometry terms against the first design's world-frame ones on random poses
with any yaw: within 1e-6 / 1e-14 of their largest entry.
The plain tick against the JAX package's `imu_from_plant` +
`estimator_update` over 50 ticks, each side carrying its own state: within
2e-5, tests/test_torch_estimator.py's budget for the update alone.  Then
the callers: `cascade_period` takes the estimator through `estimator_tick`
once a tick and never through `estimator_update`.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.est import filter as jfilter
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu_torch.cascade import CascadeConfigured, init_controller
from mpctsid_tpu_torch.cascade import engine
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.dyn import kernels as dk
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState, plant_step
from mpctsid_tpu_torch.est import filter as tfilter
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree

from _torch_port_util import (build_est_step_harness,
                              build_first_est_harness, jj, npy, random_qv,
                              standing_q0)

TREE = build_tree(SOLO12)
JTREE = j_build_tree(J_SOLO12)
DTYPES = [torch.float32, torch.float64]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
CHAIN_TOL = {torch.float32: 1e-4, torch.float64: 1e-11}
ODO_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
DT = 0.001
GAINS = (0.02, 0.97, 0.05)      # alpha_tilt, alpha_vel, alpha_z
# none in stance, all, the trot pairs, a single foot (front and hind)
CONTACTS = np.array([[0, 0, 0, 0], [1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0],
                     [1, 0, 0, 0], [0, 0, 1, 0]], np.float64)
B = len(CONTACTS)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_est_step_harness(tmp_path_factory.mktemp("est_step"))


@pytest.fixture(scope="module")
def first_legs(tmp_path_factory):
    return build_first_est_harness(tmp_path_factory.mktemp("first_est"))


def t(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


def plant_states(seed, dtype, n=B):
    """(q_plant, v_plant, est): a plant near standing with any yaw and an
    estimate a little off it."""
    q, v = random_qv(seed, n)
    r = np.random.default_rng(seed + 300)
    yaw = r.uniform(-np.pi, np.pi, n)
    cz, sz = np.cos(yaw / 2), np.sin(yaw / 2)
    x, y, z, w = q[:, 3:7].astype(np.float64).T
    q[:, 3:7] = np.stack([cz * x - sz * y, cz * y + sz * x,
                          cz * z + sz * w, cz * w - sz * z], 1)
    qe, ve = random_qv(seed + 1, n, spread=0.1)
    qe[:, 0:3] = q[:, 0:3] + r.normal(size=(n, 3)) * 0.01
    return (t(q, dtype), t(v, dtype),
            tfilter.EstimatorState(q=t(qe, dtype), v=t(ve, dtype)))


def sensors(seed, dtype, n=B):
    """gyro, accel, q_joints, qd_joints of n scenarios; the last two
    accelerometer readings at 1e-6 and under it (the tilt gain 0)."""
    r = np.random.default_rng(seed)
    gyro = r.normal(size=(n, 3)) * 0.2
    accel = np.array([0.0, 0.0, 9.81]) + r.normal(size=(n, 3)) * 0.5
    accel[-1] = 0.0
    accel[-2] = [0.0, 6e-7, 8e-7]   # |a| = 1e-6
    qj = np.asarray(SOLO12.q_stand) + r.normal(size=(n, 12)) * 0.1
    qdj = r.normal(size=(n, 12)) * 0.5
    return [t(a, dtype) for a in (gyro, accel, qj, qdj)]


def rel_err(got, want):
    """Largest |got - want| over the largest |want| (1 where that is 0)."""
    scale = max(float(want.abs().max()), 1.0)
    return float((got.double() - want.double()).abs().max()) / scale


def hint_of(q_plant, with_hint):
    return q_plant[:, 0:3] if with_hint else None


# ---------------------------------------------------- the g++ build

@pytest.mark.parametrize("with_hint", [False, True],
                         ids=["hint_free", "with_hint"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tick_header_against_plain(harness, dtype, with_hint):
    """One tick: the host build within 1e-5 / 1e-12 of each output's
    largest entry, the lanes in either order the same bits, the hint's x-y
    taken as they are."""
    q_p, v_p, st = plant_states(1, dtype)
    c = t(CONTACTS, dtype)
    hint = hint_of(q_p, with_hint)
    want = tfilter.estimator_tick_reference(TREE, st, q_p, v_p, c, DT,
                                            *GAINS, base_pos_hint=hint)
    rc, got = tfilter.run_est_step(harness.tick, TREE, st, q_p, v_p, c, DT,
                                   *GAINS, hint)
    rc2, rev = tfilter.run_est_step(harness.tick_reversed, TREE, st, q_p,
                                    v_p, c, DT, *GAINS, hint)
    assert rc == 0 and rc2 == 0
    for g, r, w in zip(got, rev, (want.q, want.v)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()
        assert rel_err(g, w) <= TOL[dtype]
        assert torch.equal(g, r)
    if with_hint:
        assert torch.equal(got[0][:, 0:2], q_p[:, 0:2])
    # v' = [v_lin, gyro, qd]: the plant's gyro and joint rates as they are
    assert torch.equal(got[1][:, 3:], v_p[:, 3:])
    assert torch.equal(got[0][:, 7:], q_p[:, 7:])


@pytest.mark.parametrize("with_hint", [False, True],
                         ids=["hint_free", "with_hint"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_update_header_against_plain(harness, dtype, with_hint):
    """The update alone, gyro and accel given (two scenarios' readings at
    and under 1e-6): within the tick's tolerances, lanes in either order
    the same bits."""
    _, _, st = plant_states(2, dtype)
    gyro, accel, qj, qdj = sensors(3, dtype)
    c = t(CONTACTS, dtype)
    hint = t(np.random.default_rng(4).normal(size=(B, 3)) * 0.05, dtype) \
        if with_hint else None
    want = tfilter.estimator_update_reference(
        TREE, st, gyro, accel, qj, qdj, c, DT, *GAINS, base_pos_hint=hint)
    outs = []
    for fn in (harness.update, harness.update_reversed):
        rc, got = tfilter.run_est_update(fn, TREE, st, gyro, accel, qj, qdj,
                                         c, DT, *GAINS, hint)
        assert rc == 0
        outs.append(got)
    for g, r, w in zip(outs[0], outs[1], (want.q, want.v)):
        assert torch.isfinite(g).all()
        assert rel_err(g, w) <= TOL[dtype]
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dead_accelerometer_takes_no_tilt_correction(harness, dtype):
    """A reading at or under 1e-6 leaves the gyro-integrated attitude: the
    update's orientation for those scenarios equals the same update with
    alpha_tilt = 0, in the host build as in the plain version."""
    _, _, st = plant_states(5, dtype)
    gyro, accel, qj, qdj = sensors(6, dtype)
    c = t(CONTACTS, dtype)
    gains = [(0.02, 0.97, 0.05), (0.0, 0.97, 0.05)]
    got = [tfilter.run_est_update(harness.update, TREE, st, gyro, accel, qj,
                                  qdj, c, DT, *g, None)[1] for g in gains]
    assert torch.equal(got[0][0][-2:, 3:7], got[1][0][-2:, 3:7])
    assert not torch.equal(got[0][0][:-2, 3:7], got[1][0][:-2, 3:7])


def recorded_plant(steps, dtype, seed=7):
    """`steps` plant states of B scenarios from standing: the plain plant
    step under a joint PD law toward the standing posture plus a random
    offset per scenario (the estimator's open-loop inputs)."""
    q0 = standing_q0(B)
    plant = PlantState.init(q0, device="cpu", dtype=dtype)
    cp = ContactParams.default(B, device="cpu", dtype=dtype)
    r = np.random.default_rng(seed)
    target = t(np.asarray(SOLO12.q_stand) + r.normal(size=(B, 12)) * 0.15,
               dtype)
    states = []
    for _ in range(steps):
        tau = torch.clamp(3.0 * (target - plant.q[:, 7:])
                          - 0.1 * plant.v[:, 6:], -2.5, 2.5)
        plant, _ = plant_step(TREE, plant, tau, dt=DT, params=cp)
        states.append((plant.q, plant.v))
    return states


@pytest.mark.parametrize("dtype", DTYPES)
def test_sixty_chained_ticks(harness, dtype):
    """60 ticks on recorded plant states, the host build carrying its own
    estimate and the plain version its own: within 1e-4 / 1e-11 of each
    output's largest entry at the end (and at every tick)."""
    states = recorded_plant(60, dtype)
    c = t(CONTACTS, dtype)
    est = tfilter.estimator_init(standing_q0(B), device="cpu", dtype=dtype)
    ref = est
    for q_p, v_p in states:
        rc, (q, v) = tfilter.run_est_step(harness.tick, TREE, est, q_p, v_p,
                                          c, DT, *GAINS, None)
        assert rc == 0
        est = tfilter.EstimatorState(q=q, v=v)
        ref = tfilter.estimator_tick_reference(TREE, ref, q_p, v_p, c, DT,
                                               *GAINS)
        assert rel_err(est.q, ref.q) <= CHAIN_TOL[dtype]
        assert rel_err(est.v, ref.v) <= CHAIN_TOL[dtype]
    assert torch.isfinite(est.q).all() and torch.isfinite(est.v).all()


def test_rows_of_a_packed_buffer(harness):
    """The hint and the plant's rows handed over as rows of wider buffers
    (their strides) give the bits of contiguous copies."""
    q_p, v_p, st = plant_states(8, torch.float32)
    c = t(CONTACTS, torch.float32)
    wide = torch.cat([q_p, v_p, torch.ones(B, 5)], dim=1)
    _, a = tfilter.run_est_step(harness.tick, TREE, st, wide[:, :19],
                                wide[:, 19:37], c, DT, *GAINS,
                                wide[:, 0:3])
    _, b = tfilter.run_est_step(harness.tick, TREE, st, q_p.clone(),
                                v_p.clone(), c, DT, *GAINS,
                                q_p[:, 0:3].clone())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bool_contacts_are_the_float_mask(harness):
    q_p, v_p, st = plant_states(9, torch.float32)
    c = t(CONTACTS, torch.float32)
    _, a = tfilter.run_est_step(harness.tick, TREE, st, q_p, v_p, c, DT,
                                *GAINS, None)
    _, b = tfilter.run_est_step(harness.tick, TREE, st, q_p, v_p, c > 0.5,
                                DT, *GAINS, None)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_layout_counts(harness):
    """The operand counts and a scenario's share of shared memory, as the
    header reports them and as dyn/kernels.py and the wrappers pack them;
    the launch layout on an H100's limits (`est_layout`)."""
    want = list(dk.LAYOUT.values()) + list(dk.EST_LAYOUT.values())
    assert [harness.layout(i) for i in range(len(want))] == want
    assert harness.layout(len(want)) == -1
    assert harness.slot_values() == dk.SLOT_VALUES["est_step"]
    seen = []

    def spy(dtype, B_, consts, ins, stride, outs, par):
        seen.append(dict(ins=len(ins), outs=len(outs), par=len(par)))
        return 0

    q_p, v_p, st = plant_states(10, torch.float32)
    c = t(CONTACTS, torch.float32)
    tfilter.run_est_step(spy, TREE, st, q_p, v_p, c, DT, *GAINS, None)
    tfilter.run_est_update(spy, TREE, st, *sensors(11, torch.float32), c, DT,
                           *GAINS, None)
    lay = dk.EST_LAYOUT
    assert seen == [dict(ins=lay["est_in"], outs=lay["est_out"],
                         par=lay["est_par"])] * 2
    smem, n_sm = 227 * 1024, 132
    assert dk.est_layout(1, torch.float32, smem, n_sm) == \
        dk.EstLayout(1, 1, 1204)
    assert dk.est_layout(4096, torch.float32, smem, n_sm) == \
        dk.EstLayout(32, 128, 12848)
    assert dk.est_layout(300, torch.float64, smem, n_sm) == \
        dk.EstLayout(3, 100, 3864)


# ------------------------------------------------------ the block's design

BLOCK_B = 37     # over S = 7 and 32: a partial last block


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
@pytest.mark.parametrize("imu", [True, False], ids=["tick", "update"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_units_in_any_order_give_the_same_bits(harness, dtype, imu,
                                                     order):
    """A block's units run in order, reversed or shuffled within each phase
    (S = 7 over B = 37, the hint given): the same bits, no unit reading
    what another writes in its own phase."""
    q_p, v_p, st = plant_states(20, dtype, n=BLOCK_B)
    c = t(CONTACTS[np.arange(BLOCK_B) % B], dtype)
    gyro, accel, qj, qdj = sensors(21, dtype, n=BLOCK_B)
    hint = q_p[:, 0:3]

    def run(fn):
        if imu:
            return tfilter.run_est_step(fn, TREE, st, q_p, v_p, c, DT,
                                        *GAINS, hint)
        return tfilter.run_est_update(fn, TREE, st, gyro, accel, qj, qdj, c,
                                      DT, *GAINS, hint)
    (rc, want), (rc2, got) = (run(harness.launcher(imu, 7, o))
                              for o in ("in_order", order))
    assert rc == 0 and rc2 == 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("S", [1, 7, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scenarios_a_block_within_the_tolerances(harness, dtype, S):
    """B = 37 in blocks of S = 1, 7 and 32 scenarios (the last block
    partial but at S = 1), tick and update, with and without the hint:
    within 1e-5 / 1e-12 of the plain chain, the pass-through entries
    exact, and every S the same bits."""
    q_p, v_p, st = plant_states(22, dtype, n=BLOCK_B)
    c = t(CONTACTS[np.arange(BLOCK_B) % B], dtype)
    gyro, accel, qj, qdj = sensors(23, dtype, n=BLOCK_B)
    for hint in (None, q_p[:, 0:3]):
        want = tfilter.estimator_tick_reference(TREE, st, q_p, v_p, c, DT,
                                                *GAINS, base_pos_hint=hint)
        rc, got = tfilter.run_est_step(harness.launcher(True, S), TREE, st,
                                       q_p, v_p, c, DT, *GAINS, hint)
        _, at32 = tfilter.run_est_step(harness.launcher(True, 32), TREE, st,
                                       q_p, v_p, c, DT, *GAINS, hint)
        assert rc == 0
        for g, w, x in zip(got, (want.q, want.v), at32):
            assert torch.isfinite(g).all()
            assert rel_err(g, w) <= TOL[dtype]
            assert torch.equal(g, x)
        assert torch.equal(got[0][:, 7:], q_p[:, 7:])
        assert torch.equal(got[1][:, 3:], v_p[:, 3:])
        if hint is not None:
            assert torch.equal(got[0][:, 0:2], hint[:, 0:2])
        want = tfilter.estimator_update_reference(
            TREE, st, gyro, accel, qj, qdj, c, DT, *GAINS,
            base_pos_hint=hint)
        rc, got = tfilter.run_est_update(harness.launcher(False, S), TREE,
                                         st, gyro, accel, qj, qdj, c, DT,
                                         *GAINS, hint)
        assert rc == 0
        for g, w in zip(got, (want.q, want.v)):
            assert rel_err(g, w) <= TOL[dtype]


# B -> (S, blocks, shared bytes float32, shared bytes float64) on an H100
EST_LAYOUTS = {1: (1, 1, 1204, 2360), 37: (1, 37, 1204, 2360),
               256: (2, 128, 1576, 3104), 4096: (32, 128, 12848, 25664)}


@pytest.mark.parametrize("B_", sorted(EST_LAYOUTS))
def test_est_layout_on_an_h100(harness, B_):
    """`est_layout` as a pure function on an H100's limits (132
    multiprocessors, 227 KB a block opted in): B spread over the
    multiprocessors, at most 32 scenarios a block; the header's
    `est_scenarios` and `est_smem_bytes` the same; fewer scenarios where
    shared memory is short, and a refusal where one does not fit."""
    smem, n_sm = 227 * 1024, 132
    S, blocks, b32, b64 = EST_LAYOUTS[B_]
    for dtype, nbytes in ((torch.float32, b32), (torch.float64, b64)):
        size = torch.empty((), dtype=dtype).element_size()
        lay = dk.est_layout(B_, dtype, smem, n_sm)
        assert lay == dk.EstLayout(S, blocks, nbytes)
        assert lay.scenarios * lay.blocks >= B_ > (lay.blocks - 1) * S
        assert harness.scenarios(B_, smem, n_sm, size) == S
        assert harness.smem_bytes(S, size) == nbytes
        if S == 1:
            with pytest.raises(ValueError):
                dk.est_layout(B_, dtype, nbytes - 1, n_sm)
            assert harness.scenarios(B_, nbytes - 1, n_sm, size) == 0
            continue
        short = dk.est_layout(B_, dtype, nbytes - 1, n_sm)
        assert short.scenarios == S - 1
        assert short.smem_bytes == harness.smem_bytes(S - 1, size)
        assert harness.scenarios(B_, nbytes - 1, n_sm, size) == S - 1


def random_poses(seed, dtype, n=64):
    """(q, gyro, qd): configurations at random positions and attitudes
    (any yaw, roll and pitch up to 0.3 rad), joints about standing."""
    r = np.random.default_rng(seed)
    q = np.zeros((n, 19))
    q[:, 0:3] = r.normal(size=(n, 3))
    rpy = np.stack([r.uniform(-0.3, 0.3, n), r.uniform(-0.3, 0.3, n),
                    r.uniform(-np.pi, np.pi, n)], 1)
    cr, cp, cy = (np.cos(rpy[:, i] / 2) for i in range(3))
    sr, sp, sy = (np.sin(rpy[:, i] / 2) for i in range(3))
    q[:, 3:7] = np.stack([sr * cp * cy - cr * sp * sy,
                          cr * sp * cy + sr * cp * sy,
                          cr * cp * sy - sr * sp * cy,
                          cr * cp * cy + sr * sp * sy], 1)
    q[:, 7:] = np.asarray(SOLO12.q_stand) + r.normal(size=(n, 12)) * 0.3
    return (t(q, dtype), t(r.normal(size=(n, 3)) * 0.5, dtype),
            t(r.normal(size=(n, 12)) * 2.0, dtype))


@pytest.mark.parametrize("seed", [30, 31])
@pytest.mark.parametrize("dtype", DTYPES)
def test_base_frame_odometry_is_the_first_designs(harness, first_legs,
                                                  dtype, seed):
    """Each foot's odometry term formed in the base frame (`leg_unit`: the
    identity base pose, r x gyro - sum col_j qd_j) against the first
    design's (the Jacobian's columns at the pose, the residual rotated
    back by R0') on random poses with any yaw: within 1e-6 / 1e-14 of the
    largest entry; the feet the plain kinematics' in the base frame."""
    q, gyro, qd = random_poses(seed, dtype)
    odo, foot = harness.legs(q, gyro, qd)
    want = first_legs(q, gyro, qd)
    assert rel_err(odo, want) <= ODO_TOL[dtype]
    q_id = q.clone()
    q_id[:, 0:7] = t([0, 0, 0, 0, 0, 0, 1], dtype)
    feet = tfilter.dyn.foot_positions(TREE, q_id)
    assert rel_err(foot, feet) <= TOL[dtype]


# ---------------------------------------- the wrappers and the plain version

def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors both wrappers run their plain versions, bit for bit,
    and count no launch."""
    q_p, v_p, st = plant_states(12, torch.float32)
    c = t(CONTACTS, torch.float32)
    before = (tfilter.estimator_tick.launches,
              tfilter.estimator_update.launches)
    got = tfilter.estimator_tick(TREE, st, q_p, v_p, c,
                                 base_pos_hint=q_p[:, 0:3])
    want = tfilter.estimator_tick_reference(TREE, st, q_p, v_p, c,
                                            base_pos_hint=q_p[:, 0:3])
    assert torch.equal(got.q, want.q) and torch.equal(got.v, want.v)
    args = sensors(13, torch.float32)
    got = tfilter.estimator_update(TREE, st, *args, c)
    want = tfilter.estimator_update_reference(TREE, st, *args, c)
    assert torch.equal(got.q, want.q) and torch.equal(got.v, want.v)
    assert (tfilter.estimator_tick.launches,
            tfilter.estimator_update.launches) == before


def test_wrappers_check_their_arguments(harness):
    q_p, v_p, st = plant_states(14, torch.float32)
    c = t(CONTACTS, torch.float32)
    with pytest.raises(ValueError):
        tfilter.estimator_tick(TREE, tfilter.EstimatorState(
            q=st.q, v=st.v[:, :17]), q_p, v_p, c)
    with pytest.raises(ValueError):
        tfilter.run_est_step(harness.tick, TREE, st, q_p, v_p[:, :17], c, DT,
                             *GAINS, None)
    with pytest.raises(ValueError):
        tfilter.run_est_step(harness.tick, TREE, st, q_p[:3], v_p[:3], c, DT,
                             *GAINS, None)
    with pytest.raises(ValueError):
        tfilter.run_est_step(harness.tick, TREE, st, q_p, v_p, c[:, :3], DT,
                             *GAINS, None)
    with pytest.raises(TypeError):
        tfilter.run_est_step(harness.tick, TREE, st, q_p.double(),
                             v_p.double(), c, DT, *GAINS, None)
    gyro, accel, qj, qdj = sensors(15, torch.float32)
    with pytest.raises(ValueError):
        tfilter.run_est_update(harness.update, TREE, st, gyro, accel,
                               qj[:, :11], qdj, c, DT, *GAINS, None)
    with pytest.raises(TypeError):
        tfilter.run_est_update(harness.update, TREE, st, gyro.double(),
                               accel, qj, qdj, c, DT, *GAINS, None)


@pytest.mark.parametrize("with_hint", [False, True],
                         ids=["hint_free", "with_hint"])
def test_plain_tick_matches_jax(with_hint):
    """50 ticks of the plain `estimator_tick_reference` against the JAX
    package's `imu_from_plant` + `estimator_update` (vmapped), each side
    carrying its own state, on a stream of plant states near standing:
    within 2e-5."""
    steps = 50
    r = np.random.default_rng(16)
    stream = []
    for k in range(steps):
        q, v = random_qv(100 + k, B, spread=0.1)
        q[:, 0:3] += r.normal(size=(B, 3)) * 0.01
        stream.append((q.astype(np.float32), v.astype(np.float32)))
    c = CONTACTS.astype(np.float32)

    def jtick(st, q, v, c_):
        gyro, accel = jfilter.imu_from_plant(JTREE, q, v)
        return jfilter.estimator_update(
            JTREE, st, gyro, accel, q[7:], v[6:], c_,
            base_pos_hint=q[0:3] if with_hint else None)

    step = jax.jit(jax.vmap(jtick))
    q0 = standing_q0(B)
    st_j = jax.vmap(jfilter.estimator_init)(jj(q0))
    st_t = tfilter.estimator_init(q0, device="cpu")
    for q, v in stream:
        st_j = step(st_j, jj(q), jj(v), jj(c))
        q_t, v_t = torch.as_tensor(q), torch.as_tensor(v)
        st_t = tfilter.estimator_tick_reference(
            TREE, st_t, q_t, v_t, torch.as_tensor(c),
            base_pos_hint=q_t[:, 0:3] if with_hint else None)
    np.testing.assert_allclose(npy(st_t.q), npy(st_j.q), atol=2e-5)
    np.testing.assert_allclose(npy(st_t.v), npy(st_j.v), atol=2e-5)


# ------------------------------------------------------------ the caller

def test_cascade_period_ticks_the_estimator_through_the_tick(monkeypatch):
    """cascade_period(use_estimator=True) calls estimator_tick once a WBC
    tick, on the plant's state and the period's contacts, and never the
    update alone; the estimate it hands back is the last tick's."""
    n = 2
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc = CascadeConfigured(SOLO12, cfg)
    q0 = standing_q0(n)
    gid = np.full((n,), GAIT_IDS["trot"], np.int32)
    ctl = init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    cp = ContactParams.default(n, device="cpu")
    v = torch.tensor([cfg.v_ref] * n, dtype=torch.float32)
    est = tfilter.estimator_init(q0, device="cpu")
    calls = []
    shipped = engine.estimator_tick

    def counted(tree, st, q_p, v_p, contacts, **kw):
        out = shipped(tree, st, q_p, v_p, contacts, **kw)
        calls.append((q_p, v_p, kw.get("base_pos_hint"), out))
        return out

    # the engine reaches the estimator only through estimator_tick
    assert not hasattr(engine, "estimator_update")
    assert not hasattr(engine, "imu_from_plant")
    monkeypatch.setattr(engine, "estimator_tick", counted)
    _, _, est_out, metrics = engine.cascade_period(
        cc, ctl, plant, torch.as_tensor(gid), v, cp, est=est,
        use_estimator=True, est_mocap=True)
    ticks = cfg.cascade.mpc_every
    assert len(calls) == ticks
    assert all(torch.equal(h, q[:, 0:3]) for q, _, h, _ in calls)
    assert torch.equal(est_out.q, calls[-1][3].q)
    assert "est_xy_err" in metrics
