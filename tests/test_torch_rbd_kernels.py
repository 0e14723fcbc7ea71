"""The arithmetic of the WBC-build and plant-step kernels on the CPU.

mpctsid_tpu_torch/dyn/csrc/rbd.h holds the whole per-scenario body of both
CUDA kernels as per-lane units of a warp (the .cu files only map a warp to
a scenario).  Here g++ builds it into a host library with the kernels' C
signature whose executor runs each scenario's 32 lanes one after another
between the phases (tests/_torch_port_util.py::build_rbd_harness), and
`wbc.tsid.run_wbc_build` / `env.plant.run_plant_step`, the wrappers' own
operand packing, drive it.  Its results are held against the plain versions
(`build_wbc_qp_reference`, `plant_step_reference`) and, in float32, against
the JAX functions under jax.vmap, on numpy-seeded batches: the trot, walk,
bound and pace contact mixes of the gait tables, payload on and off,
`exact_pin` on and off, float32 and float64; for the plant, feet above the
ground, pressed into it, sliding and pulled off it.

Tolerances.  The kernels sum in other orders than the plain chain, and the
plant solves its two 18 x 18 SPD systems by Cholesky (of their arrow
structure) where the plain version forms inverses (cond ~1e2): float32
within 1e-4 of the plain result relative to the largest entry of each output
(of each diagonal block for H, whose 1e6 ridge would hide the rest), float64
within 1e-10.  Measured: 1.3e-7 and 1.2e-6 (float32 build and plant),
1.1e-16 and 1.6e-15 (float64).  The plant
states are drawn away from its switching surfaces (a foot within 1e-5 m of
the ground, a tangential force within 1e-5 N of the cone, a normal force
within 1e-5 N of zero), where one rounding can flip a branch.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu import dyn as jdyn
from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.env import plant as jplant
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu.wbc import tsid as jtsid
from mpctsid_tpu_torch import dyn as tdyn
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.dyn import kernels as rbd
from mpctsid_tpu_torch.env import plant as tplant
from mpctsid_tpu_torch.model.gaits import GAITS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.wbc import tsid as ttsid

from _torch_port_util import build_rbd_harness, jj, npy, random_qv

JCFG = JEngineConfig()
CFG = EngineConfig()
JTREE = j_build_tree(J_SOLO12)
TREE = build_tree(SOLO12)
B = 8
GAIT_NAMES = ("trot", "walk", "bound", "pace")
FIELDS = ["contacts", "f_mpc", "foot_pos_ref", "foot_vel_ref", "foot_acc_ref",
          "q_posture", "base_rpy_ref", "h_ref"]
NAMES = ["H", "g", "A", "l", "u", "M", "h", "JcT"]
REL = {torch.float32: 1e-4, torch.float64: 1e-10}
INF_AT = 1e19


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_rbd_harness(tmp_path_factory.mktemp("rbd"))


def close(got, want, rel, what):
    """|got - want| <= rel * (largest |want|) over the finite entries; the
    infinite bounds (INF = 1e20) where the plain version puts them."""
    got, want = npy(got).astype(np.float64), npy(want).astype(np.float64)
    assert got.shape == want.shape, what
    inf_w = np.abs(want) >= INF_AT
    np.testing.assert_array_equal(np.abs(got) >= INF_AT, inf_w, err_msg=what)
    np.testing.assert_array_equal(got[inf_w], want[inf_w], err_msg=what)
    scale = max(np.abs(want[~inf_w]).max(), 1e-30)
    err = np.abs(got - want)[~inf_w].max() / scale
    assert err <= rel, f"{what}: {err:.3e} of the largest entry > {rel:g}"


def close_qp(got, want, rel, what):
    for name, g, w in zip(NAMES, got, want):
        close(g, w, rel, f"{what} {name}")
    # H's two diagonal blocks apart: the 1e6 swing-force ridge would set
    # the scale of the whole matrix
    close(got[0][:, :18, :18], want[0][:, :18, :18], rel, f"{what} H_qq")
    close(got[0][:, 18:, 18:], want[0][:, 18:, 18:], rel, f"{what} H_ff")


# ------------------------------------------------------------------- WBC

@pytest.fixture(scope="module")
def wbc_case():
    """Two scenarios of each gait at numpy-seeded phases (its contact mix),
    states near standing, swing references near the feet, an MPC plan."""
    r = np.random.default_rng(11)
    q, v = random_qv(7, B, spread=0.3)
    contacts = np.stack([GAITS[GAIT_NAMES[i // 2]].contacts_at(
        int(r.integers(0, 16))) for i in range(B)])
    feet = npy(tdyn.foot_positions(TREE, torch.tensor(q)))
    refs = dict(
        contacts=contacts,
        f_mpc=np.concatenate([r.normal(size=(B, 4, 2)),
                              r.uniform(2.0, 12.0, size=(B, 4, 1))], -1)
        * contacts[..., None],
        foot_pos_ref=feet + r.normal(size=(B, 4, 3)) * 0.01,
        foot_vel_ref=r.normal(size=(B, 4, 3)) * 0.2,
        foot_acc_ref=r.normal(size=(B, 4, 3)) * 2.0,
        q_posture=np.tile(SOLO12.q_stand, (B, 1)),
        base_rpy_ref=r.normal(size=(B, 2)) * 0.02,
        h_ref=np.full(B, SOLO12.h_ref))
    refs = {k: np.asarray(a, np.float32) for k, a in refs.items()}
    payload = r.uniform(0.0, 0.4, size=B).astype(np.float32)
    # every gait's stance sets, and both a stance and a swing foot
    assert 0 < contacts.sum() < contacts.size
    return q, v, refs, payload


def torch_case(case, dtype):
    q, v, refs, payload = case
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return (t(q), t(v), ttsid.WbcRefs(**{k: t(refs[k]) for k in FIELDS}),
            t(payload))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("exact_pin", [False, True])
def test_wbc_build_matches_plain(harness, wbc_case, dtype, with_payload,
                                 exact_pin):
    q, v, refs, payload = torch_case(wbc_case, dtype)
    extra = tdyn.point_mass_spatial(payload) if with_payload else None
    rc, got = ttsid.run_wbc_build(harness.wbc_build, TREE, CFG.wbc, q, v, refs,
                                extra, exact_pin)
    assert rc == 0
    want = ttsid.build_wbc_qp_reference(TREE, CFG.wbc, q, v, refs, extra,
                                      exact_pin)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
    # JcT is the transposed view of J, as the plain version's
    assert got[7].stride() == want[7].stride()
    close_qp(got, want, REL[dtype], f"{dtype} payload={with_payload} "
                                    f"exact_pin={exact_pin}")
    # exact_pin: the swing forces leave every constraint row
    swing_cols = np.repeat(npy(refs.contacts) < 0.5, 3, axis=1)
    col_sums = np.abs(npy(got[2])[:, :, 18:]).sum(axis=1)[swing_cols]
    assert swing_cols.any()
    assert (col_sums == 0).all() if exact_pin else (col_sums > 0).all()


@pytest.mark.parametrize("with_payload", [False, True])
def test_wbc_build_matches_jax(harness, wbc_case, with_payload):
    q, v, refs, payload = wbc_case
    jrefs = jtsid.WbcRefs(**{k: jj(refs[k]) for k in FIELDS})
    if with_payload:
        want = jax.vmap(lambda q_, v_, r_, m: jtsid.build_wbc_qp(
            JTREE, JCFG.wbc, q_, v_, r_,
            extra_base_inertia=jdyn.point_mass_spatial(m)))(
                jj(q), jj(v), jrefs, jj(payload))
    else:
        want = jax.vmap(lambda q_, v_, r_: jtsid.build_wbc_qp(
            JTREE, JCFG.wbc, q_, v_, r_))(jj(q), jj(v), jrefs)
    tq, tv, trefs, tpay = torch_case(wbc_case, torch.float32)
    extra = tdyn.point_mass_spatial(tpay) if with_payload else None
    rc, got = ttsid.run_wbc_build(harness.wbc_build, TREE, CFG.wbc, tq, tv,
                                  trefs, extra, False)
    assert rc == 0
    close_qp(got, [np.asarray(w) for w in want], REL[torch.float32],
             f"against JAX, payload={with_payload}")


def test_wbc_build_operand_strides(harness, wbc_case):
    """Rows shared by every scenario (expand), column slices of a wider
    buffer and non-contiguous rows (copied) give the result of contiguous
    inputs, bit for bit."""
    q, v, refs, _ = torch_case(wbc_case, torch.float32)
    _, want = ttsid.run_wbc_build(harness.wbc_build, TREE, CFG.wbc, q, v, refs)
    wide = torch.cat([q, v, torch.zeros(B, 5)], dim=1)       # (B, 42)
    strided = dataclasses.replace(
        refs,
        q_posture=refs.q_posture[:1].expand(B, 12),
        foot_pos_ref=refs.foot_pos_ref.transpose(1, 2).contiguous()
        .transpose(1, 2),
        h_ref=torch.stack([refs.h_ref, refs.h_ref], dim=1)[:, 0])
    assert strided.q_posture.stride(0) == 0
    assert not strided.foot_pos_ref[0].is_contiguous()
    _, got = ttsid.run_wbc_build(harness.wbc_build, TREE, CFG.wbc,
                                 wide[:, :19], wide[:, 19:37], strided)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


# ------------------------------------------------------------------ plant

@pytest.fixture(scope="module")
def plant_case():
    """Two scenarios of each kind: feet above the ground; pressed into it
    and sticking; pressed and sliding (the cone clamps, anchors drag);
    pressed and pulled off it fast (the unilateral clamp).  Candidates
    within 1e-5 of a switching surface at either substep are redrawn."""
    r = np.random.default_rng(5)
    kinds = ("above", "sticking", "sliding", "pulled off")
    picked = {k: [] for k in kinds}
    seed = 0
    while any(len(p) < 2 for p in picked.values()):
        n = 16
        q, v = random_qv(100 + seed, n, spread=0.2)
        kind = kinds[seed % 4]
        seed += 1
        if kind == "above":
            q[:, 2] += 0.03
        else:
            q[:, 2] -= r.uniform(0.002, 0.005, size=n)
            v[:, 0:6] *= 0.1
        if kind == "sliding":
            v[:, 0:2] = r.normal(size=(n, 2)) * 1.5
        if kind == "pulled off":
            v[:, 2] = r.uniform(1.5, 2.5, size=n)
        q64 = torch.tensor(q, dtype=torch.float64)
        feet = npy(tdyn.foot_positions(TREE, q64))
        st = dict(q=q, v=v,
                  anchor=feet[..., 0:2] + r.normal(size=(n, 4, 2)) * 0.002,
                  in_contact=r.integers(0, 2, size=(n, 4)).astype(float))
        params = dict(kp_n=np.full(n, 8000.0), kd_n=np.full(n, 100.0),
                      kp_t=np.full(n, 2000.0), kd_t=np.full(n, 30.0),
                      mu=r.uniform(0.3, 1.0, size=n))
        tau = r.normal(size=(n, 12)) * 0.5
        payload = r.uniform(0.0, 0.4, size=n)
        # the float32 inputs, as both dtypes will see them
        st = {k: np.asarray(a, np.float32) for k, a in st.items()}
        params = {k: np.asarray(a, np.float32) for k, a in params.items()}
        tau, payload = (np.asarray(a, np.float32) for a in (tau, payload))
        t64 = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        ok = np.ones(n, bool)
        for extra in (None, tdyn.point_mass_spatial(t64(payload))):
            s = tplant.PlantState(**{k: t64(a) for k, a in st.items()})
            p = tplant.ContactParams(**{k: t64(a) for k, a in params.items()})
            for _ in range(2):
                ok &= npy(tplant.contact_margins(TREE, s, t64(tau), 5e-4, p,
                                                 extra)[0]) > 1e-5
                s, _ = tplant.plant_step_reference(TREE, s, t64(tau), 5e-4,
                                                   1, p, extra)
        for i in np.flatnonzero(ok)[:2 - len(picked[kind])]:
            picked[kind].append(({k: a[i] for k, a in st.items()},
                                 {k: a[i] for k, a in params.items()},
                                 tau[i], payload[i]))
    rows = [row for k in kinds for row in picked[k]]
    stack = lambda i, k: np.stack([row[i][k] for row in rows])  # noqa: E731
    state = {k: stack(0, k) for k in rows[0][0]}
    params = {k: stack(1, k) for k in rows[0][1]}
    return (state, params, np.stack([row[2] for row in rows]),
            np.stack([row[3] for row in rows]))


def torch_plant(case, dtype):
    state, params, tau, payload = case
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return (tplant.PlantState(**{k: t(a) for k, a in state.items()}),
            tplant.ContactParams(**{k: t(a) for k, a in params.items()}),
            t(tau), t(payload))


def plant_close(got, want, rel, what):
    st_g, f_g = got
    st_w, f_w = want
    for name in ("q", "v", "anchor"):
        close(getattr(st_g, name), getattr(st_w, name), rel,
              f"{what} {name}")
    assert torch.equal(st_g.in_contact, st_w.in_contact), what
    close(f_g, f_w, rel, f"{what} ground forces")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_payload", [False, True])
def test_plant_step_matches_plain(harness, plant_case, dtype, with_payload):
    st, p, tau, payload = torch_plant(plant_case, dtype)
    extra = tdyn.point_mass_spatial(payload) if with_payload else None
    rc, got = tplant.run_plant_step(harness.plant_step, TREE, st, tau, 0.001,
                                    2, p, extra)
    assert rc == 0
    assert type(got[0]) is tplant.PlantState
    want = tplant.plant_step_reference(TREE, st, tau, 0.001, 2, p, extra)
    plant_close(got, want, REL[dtype], f"{dtype} payload={with_payload}")
    # the kinds were drawn: feet in and out of contact, clamped feet
    f = npy(want[1])
    in_c = npy(want[0].in_contact) > 0.5
    assert in_c.any() and (~in_c).any()
    ft = np.linalg.norm(f[..., 0:2], axis=-1)
    on_cone = np.abs(ft - npy(p.mu)[:, None] * f[..., 2]) < 1e-6 * (
        1.0 + f[..., 2])
    assert (on_cone & in_c & (f[..., 2] > 0)).any()
    assert ((f[..., 2] == 0) & in_c).any()


@pytest.mark.parametrize("with_payload", [False, True])
def test_plant_step_matches_jax(harness, plant_case, with_payload):
    """Against the JAX plant, at the port's plant budgets
    (tests/test_torch_plant.py)."""
    state, params, tau, payload = plant_case
    st_j = jplant.PlantState(**{k: jj(a) for k, a in state.items()})
    cp_j = jplant.ContactParams(**{k: jj(a) for k, a in params.items()})
    if with_payload:
        new_j, f_j = jax.vmap(lambda s, t, p, m: jplant.plant_step(
            JTREE, s, t, params=p,
            extra_base_inertia=jdyn.point_mass_spatial(m)))(
                st_j, jj(tau), cp_j, jj(payload))
    else:
        new_j, f_j = jax.vmap(lambda s, t, p: jplant.plant_step(
            JTREE, s, t, params=p))(st_j, jj(tau), cp_j)
    st, p, t_tau, t_pay = torch_plant(plant_case, torch.float32)
    extra = tdyn.point_mass_spatial(t_pay) if with_payload else None
    rc, (st_t, f_t) = tplant.run_plant_step(harness.plant_step, TREE, st,
                                            t_tau, 0.001, 2, p, extra)
    assert rc == 0
    np.testing.assert_allclose(npy(st_t.q), np.asarray(new_j.q), atol=2e-6)
    np.testing.assert_allclose(npy(st_t.v), np.asarray(new_j.v), atol=2e-4)
    np.testing.assert_allclose(npy(st_t.anchor), np.asarray(new_j.anchor),
                               atol=2e-5)
    np.testing.assert_array_equal(npy(st_t.in_contact),
                                  np.asarray(new_j.in_contact))
    np.testing.assert_allclose(npy(f_t), np.asarray(f_j), atol=5e-3)


def test_contact_margins_from_the_plain_substep(plant_case):
    """`contact_margins` reads the plain substep's own intermediates: its
    distance is never more than the feet's height above or depth below the
    ground and equals it for feet that all stand clear; its clamp flag is
    the substep's own (where it is set, the substep's velocity is the
    explicit re-solve's)."""
    st, p, tau, _ = torch_plant(plant_case, torch.float64)
    m, cl = tplant.contact_margins(TREE, st, tau, 5e-4, p)
    depth = npy(tdyn.foot_positions(TREE, st.q)[..., 2])
    assert (npy(m) <= np.abs(depth).min(axis=1)).all() and npy(cl).any()
    lifted = dataclasses.replace(st, q=st.q + torch.tensor(
        [0.0, 0.0, 0.1] + [0.0] * 16, dtype=torch.float64))
    m, cl_lifted = tplant.contact_margins(TREE, lifted, tau, 5e-4, p)
    clear = npy(tdyn.foot_positions(TREE, lifted.q)[..., 2])
    assert (clear > 0).all()
    np.testing.assert_array_equal(npy(m), clear.min(axis=1))
    assert not npy(cl_lifted).any()
    # the clamped scenarios step to another velocity when the clamp is
    # undone by a cone wide enough to hold every force
    wide = dataclasses.replace(p, mu=torch.full_like(p.mu, 1e6))
    _, cl_wide = tplant.contact_margins(TREE, st, tau, 5e-4, wide)
    v = tplant.plant_step_reference(TREE, st, tau, 5e-4, 1, p)[0].v
    v_wide = tplant.plant_step_reference(TREE, st, tau, 5e-4, 1, wide)[0].v
    moved = npy((v - v_wide).abs().amax(dim=1)) > 0
    np.testing.assert_array_equal(moved, npy(cl) & ~npy(cl_wide))


# --------------------------------------------------------------- wrappers

def test_layout_and_constants(harness):
    """The host build's layout is dyn/kernels.py's, and the packed
    constants are LegConsts' (placements, foot offsets, inertias), the
    joint axes (x, y, y) and gravity."""
    assert [harness.layout(i) for i in range(len(rbd.LAYOUT))] == \
        list(rbd.LAYOUT.values())
    C = rbd.rbd_constants(TREE, "cpu", torch.float64)
    assert tuple(C.shape) == (rbd.LAYOUT["const_size"],)
    L = tdyn.rigid_body.LegConsts(TREE, dtype=torch.float64)
    assert torch.equal(C[0:12], L.pl_hip.reshape(-1))
    assert torch.equal(C[36:48], L.foot_off.reshape(-1))
    assert torch.equal(C[120:156], L.I_lower.reshape(-1))
    assert torch.equal(C[156:192], L.I_base.reshape(-1))
    assert C[192:195].tolist() == [0.0, 1.0, 1.0]
    assert float(C[195]) == tdyn.rigid_body.GRAV
    assert rbd.rbd_constants(TREE, "cpu", torch.float64) is C


def test_wrappers_run_the_plain_bodies_on_cpu(wbc_case, plant_case):
    """On CPU tensors the wrappers, and the port's entry points through
    them, ARE the plain versions, bit for bit; nothing launches."""
    before = (ttsid.wbc_build.launches, tplant.plant_step.launches)
    q, v, refs, payload = torch_case(wbc_case, torch.float32)
    extra = tdyn.point_mass_spatial(payload)
    want = ttsid.build_wbc_qp_reference(TREE, CFG.wbc, q, v, refs, extra)
    for got in (ttsid.wbc_build(TREE, CFG.wbc, q, v, refs, extra),
                ttsid.build_wbc_qp(TREE, CFG.wbc, q, v, refs,
                                   extra_base_inertia=extra)):
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), name
    st, p, tau, payload = torch_plant(plant_case, torch.float32)
    want = tplant.plant_step_reference(TREE, st, tau, 0.001, 2, p, None)
    got = tplant.plant_step(TREE, st, tau, params=p)
    for name in ("q", "v", "anchor", "in_contact"):
        assert torch.equal(getattr(got[0], name), getattr(want[0], name))
    assert torch.equal(got[1], want[1])
    # env/plant.py supplies the default contact parameters
    default = tplant.ContactParams.default(B, device="cpu")
    got = tplant.plant_step(TREE, st, tau)
    want = tplant.plant_step_reference(TREE, st, tau, 0.001, 2, default, None)
    assert torch.equal(got[0].v, want[0].v)
    assert (ttsid.wbc_build.launches, tplant.plant_step.launches) == before


def test_wrappers_check_arguments(wbc_case, plant_case):
    q, v, refs, _ = torch_case(wbc_case, torch.float32)
    build = lambda **kw: ttsid.wbc_build(  # noqa: E731
        TREE, CFG.wbc, kw.get("q", q), kw.get("v", v), kw.get("refs", refs),
        kw.get("extra"))
    with pytest.raises(TypeError, match="float32 or float64"):
        build(q=q.half(), v=v.half())
    with pytest.raises(TypeError, match="contacts must be torch.float32"):
        build(refs=dataclasses.replace(refs, contacts=refs.contacts.double()))
    with pytest.raises(ValueError, match=r"q must be \(B, 19\)"):
        build(q=q[:, :18])
    with pytest.raises(ValueError, match="v must be"):
        build(v=v[:3])
    with pytest.raises(ValueError, match="f_mpc must be"):
        build(refs=dataclasses.replace(refs, f_mpc=refs.f_mpc[:3]))
    with pytest.raises(ValueError, match="extra_base_inertia must be"):
        build(extra=torch.zeros(B, 6, 5))
    with pytest.raises(TypeError, match="must be a torch.Tensor"):
        build(refs=dataclasses.replace(refs, h_ref=0.24))
    st, p, tau, _ = torch_plant(plant_case, torch.float32)
    with pytest.raises(TypeError, match="kp_n must be torch.float32"):
        tplant.plant_step(TREE, st, tau,
                          params=dataclasses.replace(p, kp_n=p.kp_n.double()))
    with pytest.raises(ValueError, match="substeps must be >= 1"):
        tplant.plant_step(TREE, st, tau, substeps=0, params=p)
    with pytest.raises(ValueError, match="dt must be > 0"):
        tplant.plant_step(TREE, st, tau, dt=0.0, params=p)
    with pytest.raises(ValueError, match="tau must be"):
        tplant.plant_step(TREE, st, tau[:, :6], params=p)
    with pytest.raises(ValueError, match="mu must be"):
        tplant.plant_step(TREE, st, tau,
                       params=dataclasses.replace(p, mu=p.mu[:3]))
