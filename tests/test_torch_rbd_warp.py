"""The warp-per-scenario layout of the WBC-build and plant-step kernels on
the CPU.

mpctsid_tpu_torch/dyn/csrc/rbd.h cuts each kernel's per-scenario body into
per-lane units run in phases between `__syncwarp()`s; its host executor runs
the 32 lanes' units one after another (tests/_torch_port_util.py::
build_rbd_harness).  tests/test_torch_rbd_kernels.py holds that arithmetic
against the plain versions and the JAX functions; here:

  * no unit reads what another lane of its phase writes: the lanes run in
    order and reversed give the same bits (both kernels, both dtypes,
    payload on and off), from a slot filled with NaN;
  * the launch layout (`dyn/kernels.py::rbd_layout`, a pure function) on
    the H100's limits at B = 1, 37 and 4096, and equal to the header's own
    `warps_per_block` (which the launchers run) over a grid of limits; the
    slot sizes are the header's;
  * a plant case whose cone clamp takes the explicit re-solve with some
    feet clamped and other feet in contact sticking inside the cone,
    against `plant_step_reference` (float32 1e-4 of each output's largest
    entry, float64 1e-10, as the other cases) and the JAX plant (the
    budgets of test_plant_step_matches_jax); drawn at least 1e-5 from the
    contact law's switching surfaces.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.env import plant as jplant
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu_torch import dyn as tdyn
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.dyn import kernels as rbd
from mpctsid_tpu_torch.env import plant as tplant
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.wbc import tsid as ttsid

from _torch_port_util import build_rbd_harness, jj, npy, random_qv
from test_torch_rbd_kernels import (REL, plant_case, plant_close,  # noqa: F401
                                    torch_case, torch_plant, wbc_case)

CFG = EngineConfig()
TREE = build_tree(SOLO12)
JTREE = j_build_tree(J_SOLO12)
# an H100's limits: shared bytes a block may opt in to, multiprocessors
H100 = (232448, 132)
MARGIN = 1e-5


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_rbd_harness(tmp_path_factory.mktemp("rbd_warp"))


# ------------------------------------------------------- lanes in any order

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_payload", [False, True])
def test_wbc_lanes_in_either_order(harness, wbc_case, dtype, with_payload):
    q, v, refs, payload = torch_case(wbc_case, dtype)
    extra = tdyn.point_mass_spatial(payload) if with_payload else None
    for pin in (False, True):
        rc, fwd = ttsid.run_wbc_build(harness.wbc_build, TREE, CFG.wbc, q, v,
                                      refs, extra, pin)
        rc_r, rev = ttsid.run_wbc_build(harness.wbc_build_reversed, TREE,
                                        CFG.wbc, q, v, refs, extra, pin)
        assert rc == rc_r == 0
        for a, b in zip(fwd, rev):
            assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_payload", [False, True])
def test_plant_lanes_in_either_order(harness, plant_case, dtype,
                                     with_payload):
    st, p, tau, payload = torch_plant(plant_case, dtype)
    extra = tdyn.point_mass_spatial(payload) if with_payload else None
    outs = []
    for fn in (harness.plant_step, harness.plant_step_reversed):
        rc, (new, f) = tplant.run_plant_step(fn, TREE, st, tau, 0.001, 2, p,
                                             extra)
        assert rc == 0
        outs.append([new.q, new.v, new.anchor, new.in_contact, f])
    for a, b in zip(*outs):
        assert torch.isfinite(a).all() and torch.equal(a, b)


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("name", ["wbc_build", "plant_step"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 37, 4096])
def test_layout_on_the_h100(harness, name, dtype, B):
    """One warp a block while B does not fill the card's multiprocessors
    (B = 1: the launch is one warp), MAX_WARPS at B = 4096; the slot is the
    header's (2,279 build values, 2,372 plant values) rounded to 16 bytes;
    a block holds its warps' slots."""
    lay = rbd.rbd_layout(name, B, dtype, *H100)
    size = 4 if dtype == torch.float32 else 8
    assert lay.slot_bytes == -(-rbd.SLOT_VALUES[name] * size // 16) * 16
    assert lay.slot_bytes % 16 == 0
    assert lay.warps == {1: 1, 37: 1, 4096: rbd.MAX_WARPS}[B]
    assert lay.blocks == -(-B // lay.warps)
    assert lay.blocks * lay.warps >= B > (lay.blocks - 1) * lay.warps
    assert lay.smem_bytes == lay.warps * lay.slot_bytes <= H100[0]
    assert lay.warps == harness.warps_per_block(B, lay.slot_bytes, *H100)


def test_layout_is_the_headers(harness):
    """rbd_layout's warps a block equal rbd.h's warps_per_block (the
    launchers' own) over a grid of batches and limits, a ragged last block
    included; the slots are the header's structs."""
    assert harness.slot_values(0) == rbd.SLOT_VALUES["wbc_build"]
    assert harness.slot_values(1) == rbd.SLOT_VALUES["plant_step"]
    for name in rbd.SLOT_VALUES:
        for dtype in (torch.float32, torch.float64):
            for B in (1, 2, 37, 131, 132, 133, 528, 529, 4094, 4096, 100000):
                for smem, n_sm in (H100, (49152, 132), (101376, 80),
                                   (40000, 16)):
                    try:
                        lay = rbd.rbd_layout(name, B, dtype, smem, n_sm)
                    except ValueError:
                        assert harness.warps_per_block(
                            B, -(-rbd.SLOT_VALUES[name] * 8 // 16) * 16,
                            smem, n_sm) == 0
                        continue
                    assert lay.warps == harness.warps_per_block(
                        B, lay.slot_bytes, smem, n_sm), (name, B, smem)
                    assert 1 <= lay.warps <= rbd.MAX_WARPS
                    assert lay.smem_bytes <= smem


def test_layout_refuses_a_slot_that_does_not_fit(harness):
    slot = rbd.rbd_layout("plant_step", 8, torch.float64, *H100).slot_bytes
    assert rbd.rbd_layout("plant_step", 8, torch.float64, slot, 132).warps \
        == 1
    with pytest.raises(ValueError, match="does not fit"):
        rbd.rbd_layout("plant_step", 8, torch.float64, slot - 1, 132)
    assert harness.warps_per_block(8, slot, slot - 1, 132) == 0


# ------------------------------------------------- a re-solve on some feet

@pytest.fixture(scope="module")
def resolve_case():
    """Scenarios with every foot pressed into the ground and anchored, each
    foot's anchor drawn apart, a slow slide: at the first substep some feet
    are clamped to the cone (the explicit re-solve runs) while other feet
    stick inside it.  Each is at least MARGIN from a switching surface at
    both substeps, with and without the payload."""
    r = np.random.default_rng(9)
    n = 64
    q, v = random_qv(300, n, spread=0.2)
    q[:, 2] -= r.uniform(0.002, 0.005, size=n)
    v[:, 0:6] *= 0.1
    v[:, 0:2] += r.normal(size=(n, 2)) * 0.3
    feet = npy(tdyn.foot_positions(TREE, torch.tensor(q, dtype=torch.float64)))
    st = dict(q=q, v=v,
              anchor=feet[..., 0:2] + r.normal(size=(n, 4, 2)) * 0.004,
              in_contact=np.ones((n, 4)))
    params = dict(kp_n=np.full(n, 8000.0), kd_n=np.full(n, 100.0),
                  kp_t=np.full(n, 2000.0), kd_t=np.full(n, 30.0),
                  mu=r.uniform(0.3, 1.0, size=n))
    tau = r.normal(size=(n, 12)) * 0.5
    payload = r.uniform(0.0, 0.4, size=n)
    st = {k: np.asarray(a, np.float32) for k, a in st.items()}
    params = {k: np.asarray(a, np.float32) for k, a in params.items()}
    tau, payload = (np.asarray(a, np.float32) for a in (tau, payload))
    t64 = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    ok = np.ones(n, bool)
    for extra in (None, tdyn.point_mass_spatial(t64(payload))):
        s = tplant.PlantState(**{k: t64(a) for k, a in st.items()})
        p = tplant.ContactParams(**{k: t64(a) for k, a in params.items()})
        for sub in range(2):
            m, cl = tplant.contact_margins(TREE, s, t64(tau), 5e-4, p, extra)
            ok &= npy(m) > MARGIN
            s, f = tplant.plant_step_reference(TREE, s, t64(tau), 5e-4, 1, p,
                                               extra)
            if sub == 0 and extra is None:
                f = npy(f)
                ft = np.linalg.norm(f[..., 0:2], axis=-1)
                mu = params["mu"][:, None]
                inc = npy(s.in_contact) > 0.5
                on_cone = inc & (f[..., 2] > 0) & (
                    np.abs(ft - mu * f[..., 2]) < 1e-6 * (1.0 + f[..., 2]))
                inside = inc & (ft < mu * f[..., 2] - 1e-3)
                ok &= npy(cl) & on_cone.any(axis=1) & inside.any(axis=1)
    pick = np.flatnonzero(ok)[:8]
    assert len(pick) >= 4
    return ({k: a[pick] for k, a in st.items()},
            {k: a[pick] for k, a in params.items()}, tau[pick],
            payload[pick])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_payload", [False, True])
def test_plant_resolve_on_some_feet_matches_plain(harness, resolve_case,
                                                  dtype, with_payload):
    st, p, tau, payload = torch_plant(resolve_case, dtype)
    extra = tdyn.point_mass_spatial(payload) if with_payload else None
    rc, got = tplant.run_plant_step(harness.plant_step, TREE, st, tau, 0.001,
                                    2, p, extra)
    assert rc == 0
    want = tplant.plant_step_reference(TREE, st, tau, 0.001, 2, p, extra)
    plant_close(got, want, REL[dtype], f"{dtype} payload={with_payload}")


def test_plant_resolve_on_some_feet_matches_jax(harness, resolve_case):
    state, params, tau, _ = resolve_case
    st_j = jplant.PlantState(**{k: jj(a) for k, a in state.items()})
    cp_j = jplant.ContactParams(**{k: jj(a) for k, a in params.items()})
    new_j, f_j = jax.vmap(lambda s, t, p: jplant.plant_step(
        JTREE, s, t, params=p))(st_j, jj(tau), cp_j)
    st, p, t_tau, _ = torch_plant(resolve_case, torch.float32)
    rc, (st_t, f_t) = tplant.run_plant_step(harness.plant_step, TREE, st,
                                            t_tau, 0.001, 2, p, None)
    assert rc == 0
    np.testing.assert_allclose(npy(st_t.q), np.asarray(new_j.q), atol=2e-6)
    np.testing.assert_allclose(npy(st_t.v), np.asarray(new_j.v), atol=2e-4)
    np.testing.assert_allclose(npy(st_t.anchor), np.asarray(new_j.anchor),
                               atol=2e-5)
    np.testing.assert_array_equal(npy(st_t.in_contact),
                                  np.asarray(new_j.in_contact))
    np.testing.assert_allclose(npy(f_t), np.asarray(f_j), atol=5e-3)
