"""Batched rigid-body dynamics for the fixed Solo-12 topology (counterpart of
the JAX package's dyn/rigid_body.py; same conventions, batch written out).

  q = [p_base(3), quat_xyzw(4), q_joints(12)]            (B, 19)
  v = [v_base_linear_LOCAL(3), w_base_LOCAL(3), qdot(12)] (B, 18)

The four legs are IDENTICAL base->HAA->HFE->KFE chains (model/tree.py), so
every per-body recursion is computed for all four legs at once: per-leg
quantities carry the axes (B, 4, ...).  The mass matrix is exactly block-
structured: dense 6x6 base block, 6x12 base-leg coupling, and a block-diagonal
12x12 joint block (legs only couple through the base).

Constants.  `LegConsts` is an `nn.Module` whose buffers hold the leg
placements and spatial inertias on one device in one dtype; `_consts` builds
it once per (tree, device, dtype), so no call copies constants from the host.
Every tensor a function creates takes dtype and device from its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from mpctsid_tpu_torch.model.tree import KinematicTree

GRAV = 9.81

__all__ = ["GRAV", "LegConsts", "LegKin", "quat_to_rot", "rot_to_rpy", "fk",
           "foot_positions", "point_mass_spatial", "rnea", "crba",
           "foot_jacobians", "foot_velocities", "foot_drifts", "integrate_q"]


# ---------------------------------------------------------------- constants

def _spatial_inertia(tree: KinematicTree, b: int) -> np.ndarray:
    m = tree.mass[b]
    c = tree.com[b]
    C = np.array([[0.0, -c[2], c[1]], [c[2], 0.0, -c[0]], [-c[1], c[0], 0.0]])
    out = np.zeros((6, 6))
    out[0:3, 0:3] = tree.inertia[b] + m * (C @ C.T)
    out[0:3, 3:6] = m * C
    out[3:6, 0:3] = m * C.T
    out[3:6, 3:6] = m * np.eye(3)
    return out


class LegConsts(torch.nn.Module):
    """Constants describing the 4 identical leg chains, as device buffers."""

    def __init__(self, tree: KinematicTree, device="cpu",
                 dtype=torch.float32):
        super().__init__()
        for b in (4, 7, 10):
            assert np.allclose(_spatial_inertia(tree, b),
                               _spatial_inertia(tree, 1))

        def buf(name, arr):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(arr), dtype=dtype,
                                      device=device), persistent=False)

        # per-level placements in the parent frame, (4, 3)
        buf("pl_hip", tree.placement[[1, 4, 7, 10]])
        buf("pl_upper", tree.placement[[2, 5, 8, 11]])
        buf("pl_lower", tree.placement[[3, 6, 9, 12]])
        buf("foot_off", tree.foot_offset)
        # per-level spatial inertias (shared across legs), (6, 6)
        buf("I_hip", _spatial_inertia(tree, 1))
        buf("I_upper", _spatial_inertia(tree, 2))
        buf("I_lower", _spatial_inertia(tree, 3))
        buf("I_base", _spatial_inertia(tree, 0))
        buf("eye4", np.eye(4))


_CONSTS_CACHE: dict = {}


def _consts(tree_or_consts, like: torch.Tensor) -> LegConsts:
    """LegConsts on `like`'s device and dtype, built once per tree."""
    if isinstance(tree_or_consts, LegConsts):
        return tree_or_consts
    key = (id(tree_or_consts), like.device, like.dtype)
    C = _CONSTS_CACHE.get(key)
    if C is None:
        C = LegConsts(tree_or_consts, device=like.device, dtype=like.dtype)
        # the tree is kept alive beside its constants so that its id stays its
        C._tree = tree_or_consts
        _CONSTS_CACHE[key] = C
    return C


# ------------------------------------------------------------ small helpers

def quat_to_rot(quat_xyzw):
    """(..., 4) xyzw quaternions -> (..., 3, 3) rotations."""
    x, y, z, w = quat_xyzw.unbind(-1)
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n
    return torch.stack([
        torch.stack([1 - s * (y * y + z * z), s * (x * y - w * z),
                     s * (x * z + w * y)], -1),
        torch.stack([s * (x * y + w * z), 1 - s * (x * x + z * z),
                     s * (y * z - w * x)], -1),
        torch.stack([s * (x * z - w * y), s * (y * z + w * x),
                     1 - s * (x * x + y * y)], -1),
    ], -2)


def rot_to_rpy(R):
    """(..., 3, 3) rotations -> (..., 3) roll, pitch, yaw."""
    return torch.stack([
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
        -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0)),
        torch.atan2(R[..., 1, 0], R[..., 0, 0]),
    ], -1)


def _rx(q):
    """(...,) angles -> (..., 3, 3) rotations about +x."""
    c, s = torch.cos(q), torch.sin(q)
    z = torch.zeros_like(q)
    o = torch.ones_like(q)
    return torch.stack([
        torch.stack([o, z, z], -1),
        torch.stack([z, c, -s], -1),
        torch.stack([z, s, c], -1),
    ], -2)


def _ry(q):
    """(...,) angles -> (..., 3, 3) rotations about +y."""
    c, s = torch.cos(q), torch.sin(q)
    z = torch.zeros_like(q)
    o = torch.ones_like(q)
    return torch.stack([
        torch.stack([c, z, s], -1),
        torch.stack([z, o, z], -1),
        torch.stack([-s, z, c], -1),
    ], -2)


def _T(A):
    return A.transpose(-1, -2)


def _mv(A, x):
    """Broadcasting (..., r, c) @ (..., c) -> (..., r)."""
    return (A @ x[..., None])[..., 0]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _skew(r):
    """(..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], z, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], z], -1),
    ], -2)


class LegKin:
    """Per-configuration leg-batched kinematics cache (all (B, 4, ...))."""

    __slots__ = ("R0", "p0", "Rr_hip", "Rr_upper", "Rr_lower",
                 "R_hip", "R_upper", "R_lower",
                 "p_hip", "p_upper", "p_lower", "p_foot", "C")

    def __init__(self, C: LegConsts, q):
        B = q.shape[0]
        self.C = C
        self.R0 = quat_to_rot(q[:, 3:7])                    # (B, 3, 3)
        self.p0 = q[:, 0:3]
        ql = q[:, 7:].reshape(B, 4, 3)
        self.Rr_hip = _rx(ql[..., 0])                       # (B, 4, 3, 3)
        self.Rr_upper = _ry(ql[..., 1])
        self.Rr_lower = _ry(ql[..., 2])
        R0l = self.R0[:, None]                              # (B, 1, 3, 3)
        self.R_hip = R0l @ self.Rr_hip
        self.p_hip = self.p0[:, None] + _mv(R0l, C.pl_hip)
        self.R_upper = self.R_hip @ self.Rr_upper
        self.p_upper = self.p_hip + _mv(self.R_hip, C.pl_upper)
        self.R_lower = self.R_upper @ self.Rr_lower
        self.p_lower = self.p_upper + _mv(self.R_upper, C.pl_lower)
        self.p_foot = self.p_lower + _mv(self.R_lower, C.foot_off)


def _leg_levels(C: LegConsts, k: LegKin):
    """(placement (4,3), joint-axis index, R_rel (B,4,3,3), inertia (6,6)) per
    level, root-first.  HAA turns about +x (index 0), HFE/KFE about +y (1)."""
    return (
        (C.pl_hip, 0, k.Rr_hip, C.I_hip),
        (C.pl_upper, 1, k.Rr_upper, C.I_upper),
        (C.pl_lower, 1, k.Rr_lower, C.I_lower),
    )


def _axis_times(ax: int, s):
    """Unit axis e_ax scaled by s (..., ) -> (..., 3)."""
    out = s.new_zeros(s.shape + (3,))
    out[..., ax] = s
    return out


def foot_positions(tree_or_consts, q):
    """(B, 4, 3) world foot positions."""
    return LegKin(_consts(tree_or_consts, q), q).p_foot


def fk(tree_or_consts, q):
    """Compatibility helper: returns the LegKin cache."""
    return LegKin(_consts(tree_or_consts, q), q)


def point_mass_spatial(m, r=None):
    """(B, 6, 6) spatial inertia ([ang; lin] convention) of point masses
    m (B,) rigidly attached to the base at offset r (B, 3) (default: the base
    origin).  This is the per-scenario LOAD perturbation hook: m is data."""
    B = m.shape[0]
    out = m.new_zeros((B, 6, 6))
    out[:, 3, 3] = m
    out[:, 4, 4] = m
    out[:, 5, 5] = m
    if r is not None:
        S = _skew(r.to(m.dtype))
        mm = m[:, None, None]
        out[:, 0:3, 0:3] = mm * (S @ _T(S))
        out[:, 0:3, 3:6] = mm * S
        out[:, 3:6, 0:3] = mm * _T(S)
    return out


def rnea(tree_or_consts, q, v, a, gravity: float = GRAV,
         extra_base_inertia=None):
    """tau (B, 18) = M(q) a + C(q, v) v + g(q);  a = 0 gives the bias vector.

    extra_base_inertia: optional (B, 6, 6) spatial inertia added to the base
    body (payload perturbations; see point_mass_spatial)."""
    C = _consts(tree_or_consts, q)
    k = LegKin(C, q)
    B = q.shape[0]
    qd = v[:, 6:].reshape(B, 4, 3)
    qdd = a[:, 6:].reshape(B, 4, 3)

    # base (local coords); R0' [0, 0, g] is g times the third ROW of R0
    w0, v0 = v[:, 3:6], v[:, 0:3]
    wd0 = a[:, 3:6]
    vd0 = a[:, 0:3] + gravity * k.R0[:, 2, :]

    # forward pass, batched over legs
    w_par = w0[:, None].expand(B, 4, 3)
    v_par = v0[:, None].expand(B, 4, 3)
    wd_par = wd0[:, None].expand(B, 4, 3)
    vd_par = vd0[:, None].expand(B, 4, 3)
    lv = []
    for lvl, (pl, ax, Rr, I6) in enumerate(_leg_levels(C, k)):
        RrT = _T(Rr)
        wc = _mv(RrT, w_par)
        vc = _mv(RrT, v_par + _cross(w_par, pl))
        s_qd = _axis_times(ax, qd[..., lvl])
        w_b = wc + s_qd
        v_b = vc
        wdc = _mv(RrT, wd_par)
        vdc = _mv(RrT, vd_par + _cross(wd_par, pl))
        wd_b = wdc + _axis_times(ax, qdd[..., lvl]) + _cross(w_b, s_qd)
        vd_b = vdc + _cross(v_b, s_qd)
        lv.append((w_b, v_b, wd_b, vd_b, I6, Rr, pl, ax))
        w_par, v_par, wd_par, vd_par = w_b, v_b, wd_b, vd_b

    # body wrenches: f = I a + v x* I v
    def wrench(w, vl, wd, vd, I6):
        mom = torch.cat([w, vl], dim=-1)
        acc = torch.cat([wd, vd], dim=-1)
        Iv = _mv(I6, mom)
        fb = _mv(I6, acc)
        n = (fb[..., 0:3] + _cross(w, Iv[..., 0:3])
             + _cross(vl, Iv[..., 3:6]))
        f = fb[..., 3:6] + _cross(w, Iv[..., 3:6])
        return n, f

    I_base = C.I_base
    if extra_base_inertia is not None:
        I_base = I_base + extra_base_inertia
    n0, f0 = wrench(w0, v0, wd0, vd0, I_base)

    # backward pass over the 3 levels
    taus = [None, None, None]
    n_child = f_child = None
    for lvl in range(2, -1, -1):
        w_b, v_b, wd_b, vd_b, I6, Rr, pl, ax = lv[lvl]
        n_b, f_b = wrench(w_b, v_b, wd_b, vd_b, I6)
        if n_child is not None:
            n_b = n_b + n_child
            f_b = f_b + f_child
        taus[lvl] = n_b[..., ax]
        # transform into parent coords
        fP = _mv(Rr, f_b)
        nP = _mv(Rr, n_b) + _cross(pl, fP)
        n_child, f_child = nP, fP

    n0 = n0 + n_child.sum(dim=1)
    f0 = f0 + f_child.sum(dim=1)
    tau_j = torch.stack(taus, dim=-1).reshape(B, 12)
    return torch.cat([f0, n0, tau_j], dim=-1)


def crba(tree_or_consts, q, extra_base_inertia=None):
    """Mass matrix M(q) (B, 18, 18): dense base block, 6x12 coupling,
    block-diagonal legs.

    extra_base_inertia: optional (B, 6, 6) base-body spatial inertia addend
    (payload perturbations; see point_mass_spatial)."""
    C = _consts(tree_or_consts, q)
    k = LegKin(C, q)
    B = q.shape[0]

    def spatial_X(Rr, pl):
        """(B, 4, 6, 6) motion transform child <- parent; pl is (4, 3)."""
        RrT = _T(Rr)
        zero = torch.zeros_like(RrT)
        top = torch.cat([RrT, zero], dim=-1)
        bot = torch.cat([RrT @ _T(_skew(pl)), RrT], dim=-1)
        return torch.cat([top, bot], dim=-2)

    # composite inertias per level, (B, 4, 6, 6)
    Ic_lower = C.I_lower.expand(B, 4, 6, 6)
    X_lower = spatial_X(k.Rr_lower, C.pl_lower)
    Ic_upper = C.I_upper + _T(X_lower) @ Ic_lower @ X_lower
    X_upper = spatial_X(k.Rr_upper, C.pl_upper)
    Ic_hip = C.I_hip + _T(X_upper) @ Ic_upper @ X_upper
    X_hip = spatial_X(k.Rr_hip, C.pl_hip)
    Ic_base = C.I_base + (_T(X_hip) @ Ic_hip @ X_hip).sum(dim=1)
    if extra_base_inertia is not None:
        Ic_base = Ic_base + extra_base_inertia

    def xf_to_parent(Rr, pl, F):
        """(B, 4, 6) child-frame force -> parent frame."""
        fP = _mv(Rr, F[..., 3:6])
        nP = _mv(Rr, F[..., 0:3]) + _cross(pl, fP)
        return torch.cat([nP, fP], dim=-1)

    # The joint motion subspaces are unit vectors: S_haa = e_0, S_hfe = e_1
    # (angular part), so I S is a COLUMN of I and S' F a COMPONENT of F.
    HAA, HFE = 0, 1
    # KFE column
    F_k = Ic_lower[..., :, HFE]                              # (B, 4, 6)
    m_kk = F_k[..., HFE]
    F_k_up = xf_to_parent(k.Rr_lower, C.pl_lower, F_k)
    m_hk = F_k_up[..., HFE]
    F_k_hip = xf_to_parent(k.Rr_upper, C.pl_upper, F_k_up)
    m_ak = F_k_hip[..., HAA]
    F_k_base = xf_to_parent(k.Rr_hip, C.pl_hip, F_k_hip)
    # HFE column
    F_h = Ic_upper[..., :, HFE]
    m_hh = F_h[..., HFE]
    F_h_hip = xf_to_parent(k.Rr_upper, C.pl_upper, F_h)
    m_ah = F_h_hip[..., HAA]
    F_h_base = xf_to_parent(k.Rr_hip, C.pl_hip, F_h_hip)
    # HAA column
    F_a = Ic_hip[..., :, HAA]
    m_aa = F_a[..., HAA]
    F_a_base = xf_to_parent(k.Rr_hip, C.pl_hip, F_a)

    # block-diagonal joint block (B, 12, 12): M_jj[3l+i, 3k+j] = [l==k] blk
    blocks = torch.stack([
        torch.stack([m_aa, m_ah, m_ak], -1),
        torch.stack([m_ah, m_hh, m_hk], -1),
        torch.stack([m_ak, m_hk, m_kk], -1),
    ], -2)                                                   # (B, 4, 3, 3)
    M_jj = torch.einsum("lk,blij->blikj", C.eye4, blocks).reshape(B, 12, 12)

    # base coupling: spatial forces in the base frame -> rows [lin; ang]
    cols = torch.stack([F_a_base, F_h_base, F_k_base], dim=2)  # (B, 4, 3, 6)
    cols = torch.cat([cols[..., 3:6], cols[..., 0:3]], dim=-1)
    M_bj = _T(cols.reshape(B, 12, 6))                         # (B, 6, 12)

    # base 6x6: [ang; lin] spatial inertia -> [lin; ang] generalized
    M_bb = torch.cat([
        torch.cat([Ic_base[:, 3:6, 3:6], Ic_base[:, 3:6, 0:3]], dim=2),
        torch.cat([Ic_base[:, 0:3, 3:6], Ic_base[:, 0:3, 0:3]], dim=2),
    ], dim=1)

    top = torch.cat([M_bb, M_bj], dim=2)
    bot = torch.cat([_T(M_bj), M_jj], dim=2)
    return torch.cat([top, bot], dim=1)


def foot_jacobians(tree_or_consts, q):
    """(B, 4, 3, 18) world-frame linear-velocity Jacobians of the four feet.

    Joint columns are only filled for each foot's own leg (block structure)."""
    C = _consts(tree_or_consts, q)
    k = LegKin(C, q)
    B = q.shape[0]
    R0 = k.R0
    p_foot = k.p_foot
    # base columns
    r_local = _mv(_T(R0)[:, None], p_foot - k.p0[:, None])   # (B, 4, 3)
    base_lin = R0[:, None].expand(B, 4, 3, 3)
    base_ang = -(base_lin @ _skew(r_local))
    # joint columns (own leg only); world joint axes are columns of R
    ax_haa = k.R_hip[..., :, 0]
    ax_hfe = k.R_upper[..., :, 1]
    ax_kfe = k.R_lower[..., :, 1]
    col_haa = _cross(ax_haa, p_foot - k.p_hip)
    col_hfe = _cross(ax_hfe, p_foot - k.p_upper)
    col_kfe = _cross(ax_kfe, p_foot - k.p_lower)
    leg_cols = torch.stack([col_haa, col_hfe, col_kfe], dim=-1)  # (B,4,3,3)
    # scatter leg columns into the (B, 4, 3, 12) block-diagonal layout
    joint_cols = torch.einsum("lk,blij->blikj", C.eye4,
                              leg_cols).reshape(B, 4, 3, 12)
    return torch.cat([base_lin, base_ang, joint_cols], dim=-1)


def foot_velocities(tree_or_consts, q, v):
    """(B, 4, 3) world foot velocities J v."""
    J = foot_jacobians(tree_or_consts, q)
    return _mv(J, v[:, None])


def foot_drifts(tree_or_consts, q, v):
    """(B, 4, 3) world-frame Jdot v per foot (classical accel, qdd = 0,
    gravity off)."""
    C = _consts(tree_or_consts, q)
    k = LegKin(C, q)
    B = q.shape[0]
    R0 = k.R0
    qd = v[:, 6:].reshape(B, 4, 3)
    w_par = _mv(R0, v[:, 3:6])[:, None].expand(B, 4, 3)
    v_par = _mv(R0, v[:, 0:3])[:, None].expand(B, 4, 3)
    a_par = _mv(R0, _cross(v[:, 3:6], v[:, 0:3]))[:, None].expand(B, 4, 3)
    al_par = q.new_zeros((B, 4, 3))
    p_par = k.p0[:, None].expand(B, 4, 3)
    Rws = (k.R_hip, k.R_upper, k.R_lower)
    ps = (k.p_hip, k.p_upper, k.p_lower)
    axes = (0, 1, 1)
    for lvl in range(3):
        r = ps[lvl] - p_par
        ax_w = Rws[lvl][..., :, axes[lvl]]
        s_qd = ax_w * qd[..., lvl:lvl + 1]
        w_b = w_par + s_qd
        v_b = v_par + _cross(w_par, r)
        al_b = al_par + _cross(w_par, s_qd)
        a_b = (a_par + _cross(al_par, r)
               + _cross(w_par, _cross(w_par, r)))
        w_par, v_par, al_par, a_par, p_par = w_b, v_b, al_b, a_b, ps[lvl]
    r = k.p_foot - k.p_lower
    return (a_par + _cross(al_par, r)
            + _cross(w_par, _cross(w_par, r)))


def integrate_q(q, v, dt):
    """Integrate generalized velocity (local convention) over dt; (B, 19)."""
    R0 = quat_to_rot(q[:, 3:7])
    p = q[:, 0:3] + _mv(R0, v[:, 0:3]) * dt
    w = v[:, 3:6] * dt
    th2 = (w * w).sum(dim=-1, keepdim=True)
    th = torch.sqrt(th2 + 1e-30)
    half = th / 2.0
    sinc_half = torch.where(th < 1e-8, 0.5 - th2 / 48.0, torch.sin(half) / th)
    dq = torch.cat([w * sinc_half, torch.cos(half)], dim=-1)
    x1, y1, z1, w1 = q[:, 3], q[:, 4], q[:, 5], q[:, 6]
    x2, y2, z2, w2 = dq.unbind(-1)
    quat = torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    return torch.cat([p, quat, q[:, 7:] + v[:, 6:] * dt], dim=-1)
