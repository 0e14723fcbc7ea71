"""Oracle rigid-body dynamics: FK, Jacobians, CRBA, RNEA (numpy, float64).

From-scratch replacement for the reference's Pinocchio layer (SURVEY.md §2.1
"Rigid-body dynamics": crba / nle / frameJacobian / forwardKinematics), written as
loop-based Featherstone spatial algebra over the fixed Solo-12 tree
(model/tree.py) and validated against MuJoCo (SURVEY.md §4.1).

Conventions (Pinocchio-style "local" free-flyer):
  q  = [p_base(3), quat_xyzw(4), q_joints(12)]          (19,)
  v  = [v_base_linear_LOCAL(3), w_base_LOCAL(3), qdot]  (18,)
Motion vectors internally are (w, v) pairs in BODY-LOCAL coordinates, Featherstone
[angular; linear] ordering; the generalized base rows use [linear; angular] like
Pinocchio, so base blocks are reordered at the boundary.
"""

from __future__ import annotations

import numpy as np

from mpctsid_tpu_torch.model.tree import NV, KinematicTree

GRAV = 9.81


def quat_to_rot(quat_xyzw: np.ndarray) -> np.ndarray:
    x, y, z, w = quat_xyzw
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ])


def rot_axis(axis: np.ndarray, q: float) -> np.ndarray:
    """Rodrigues rotation about a unit axis."""
    c, s = np.cos(q), np.sin(q)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def _skew(r):
    return np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])


def spatial_inertia(mass, com, inertia) -> np.ndarray:
    """6x6 spatial inertia in [angular; linear] ordering at the body frame origin."""
    C = _skew(com)
    out = np.zeros((6, 6))
    out[0:3, 0:3] = inertia + mass * (C @ C.T)
    out[0:3, 3:6] = mass * C
    out[3:6, 0:3] = mass * C.T
    out[3:6, 3:6] = mass * np.eye(3)
    return out


class DynState:
    """Per-configuration kinematic cache."""

    def __init__(self, tree: KinematicTree, q: np.ndarray):
        self.tree = tree
        self.q = q
        n = len(tree.parent)
        self.R_rel = np.zeros((n, 3, 3))   # parent <- body rotation
        self.R_w = np.zeros((n, 3, 3))     # world <- body
        self.p_w = np.zeros((n, 3))        # world position of body frame origin
        self.R_rel[0] = quat_to_rot(q[3:7])
        self.R_w[0] = self.R_rel[0]
        self.p_w[0] = q[0:3]
        for b in range(1, n):
            par = tree.parent[b]
            self.R_rel[b] = rot_axis(tree.axis[b], q[7 + b - 1])
            self.R_w[b] = self.R_w[par] @ self.R_rel[b]
            self.p_w[b] = self.p_w[par] + self.R_w[par] @ tree.placement[b]

    def foot_positions(self) -> np.ndarray:
        t = self.tree
        out = np.zeros((4, 3))
        for i in range(4):
            b = t.foot_body[i]
            out[i] = self.p_w[b] + self.R_w[b] @ t.foot_offset[i]
        return out


def _xm(R_rel, r, w, v):
    """Motion vector from parent coords to child coords; child at (R_rel, r)."""
    wc = R_rel.T @ w
    vc = R_rel.T @ (v + np.cross(w, r))
    return wc, vc


def _xf_to_parent(R_rel, r, n, f):
    """Force vector from child coords to parent coords."""
    fp = R_rel @ f
    np_ = R_rel @ n + np.cross(r, fp)
    return np_, fp


def rnea(tree: KinematicTree, st: DynState, v: np.ndarray, a: np.ndarray,
         gravity: float = GRAV) -> np.ndarray:
    """Inverse dynamics tau = M(q) a + C(q,v) v + g(q); tau is (18,).

    With a = 0 this is the nonlinear-effects vector h (Pinocchio nle)."""
    nb = len(tree.parent)
    w_ = np.zeros((nb, 3))
    vl = np.zeros((nb, 3))
    wd = np.zeros((nb, 3))
    vd = np.zeros((nb, 3))
    # base: local twist / acceleration, gravity folded into base acceleration
    w_[0] = v[3:6]
    vl[0] = v[0:3]
    wd[0] = a[3:6]
    vd[0] = a[0:3] + st.R_w[0].T @ np.array([0.0, 0.0, gravity])

    for b in range(1, nb):
        par = tree.parent[b]
        qd = v[6 + b - 1]
        qdd = a[6 + b - 1]
        ax = tree.axis[b]
        wc, vc = _xm(st.R_rel[b], tree.placement[b], w_[par], vl[par])
        w_[b] = wc + ax * qd
        vl[b] = vc
        wdc, vdc = _xm(st.R_rel[b], tree.placement[b], wd[par], vd[par])
        # velocity-product terms: v_b x (S qd)  (spatial cross of motion vectors)
        wd[b] = wdc + ax * qdd + np.cross(w_[b], ax * qd)
        vd[b] = vdc + np.cross(vl[b], ax * qd)

    n_ = np.zeros((nb, 3))
    f_ = np.zeros((nb, 3))
    for b in range(nb):
        I6 = spatial_inertia(tree.mass[b], tree.com[b], tree.inertia[b])
        mv = np.concatenate([wd[b], vd[b]])
        mom = np.concatenate([w_[b], vl[b]])
        Iv = I6 @ mom
        fb = I6 @ mv
        # v x* (I v):  [w x n + v x f ; w x f]
        fb[0:3] += np.cross(w_[b], Iv[0:3]) + np.cross(vl[b], Iv[3:6])
        fb[3:6] += np.cross(w_[b], Iv[3:6])
        n_[b] = fb[0:3]
        f_[b] = fb[3:6]

    tau = np.zeros(NV)
    for b in range(nb - 1, 0, -1):
        par = tree.parent[b]
        tau[6 + b - 1] = tree.axis[b] @ n_[b]
        nP, fP = _xf_to_parent(st.R_rel[b], tree.placement[b], n_[b], f_[b])
        n_[par] += nP
        f_[par] += fP
    tau[0:3] = f_[0]
    tau[3:6] = n_[0]
    return tau


def crba(tree: KinematicTree, st: DynState) -> np.ndarray:
    """Mass matrix M(q), (18,18), composite-rigid-body algorithm."""
    nb = len(tree.parent)
    Ic = [spatial_inertia(tree.mass[b], tree.com[b], tree.inertia[b])
          for b in range(nb)]
    # accumulate composite inertias towards the root
    for b in range(nb - 1, 0, -1):
        par = tree.parent[b]
        X = _spatial_X(st.R_rel[b], tree.placement[b])
        Ic[par] = Ic[par] + X.T @ Ic[b] @ X

    M = np.zeros((NV, NV))
    for b in range(1, nb):
        ax = tree.axis[b]
        S = np.concatenate([ax, np.zeros(3)])
        F = Ic[b] @ S
        j = 6 + b - 1
        M[j, j] = S @ F
        # walk up the tree
        bb = b
        Fv = F.copy()
        while tree.parent[bb] != 0 and tree.parent[bb] != -1:
            par = tree.parent[bb]
            nP, fP = _xf_to_parent(st.R_rel[bb], tree.placement[bb],
                                   Fv[0:3], Fv[3:6])
            Fv = np.concatenate([nP, fP])
            i = 6 + par - 1
            Si = np.concatenate([tree.axis[par], np.zeros(3)])
            M[i, j] = M[j, i] = Si @ Fv
            bb = par
        # transform into the base frame for the coupling block
        nP, fP = _xf_to_parent(st.R_rel[bb], tree.placement[bb],
                               Fv[0:3], Fv[3:6])
        # base generalized rows are [linear; angular]
        M[0:3, j] = M[j, 0:3] = fP
        M[3:6, j] = M[j, 3:6] = nP

    # base 6x6 block: composite spatial inertia reordered to [lin; ang]
    I0 = Ic[0]
    M[0:3, 0:3] = I0[3:6, 3:6]
    M[0:3, 3:6] = I0[3:6, 0:3]
    M[3:6, 0:3] = I0[0:3, 3:6]
    M[3:6, 3:6] = I0[0:3, 0:3]
    return M


def _spatial_X(R_rel, r) -> np.ndarray:
    """6x6 motion transform child <- parent in [ang; lin] ordering."""
    X = np.zeros((6, 6))
    Rt = R_rel.T
    X[0:3, 0:3] = Rt
    X[3:6, 3:6] = Rt
    X[3:6, 0:3] = Rt @ _skew(r).T  # v_c = R'(v + w x r) = R' v - R' skew(r) w
    return X


def foot_jacobian(tree: KinematicTree, st: DynState, leg: int) -> np.ndarray:
    """(3,18) world-frame linear-velocity Jacobian of the foot point."""
    b = tree.foot_body[leg]
    p_foot = st.p_w[b] + st.R_w[b] @ tree.foot_offset[leg]
    J = np.zeros((3, NV))
    # base columns: v_foot = R0 (v_local + w_local x r_local)
    R0 = st.R_w[0]
    r_local = R0.T @ (p_foot - st.p_w[0])
    J[:, 0:3] = R0
    J[:, 3:6] = -R0 @ _skew(r_local)
    # joint columns along the supporting chain
    bb = b
    while tree.parent[bb] != -1:
        ax_w = st.R_w[bb] @ tree.axis[bb]
        J[:, 6 + bb - 1] = np.cross(ax_w, p_foot - st.p_w[bb])
        bb = tree.parent[bb]
        if bb == 0:
            break
    return J


def foot_drift(tree: KinematicTree, st: DynState, v: np.ndarray,
               leg: int) -> np.ndarray:
    """(3,) world-frame Jdot @ v for the foot point (classical acceleration with
    qdd = 0 and gravity off)."""
    nb = len(tree.parent)
    w_w = np.zeros((nb, 3))     # world angular velocity
    vw = np.zeros((nb, 3))      # world linear velocity of body origin
    al = np.zeros((nb, 3))      # world angular acceleration (qdd = 0)
    aw = np.zeros((nb, 3))      # world classical acceleration of body origin
    R0 = st.R_w[0]
    w_w[0] = R0 @ v[3:6]
    vw[0] = R0 @ v[0:3]
    # constant LOCAL twist => classical base acceleration Rdot v_loc = R (w x v)
    aw[0] = R0 @ np.cross(v[3:6], v[0:3])
    for b in range(1, nb):
        par = tree.parent[b]
        r = st.p_w[b] - st.p_w[par]
        qd = v[6 + b - 1]
        ax_w = st.R_w[b] @ tree.axis[b]
        w_w[b] = w_w[par] + ax_w * qd
        vw[b] = vw[par] + np.cross(w_w[par], r)
        al[b] = al[par] + np.cross(w_w[par], ax_w * qd)
        aw[b] = (aw[par] + np.cross(al[par], r)
                 + np.cross(w_w[par], np.cross(w_w[par], r)))
    b = tree.foot_body[leg]
    r = st.R_w[b] @ tree.foot_offset[leg]
    return (aw[b] + np.cross(al[b], r)
            + np.cross(w_w[b], np.cross(w_w[b], r)))


def foot_velocity(tree: KinematicTree, st: DynState, v: np.ndarray,
                  leg: int) -> np.ndarray:
    return foot_jacobian(tree, st, leg) @ v


def integrate_q(q: np.ndarray, v: np.ndarray, dt: float) -> np.ndarray:
    """Integrate a generalized velocity (local convention) over dt."""
    out = q.copy()
    R0 = quat_to_rot(q[3:7])
    out[0:3] = q[0:3] + R0 @ v[0:3] * dt
    # quaternion integration: exp of local angular velocity
    w = v[3:6] * dt
    th = np.linalg.norm(w)
    if th < 1e-12:
        dq = np.array([0.5 * w[0], 0.5 * w[1], 0.5 * w[2], 1.0])
    else:
        ax = w / th
        dq = np.concatenate([ax * np.sin(th / 2.0), [np.cos(th / 2.0)]])
    x1, y1, z1, w1 = q[3:7]
    x2, y2, z2, w2 = dq
    out[3:7] = np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])
    out[3:7] /= np.linalg.norm(out[3:7])
    out[7:] = q[7:] + v[6:] * dt
    return out
