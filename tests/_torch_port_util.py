"""Shared helpers of the tests/test_torch_*.py parity tests.

Inputs are made with numpy from a seed and handed to both packages: to the
JAX package as float32 jax arrays (batched with jax.vmap, as its callers do),
to the port as float32 CPU tensors with the scenario axis written out.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from mpctsid_tpu_torch.model.solo12 import SOLO12

# small shapes, several pytest workers: one intra-op thread each is fastest
torch.set_num_threads(1)

F32 = jnp.float32


def tt(a):
    """numpy -> float32 CPU tensor."""
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def jj(a):
    """numpy -> float32 jax array."""
    return jnp.asarray(np.asarray(a), F32)


def npy(t):
    """tensor or jax array -> numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def fields_to_numpy(state):
    """{field name: numpy array} of a (JAX or torch) state dataclass."""
    return {f.name: npy(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def random_qv(seed, B, spread=0.3):
    """Random full states near standing: q (B, 19) with unit quaternions, v
    (B, 18).  Feet land within a few cm of the ground plane, some below it."""
    r = np.random.default_rng(seed)
    q = np.zeros((B, 19))
    q[:, 0:2] = r.normal(size=(B, 2)) * 0.2
    q[:, 2] = SOLO12.h_ref + r.normal(size=B) * 0.01
    quat = np.concatenate([r.normal(size=(B, 3)) * 0.08, np.ones((B, 1))], 1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = SOLO12.q_stand + r.normal(size=(B, 12)) * spread * 0.5
    v = r.normal(size=(B, 18)) * spread
    return q.astype(np.float32), v.astype(np.float32)


def standing_q0(B):
    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = SOLO12.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = SOLO12.q_stand
    return q0



def random_qp(seed, n=24, m=40, eq=True):
    """The generator of tests/test_pallas_admm.py, as numpy arrays."""
    r = np.random.default_rng(seed)
    Q = r.normal(size=(n, n))
    P = Q @ Q.T / n + 0.1 * np.eye(n)
    q = r.normal(size=n)
    A = r.normal(size=(m, n))
    x_feas = r.normal(size=n) * 0.1
    margin = np.abs(r.normal(size=m)) + 0.1
    l = A @ x_feas - margin
    u = A @ x_feas + margin
    if eq:
        l[:4] = u[:4] = (A @ x_feas)[:4]
    return [np.asarray(a, np.float32) for a in (P, q, A, l, u)]


def stacked(seeds, **kw):
    qps = [random_qp(s, **kw) for s in seeds]
    return [np.stack([qp[i] for qp in qps]) for i in range(5)]
