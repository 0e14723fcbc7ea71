"""Plant interface protocol: the slot a hardware bridge and the simulated
plant share (counterpart of the JAX package's env/interface.py).

The protocol is host-side and imperative (a real robot is a stateful 1 kHz
device, not a pure function), while the simulated implementation wraps the
functional `plant_step` at B = 1.  Batched rollouts (cascade/engine.py)
bypass it and call `plant_step` directly; the protocol exists for
single-robot host-loop deployment and hardware bring-up.  PyTorch runs
eagerly, so there is no compiled step to share between instances.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from mpctsid_tpu_torch.env.plant import ContactParams, PlantState, plant_step
from mpctsid_tpu_torch.est.filter import imu_from_plant
from mpctsid_tpu_torch.model.tree import KinematicTree
from mpctsid_tpu_torch.utils import resolve_device

__all__ = ["Sensors", "Plant", "SimPlant"]


@dataclasses.dataclass
class Sensors:
    """What one control tick may read (IMU + joint encoders)."""

    q: torch.Tensor          # (19,) base pose + joint positions
    v: torch.Tensor          # (18,) base twist + joint velocities
    gyro: torch.Tensor       # (3,) base angular velocity, body frame
    accel: torch.Tensor      # (3,) specific force, body frame
    q_joints: torch.Tensor   # (12,)
    qd_joints: torch.Tensor  # (12,)


@runtime_checkable
class Plant(Protocol):
    """One robot (or one simulated robot) driven at the WBC rate.

    read() returns the latest sensor snapshot; apply(tau) commands the next
    joint torques and advances the plant by one WBC tick (1 ms)."""

    def read(self) -> Sensors: ...

    def apply(self, tau: torch.Tensor) -> None: ...


class SimPlant:
    """`Plant` implementation backed by the batched plant at B = 1."""

    def __init__(self, tree: KinematicTree, q0,
                 params: ContactParams | None = None, dt: float = 1e-3,
                 device="cuda", dtype=torch.float32):
        dev = resolve_device(device)
        self.tree = tree
        q0 = torch.as_tensor(q0, dtype=dtype).reshape(1, 19)
        self.state = PlantState.init(q0, device=dev, dtype=dtype)
        self.params = params or ContactParams.default(1, device=dev,
                                                      dtype=dtype)
        self.dt = dt

    def read(self) -> Sensors:
        q, v = self.state.q, self.state.v
        gyro, accel = imu_from_plant(self.tree, q, v)
        return Sensors(q=q[0], v=v[0], gyro=gyro[0], accel=accel[0],
                       q_joints=q[0, 7:], qd_joints=v[0, 6:])

    def apply(self, tau) -> None:
        tau = torch.as_tensor(tau, dtype=self.state.q.dtype).to(
            self.state.q.device).reshape(1, 12)
        self.state, _ = plant_step(self.tree, self.state, tau, dt=self.dt,
                                   params=self.params)
