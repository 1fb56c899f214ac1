"""Cheetah-run on the planar engine, batched over envs.

Counterpart of ``gan_mpc_tpu/envs/cheetah.py``: observation = 8 positions
(root z, pitch, 6 leg joints; root x excluded) + 9 velocities = 17; 6
bounded torque actuators; reward ``clip(forward_speed / 10, 0, 1)``;
1000-step episodes. The imitator's domain-shift knobs are the physics
fields of ``CheetahParams``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.envs import base
from gan_mpc_tpu_torch.envs.planar import PlanarModel, step as planar_step

# Link order: torso(root), bthigh, bshin, bfoot, fthigh, fshin, ffoot.
_PARENT = (-1, 0, 1, 2, 0, 4, 5)
_LENGTHS = np.array([1.0, 0.29, 0.30, 0.19, 0.27, 0.21, 0.14])
_MASSES = np.array([6.4, 1.5, 1.6, 1.1, 1.4, 1.2, 0.9])
_ANCHORS = np.array(
    [
        [0.0, 0.0],
        [-0.5, 0.0],
        [0.0, -0.29],
        [0.0, -0.30],
        [0.5, 0.0],
        [0.0, -0.27],
        [0.0, -0.21],
    ]
)
_COM = np.array([[0.0, 0.0]] + [[0.0, -float(l) / 2.0] for l in _LENGTHS[1:]])
_INERTIA = _MASSES * _LENGTHS**2 / 12.0
_STIFFNESS = np.array([0.0, 240.0, 180.0, 120.0, 180.0, 120.0, 60.0])
_DAMPING = np.array([0.0, 6.0, 4.5, 3.0, 4.5, 3.0, 1.5])
_REF = np.array([0.0, 0.9, -0.75, 0.35, 0.0, 0.0, 0.0])
_RANGE = np.array(
    [
        [0.0, 0.0],
        [-0.52, 1.05],
        [-0.79, 0.79],
        [-0.40, 0.79],
        [-1.00, 0.70],
        [-1.20, 0.87],
        [-0.50, 0.50],
    ]
)
_GEAR = np.array([0.0, 120.0, 90.0, 60.0, 120.0, 60.0, 30.0])
_CONTACT_BODY = (3, 6, 0, 0)
_CONTACT_OFFSET = np.array([[0.0, -0.19], [0.0, -0.14], [-0.5, -0.05], [0.6, 0.05]])


@dataclasses.dataclass(frozen=True)
class CheetahParams:
    body_mass_torso: float = 6.4
    jnt_stiffness_bfoot: float = 120.0
    jnt_stiffness_ffoot: float = 60.0
    geom_size_torso: float = 1.0


class CheetahRun:
    obs_size = 17
    act_size = 6
    dt = 0.01
    episode_steps = 1000
    name = "cheetah_run"
    _substeps = 4

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._models = {}

    def default_params(self) -> CheetahParams:
        return CheetahParams()

    def model(self, params: CheetahParams) -> PlanarModel:
        """The engine model for ``params``, built once per params value."""
        if params not in self._models:
            f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=self.device)
            masses = _MASSES.astype(np.float32)
            masses[0] = np.float32(params.body_mass_torso)
            stiff = _STIFFNESS.astype(np.float32)
            stiff[3] = np.float32(params.jnt_stiffness_bfoot)
            stiff[6] = np.float32(params.jnt_stiffness_ffoot)
            scale = np.float32(params.geom_size_torso)
            anchors = _ANCHORS.astype(np.float32)
            anchors[1, 0] = -0.5 * scale
            anchors[4, 0] = 0.5 * scale
            inertia = _INERTIA.astype(np.float32)
            inertia[0] = (
                np.float32(params.body_mass_torso)
                * (scale * np.float32(_LENGTHS[0])) ** 2
                / np.float32(12.0)
            )
            self._models[params] = PlanarModel(
                parent=_PARENT,
                joint_anchor=f32(anchors),
                com_offset=f32(_COM),
                mass=f32(masses),
                inertia=f32(inertia),
                joint_stiffness=f32(stiff),
                joint_damping=f32(_DAMPING),
                joint_ref=f32(_REF),
                joint_range=f32(_RANGE),
                gear=f32(_GEAR),
                contact_body=_CONTACT_BODY,
                contact_offset=f32(_CONTACT_OFFSET),
            )
        return self._models[params]

    def reset(self, params: CheetahParams, num_envs: int,
              generator: torch.Generator) -> base.EnvState:
        """Rest pose plus N(0, 0.01^2) noise on qpos and qvel; the normal
        draws come from ``generator`` (on the CPU), then move to the env's
        device."""
        del params
        qpos0 = np.concatenate([[0.0, 0.64, 0.0], _REF[1:]]).astype(np.float32)
        noise = torch.randn((2, num_envs, 9), generator=generator)
        qpos = torch.tensor(qpos0) + 0.01 * noise[0]
        qvel = 0.01 * noise[1]
        return base.EnvState(
            qpos=qpos.to(self.device),
            qvel=qvel.to(self.device),
            t=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
        )

    def step(self, params: CheetahParams, state: base.EnvState, action):
        u = torch.clamp(action, -1.0, 1.0)
        q, qd = planar_step(
            self.model(params), state.qpos, state.qvel, u, self.dt, self._substeps
        )
        reward = base.tolerance(
            qd[:, 0], lower=10.0, upper=float("inf"), margin=10.0,
            sigmoid="linear", value_at_margin=0.0,
        )
        return base.EnvState(qpos=q, qvel=qd, t=state.t + 1), reward

    def observe(self, params: CheetahParams, state: base.EnvState):
        del params
        return torch.cat([state.qpos[:, 1:], state.qvel], dim=-1)
