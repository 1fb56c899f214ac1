"""Planar biped walker (7 links, 9 DoF) on the planar engine, batched over envs.

Counterpart of ``gan_mpc_tpu/envs/walker.py``: a torso (the root, rising
from the hip) and two (thigh, shin, foot) legs, 6 bounded torque
actuators, contacts at each foot's heel and toe and at the hip and head,
and dm_control ``walker_walk``'s shaped reward (stand tall x move
forward); observation = 8 positions (root x excluded) + 9 velocities = 17.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.envs import base
from gan_mpc_tpu_torch.envs.planar import PlanarModel, step as planar_step

# bodies: torso (root), lthigh, lshin, lfoot, rthigh, rshin, rfoot
_PARENT = (-1, 0, 1, 2, 0, 4, 5)
_MASSES = np.array([3.5, 0.9, 0.6, 0.3, 0.9, 0.6, 0.3])
_ANCHORS = np.array(
    [
        [0.0, 0.0],
        [0.0, 0.0],  # left thigh at the hip (root origin)
        [0.0, -0.45],  # left shin at the thigh's end
        [0.0, -0.5],  # left foot at the shin's end
        [0.0, 0.0],  # right thigh at the hip
        [0.0, -0.45],
        [0.0, -0.5],
    ]
)
_LENGTHS = np.array([0.6, 0.45, 0.5, 0.2, 0.45, 0.5, 0.2])
# the torso's centre of mass is above the hip; the limbs extend down
_COM = np.array([[0.0, 0.3]] + [[0.0, -float(l) / 2.0] for l in _LENGTHS[1:]])
_INERTIA = _MASSES * _LENGTHS**2 / 12.0
_STIFFNESS = np.array([0.0, 30.0, 20.0, 40.0, 30.0, 20.0, 40.0])
_DAMPING = np.array([0.0, 2.0, 1.5, 1.0, 2.0, 1.5, 1.0])
_REF = np.zeros(7)
_RANGE = np.array(
    [
        [0.0, 0.0],
        [-1.0, 1.0],
        [-1.5, 0.0],
        [-0.8, 0.8],
        [-1.0, 1.0],
        [-1.5, 0.0],
        [-0.8, 0.8],
    ]
)
_GEAR = np.array([0.0, 60.0, 40.0, 20.0, 60.0, 40.0, 20.0])
# heel and toe of each foot, plus hip and head, so that a fallen body
# rests on the ground
_CONTACT_BODY = (3, 3, 6, 6, 0, 0)
_CONTACT_OFFSET = np.array(
    [[-0.06, -0.2], [0.1, -0.2], [-0.06, -0.2], [0.1, -0.2], [0.0, 0.0], [0.0, 0.6]]
)


@dataclasses.dataclass(frozen=True)
class WalkerParams:
    """The physics knobs, in the JAX ``WalkerParams``' leaf order (the
    collection fingerprint hashes them in this order)."""

    body_mass_torso: float = 3.5
    jnt_stiffness_left_hip: float = 30.0
    jnt_stiffness_right_hip: float = 30.0
    geom_size_torso: float = 1.0


class WalkerWalk:
    obs_size = 17
    act_size = 6
    dt = 0.01
    episode_steps = 1000
    name = "walker_walk"
    _substeps = 4
    _stand_height = 1.0

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._models = {}

    def default_params(self) -> WalkerParams:
        return WalkerParams()

    def model(self, params: WalkerParams) -> PlanarModel:
        """The engine model for ``params``, built once per params value:
        the torso's mass and inertia and the hips' stiffness overridden."""
        if params not in self._models:
            f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=self.device)
            masses = _MASSES.astype(np.float32)
            masses[0] = np.float32(params.body_mass_torso)
            stiff = _STIFFNESS.astype(np.float32)
            stiff[1] = np.float32(params.jnt_stiffness_left_hip)
            stiff[4] = np.float32(params.jnt_stiffness_right_hip)
            inertia = _INERTIA.astype(np.float32)
            inertia[0] = (
                np.float32(params.body_mass_torso)
                * (np.float32(params.geom_size_torso) * np.float32(_LENGTHS[0])) ** 2
                / np.float32(12.0)
            )
            self._models[params] = PlanarModel(
                parent=_PARENT,
                joint_anchor=f32(_ANCHORS),
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

    def reset(self, params: WalkerParams, num_envs: int,
              generator: torch.Generator) -> base.EnvState:
        """The hip at the legs' length (z 1.13), plus N(0, 0.005^2) noise on
        qpos and qvel; the normal draws come from ``generator`` (on the
        CPU), then move to the env's device."""
        del params
        qpos0 = torch.zeros(9)
        qpos0[1] = 1.13
        noise = torch.randn((2, num_envs, 9), generator=generator)
        return base.EnvState(
            qpos=(qpos0 + 0.005 * noise[0]).to(self.device),
            qvel=(0.005 * noise[1]).to(self.device),
            t=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
        )

    def step(self, params: WalkerParams, state: base.EnvState, action):
        u = torch.clamp(action, -1.0, 1.0)
        q, qd = planar_step(
            self.model(params), state.qpos, state.qvel, u, self.dt, self._substeps
        )
        inf = float("inf")
        torso_top = q[:, 1] + 0.6 * torch.cos(q[:, 2])
        standing = base.tolerance(
            torso_top, lower=self._stand_height, upper=inf, margin=self._stand_height / 2.0
        )
        upright = (1.0 + torch.cos(q[:, 2])) / 2.0
        stand_reward = (3.0 * standing + upright) / 4.0
        move = base.tolerance(
            qd[:, 0], lower=1.0, upper=inf, margin=1.0, sigmoid="linear", value_at_margin=0.5
        )
        reward = stand_reward * (5.0 * move + 1.0) / 6.0
        return base.EnvState(qpos=q, qvel=qd, t=state.t + 1), reward

    def observe(self, params: WalkerParams, state: base.EnvState):
        del params
        return torch.cat([state.qpos[:, 1:], state.qvel], dim=-1)
