"""Planar humanoid (13 links, 15 DoF) on the planar engine, batched over envs.

Counterpart of ``gan_mpc_tpu/envs/humanoid.py``: a pelvis root with a
waist-hinged torso and a neck-hinged head, two (thigh, shin, foot) legs
and two (upper arm, forearm) arms; 12 actuated hinges; observation = 14
positions (root x excluded) + 15 velocities = 29. Rewards follow
dm_control's ``humanoid`` domain: stand and walk variants built from
``tolerance`` terms. The ground is stiffer than the lighter envs' (kp
20000, kd 500).

Body index map (parent in brackets):
  0 pelvis(root)  1 torso[0]   2 head[1]
  3 lthigh[0]     4 lshin[3]   5 lfoot[4]
  6 rthigh[0]     7 rshin[6]   8 rfoot[7]
  9 luarm[1]     10 lfarm[9]  11 ruarm[1]  12 rfarm[11]
Hinge q indices: 3 waist, 4 neck, 5/8 hips, 6/9 knees, 7/10 ankles,
11/13 shoulders, 12/14 elbows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.envs import base
from gan_mpc_tpu_torch.envs.planar import PlanarModel, step as planar_step

_PARENT = (-1, 0, 1, 0, 3, 4, 0, 6, 7, 1, 9, 1, 11)
_MASSES = np.array([9.0, 12.0, 4.0, 4.5, 2.5, 1.0, 4.5, 2.5, 1.0, 1.5, 1.0, 1.5, 1.0])
_LENGTHS = np.array([0.2, 0.45, 0.25, 0.4, 0.4, 0.15, 0.4, 0.4, 0.15, 0.3, 0.25, 0.3, 0.25])
_ANCHORS = np.array(
    [
        [0.0, 0.0],
        [0.0, 0.1],  # torso at pelvis top (waist)
        [0.0, 0.45],  # head at torso top (neck)
        [0.0, -0.1],  # left thigh at pelvis bottom (hip)
        [0.0, -0.4],  # left shin (knee)
        [0.0, -0.4],  # left foot (ankle)
        [0.0, -0.1],  # right thigh
        [0.0, -0.4],
        [0.0, -0.4],
        [0.0, 0.4],  # left upper arm at shoulder
        [0.0, -0.3],  # left forearm (elbow)
        [0.0, 0.4],  # right upper arm
        [0.0, -0.3],
    ]
)
# pelvis COM at the root; torso and head extend up, limbs down
_COM = np.array(
    [[0.0, 0.0], [0.0, 0.225], [0.0, 0.125]] + [[0.0, -float(l) / 2.0] for l in _LENGTHS[3:]]
)
_INERTIA = _MASSES * _LENGTHS**2 / 12.0
#        (root) waist neck  hip knee ankle  hip knee ankle  sho elb  sho elb
_STIFFNESS = np.array([0.0, 60.0, 10.0, 20.0, 15.0, 60.0, 20.0, 15.0, 60.0, 10.0, 5.0, 10.0, 5.0])
_DAMPING = np.array([0.0, 5.0, 1.0, 3.0, 2.0, 3.0, 3.0, 2.0, 3.0, 1.0, 0.5, 1.0, 0.5])
_REF = np.zeros(13)
_RANGE = np.array(
    [
        [0.0, 0.0],
        [-0.8, 0.8],  # waist
        [-0.6, 0.6],  # neck
        [-1.2, 1.2],  # hips
        [-2.0, 0.0],  # knees
        [-0.9, 0.9],  # ankles
        [-1.2, 1.2],
        [-2.0, 0.0],
        [-0.9, 0.9],
        [-1.5, 1.5],  # shoulders
        [-2.0, 0.0],  # elbows
        [-1.5, 1.5],
        [-2.0, 0.0],
    ]
)
_GEAR = np.array([0.0, 100.0, 10.0, 120.0, 80.0, 50.0, 120.0, 80.0, 50.0, 25.0, 15.0, 25.0, 15.0])
# heel and toe of each foot; pelvis, head top and both elbows, so that a
# fallen body rests on the ground
_CONTACT_BODY = (5, 5, 8, 8, 0, 2, 10, 12)
_CONTACT_OFFSET = np.array(
    [
        [-0.06, -0.15],
        [0.12, -0.15],
        [-0.06, -0.15],
        [0.12, -0.15],
        [0.0, -0.1],
        [0.0, 0.25],
        [0.0, -0.25],
        [0.0, -0.25],
    ]
)


@dataclasses.dataclass(frozen=True)
class HumanoidParams:
    """The physics knobs, in the JAX ``HumanoidParams``' leaf order (the
    collection fingerprint hashes them in this order)."""

    body_mass_torso: float = 12.0
    body_mass_pelvis: float = 9.0
    jnt_stiffness_left_hip: float = 20.0
    jnt_stiffness_right_hip: float = 20.0
    geom_size_torso: float = 1.0


class _Humanoid:
    """Physics shared by the stand and walk tasks."""

    obs_size = 29
    act_size = 12
    dt = 0.01
    episode_steps = 1000
    _substeps = 4
    # standing head-top height: root z ~1.05 + pelvis 0.1 + torso 0.45 +
    # head 0.25 = 1.85; the reward asks for most of it
    _stand_height = 1.6
    _move_speed = 0.0

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._models = {}

    def default_params(self) -> HumanoidParams:
        return HumanoidParams()

    def model(self, params: HumanoidParams) -> PlanarModel:
        """The engine model for ``params``, built once per params value."""
        if params not in self._models:
            f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=self.device)
            masses = _MASSES.astype(np.float32)
            masses[0] = np.float32(params.body_mass_pelvis)
            masses[1] = np.float32(params.body_mass_torso)
            stiff = _STIFFNESS.astype(np.float32)
            stiff[3] = np.float32(params.jnt_stiffness_left_hip)
            stiff[6] = np.float32(params.jnt_stiffness_right_hip)
            inertia = _INERTIA.astype(np.float32)
            inertia[1] = (
                np.float32(params.body_mass_torso)
                * (np.float32(params.geom_size_torso) * np.float32(_LENGTHS[1])) ** 2
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
                # the 46-kg body would sink ~4 cm into the default 4 kN/m
                # springs, compliant enough to destabilize standing
                ground_kp=20000.0,
                ground_kd=500.0,
            )
        return self._models[params]

    def reset(self, params: HumanoidParams, num_envs: int,
              generator: torch.Generator) -> base.EnvState:
        """Feet on the ground (root z 1.05) plus N(0, 0.005^2) noise on
        qpos and qvel; the normal draws come from ``generator`` (on the
        CPU), then move to the env's device."""
        del params
        qpos0 = torch.zeros(15)
        qpos0[1] = 1.05
        noise = torch.randn((2, num_envs, 15), generator=generator)
        return base.EnvState(
            qpos=(qpos0 + 0.005 * noise[0]).to(self.device),
            qvel=(0.005 * noise[1]).to(self.device),
            t=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
        )

    def _head_height(self, q: torch.Tensor) -> torch.Tensor:
        """Height of the head's top (B,) from q (B, 15)."""
        torso_ang = q[:, 2] + q[:, 3]
        head_ang = torso_ang + q[:, 4]
        torso_base_z = q[:, 1] + 0.1 * torch.cos(q[:, 2])
        head_base_z = torso_base_z + 0.45 * torch.cos(torso_ang)
        return head_base_z + 0.25 * torch.cos(head_ang)

    def step(self, params: HumanoidParams, state: base.EnvState, action):
        u = torch.clamp(action, -1.0, 1.0)
        q, qd = planar_step(
            self.model(params), state.qpos, state.qvel, u, self.dt, self._substeps
        )
        inf = float("inf")
        standing = base.tolerance(
            self._head_height(q), lower=self._stand_height, upper=inf,
            margin=self._stand_height / 4.0,
        )
        upright = base.tolerance(
            torch.cos(q[:, 2] + q[:, 3]), lower=0.9, upper=inf, margin=1.9,
            sigmoid="linear", value_at_margin=0.0,
        )
        small_control = base.tolerance(
            u, margin=1.0, value_at_margin=0.0, sigmoid="quadratic"
        ).mean(-1)
        small_control = (4.0 + small_control) / 5.0
        if self._move_speed == 0.0:
            move = base.tolerance(torch.abs(qd[:, 0]), margin=2.0)
        else:
            move = base.tolerance(
                qd[:, 0], lower=self._move_speed, upper=inf, margin=self._move_speed,
                sigmoid="linear", value_at_margin=0.0,
            )
            move = (5.0 * move + 1.0) / 6.0
        reward = small_control * (standing * upright) * move
        return base.EnvState(qpos=q, qvel=qd, t=state.t + 1), reward

    def observe(self, params: HumanoidParams, state: base.EnvState):
        del params
        return torch.cat([state.qpos[:, 1:], state.qvel], dim=-1)


class HumanoidStand(_Humanoid):
    name = "humanoid_stand"
    _move_speed = 0.0


class HumanoidWalk(_Humanoid):
    name = "humanoid_walk"
    _move_speed = 1.0
