"""Torque-limited pendulum swingup, batched over envs.

Counterpart of ``gan_mpc_tpu/envs/pendulum.py`` (dm_control's
``pendulum_swingup`` to machine precision there): a point mass m = 1 at
r = 0.5 from the hinge with 0.001 inertia about its centre of mass,
actuator gear 1, joint damping 0.1 integrated implicitly (MuJoCo's Euler
integrator), semi-implicit Euler at dt = 0.02. Observation [cos th,
sin th, th_dot]; reward 1 while the pole is within 8 degrees of upright;
reset angle uniform in [-pi, pi) with zero velocity; th = 0 is upright.
The physics constants enter the step as float32, as they do in JAX.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.envs import base

_COS_BOUND = math.cos(math.radians(8.0))


@dataclasses.dataclass(frozen=True)
class PendulumParams:
    body_mass_pole: float = 1.0
    geom_size_pole: float = 0.5  # centre-of-mass distance r
    com_inertia: float = 0.001
    gravity: float = 9.81
    damping: float = 0.1
    torque_gain: float = 1.0


class PendulumSwingup:
    obs_size = 3
    act_size = 1
    dt = 0.02
    episode_steps = 1000
    name = "pendulum_swingup"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def default_params(self) -> PendulumParams:
        return PendulumParams()

    def _f32(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def reset(self, params: PendulumParams, num_envs: int,
              generator: torch.Generator) -> base.EnvState:
        """Angles uniform in [-pi, pi) drawn from ``generator`` (on the
        CPU), zero velocities, on the env's device."""
        del params
        th = (torch.rand(num_envs, generator=generator) * 2.0 - 1.0) * math.pi
        return base.EnvState(
            qpos=th[:, None].to(self.device),
            qvel=torch.zeros((num_envs, 1), device=self.device),
            t=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
        )

    def inertia(self, params: PendulumParams) -> torch.Tensor:
        """Moment of inertia about the hinge (parallel axis), float32."""
        f = self._f32
        return f(params.body_mass_pole) * f(params.geom_size_pole) ** 2 + f(params.com_inertia)

    def step(self, params: PendulumParams, state: base.EnvState, action):
        u = torch.clamp(action, -1.0, 1.0)[:, 0]
        th, thd = state.qpos[:, 0], state.qvel[:, 0]
        f = self._f32
        m, r = f(params.body_mass_pole), f(params.geom_size_pole)
        inertia = self.inertia(params)
        torque = f(params.torque_gain) * u + m * f(params.gravity) * r * torch.sin(th)
        thd = (thd + self.dt * torque / inertia) / (1.0 + self.dt * f(params.damping) / inertia)
        th = th + self.dt * thd
        new_state = base.EnvState(qpos=th[:, None], qvel=thd[:, None], t=state.t + 1)
        reward = base.tolerance(torch.cos(th), lower=_COS_BOUND, upper=1.0)
        return new_state, reward

    def observe(self, params: PendulumParams, state: base.EnvState):
        del params
        th = state.qpos[:, 0]
        return torch.stack([torch.cos(th), torch.sin(th), state.qvel[:, 0]], dim=-1)
