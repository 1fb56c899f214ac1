"""Cart-pole balance, batched over envs.

Counterpart of ``gan_mpc_tpu/envs/cartpole.py`` (dm_control's cartpole
to machine precision there): a cart of mass 1 sliding on x under a force
of gain 10, a pole of mass 0.1 with its centre of mass at r = 0.5 from
the hinge and 0.00942459 inertia about it, joint dampings (5e-4, 2e-6)
applied explicitly inside each stage of the classic RK4 step on (q, v)
(MuJoCo's ``mj_RungeKutta``, control held constant), dt = 0.01, 1000-step
episodes. Observation [cart_x, cos th, sin th, cart_xd, th_d]; th = 0 is
upright. Reward and reset follow dm_control's ``cartpole.Balance``.

Mass matrix of the (x, th) system and its bias force:
    M = [[mc + mp,        mp r cos th ],
         [mp r cos th,    mp r^2 + Ic ]]
    bias = [-mp r sin th * thd^2, -mp g r sin th]
The physics constants enter the step as float32, as they do in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from gan_mpc_tpu_torch import resolve_device
from gan_mpc_tpu_torch.envs import base


@dataclasses.dataclass(frozen=True)
class CartpoleParams:
    """The physics knobs, in the JAX ``CartpoleParams``' leaf order (the
    collection fingerprint hashes them in this order)."""

    body_mass_cart: float = 1.0
    body_mass_pole_1: float = 0.1
    geom_size_pole_1: float = 0.5  # centre-of-mass distance r
    pole_com_inertia: float = 0.00942459
    gravity: float = 9.81
    force_gain: float = 10.0
    damping_slider: float = 5.0e-4
    damping_hinge: float = 2.0e-6


class CartpoleBalance:
    obs_size = 5
    act_size = 1
    dt = 0.01
    episode_steps = 1000
    name = "cartpole_balance"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def default_params(self) -> CartpoleParams:
        return CartpoleParams()

    def _f32(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def reset(self, params: CartpoleParams, num_envs: int,
              generator: torch.Generator) -> base.EnvState:
        """dm_control's balance start: slider uniform in (-0.1, 0.1), hinge
        uniform in (-0.034, 0.034), velocities 0.01 N(0, 1); the draws come
        from ``generator`` (on the CPU), then move to the env's device."""
        del params
        x = torch.rand(num_envs, generator=generator) * 0.2 - 0.1
        th = torch.rand(num_envs, generator=generator) * 0.068 - 0.034
        qvel = 0.01 * torch.randn((num_envs, 2), generator=generator)
        return base.EnvState(
            qpos=torch.stack([x, th], dim=-1).to(self.device),
            qvel=qvel.to(self.device),
            t=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
        )

    def step(self, params: CartpoleParams, state: base.EnvState, action):
        u = torch.clamp(action, -1.0, 1.0)[:, 0]
        f = self._f32
        mc, mp = f(params.body_mass_cart), f(params.body_mass_pole_1)
        r, g = f(params.geom_size_pole_1), f(params.gravity)
        pole_inertia = mp * r ** 2 + f(params.pole_com_inertia)
        h = f(self.dt)
        tau = torch.stack([f(params.force_gain) * u, torch.zeros_like(u)], dim=-1)
        damping = torch.stack([f(params.damping_slider), f(params.damping_hinge)])

        def deriv(q, v):
            th, thd = q[:, 1], v[:, 1]
            sin, cos = torch.sin(th), torch.cos(th)
            off = mp * r * cos
            M = torch.stack([torch.stack([(mc + mp).expand_as(off), off], -1),
                             torch.stack([off, pole_inertia.expand_as(off)], -1)], -2)
            bias = torch.stack([-mp * r * sin * thd ** 2, -mp * g * r * sin], dim=-1)
            qacc = torch.linalg.solve(M, tau - bias - damping * v)
            return v, qacc

        # classic RK4 on (q, v), matching mj_RungeKutta
        q0, v0 = state.qpos, state.qvel
        k1 = deriv(q0, v0)
        k2 = deriv(q0 + h / 2.0 * k1[0], v0 + h / 2.0 * k1[1])
        k3 = deriv(q0 + h / 2.0 * k2[0], v0 + h / 2.0 * k2[1])
        k4 = deriv(q0 + h * k3[0], v0 + h * k3[1])
        qpos, qvel = (
            y + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
            for y, a, b, c, d in zip((q0, v0), k1, k2, k3, k4)
        )

        upright = (torch.cos(qpos[:, 1]) + 1.0) / 2.0
        centered = (1.0 + base.tolerance(qpos[:, 0], margin=2.0)) / 2.0
        small_control = (
            4.0 + base.tolerance(u, margin=1.0, value_at_margin=0.0, sigmoid="quadratic")
        ) / 5.0
        small_velocity = (1.0 + base.tolerance(qvel[:, 1], margin=5.0)) / 2.0
        reward = upright * centered * small_control * small_velocity
        return base.EnvState(qpos=qpos, qvel=qvel, t=state.t + 1), reward

    def observe(self, params: CartpoleParams, state: base.EnvState):
        del params
        th = state.qpos[:, 1]
        return torch.stack([state.qpos[:, 0], torch.cos(th), torch.sin(th),
                            state.qvel[:, 0], state.qvel[:, 1]], dim=-1)
