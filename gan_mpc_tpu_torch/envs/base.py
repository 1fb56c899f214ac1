"""Environment substrate: batched state, shaped rewards, physics shift.

Counterpart of ``gan_mpc_tpu/envs/base.py``. Environments here are
batched: every ``EnvState`` field carries a leading env axis, and
``reset``/``step``/``observe`` act on the whole batch at once.

Env API:
    env.obs_size / env.act_size / env.dt / env.episode_steps
    env.default_params() -> frozen dataclass of physics knobs
    env.reset(params, num_envs, generator) -> EnvState
    env.step(params, state, action (B, act)) -> (EnvState, reward (B,))
    env.observe(params, state) -> (B, obs_size)
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch


@dataclasses.dataclass
class EnvState:
    qpos: torch.Tensor  # (B, nq) generalized positions
    qvel: torch.Tensor  # (B, nq) generalized velocities
    t: torch.Tensor  # (B,) step counter (int32)


def tolerance(
    x: torch.Tensor,
    lower: float = 0.0,
    upper: float = 0.0,
    margin: float = 0.0,
    sigmoid: str = "gaussian",
    value_at_margin: float = 0.1,
) -> torch.Tensor:
    """Reward 1 inside [lower, upper], decaying outside over ``margin``
    (dm_control's ``rewards.tolerance``)."""
    in_bounds = (lower <= x) & (x <= upper)
    if margin == 0.0:
        return torch.where(in_bounds, 1.0, 0.0).to(x.dtype)
    d = torch.where(x < lower, lower - x, x - upper) / margin
    d = torch.where(in_bounds, 0.0, d)
    if sigmoid == "gaussian":
        scale = math.sqrt(-2.0 * math.log(value_at_margin))
        out = torch.exp(-0.5 * (d * scale) ** 2)
    elif sigmoid == "linear":
        scale = 1.0 - value_at_margin
        out = torch.clamp(1.0 - d * scale, 0.0, 1.0)
    elif sigmoid == "quadratic":
        scale = math.sqrt(1.0 - value_at_margin)
        out = torch.clamp(1.0 - (d * scale) ** 2, 0.0, 1.0)
    else:
        raise ValueError(f"unknown sigmoid {sigmoid!r}")
    return torch.where(in_bounds, 1.0, out)


_SHIFT_PATTERNS = ("body_mass_", "geom_size_", "jnt_stiffness_")


def apply_physics_shift(params, shifts):
    """Multiply named physics fields (the imitator's domain shift).

    ``shifts`` is a list of ``{"key": "body_mass_torso", "value": 3.0}``
    entries; keys name fields of the env's params dataclass, and unknown
    keys raise.
    """
    field_names = {f.name for f in dataclasses.fields(params)}
    updates = {}
    for kv in shifts:
        key, value = kv["key"], float(kv["value"])
        if not re.match("|".join(_SHIFT_PATTERNS), key):
            raise ValueError(f"unsupported physics-shift key {key!r}")
        if key not in field_names:
            raise ValueError(
                f"{type(params).__name__} has no physics field {key!r}; "
                f"available: {sorted(field_names)}"
            )
        updates[key] = getattr(params, key) * value
    return dataclasses.replace(params, **updates)
