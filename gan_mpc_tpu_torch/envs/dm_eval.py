"""Evaluate policies in the real dm_control suite tasks (host side).

Counterpart of ``gan_mpc_tpu/envs/dm_eval.py``: a trained policy is
rolled in the actual MuJoCo suite task (the reference's reward protocol)
with the same observation flattening, the same episode protocol and the
imitator's physics shift applied to the suite model, so its return is
comparable to anything the reference reports. dm_control is an optional
oracle: it is imported inside the functions, and the package imports
without it.

Observations and rewards stay numpy float64 on the host, as in the JAX
package. The policy sees float32 tensors on the normalizer's device (the
card on a served run): each observation crosses to the device once a
step, is normalized there, and the action comes back once a step as
float64.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_SUITE_NAMES = {
    "pendulum_swingup": ("pendulum", "swingup"),
    "cartpole_balance": ("cartpole", "balance"),
    "cheetah_run": ("cheetah", "run"),
    "walker_walk": ("walker", "walk"),
}

# The repo's humanoid is planar (13 links, 29-dim obs); dm_control's is
# 3-D with a 67-dim observation in another layout, so these names have no
# suite task to be evaluated in.
_NO_COUNTERPART = {"humanoid_stand", "humanoid_walk"}


def dm_control_available() -> bool:
    try:
        import dm_control.suite  # noqa: F401

        return True
    except Exception:
        return False


def has_dm_counterpart(env_name: str) -> bool:
    """True where the env maps onto a dm_control suite task (the planar
    humanoid does not)."""
    return env_name in _SUITE_NAMES


def apply_suite_physics_shift(env, shifts) -> None:
    """Scale a loaded dm_control env's MuJoCo model in place with the
    multipliers of the envs' ``apply_physics_shift``: ``body_mass_<name>``,
    ``geom_size_<name>`` and ``jnt_stiffness_<name>`` multiply the named
    model entry."""
    for kv in shifts or []:
        key, value = kv["key"], float(kv["value"])
        for pattern, field in (
            ("^body_mass_(.*)$", "body_mass"),
            ("^geom_size_(.*)$", "geom_size"),
            ("^jnt_stiffness_(.*)$", "jnt_stiffness"),
        ):
            m = re.search(pattern, key)
            if m:
                getattr(env.physics.named.model, field)[m.group(1)] *= value
                break
        else:
            raise ValueError(f"unsupported physics-shift key {key!r}")


def _walker_obs(physics) -> np.ndarray:
    """dm_control walker state -> the planar walker's 17-dim observation.

    The suite's observation dict (orientations 14 + height + velocity 9)
    is not the planar walker's [qpos[1:], qvel], but the state is, up to a
    joint permutation: dm qpos is [rootz, rootx, rooty, R(hip, knee,
    ankle), L(hip, knee, ankle)], the planar walker's [x, z, pitch, L...,
    R...]."""
    q = np.asarray(physics.data.qpos)
    v = np.asarray(physics.data.qvel)
    perm = [1, 0, 2, 6, 7, 8, 3, 4, 5]
    q2, v2 = q[perm], v[perm]
    return np.concatenate([q2[1:], v2])


# envs whose suite observation layout differs from the port's env: the
# policy's observation is built from the physics state instead
_OBS_ADAPTERS = {"walker_walk": _walker_obs}


def flatten_observation(obs_dict) -> np.ndarray:
    """dict of arrays -> flat float64 vector: the values concatenated in
    dict order, scalars promoted (the reference's flattening)."""
    parts = []
    for v in obs_dict.values():
        parts.append(np.atleast_1d(np.asarray(v, dtype=np.float64)))
    return np.concatenate(parts)


def evaluate_in_dm_control(
    env_name: str,
    policy_fn,
    normalizer,
    history: int = 1,
    num_episodes: int = 3,
    max_steps: int = 1000,
    seed: int = 0,
    physics_shifts=None,
):
    """Roll ``policy_fn(history_x, history_u) -> action`` in the dm_control
    suite task; returns (mean_return, per-episode returns).

    ``policy_fn`` takes (history + 1, obs) normalized states and (history,
    act) past actions, float32 tensors on the normalizer's device, and
    returns the raw action, the contract of the rollouts. The past actions
    are the raw actions taken, zeros before the first, as the JAX package
    keeps them here (its rollouts keep normalized ones). Episode ``ep``
    loads the task with ``random=seed + ep``; ``physics_shifts`` applies the
    imitator's domain shift to the suite model, so the episode measures
    the task the policy was trained for."""
    from dm_control import suite

    if env_name in _NO_COUNTERPART:
        raise ValueError(
            f"{env_name}: no dm_control counterpart — the repo's humanoid "
            "is planar (29-dim obs); the suite humanoid is 3-D (67-dim)."
        )
    domain, task = _SUITE_NAMES[env_name]
    adapter = _OBS_ADAPTERS.get(env_name)
    device = normalizer.state_mean.device

    def observe(env, ts):
        if adapter is not None:
            return adapter(env.physics)
        return flatten_observation(ts.observation)

    def normalized(obs):
        return normalizer.normalize_state(torch.as_tensor(obs, dtype=torch.float32,
                                                          device=device))

    returns = []
    for ep in range(num_episodes):
        env = suite.load(domain, task, task_kwargs={"random": seed + ep})
        apply_suite_physics_shift(env, physics_shifts)
        ts = env.reset()
        hx = [normalized(observe(env, ts))] * (history + 1)
        hu = [torch.zeros(env.action_spec().shape, dtype=torch.float32, device=device)] * history
        total = 0.0
        for _ in range(max_steps):
            u = policy_fn(torch.stack(hx[-(history + 1):]), torch.stack(hu[-history:]))
            u = u.detach().to("cpu", torch.float64).numpy()
            ts = env.step(u)
            total += float(ts.reward or 0.0)
            hx.append(normalized(observe(env, ts)))
            hu.append(torch.as_tensor(u, dtype=torch.float32, device=device))
            if ts.last():
                break
        returns.append(total)
    return float(np.mean(returns)), returns
