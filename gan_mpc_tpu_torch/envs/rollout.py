"""Closed-loop rollouts of a batch of envs under a batch policy.

Counterpart of ``batch_policy_rollout`` / ``policy_rollout`` /
``average_return`` in ``gan_mpc_tpu/envs/rollout.py``: per control step

    observe -> normalize -> plan (one solver for all envs) -> env.step

with fixed-shape rolling history windows, zero-initialized. The time
``scan`` is a Python loop. Resets come from an explicit initial
``EnvState`` or from a ``torch.Generator``; ``jax.random`` cannot be
reproduced in torch, so parity tests pass the JAX package's resets in.

``action_noise`` > 0 adds clipped Gaussian exploration noise to the
executed action, which the episode records (the dynamics trainer learns
from the executed transitions). The standard normal draws come from the
generator, one (B, act) draw per step, or from ``noise`` (T, B, act),
which parity tests fill with the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.envs.base import EnvState


class EpisodeData(NamedTuple):
    states: torch.Tensor  # (B, T, obs) raw observations
    actions: torch.Tensor  # (B, T, act)
    rewards: torch.Tensor  # (B, T)
    qpos: torch.Tensor  # (B, T, nq)
    qvel: torch.Tensor  # (B, T, nq)


def batch_policy_rollout(
    env,
    env_params,
    batch_policy_fn: Callable,
    normalizer: Normalizer,
    num_steps: int,
    history: int,
    num_envs: int,
    init_state: Optional[EnvState] = None,
    generator: Optional[torch.Generator] = None,
    action_noise: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> EpisodeData:
    """Roll ``num_envs`` envs for ``num_steps`` control steps, calling
    ``batch_policy_fn(hist_X (B,h+1,x), hist_U (B,h,u)) -> (B, act)`` once
    per step. Starts from ``init_state`` if given, else resets from
    ``generator``; with ``action_noise`` > 0 the exploration noise comes
    from ``noise`` if given, else from ``generator``."""
    if init_state is None:
        if generator is None:
            raise ValueError("pass init_state or a torch.Generator")
        init_state = env.reset(env_params, num_envs, generator)
    if action_noise > 0.0 and noise is None and generator is None:
        raise ValueError("action_noise needs a torch.Generator or the noise draws")
    state = init_state
    dev = state.qpos.device
    hist_x = torch.zeros((num_envs, history + 1, env.obs_size), device=dev)
    hist_u = torch.zeros((num_envs, history, env.act_size), device=dev)
    outs = []
    for step in range(num_steps):
        obs = env.observe(env_params, state)
        hist_x = torch.cat([hist_x[:, 1:], normalizer.normalize_state(obs)[:, None]], 1)
        u = batch_policy_fn(hist_x, hist_u).to(torch.float32)
        if action_noise > 0.0:
            z = noise[step] if noise is not None else torch.randn(
                u.shape, generator=generator, device=generator.device)
            u = torch.clamp(u + action_noise * z.to(dev), -1.0, 1.0)
        hist_u = torch.cat([hist_u[:, 1:], normalizer.normalize_action(u)[:, None]], 1)
        qpos, qvel = state.qpos, state.qvel
        state, reward = env.step(env_params, state, u)
        outs.append((obs, u, reward, qpos, qvel))
    return EpisodeData(*(torch.stack(f, dim=1) for f in zip(*outs)))


def policy_rollout(
    env,
    env_params,
    policy,
    normalizer: Normalizer,
    num_steps: int,
    history: int,
    num_envs: int,
    init_state: Optional[EnvState] = None,
    generator: Optional[torch.Generator] = None,
    action_noise: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> EpisodeData:
    """Rollout through the policy's planner (``MPCPolicy.act_batch``), one
    solve for all envs: batch-native policies solve their lanes jointly,
    the others per instance, each lane independently, as the JAX package's
    per-env ``act`` does."""
    return batch_policy_rollout(
        env, env_params, policy.act_batch, normalizer, num_steps, history,
        num_envs, init_state=init_state, generator=generator, action_noise=action_noise,
        noise=noise,
    )


def average_return(
    env,
    env_params,
    batch_policy_fn: Callable,
    normalizer: Normalizer,
    num_steps: int,
    history: int,
    num_runs: int,
    init_state: Optional[EnvState] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Mean episode return over ``max(num_runs, 1)`` envs rolled at once
    under ``batch_policy_fn`` (the reference's ``avg_run_dm_policy``
    metric); the same history windows as the JAX per-env rollouts. Starts
    from ``init_state`` if given, else resets from ``generator``."""
    ep = batch_policy_rollout(env, env_params, batch_policy_fn, normalizer, num_steps, history,
                              max(num_runs, 1), init_state=init_state, generator=generator)
    return ep.rewards.sum(-1).mean()
