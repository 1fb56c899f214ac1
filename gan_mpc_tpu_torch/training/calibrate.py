"""Reward-free action-goal-gain calibration by state-moment matching.

Counterpart of ``gan_mpc_tpu/training/calibrate.py``. The action-goal
gain (the 5th raw MPC weight, ``models/cost.py``) rescales the tracked
cloned actions; its gradient through the adversarial loss is unreliable,
so the gain is set by the imitation objective itself: roll the policy on
the imitator env at each gain of a small grid and keep the one whose
state distribution best matches the demonstrations' first and second
moments. No reward is read.

The JAX function takes a parameter dict and returns a new one; here the
weights live in the policy, so the chosen gain is installed in it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from gan_mpc_tpu_torch.training.masking import set_mpc_weights

DEFAULT_GRID = (1.0, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6, 1.8)


def moment_distance(states: torch.Tensor, target_mean, target_std) -> torch.Tensor:
    """|| E[x] - E_e[x] ||^2 + || std[x] - std_e[x] ||^2 in the
    demonstrations' normalized units. ``states``: (B, T, x) raw."""
    xn = (states - target_mean) / target_std
    m = xn.mean(dim=(0, 1))
    s = xn.std(dim=(0, 1), correction=0)
    return (m * m).sum() + ((s - 1.0) ** 2).sum()


def with_gain(weights: torch.Tensor, gain: float) -> torch.Tensor:
    """The raw MPC weights with the gain (5th weight) set to ``gain``,
    appended where there are 4."""
    gain = torch.tensor([float(gain)], dtype=weights.dtype, device=weights.device)
    return torch.cat([weights[:4], gain, weights[5:]])


@torch.no_grad()
def calibrate_action_goal_gain(
    policy,
    rollout_fn: Callable,
    target_mean,
    target_std,
    grid: Sequence[float] = DEFAULT_GRID,
    log=print,
):
    """Set ``policy``'s gain to the grid value whose on-policy state
    distribution best matches the demonstrations; returns that gain (None
    without an action-goal term, fewer than 4 weights, which is left alone).

    ``rollout_fn(policy) -> states (B, T, x)`` rolls the policy, with the
    gain under trial installed, on the (shifted) imitator env; the caller
    chooses env, batch and steps (and tests stub it)."""
    w = policy.cost_model.weights.detach().clone()
    if w.shape[-1] < 4:
        return None
    best_gain, best_d = None, None
    for gain in grid:
        set_mpc_weights(policy, with_gain(w, gain))
        d = float(moment_distance(rollout_fn(policy), target_mean, target_std))
        log(f"[calibrate] action_goal_gain {gain}: moment_dist {d:.4f}")
        if best_d is None or d < best_d:
            best_gain, best_d = float(gain), d
    set_mpc_weights(policy, with_gain(w, best_gain))
    log(f"[calibrate] selected action_goal_gain {best_gain} (moment_dist {best_d:.4f})")
    return best_gain
