#!/usr/bin/env python3
"""How well conditioned the committed run pendulum_swingup gan/9's solves
are, in the JAX package (the reference), on the CPU.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 scripts/diag_gan9_conditioning.py [--pool 256]
        [--windows i ...]

gan/9 is loaded from its config.json and params.msgpack, the normalizer
fitted on the committed expert store (not ``ensure_trajectories``, which
would collect a new one). On a pool of its cost windows (history 1,
H=10: window 37 i mod their count for i < pool) it prints:

  * the histogram of the batch iLQR's iterations (<= 30) and how many
    converged;
  * each window's plan spread: the largest change of U when the history
    is scaled by 1 +- 1e-7 or the dynamics weights by 1 +- 1e-6, and the
    windows under 1e-5 whose iterations do not change;
  * the implicit gradient's spread under the input nudges (max|d| over
    max|ref| of the generator loss's gradient, one window at a time) for
    up to 32 windows that converged and 32 that did not, and for the
    windows given with ``--windows`` (indices into all cost windows).

These are the numbers behind the histories that ``tests/test_torch_gan.py``
and ``chip_smoke.py`` pick.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
from flax import serialization

from gan_mpc_tpu.data.trajectories import load_trajectories
from gan_mpc_tpu.data.windows import cost_windows
from gan_mpc_tpu.policies import MPCPolicy
from gan_mpc_tpu.policies.losses import gan_generator_loss
from gan_mpc_tpu.runners import common

RUN = "runs/trained_models/imitator/pendulum_swingup/gan/9"
STORE = "runs/expert_trajectories/pendulum_swingup/trajectories-f690b23776.gmts"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pool", type=int, default=256)
    ap.add_argument("--windows", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cfg = common.load_run_config(RUN)
    H = cfg.mpc.horizon
    policy = MPCPolicy(
        cost_model=common.build_cost_model(cfg, H),
        dynamics_model=common.build_dynamics_model(cfg, 3),
        expert_model=common.build_expert_model(cfg, 3, 1),
        critic_model=common.build_critic_model(cfg), horizon=H,
        settings=common.solver_settings(cfg))
    with open(f"{RUN}/params.msgpack", "rb") as f:
        params = jax.tree_util.tree_map(jnp.asarray, serialization.msgpack_restore(f.read()))
    trajs = load_trajectories(STORE, cfg.mpc.train.num_trajectories, cfg.mpc.train.trajectory_len)
    norm = common.build_normalizer(cfg, trajs)
    X = np.array(cost_windows(norm.normalize_state(jnp.asarray(trajs.states)), 1, H)[0])
    pick = np.arange(args.pool) * 37 % X.shape[0]
    hX, hU = X[pick], jnp.zeros((args.pool, 1, 1))
    plan = jax.jit(policy.plan_batch)
    ref = plan(params, jnp.asarray(hX), hU)
    its = np.asarray(ref.iterations)
    print(f"gan/9: {args.pool} of {X.shape[0]} cost windows; iterations histogram (0..30) "
          f"{np.bincount(its, minlength=31).tolist()}; converged "
          f"{int(np.asarray(ref.converged).sum())}; at 30: {int((its == 30).sum())}")

    spread, changed = np.zeros(args.pool), np.zeros(args.pool, bool)
    for x_scale, w_scale in ((1 + 1e-7, 1), (1 - 1e-7, 1), (1, 1 + 1e-6), (1, 1 - 1e-6)):
        nudged = dict(params, dynamics_params=jax.tree_util.tree_map(
            lambda a: a * w_scale, params["dynamics_params"]))
        sol = plan(nudged, jnp.asarray(hX * x_scale), hU)
        spread = np.maximum(spread, np.abs(np.asarray(sol.U) - np.asarray(ref.U)).max((1, 2)))
        changed |= np.asarray(sol.iterations) != its
    stable = [int(i) for i in pick[(spread < 1e-5) & ~changed]]
    print(f"plan spread under rounding-sized nudges: median {np.median(spread):.2e}, max "
          f"{spread.max():.2e}; under 1e-5 with unchanged iterations: {stable}")

    grad = jax.jit(lambda p, x: policy.batched_loss_and_grad(p, x, gan_generator_loss)[1])
    flat = lambda g: np.concatenate([np.asarray(a).ravel() for k in
                                     ("mpc_weights", "cost_params", "dynamics_params")
                                     for a in jax.tree_util.tree_leaves(g[k])])
    for name, windows in (("converged", pick[its < 30][:32]),
                          ("at 30 iterations", pick[its == 30][:32]),
                          ("given", args.windows)):
        if not len(windows):
            continue
        out = {}
        for w in windows:
            x = X[w:w + 1]
            base = flat(grad(params, jnp.asarray(x)))
            out[int(w)] = max(float(np.abs(flat(grad(params, jnp.asarray(x * s))) - base).max()
                                    / np.abs(base).max()) for s in (1 + 1e-7, 1 - 1e-7))
        vals = np.array(list(out.values()))
        print(f"implicit gradient spread, {name} ({len(out)} windows): median "
              f"{np.median(vals):.2e}, max {vals.max():.2e}; per window {json.dumps(out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
