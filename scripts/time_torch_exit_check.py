#!/usr/bin/env python3
"""Time the batch iLQR loop's early exit against the fixed-trip loop it
replaced, on one GPU.

    git archive <parent> | tar -x -C runs/parent   # a tree with the fixed loop
    env PYTHONPATH=. python3 scripts/time_torch_exit_check.py --parent runs/parent
        [--rounds 1] [--gan9-steps 20] [--flagship-steps 20]

This tree's ``batch_ilqr`` stops once no lane is active (one host sync a
trip). The fixed loop is ``gan_mpc_tpu_torch/planner/batch_ilqr.py`` of the
``--parent`` tree, which runs all ``max_iterations`` trips and never syncs,
loaded from its file beside this tree's package and swapped in where the
policy and the implicit planner call the solver; every other module is this
tree's. The outputs are the same either way. Three paths, each closed loop
from the same resets for every episode (so the work differs only by the
trips):

  * gan/9 serving: pendulum_swingup gan/9 loaded from its config.json and
    params.msgpack, normalizer fitted on the committed store, 16 envs on
    the imitator's pendulum, H=10, iLQR <= 30;
  * gan/9 at 1 env, the shape of the dynamics phase's on-policy
    collection, where a solve's trips are its one lane's iterations;
  * the flagship row with fused_ls="off": cheetah_run, 512 envs, H=5,
    iLQR <= 5, random weights from seed 0 (no lane stops early there, so
    the check is pure cost).

Per path: one warmup episode, then per round the loops early, fixed,
fixed, early in turns. Prints the card, each episode's env steps/s and
trips per solve, and the median steps/s of each loop. Exits non-zero
without a card.
"""

import argparse
import importlib.util
import os
import statistics
import sys
import time

import numpy as np
import torch

GAN9 = "runs/trained_models/imitator/pendulum_swingup/gan/9"
GAN9_STORE = "runs/expert_trajectories/pendulum_swingup/trajectories-f690b23776.gmts"
ORDER = ("early", "fixed", "fixed", "early")


def load_fixed_solver(tree):
    """``batch_ilqr`` of ``tree``'s planner module, imported from its file;
    its own imports resolve to this tree's package."""
    path = os.path.join(tree, "gan_mpc_tpu_torch", "planner", "batch_ilqr.py")
    spec = importlib.util.spec_from_file_location("fixed_trip_batch_ilqr", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module.batch_ilqr


def use_solver(solver):
    """Route the policy's and the implicit planner's solves to ``solver``."""
    from gan_mpc_tpu_torch.planner import bilevel
    from gan_mpc_tpu_torch.policies import mpc

    mpc.batch_ilqr = bilevel.batch_ilqr = solver


def episode(policy, env, env_params, norm, steps, envs, seed):
    """One closed-loop episode from ``seed``'s resets: (env steps/s, the
    trips of each solve; the fixed loop reports none and runs them all)."""
    from gan_mpc_tpu_torch.envs.rollout import batch_policy_rollout

    trips = []

    def act(hist_x, hist_u):
        sol = policy.plan_batch(hist_x, hist_u)
        trips.append(policy.settings.max_iterations if sol.trips is None else sol.trips)
        return sol.U[:, 0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_policy_rollout(env, env_params, act, norm, steps, 1, envs,
                         generator=torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    return envs * steps / (time.perf_counter() - t0), trips


def run_path(name, solvers, policy, env, env_params, norm, steps, envs, rounds):
    use_solver(solvers["early"])
    episode(policy, env, env_params, norm, steps, envs, 0)  # warmup
    rates = {loop: [] for loop in solvers}
    for _ in range(rounds):
        for loop in ORDER:
            use_solver(solvers[loop])
            rate, trips = episode(policy, env, env_params, norm, steps, envs, 0)
            rates[loop].append(rate)
            print(f"{name} {loop}: {rate:.2f} env steps/s, trips per solve mean "
                  f"{np.mean(trips):.2f} max {max(trips)} min {min(trips)}", flush=True)
    use_solver(solvers["early"])
    for loop, rs in rates.items():
        print(f"{name} {loop}: median {statistics.median(rs):.2f} env steps/s over "
              f"{len(rs)} episodes of {steps} steps x {envs} envs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a tree whose planner/batch_ilqr.py runs fixed trips")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--gan9-steps", type=int, default=20)
    ap.add_argument("--flagship-steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from gan_mpc_tpu_torch import pin_fp32
    from gan_mpc_tpu_torch.bench import NUM_ENVS, card, flagship
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.planner.batch_ilqr import batch_ilqr
    from gan_mpc_tpu_torch.runners import common

    pin_fp32()
    dev = torch.device("cuda")
    print(card(), flush=True)
    solvers = {"early": batch_ilqr, "fixed": load_fixed_solver(args.parent)}
    cfg = common.load_run_config(GAN9).replace(mpc__train__init_from_run=GAN9)
    ctx = common.setup(cfg, True, GAN9_STORE, dev)
    for envs in (16, 1):
        run_path(f"gan/9 {envs} env(s)", solvers, ctx["policy"], ctx["env_im"],
                 ctx["env_im_params"], ctx["normalizer"], args.gan9_steps, envs, args.rounds)
    env = make_env("cheetah_run", dev)
    run_path("flagship fused_ls=off", solvers, flagship(device=dev, seed=0), env,
             env.default_params(), Normalizer.identity(env.obs_size, env.act_size, dev),
             args.flagship_steps, NUM_ENVS, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
