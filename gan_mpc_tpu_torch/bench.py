"""Throughput benchmark: batched env+planner steps/sec on one GPU.

Closed-loop MPC control: every env step runs a full iLQR plan (expert
goal generation, linearization, quadratization, Riccati, line search)
and then a physics step, batched over many parallel envs on the card.
The configuration is the JAX package's flagship row (``bench.py`` and
``__graft_entry__._flagship`` there): cheetah_run, 512 envs, H=5, iLQR
<= 5 iterations, identity normalizer, history 1; cost net 17->128->128->10,
residual dynamics 23->200->200->200->17, LSTM expert with 128 features
and two 128->128 heads, MPC weights (-2, 3, -3). Weights are random,
drawn with flax's default initializers from ``--seed``.

    python -m gan_mpc_tpu_torch.bench [--seed 0] [--profile 3]

The flags ``--env``, ``--num-envs``, ``--horizon``, ``--iters``,
``--alphas``, ``--ls``, ``--dtype``, ``--riccati`` and ``--num-steps``
mirror the JAX bench's ``BENCH_ENV``, ``BENCH_NUM_ENVS``,
``BENCH_HORIZON``, ``BENCH_ILQR_ITERS``, ``BENCH_ALPHAS``, ``BENCH_LS``,
``BENCH_DTYPE``, ``BENCH_RICCATI`` and ``BENCH_NUM_STEPS``; their
defaults are the flagship's. ``BENCH_UNROLL`` (an XLA scan-unroll knob)
has no counterpart: the eager loops have nothing to unroll. The reference's
humanoid-class row (planar humanoid, 29 states, 12 actions; dynamics
41->200->200->200->29, where "auto" resolves to the materializing line
search), and the JAX H=50 matrix's bf16 rows
(``scripts/r5_bench_h50b.sh``) and its associative backward:

    python -m gan_mpc_tpu_torch.bench --env humanoid_stand --num-envs 128 \
        --horizon 50 --iters 5 [--dtype bfloat16] [--riccati associative]

The window is the JAX bench's: one full warmup episode of ``--num-steps``
(50) control steps, then 3 timed episodes of as many steps (every episode
from a fresh reset drawn from the run's generator), and the mean of the
three.

Prints one JSON line per row, {"metric", "value", "unit", "vs_baseline"},
with the card's name and power limit and the solver setting in the
metric: first the flagship with the forward scans through the separate
dynamics and stage-cost callbacks (``fused_ls="off"``), then through the
fused line-search step (``fused_ls="on"``, the JAX bench's
``BENCH_FUSED=on`` row), then, as the JAX bench's second line, the
committed production checkpoint ``DEFAULT_CHECKPOINT`` (cheetah_run
gan/4) at its own solver budget, "(trained ckpt)" in the row's name.
``--checkpoint DIR`` (the JAX bench's ``BENCH_CHECKPOINT``) benches only
that trained run. A checkpoint row rebuilds the policy, its solver
settings, the imitator env with the run's physics shift and the history
from the run's own ``config.json``, loads every component from its
``params.msgpack``, and refits the normalizer on the run's expert store
through ``ensure_trajectories`` (the store in the run's workdir, the
directory that holds its ``trained_models``); a run that fails to load
raises. The port has no GPU baseline yet, so ``vs_baseline`` is null.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from gan_mpc_tpu_torch import pin_fp32, resolve_device
from gan_mpc_tpu_torch.data.normalizer import Normalizer
from gan_mpc_tpu_torch.envs import make_env
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
from gan_mpc_tpu_torch.models.expert import ExpertPredictor
from gan_mpc_tpu_torch.params import init_flax_like, load_msgpack
from gan_mpc_tpu_torch.planner.ilqr import SolverSettings
from gan_mpc_tpu_torch.policies.mpc import MPCPolicy
from gan_mpc_tpu_torch.runners import common

# the flagship row's sizes; chip_smoke.py drives the same widths over a
# shorter episode of its own
ENV = "cheetah_run"
NUM_ENVS = 512
STEPS = 50  # control steps per episode
WARMUP_EPISODES = 1  # full episodes before the timed ones
REPS = 3  # timed episodes; the row is their mean
HORIZON = 5
ILQR_ITERS = 5
NUM_ALPHAS = 16
LS_MATERIALIZE = "auto"
HISTORY = 1
DTYPE = "float32"
RICCATI = "sequential"
FUSED_LS = ("off", "on")  # the rows, in print order
# the committed production checkpoint, benched as the row after the flagship's
DEFAULT_CHECKPOINT = str(Path(__file__).resolve().parent.parent
                         / "runs/trained_models/imitator/cheetah_run/gan/4")


def flagship(horizon: int = HORIZON, max_iterations: int = ILQR_ITERS,
             x_size: int = 17, u_size: int = 6, device="cuda", seed=None,
             fused_ls: str = "off", num_alphas: int = NUM_ALPHAS,
             ls_materialize: str = LS_MATERIALIZE, compute_dtype: str = DTYPE,
             riccati: str = RICCATI, hidden: tuple = (200, 200, 200)) -> MPCPolicy:
    """The flagship policy at full width, on the card unless ``device``
    says otherwise. With ``seed`` its weights are drawn flax-style from a
    torch.Generator; without, they are zero and the caller loads them
    (``params.from_jax_params``). ``fused_ls``, ``num_alphas``,
    ``ls_materialize``, ``compute_dtype`` and ``riccati`` as in
    ``SolverSettings``; ``hidden``: the dynamics MLP's hidden widths."""
    device = resolve_device(device)
    policy = MPCPolicy(
        cost_model=MPCCost(
            CostFeatureNet(x_size, hidden=(128, 128), features_out=10),
            horizon,
            mpc_weights=(-2.0, 3.0, -3.0),
        ),
        dynamics_model=LearnedDynamics(
            ResidualMLPDynamicsNet(x_size, u_size, hidden=tuple(hidden))
        ),
        expert_model=ExpertPredictor(
            x_size, u_size, arch="lstm", features=128, hidden=(128, 128)
        ),
        horizon=horizon,
        settings=SolverSettings(max_iterations=max_iterations, fused_ls=fused_ls,
                                num_alphas=num_alphas, ls_materialize=ls_materialize,
                                compute_dtype=compute_dtype, riccati=riccati),
    )
    if seed is not None:
        init_flax_like(policy, torch.Generator().manual_seed(seed))
    return policy.requires_grad_(False).to(device)


def card() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Checkpoint(NamedTuple):
    """A trained run as the bench serves it (the JAX bench's
    ``_load_checkpoint``)."""

    policy: MPCPolicy
    env: object
    env_params: object
    normalizer: Normalizer
    history: int
    name: str  # the row's env name: "<env> (trained ckpt)"


def load_checkpoint(run_dir: str, device="cuda") -> Checkpoint:
    """The trained run ``run_dir`` (``<workdir>/trained_models/imitator/
    <env>/<family>/<id>``) from its own ``config.json`` and
    ``params.msgpack`` (the critic where the run saved one), the
    normalizer refitted on the expert store that ``ensure_trajectories``
    reads in the run's workdir, on the card unless ``device`` says
    otherwise."""
    run_dir = os.path.abspath(run_dir)
    workdir = str(Path(run_dir).parents[4])
    config = common.load_run_config(run_dir).replace(runtime__workdir=workdir)
    env, env_params = common.imitator_env(config, device)
    trajs = common.ensure_trajectories(config, device)
    norm = common.build_normalizer(config, trajs, device)
    with_critic = "critic_params" in load_msgpack(os.path.join(run_dir, "params.msgpack"))
    policy = common.build_policy(config, env.obs_size, env.act_size, with_critic, device)
    common.load_saved_params(policy, run_dir)
    return Checkpoint(policy, env, env_params, norm, config.mpc.history,
                      f"{config.env.name} (trained ckpt)")


def run_steps(policy, env, norm, num_steps, generator, num_envs=NUM_ENVS, env_params=None,
              history=HISTORY):
    """One closed-loop rollout of ``num_envs`` envs on the card (the env's
    default physics unless ``env_params`` is given); returns (episode,
    seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = policy_rollout(
        env, env_params if env_params is not None else env.default_params(), policy, norm,
        num_steps=num_steps, history=history, num_envs=num_envs, generator=generator,
    )
    torch.cuda.synchronize()
    return ep, time.perf_counter() - t0


def profile_steps(policy, env, norm, num_steps, generator, num_envs=NUM_ENVS, top=25,
                  **served):
    """Trace ``num_steps`` control steps with torch.profiler; print the
    device's busy share of the wall time and the ops with the most device
    time. ``served``: ``run_steps``' ``env_params`` and ``history``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, dt = run_steps(policy, env, norm, num_steps, generator, num_envs, **served)
    events = prof.key_averages()
    # kernel events only: an op's row repeats the time of the kernels it launched
    busy_s = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
    ) / 1e6
    print(f"profile: {num_steps} steps in {dt:.4f} s wall (traced), device busy "
          f"{busy_s:.4f} s = {100 * busy_s / dt:.1f}%")
    print(events.table(sort_by="self_device_time_total", row_limit=top))


def timed_episodes(policy, env, norm, generator, num_envs=NUM_ENVS, num_steps=STEPS,
                   **served):
    """The bench window: WARMUP_EPISODES full episodes of ``num_steps``
    control steps, then REPS timed ones; returns the mean seconds of a
    timed episode. ``served``: ``run_steps``' ``env_params`` and
    ``history``."""
    for _ in range(WARMUP_EPISODES):
        run_steps(policy, env, norm, num_steps, generator, num_envs, **served)
    return sum(run_steps(policy, env, norm, num_steps, generator, num_envs, **served)[1]
               for _ in range(REPS)) / REPS


def bench_row(steps_per_sec, card_name, fused_ls, env_name=ENV, num_envs=NUM_ENVS,
              iters=ILQR_ITERS, horizon=HORIZON, num_alphas=NUM_ALPHAS,
              ls_materialize=LS_MATERIALIZE, compute_dtype=DTYPE, riccati=RICCATI,
              num_steps=STEPS):
    """The JSON row; the step sizes, the line-search mode, the compute
    dtype, the backward pass and the episode length are named where they
    are not the defaults."""
    extra = "".join(f", {name}={value}" for name, value, default in (
        ("alphas", num_alphas, NUM_ALPHAS), ("ls_materialize", ls_materialize, LS_MATERIALIZE),
        ("dtype", compute_dtype, DTYPE), ("riccati", riccati, RICCATI),
        ("steps", num_steps, STEPS),
    ) if value != default)
    return {
        "metric": f"batched env+planner steps/sec (one GPU: {card_name}; "
        f"{env_name}, {num_envs} envs, iLQR<= {iters} iters, "
        f"H={horizon}, fused_ls={fused_ls}{extra}, torch port)",
        "value": steps_per_sec,
        "unit": "steps/sec",
        "vs_baseline": None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="also trace this many steps and print where device time goes")
    ap.add_argument("--env", default=ENV, help="environment name (BENCH_ENV)")
    ap.add_argument("--num-envs", type=int, default=NUM_ENVS, help="BENCH_NUM_ENVS")
    ap.add_argument("--horizon", type=int, default=HORIZON, help="BENCH_HORIZON")
    ap.add_argument("--iters", type=int, default=ILQR_ITERS, help="BENCH_ILQR_ITERS")
    ap.add_argument("--alphas", type=int, default=NUM_ALPHAS, help="BENCH_ALPHAS")
    ap.add_argument("--ls", default=LS_MATERIALIZE, choices=("auto", "recompute", "materialize"),
                    help="the line-search strategy (BENCH_LS)")
    ap.add_argument("--dtype", default=DTYPE, choices=("float32", "bfloat16"),
                    help="the dynamics net's product dtype, f32 accumulation (BENCH_DTYPE)")
    ap.add_argument("--riccati", default=RICCATI, choices=("sequential", "associative"),
                    help="the backward pass (BENCH_RICCATI)")
    ap.add_argument("--num-steps", type=int, default=STEPS,
                    help="control steps per episode (BENCH_NUM_STEPS)")
    ap.add_argument("--checkpoint", metavar="DIR",
                    help="bench only this trained run (BENCH_CHECKPOINT)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on a GPU", file=sys.stderr)
        return 1
    pin_fp32()
    dev = torch.device("cuda")
    card_name = card()
    if args.checkpoint:
        bench_checkpoint(args.checkpoint, card_name, args)
        return 0
    env = make_env(args.env, dev)
    norm = Normalizer.identity(env.obs_size, env.act_size, dev)
    for fused_ls in FUSED_LS:
        policy = flagship(args.horizon, args.iters, env.obs_size, env.act_size, dev, args.seed,
                          fused_ls, args.alphas, args.ls, args.dtype, args.riccati)
        gen = torch.Generator().manual_seed(args.seed)
        dt = timed_episodes(policy, env, norm, gen, args.num_envs, args.num_steps)
        row = bench_row(args.num_envs * args.num_steps / dt, card_name, fused_ls, args.env,
                        args.num_envs, args.iters, args.horizon, args.alphas, args.ls,
                        args.dtype, args.riccati, args.num_steps)
        print(json.dumps(row), flush=True)
        if args.profile:
            profile_steps(policy, env, norm, args.profile, gen, args.num_envs)
    bench_checkpoint(DEFAULT_CHECKPOINT, card_name, args)
    return 0


def bench_checkpoint(run_dir: str, card_name: str, args) -> None:
    """Print the bench row of the trained run ``run_dir`` at
    ``args.num_envs`` envs (then its trace, with ``args.profile``)."""
    ckpt = load_checkpoint(run_dir)
    settings = ckpt.policy.settings
    gen = torch.Generator().manual_seed(args.seed)
    served = dict(env_params=ckpt.env_params, history=ckpt.history)
    dt = timed_episodes(ckpt.policy, ckpt.env, ckpt.normalizer, gen, args.num_envs,
                        args.num_steps, **served)
    row = bench_row(args.num_envs * args.num_steps / dt, card_name, settings.fused_ls,
                    ckpt.name, args.num_envs, settings.max_iterations, ckpt.policy.horizon,
                    settings.num_alphas, settings.ls_materialize, settings.compute_dtype,
                    settings.riccati, args.num_steps)
    print(json.dumps(row), flush=True)
    if args.profile:
        profile_steps(ckpt.policy, ckpt.env, ckpt.normalizer, args.profile, gen, args.num_envs,
                      **served)


if __name__ == "__main__":
    sys.exit(main())
