#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. print the card (nvidia-smi name and power limit) and the toolchain,
     then build the three kernels from ``gan_mpc_tpu_torch/csrc`` (one
     nvcc each, started together);
  2. hold each kernel against its plain torch version on the card (TF32
     off), max|d| <= 1e-4 * max(1, max|ref|) on every output: the plain
     version is cuBLAS in f32, the two forward kernels multiply on the
     tensor cores with each operand split into two TF32 parts (three
     products a term, a few 1e-6 off), and f32 sums run in another order:
     - fused_mlp_fwd at the shapes the main paths give it (serving 8192
       and 512 rows; the trainer's loss 128; its 1-env collection 16 and
       1, on the dynamics and the cost stack; the cost trainer's solves
       2048 and 128 rows, its evaluation 4096 and 256), plus a ragged row count,
       the 256-wide stack at 8192 and 512 rows, and a 23->41->17 stack
       (no width a multiple of 8) at 9, 17 and 65 rows (ragged against
       16- and 64-row tiles);
     - fused_ls_step at 512 lanes x 16 step sizes (the line search), 512
       x 1 (rollout, recompute), a ragged 1000 x 16 with a 12-wide goal,
       the humanoid-class widths (29 states, 12 actions) at 128 x 16
       and 128 x 1, and the cost trainer's 128 x 16 and 128 x 1 (n = 17),
       each with 3, 4 and 5 raw MPC weights and both
       action-goal forms;
     - fused_mlp_bwd (dx and every dW, db) on the dynamics stack at 128
       rows (the trainer), 1000 (ragged) and 8192, the 256-wide stack at
       128, the cost stack at 512 and 128 (the cost trainer's envelope
       term), the 23->41->17 stack at 9, 17 and 65
       rows, the humanoid-class stack (41->200->200->200->29) at 128 and
       an empty call, on input rows whose hidden pre-activations all sit
       1e-4 or more from a relu kink (where the derivative jumps); a second
       call on the same inputs must give the same bits, and the kernel's
       distance to the plain-torch model of its own arithmetic (3xTF32
       products, dW summed per tile of 16 or 32 rows) is printed beside it;
     - fused_mlp_fwd and fused_mlp_bwd at 128 rows on trained weights: the
       dynamics (23->256->256->256->17) of the committed checkpoint
       runs/trained_models/imitator/cheetah_run/gan/4/params.msgpack, read
       by the port's own msgpack reader;
     - fused_mlp_fwd on the trained stacks of the committed GAN run
       pendulum_swingup gan/9 (dynamics 4->200->200->200->3, cost
       3->128->128->10, loaded by runners.common as phase 8 loads them)
       at the rows phase 8 gives them (serving 16 envs x 16 step sizes =
       256 and 16; the critic's dataset 4096 and 256; a generator step 2048
       and 128; the 1-env collection 16 and 1), and fused_mlp_bwd on its
       dynamics at 128 rows (the dynamics trainer, the implicit gradient's
       rollout pullback);
  3. time kernels and plain versions with CUDA events (median of 21 runs
     of 20 back-to-back launches, queued behind a device sleep so that
     host overhead is not timed), and compute each call's bound: the
     larger of its bytes over the memory rate and its operations over the
     best rate the card has for an f32-accurate product, three TF32
     tensor-core passes (495 / 3 = 165 TFLOP/s), whatever the kernel
     multiplies with; each line gives kernel, plain version, bound and the
     kernel's share of it (new in the cost trainer's slice: fused_mlp_fwd
     at 2048 rows on both stacks, fused_mlp_bwd on the cost stack at 128,
     fused_ls_step at 128 x 16 and 128 x 1; in the GAN slice's: gan/9's
     trained stacks at 256, 4096, 2048 and 128 rows forward, 128
     backward);
  4. check the main path's pieces on a small input against the same code
     on the CPU (plain versions): one flagship plan_batch at 8 envs and 2
     iLQR iterations with fused_ls off and on (U atol 1e-3), one cheetah
     step (atol 1e-4), and one trainer update pass of 3 minibatches of
     128 windows on the same windows, indices and weights (the first
     minibatch's parameter gradients max|d| <= 1e-4 max(1, max|ref|),
     losses rtol 1e-4, parameters atol 2 k lr after k Adam steps); and
     one minibatch of the cost trainer's implicit gradient (16 windows
     near the rest pose, 2 iLQR iterations, l2 loss, every component but
     the expert differentiated): loss rel 1e-4, each component's gradient
     max|d| <= 1e-3 max|ref|, a second call on the card bitwise equal,
     with the CPU's own spread under rounding-sized nudges printed beside;
     and on gan/9: one plan_batch of 8 expert histories whose plans are
     stable (U atol 1e-3), and one generator minibatch's implicit gradient
     (gan_generator_loss, 16 expert histories whose plans converge, every
     component but the expert differentiated): the loss within 1e-4 of
     the windows' mean |loss|, each component's gradient max|d| <= 1e-3
     max|ref|, a second call bitwise equal, the CPU's own spread printed
     beside;
  5. drive the main path, the flagship closed loop (cheetah_run, 512
     envs, H=5, iLQR <= 5, random flax-style weights from seed 0), for 2
     warmup and 20 timed control steps, once per solver setting:
     - fused_ls="off": every MLP call of the planner must have launched
       fused_mlp_fwd (20 x 61) and nothing fused_ls_step;
     - fused_ls="on": every forward-scan step must have launched
       fused_ls_step (20 x 55) and every terminal cost fused_mlp_fwd
       (20 x 6);
     every output must be finite. Each prints its steps/s row;
  6. drive the training path: one epoch of ``train_dynamics`` on the
     flagship's dynamics with the dynamics phase of
     configs/gan_cheetah.yaml (window 5, batch 128, replay 10000, lr
     1e-5, discount 0.9, teacher forcing 0.7, 3 warm-start updates and 1
     update, 1 episode). The expert data is phase 5's fused_ls="off"
     episode (512 envs x 20 steps: 6,144 train windows after an 80%
     split, 48 minibatches per update); the normalizer is fitted on it.
     The episode is collected on-policy with 1 env, cut to 50 steps (of
     300) and the flagship's 5 iLQR iterations (of 50). Every MLP call of
     the loss must have launched fused_mlp_fwd and its gradient
     fused_mlp_bwd ((3 x 48 + 1) x 5 = 725 each), every planner MLP call
     fused_mlp_fwd (50 x 61); every loss must be finite. Prints the
     trainer's windows/s and minibatch steps/s.
  7. drive the cost-trainer path: one ``train_cost`` call on the flagship
     with the cost phase of configs/gan_cheetah.yaml (batch 128, lr 1e-5,
     polyak 0.9, dynamics and expert frozen, bilevel dense, ridge 1e-5),
     on cost windows (history 1, horizon 5) of phase 5's fused_ls="off"
     episode, normalized by a normalizer fitted on it (512 x 14 = 7,168
     windows, 80% train). Cuts: iLQR 5 of 50 iterations, 1 update of 4
     minibatch steps (of 3 of 44), evaluation on 256 windows. Every MLP
     call must have launched its kernel in the counts of
     ``planner.bilevel.mlp_calls_per_step`` per step plus
     ``mlp_calls_per_solve`` per evaluation; losses finite; the MPC
     weights and the cost net moved and nothing else. Prints minibatch
     steps/s, windows/s and the host ms of a step split into solve,
     backward and optimizer.
  8. the GAN slice on a committed run: runs.common.setup loads
     pendulum_swingup gan/9 from its own config.json and params.msgpack
     (every component, the critic included; continued from itself) and
     fits the normalizer on the committed expert store; then
     - serving: 16 envs closed loop on the imitator's pendulum for 200
       control steps (2 warmup steps), H=10, iLQR <= 30 with the loop's
       early exit; prints the mean return, the mean and max trips per
       solve and steps/s; fused_mlp_fwd must have launched
       mlp_calls_per_solve(10, trips, solves) times for the trips the
       solver reported;
     - one GAN epoch (runners.gan.gan_epoch, epoch 1 of a continuation):
       the dynamics phase with the config's updates (20 warm-start, 6
       expert, 12 on-policy) on 1 episode cut to 50 of 300 steps at 1
       env with the collection noise 0.2; the critic with plan_batch 256
       and 2 updates of batch 128; the generator cut to 1 update of 4
       minibatch steps of 128 windows (of 3 updates of 61), evaluation on
       256 windows. Prints each phase's losses and wall time; every loss
       must be finite, the critic's within 0.05 of ln 2, each phase must
       move its own components and leave its no_grads bitwise unchanged,
       and the launches must equal the counts the solver's reported
       solves and trips and the trainers' steps give.
  9. the GAN training run: ``runners.gan.run`` on gan/9's own config,
     continued from gan/9, with ``G9_RUN_CUTS`` (phase 8's epoch cuts; 2
     epochs; evaluation every epoch on 4 envs of 25 steps; a candidate
     pool of 2; the action-goal gain appended as a 5th weight at 1.0 and
     calibrated over 1.0 and 1.4; checkpoints every epoch; DAgger off) in
     a temporary workdir on the committed store. The first call's log
     raises on the "[gan] epoch 1 " line; a second call resumes from the
     epoch-1 checkpoint, trains epoch 2 alone, evaluates, selects,
     calibrates and saves. Checks: the resume logged, the checkpoints
     cleared, the saved run (config.json, params.msgpack, the six loss
     curves; 5 MPC weights) reloaded by ``common.setup(init_from_run=...)``
     bitwise equal to the returned params, every loss and return finite,
     gan.jsonl holding both epochs' rows and epoch 2's evaluation, and
     the launches of both MLP kernels equal to what the solver's trips and
     the trainers' minibatch steps give. Prints the wall time of each
     epoch and evaluation kind (midrun, selection, calibration, final,
     fresh), the selection scores, the chosen gain, the stamped reward
     and fresh_eval, and the launches; then the script's total wall time.
The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. Exits 1 without a CUDA device.
"""

import contextlib
import json
import re
import sys
import time

import numpy as np
import torch

SEED = 0
DYNAMICS = [23, 200, 200, 200, 17]
WIDE = [23, 256, 256, 256, 17]
COST = [17, 128, 128, 10]
# (name, widths, rows): the serving path calls the MLP kernel at 512 rows
# (rollout, winner recompute) and 512 * 16 alphas = 8192 (line search);
# the trainer's loss at 128 rows, and its 1-env collection at 16 (1 x 16
# alphas) and 1 row, on both stacks
ODD = [23, 41, 17]  # no width a multiple of 8: padded in shared memory at every position
HUMANOID = [41, 200, 200, 200, 29]  # 29 states + 12 actions, the humanoid-class dynamics
# the main path's episode; the port's bench times longer ones
STEPS = 20
WARMUP_STEPS = 2
# a committed checkpoint whose dynamics (23->256->256->256->17) the kernels are held on
CHECKPOINT = "runs/trained_models/imitator/cheetah_run/gan/4/params.msgpack"
CHECKS = [
    ("dynamics", DYNAMICS, 8192), ("dynamics", DYNAMICS, 512),
    # the cost trainer's solves: line search 128 x 16 alphas and 256 x 16
    # (evaluation), rollout and recompute 128 and 256 rows
    ("dynamics", DYNAMICS, 2048), ("cost", COST, 2048), ("cost", COST, 128),
    ("dynamics", DYNAMICS, 4096), ("dynamics", DYNAMICS, 256), ("cost", COST, 4096),
    ("cost", COST, 256),
    ("dynamics", DYNAMICS, 1000), ("wide", WIDE, 8192),
    ("cost", COST, 8192), ("cost", COST, 512),
    ("dynamics", DYNAMICS, 128), ("dynamics", DYNAMICS, 16), ("dynamics", DYNAMICS, 1),
    ("cost", COST, 16), ("cost", COST, 1),
    # ragged against the 16- and 64-row tiles; the wide stack on the 16-row tile
    ("odd", ODD, 9), ("odd", ODD, 17), ("odd", ODD, 65), ("wide", WIDE, 512),
]
TIMED = [("dynamics", DYNAMICS, 8192), ("dynamics", DYNAMICS, 512),
         ("dynamics", DYNAMICS, 128), ("cost", COST, 8192), ("cost", COST, 512),
         ("dynamics", DYNAMICS, 2048), ("cost", COST, 2048)]
# the trainer calls the backward kernel at 128 rows (one time step of a
# minibatch); 8192 is the JAX package's fused-VJP threshold
BWD_CHECKS = [("dynamics", DYNAMICS, 128), ("dynamics", DYNAMICS, 1000),
              ("dynamics", DYNAMICS, 8192), ("wide", WIDE, 128), ("cost", COST, 512),
              ("cost", COST, 128),
              ("odd", ODD, 9), ("odd", ODD, 17), ("odd", ODD, 65),
              ("humanoid-class", HUMANOID, 128)]
BWD_TIMED = [("dynamics", DYNAMICS, 128), ("dynamics", DYNAMICS, 512),
             ("dynamics", DYNAMICS, 8192), ("cost", COST, 128)]
# the dynamics phase of configs/gan_cheetah.yaml (mpc.train.dynamics) and
# runners/gan.py's warm-start default
HORIZON_DYN = 5  # the trainer's window length: the configuration's horizon
DYN = dict(num_episodes=1, num_updates=1, batch_size=128, discount_factor=0.9,
           teacher_forcing_factor=0.7, warm_start_updates=3, expert_updates=0)
DYN_LR = 1e-5
DYN_NO_GRADS = ("mpc_weights", "cost_params", "expert_params")
REPLAY_SIZE = 10000
COLLECT_STEPS = 50  # cut from the configuration's 300 interactions per episode
# (name, lanes, step sizes, state n, actions m, goal width gs) of the
# line-search step; dynamics (n + m) -> 200 -> 200 -> 200 -> n
LS_CHECKS = [
    ("line search", 512, 16, 17, 6, 17), ("rollout", 512, 1, 17, 6, 17),
    ("ragged", 1000, 16, 17, 6, 12), ("humanoid-class", 128, 16, 29, 12, 29),
    ("humanoid-class rollout", 128, 1, 29, 12, 29),
    ("cost-trainer line search", 128, 16, 17, 6, 17), ("cost-trainer rollout", 128, 1, 17, 6, 17),
]
LS_TIMED = [("line search", 512, 16, 17, 6, 17), ("rollout", 512, 1, 17, 6, 17),
            ("cost-trainer line search", 128, 16, 17, 6, 17),
            ("cost-trainer rollout", 128, 1, 17, 6, 17)]
# the cost phase of configs/gan_cheetah.yaml (mpc.train.cost, mpc.bilevel;
# no_grads without critic_params: the flagship policy has no critic)
COST_PHASE = dict(batch_size=128, polyak_factor=0.9, num_updates=1, max_steps_per_update=4,
                  eval_windows=256)
COST_LR = 1e-5
COST_NO_GRADS = ("dynamics_params", "expert_params")
HISTORY_COST = 1  # mpc.history
GRAD_CHECK = dict(windows=16, iters=2, seed=3)  # the card-against-CPU minibatch
# (raw MPC weights, action_goal_scale, action_goal_squared)
LS_WEIGHTS = [
    ((-2.0, 3.0, -3.0), 1.0, False),
    ((-2.0, 3.0, -3.0, 0.5), 1.0, False),
    ((-2.0, 3.0, -3.0, 0.5), 5.0, True),
    ((-2.0, 3.0, -3.0, 0.5, 1.3), 2.0, True),
    ((-2.0, 3.0, -3.0, 0.5, 1.3), 2.0, False),
]
# the committed GAN run of phase 8 and the expert store its normalizer is
# fitted on (the JAX runner's ensure_trajectories would collect a new one)
GAN9 = "runs/trained_models/imitator/pendulum_swingup/gan/9"
GAN9_STORE = "runs/expert_trajectories/pendulum_swingup/trajectories-f690b23776.gmts"
# gan/9's stacks at the rows phase 8 gives them: the critic's dataset 256
# histories x 16 step sizes and 256, a generator step 128 x 16 and 128,
# serving 16 envs x 16 and 16, the 1-env collection 16 and 1
G9_ROWS = (4096, 2048, 256, 128, 16, 1)
G9_TIMED = [("dynamics", 256), ("dynamics", 4096), ("dynamics", 2048), ("dynamics", 128),
            ("cost", 256), ("cost", 4096)]
SERVE_ENVS, SERVE_STEPS = 16, 200  # swing-up takes about 160 steps
# phase 8's cuts of gan/9's config (the rest is the run's own)
G9_CUTS = dict(mpc__train__dynamics__max_interactions_per_episode=50,  # of 300
               mpc__train__cost__num_updates=1,  # of 3
               mpc__train__cost__steps_per_update=4,  # of 61
               mpc__train__cost__eval_windows=256)
# phase 9's cuts of gan/9's config for runners.gan.run (the rest is the
# run's own): 2 epochs of phase 8's epoch, evaluation every epoch on 4
# envs of 25 steps (of 16 of 1000), a pool of 2, and the gain calibrated
# over 2 gains from 1.0 appended to gan/9's 4 weights
G9_RUN_CUTS = dict(G9_CUTS, mpc__train__num_epochs=2,  # of 9
                   mpc__evaluate__every_epochs=1,  # of 3
                   mpc__evaluate__midrun_episodes=4,  # of 16
                   mpc__evaluate__candidate_pool=2,  # of 6
                   mpc__evaluate__selection_episodes=4,  # of 16
                   mpc__evaluate__num_runs_for_avg=4,  # of 16
                   mpc__evaluate__fresh_eval_episodes=4,  # of 16
                   mpc__evaluate__max_interactions=25,  # of 1000
                   mpc__model__cost__calibrate_action_goal_gain=True,
                   mpc__model__cost__gain_grid=[1.0, 1.4],
                   mpc__model__cost__weights__action_goal_gain=1.0,
                   runtime__checkpoint={"every_epochs": 1, "keep": 2},
                   # of 2: the JAX modular loop runs no DAgger round, the port refuses them
                   expert_prediction__dagger__rounds=0)
# cost windows (history 1, H=10) of the whole normalized store: 8 whose
# plans move by less than 5e-5 under rounding-sized nudges, and 16 whose
# plans converge in at most 12 iterations and whose implicit gradient in
# the JAX package moves by at most 2e-5 of its max when they are scaled by
# 1 +- 1e-7 (most of gan/9's solves run all 30 iterations, and their
# implicit gradients move by a median 3%: scripts/diag_gan9_conditioning.py,
# with --windows for these)
G9_STABLE = [1998, 2368, 4699, 4736, 5698, 7696, 9028, 9139]
G9_CONVERGED = [28, 896, 1029, 2100, 2156, 4018, 5068, 6104, 7028, 8155, 8407, 8806, 8911,
                8946, 9093, 9170]
# one H100 SXM (NVIDIA's data sheet): dense TF32 on the tensor cores, HBM3.
# An f32-accurate product takes three TF32 passes (hi x hi, hi x lo, lo x
# hi), so the least time for f32 products is their operations over a third
# of the TF32 rate; the f32 FMA pipes (67 TFLOP/s) are slower than that.
TF32_PEAK = 495e12
F32_PRODUCT_RATE = TF32_PEAK / 3
MEM_RATE = 3.35e12


def device_ms(fn, launches=20, reps=21):
    """Median device time of one ``fn()`` on the current stream."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # the host queues every launch meanwhile
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def mlp_flops(rows, widths):
    """Multiply-add FLOPs of one MLP forward over ``rows`` rows."""
    return 2 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def mlp_weight_floats(widths):
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time for ``ops`` f32-accurate
    operations and ``nbytes`` of device-memory traffic."""
    t_ops, t_bytes = ops / F32_PRODUCT_RATE * 1e3, nbytes / MEM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mlp_bound(rows, widths):
    """Input rows read and output rows written once, weights read once."""
    nbytes = 4 * (rows * (widths[0] + widths[-1]) + mlp_weight_floats(widths))
    return bound(mlp_flops(rows, widths), nbytes)


def ls_bound(lanes, alphas, n, m, gs):
    """The step's operations: the dynamics MLP, the control law
    (dx, K dx, u) and the stage cost (three pseudo-Huber norms, the
    action-goal difference, the weighted sum) and the residual add, per
    row. Bytes: every input read once (per-lane rows once per lane, the
    weights once), every output written once."""
    rows = lanes * alphas
    widths = [n + m, 200, 200, 200, n]
    per_row = n + 2 * m * n + 3 * m + (2 * m + 4 * m + 3 * gs + 12) + n
    ops = mlp_flops(rows, widths) + rows * per_row
    in_floats = rows * n + rows + lanes * (n + m + m + m * n + gs + m) + 4
    out_floats = rows * (n + m + 1)
    return bound(ops, 4 * (in_floats + out_floats + mlp_weight_floats(widths)))


def bwd_bound(rows, widths):
    """The dx chain and dW, each the forward's operations, and the
    recompute of every layer but the last (dW of the last layer takes its
    input, not its output). Bytes: x, g and dx once, the weights read once
    and dW, db written once."""
    nbytes = 4 * (rows * (2 * widths[0] + widths[-1]) + 2 * mlp_weight_floats(widths))
    return bound(2 * mlp_flops(rows, widths) + mlp_flops(rows, widths[:-1]), nbytes)


def clear_of_kinks(rng, rows, layers, device, margin=1e-4):
    """(rows, fin) inputs drawn from ``rng``, each row redrawn until none
    of its hidden pre-activations lies within ``margin`` of 0, and the
    number of redraws. At a relu kink the derivative jumps, so there two
    f32 forwards that round differently disagree on the mask, and dx and
    dW move by a whole term; rounding moves a pre-activation by ~1e-6."""
    fin = layers[0][0].shape[0]
    draw = lambda n: torch.tensor(rng.standard_normal((n, fin)), dtype=torch.float32,
                                  device=device)
    x, redrawn = draw(rows), 0
    while True:
        h, near = x, torch.zeros(rows, dtype=torch.bool, device=device)
        for w, b in layers[:-1]:
            z = h @ w + b
            near |= (z.abs() < margin).any(1)
            h = torch.relu(z)
        bad = near.nonzero().flatten()
        if bad.numel() == 0:
            return x, redrawn
        redrawn += bad.numel()
        x[bad] = draw(bad.numel())


def random_layers(widths, seed, device):
    rng = np.random.default_rng(seed)
    return [
        (torch.tensor(rng.standard_normal((a, b)) / np.sqrt(a), dtype=torch.float32,
                      device=device),
         torch.tensor(0.1 * rng.standard_normal(b), dtype=torch.float32, device=device))
        for a, b in zip(widths[:-1], widths[1:])
    ]


def trained_layers(device):
    """The dynamics stack of CHECKPOINT, loaded as a user would: the
    msgpack tree into a LearnedDynamics. A missing file raises."""
    from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
    from gan_mpc_tpu_torch.params import dynamics_from_jax_params, load_msgpack

    tree = load_msgpack(CHECKPOINT)
    model = LearnedDynamics(ResidualMLPDynamicsNet(17, 6, hidden=tuple(WIDE[1:-1])))
    dynamics_from_jax_params(tree["dynamics_params"], model)
    return [(w.detach(), b.detach()) for w, b in model.requires_grad_(False).to(device).net.stack()]


def check_backward(name, layers, rows, rng, dev):
    """fused_mlp_bwd against reference_backward on rows clear of kinks:
    every output within 1e-4 max(1, max|ref|), a second call bitwise equal.
    Returns the largest max|d|."""
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        bwd_tile_rows, fused_mlp_backward, reference_backward, reference_backward_3xtf32,
    )

    widths = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x, redrawn = clear_of_kinks(rng, rows, layers, dev)
    g = torch.tensor(rng.standard_normal((rows, widths[-1])), dtype=torch.float32, device=dev)
    dx, grads = fused_mlp_backward(x, layers, g)
    rdx, rgrads = reference_backward(x, layers, g)
    mdx, mgrads = reference_backward_3xtf32(x, layers, g, bwd_tile_rows(rows, widths, sms))
    torch.cuda.synchronize()
    flat = lambda d, gr: [d] + [t for pair in gr for t in pair]
    names = ["dx"] + [f"{kind}{l}" for l in range(len(layers)) for kind in ("dW", "db")]
    worst, worst_share, to_model = 0.0, 0.0, 0.0
    for out, t, r, m in zip(names, flat(dx, grads), flat(rdx, rgrads), flat(mdx, mgrads)):
        err = (t - r).abs().max().item()
        tol = 1e-4 * max(1.0, r.abs().max().item())
        if not (err <= tol and tuple(t.shape) == tuple(r.shape)):
            raise SystemExit(f"fused_mlp_bwd disagrees with plain version: {name} "
                             f"rows={rows} output {out}: max|d|={err:.3e} > {tol:.3e}")
        worst, worst_share = max(worst, err), max(worst_share, err / tol)
        to_model = max(to_model, (t - m).abs().max().item() / tol)
    # the cross-tile sums run in a fixed order: a second call gives the same bits
    again = fused_mlp_backward(x, layers, g)
    same = all(torch.equal(a, b) for a, b in zip(flat(*again), flat(dx, grads)))
    print(f"check fused_mlp_bwd {name} {widths} rows={rows} ({redrawn} rows redrawn "
          f"clear of relu kinks): max|d| over dx, {len(layers)} dW and db {worst:.3e}, "
          f"at most {100 * worst_share:.1f}% of its output's bound (to the 3xTF32 model "
          f"{100 * to_model:.1f}%); second call bitwise equal: {same}")
    if not same:
        raise SystemExit(f"fused_mlp_bwd is not deterministic: {name} rows={rows}")
    return worst


def ls_args(lanes, alphas, n, m, gs, weights, seed, device):
    """Inputs of one line-search step, drawn from ``seed``, with the stage
    weights from ``MPCCost.stage_weights`` and W0 split once."""
    from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
    from gan_mpc_tpu_torch.ops.fused_ls import split_w0

    raw, scale, squared = weights
    rng = np.random.default_rng(seed)
    f = lambda shape, s=1.0: torch.tensor(s * rng.standard_normal(shape),
                                          dtype=torch.float32, device=device)
    grid = 0.5 ** np.arange(16)
    alpha = grid[:alphas] if alphas > 1 else rng.choice(grid, (lanes, 1))
    cost = MPCCost(CostFeatureNet(n), 5, mpc_weights=raw, action_goal_scale=scale,
                   action_goal_squared=squared).to(device)
    wvec, ag_scale = cost.stage_weights()
    return dict(
        x3=f((lanes, alphas, n)), Xref=f((lanes, n)), Uref=f((lanes, m), 0.3),
        alphaBA=torch.tensor(np.broadcast_to(alpha, (lanes, alphas)).copy(),
                             dtype=torch.float32, device=device),
        k=f((lanes, m), 0.3), K=f((lanes, m, n), 0.2), goal=f((lanes, gs)),
        goal_u=f((lanes, m), 0.3), wvec=wvec.detach(),
        layers=split_w0(random_layers([n + m, 200, 200, 200, n], seed, device), n),
        gs=gs, action_goal_squared=squared, ag_scale=ag_scale,
    )


def update_pass_inputs(device):
    """The flagship's dynamics (seed weights) with its phase optimizer,
    384 windows and a (3, 128) index matrix, from SEED."""
    from gan_mpc_tpu_torch.bench import flagship
    from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components

    policy = flagship(device=device, seed=SEED)
    opt = masked_adam(policy_components(policy), DYN_NO_GRADS, DYN_LR)
    rng = np.random.default_rng(SEED)
    f = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                    device=device)
    windows = (f(384, HORIZON_DYN, 17), f(384, HORIZON_DYN, 6), f(384, HORIZON_DYN, 17))
    idx = torch.tensor(rng.integers(0, 384, (3, DYN["batch_size"])), device=device)
    return policy.dynamics_model, opt, windows, idx


def check_update_pass(dev):
    """One update pass of 3 minibatches (open loop, so dx flows) on the
    card and on the CPU, on the same windows, indices and weights: the
    gradient of every parameter from the first minibatch's loss, then the
    three losses and the parameters after three Adam steps."""
    from gan_mpc_tpu_torch.training.dynamics import multistep_prediction_loss, update_pass

    results = []
    for device in (dev, torch.device("cpu")):
        model, opt, windows, idx = update_pass_inputs(device)
        X, U, Y = windows
        first = idx[0]
        multistep_prediction_loss(model, X[first], U[first], Y[first], DYN["discount_factor"],
                                  teacher_forcing=False).mean().backward()
        grads = {name: p.grad.detach().cpu().clone() for name, p in model.named_parameters()}
        opt.zero_grad()
        losses = []
        for row in idx:
            losses.append(update_pass(model, opt, windows, row[None], DYN["discount_factor"],
                                      teacher_forcing=False).item())
        results.append((grads, losses, [p.detach().cpu() for p in model.parameters()]))
    (g_gpu, l_gpu, p_gpu), (g_cpu, l_cpu, p_cpu) = results
    # each gradient's max|d| as a share of its bound 1e-4 * max(1, max|ref|)
    d_grad = {name: (g_gpu[name] - ref).abs().max().item()
              / (1e-4 * max(1.0, ref.abs().max().item())) for name, ref in g_cpu.items()}
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    d_par = max((a - b).abs().max().item() for a, b in zip(p_gpu, p_cpu))
    print(f"update pass (3 x 128 windows, open loop) GPU vs CPU: first-minibatch gradients of "
          f"{len(d_grad)} parameters, max|d| at most {100 * max(d_grad.values()):.1f}% of "
          f"1e-4 max(1, max|ref|); losses {l_gpu} vs {l_cpu}, max rel d loss {d_loss:.3e} "
          f"(rtol 1e-4), max|d| params {d_par:.3e} (atol {2 * 3 * DYN_LR:.0e})")
    if not (max(d_grad.values()) <= 1.0 and d_loss <= 1e-4 and d_par <= 2 * 3 * DYN_LR):
        raise SystemExit("the trainer's update pass on the card disagrees with the CPU path")


def train_phase(expert_episode, env, kernels, card_line, dev):
    """Phase 6: one epoch of the dynamics trainer; returns its launches."""
    from gan_mpc_tpu_torch.bench import ILQR_ITERS, flagship
    from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.data.windows import sequence_windows, shuffle_and_split
    from gan_mpc_tpu_torch.envs.rollout import policy_rollout
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
    from gan_mpc_tpu_torch.training.dynamics import train_dynamics
    from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components

    gen = torch.Generator().manual_seed(SEED)
    norm = Normalizer.fit(expert_episode.states, expert_episode.actions)
    windows = sequence_windows(norm.normalize_state(expert_episode.states),
                               norm.normalize_action(expert_episode.actions), HORIZON_DYN)
    train, _ = shuffle_and_split(windows, gen)
    policy = flagship(device=dev, seed=SEED)
    opt = masked_adam(policy_components(policy), DYN_NO_GRADS, DYN_LR)
    replay = ReplayBuffer.create(REPLAY_SIZE, HORIZON_DYN, env.obs_size, env.act_size, dev)
    collect_s = []

    def collect_fn(generator):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep = policy_rollout(env, env.default_params(), policy, norm, num_steps=COLLECT_STEPS,
                            history=1, num_envs=1, generator=generator)
        torch.cuda.synchronize()
        collect_s.append(time.perf_counter() - t0)
        return ep

    batch = DYN["batch_size"]
    steps = (DYN["warm_start_updates"] * max(train[0].shape[0] // batch, 1)
             + DYN["num_updates"] * max(min(COLLECT_STEPS - HORIZON_DYN, REPLAY_SIZE) // batch, 1))
    expected = {"fused_mlp_bwd": steps * HORIZON_DYN, "fused_ls_step": 0,
                "fused_mlp_fwd": steps * HORIZON_DYN + COLLECT_STEPS
                * mlp_calls_per_solve(policy.horizon, ILQR_ITERS)["fused_mlp_fwd"]}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay, returns, losses = train_dynamics(
        policy.dynamics_model, opt, train, replay, collect_fn, norm, generator=gen, epoch=1,
        **DYN)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    train_s = total_s - sum(collect_s)
    print(f"training path: {train[0].shape[0]} expert train windows, {steps} minibatch steps "
          f"of {batch} windows, replay {replay.size} windows; cuts: on-policy episode "
          f"{COLLECT_STEPS} of 300 steps, iLQR {ILQR_ITERS} of 50 iterations; losses {losses}, "
          f"episode return {returns}; kernel launches {counts} (expected {expected})")
    if counts != expected:
        raise SystemExit("the training path did not launch the kernels on every MLP call")
    if not (len(losses) == 4 and np.all(np.isfinite(losses + returns))):
        raise SystemExit("the training path's losses are malformed or not finite")
    print(f"trainer (one GPU: {card_line}; flagship dynamics 23->200->200->200->17, "
          f"batch {batch}, window {HORIZON_DYN}): {steps * batch / train_s:.1f} windows/s, "
          f"{steps / train_s:.2f} minibatch steps/s over {train_s:.3f} s of updates; "
          f"collection {sum(collect_s):.3f} s")
    return counts


def grad_check_inputs(n, seed):
    """``n`` cost windows: histories at the rest pose with 0.01 noise
    (zero past row, as the first control step sees them) and targets at
    the rest pose with 0.05 noise. The seed is one whose windows sit clear
    of line-search flips (the CPU's own spread is printed beside)."""
    rng = np.random.default_rng(seed)
    rest = np.concatenate([[0.64, 0.0, 0.9, -0.75, 0.35, 0.0, 0.0, 0.0], np.zeros(9)])
    hX = np.zeros((n, HISTORY_COST + 1, 17), np.float32)
    hX[:, -1] = rest + 0.01 * rng.standard_normal((n, 17))
    Y = (rest + 0.05 * rng.standard_normal((n, 6, 17))).astype(np.float32)
    return torch.from_numpy(hX), torch.from_numpy(Y)


def check_implicit_step(dev):
    """One minibatch of the cost trainer's loss and gradient (every
    component but the expert differentiated) on the card against the
    CPU, flagship widths, 2 iLQR iterations: loss rel 1e-4, each gradient
    max|d| <= 1e-3 max|ref|; a second call on the card bitwise equal. The
    CPU's own spread under inputs scaled by 1 +- 1e-7 and dynamics weights
    by 1 +- 1e-6 is printed beside: the implicit gradient of the MPC
    weights is the most ill-conditioned."""
    from gan_mpc_tpu_torch.bench import flagship
    from gan_mpc_tpu_torch.policies.losses import l2_imitation_loss
    from gan_mpc_tpu_torch.training.masking import policy_components

    hX, Y = grad_check_inputs(GRAD_CHECK["windows"], GRAD_CHECK["seed"])

    def run(device, x_scale=1.0, w_scale=1.0):
        policy = flagship(HORIZON_DYN, GRAD_CHECK["iters"], device=device, seed=SEED)
        with torch.no_grad():
            for p in policy.dynamics_model.parameters():
                p.mul_(w_scale)
        for name in ("mpc_weights", "cost_params", "dynamics_params"):
            for p in policy_components(policy)[name]:
                p.requires_grad_(True)
        loss, grads = policy.batched_loss_and_grad((hX * x_scale).to(device), l2_imitation_loss,
                                                   (Y.to(device),))
        return loss.item(), {k: [g.cpu() for g in v] for k, v in grads.items()}

    comps = ("mpc_weights", "cost_params", "dynamics_params")
    share = lambda g, ref: {k: max((a - b).abs().max().item() / b.abs().max().item()
                                   for a, b in zip(g[k], ref[k])) for k in comps}
    l_gpu, g_gpu = run(dev)
    l_again, g_again = run(dev)
    l_cpu, g_cpu = run("cpu")
    spread = {k: 0.0 for k in comps}
    for kw in (dict(x_scale=1 + 1e-7), dict(x_scale=1 - 1e-7), dict(w_scale=1 + 1e-6),
               dict(w_scale=1 - 1e-6)):
        spread = {k: max(v, share(run("cpu", **kw)[1], g_cpu)[k]) for k, v in spread.items()}
    d = share(g_gpu, g_cpu)
    same = l_again == l_gpu and all(torch.equal(a, b) for k in g_gpu
                                    for a, b in zip(g_gpu[k], g_again[k]))
    fmt = lambda m: ", ".join(f"{k} {v:.2e}" for k, v in m.items())
    print(f"implicit gradient ({GRAD_CHECK['windows']} windows, {GRAD_CHECK['iters']} iLQR "
          f"iterations, l2 loss) GPU vs CPU: loss {l_gpu:.7g} vs {l_cpu:.7g} (rel "
          f"{abs(l_gpu - l_cpu) / abs(l_cpu):.2e}, tol 1e-4); max|d| / max|ref| {fmt(d)} (tol "
          f"1e-3); the CPU's own spread {fmt(spread)}; second call bitwise equal: {same}")
    if not (abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu) and max(d.values()) <= 1e-3):
        raise SystemExit("the implicit gradient on the card disagrees with the CPU path")
    if not same:
        raise SystemExit("the implicit gradient on the card is not deterministic")


def cost_phase(expert_episode, kernels, card_line, dev):
    """Phase 7: one ``train_cost`` call on the flagship with the cost phase
    of configs/gan_cheetah.yaml; returns its launches."""
    from gan_mpc_tpu_torch.bench import ILQR_ITERS, flagship
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.data.windows import cost_windows, shuffle_and_split
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
    from gan_mpc_tpu_torch.planner.bilevel import mlp_calls_per_step
    from gan_mpc_tpu_torch.policies.losses import l2_imitation_loss
    from gan_mpc_tpu_torch.training.cost import evaluate_cost_loss, train_cost
    from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components

    gen = torch.Generator().manual_seed(SEED)
    norm = Normalizer.fit(expert_episode.states, expert_episode.actions)
    windows = cost_windows(norm.normalize_state(expert_episode.states), HISTORY_COST,
                           HORIZON_DYN)
    train, test = shuffle_and_split(windows, gen)
    policy = flagship(device=dev, seed=SEED)
    opt = masked_adam(policy_components(policy), COST_NO_GRADS, COST_LR)
    before = {k: [p.detach().clone() for p in ps] for k, ps in policy_components(policy).items()}
    plan = policy._plan
    batch, steps = COST_PHASE["batch_size"], COST_PHASE["max_steps_per_update"]
    steps = min(steps, train[0].shape[0] // batch)
    per_step = mlp_calls_per_step(policy.horizon, ILQR_ITERS)
    per_eval = mlp_calls_per_solve(policy.horizon, ILQR_ITERS)
    updates = COST_PHASE["num_updates"]
    expected = {name: steps * per_step[name] + updates * per_eval.get(name, 0)
                for name in kernels}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_losses, test_losses = train_cost(policy, opt, train, test, l2_imitation_loss,
                                           generator=gen, **COST_PHASE)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    print(f"cost-trainer path: {windows[0].shape[0]} windows ({train[0].shape[0]} train, "
          f"{test[0].shape[0]} test), {steps} minibatch steps of {batch} windows, bilevel "
          f"{plan.solver} ridge {plan.ridge}; cuts: iLQR {ILQR_ITERS} of 50 iterations, {updates} "
          f"update of {steps} steps (of 3 updates of {train[0].shape[0] // batch}), evaluation on "
          f"{COST_PHASE['eval_windows']} windows; train losses {train_losses}, test losses "
          f"{test_losses}; kernel launches {counts} (expected {expected} = {steps} x {per_step} "
          f"+ {updates} x {per_eval})")
    if counts != expected:
        raise SystemExit("the cost-trainer path did not launch the kernels on every MLP call")
    if not (len(train_losses) == len(test_losses) == updates
            and np.all(np.isfinite(train_losses + test_losses))):
        raise SystemExit("the cost-trainer path's losses are malformed or not finite")
    for name, ps in policy_components(policy).items():
        moved = any(not torch.equal(p, q) for p, q in zip(ps, before[name]))
        if moved != (name in ("mpc_weights", "cost_params")):
            raise SystemExit(f"cost phase: {name} {'moved' if moved else 'did not move'}")

    # the evaluation alone, then the host time of a minibatch step split
    # into solve (and loss), backward and optimizer
    t0 = time.perf_counter()
    evaluate_cost_loss(policy, l2_imitation_loss, test, eval_windows=COST_PHASE["eval_windows"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    update_s = total_s - eval_s
    split = {"solve": [], "backward": [], "optimizer": []}
    X, Y = train
    for row in torch.randint(train[0].shape[0], (3, batch), generator=gen):
        row = row.to(dev)
        opt.zero_grad()
        marks = [time.perf_counter()]
        loss = policy.batched_loss(X[row], l2_imitation_loss, (Y[row],))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        opt.step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for key, a, b in zip(split, marks, marks[1:]):
            split[key].append(1e3 * (b - a))
    print(f"cost trainer (one GPU: {card_line}; flagship, batch {batch}, H={HORIZON_DYN}): "
          f"{steps / update_s:.3f} minibatch steps/s, {steps * batch / update_s:.1f} windows/s "
          f"over {update_s:.3f} s of updates (train_cost {total_s:.3f} s less one evaluation "
          f"of {COST_PHASE['eval_windows']} windows timed again alone, {eval_s:.3f} s); host ms "
          "per minibatch step, 3 more steps: "
          + "; ".join(f"{k} {', '.join(f'{v:.1f}' for v in vs)}" for k, vs in split.items()))
    return counts


def gan9_config(**cuts):
    """gan/9's training config from its own config.json, continued from
    its own params (``mpc.train.init_from_run``), with ``cuts``."""
    from gan_mpc_tpu_torch.runners import common

    return common.load_run_config(GAN9).replace(mpc__train__init_from_run=GAN9, **cuts)


def gan9_policy(device):
    """gan/9's policy, every component (the critic included) read from its
    params.msgpack by the port's loader, without gradients."""
    from gan_mpc_tpu_torch.runners import common

    policy = common.build_policy(gan9_config(), 3, 1, with_critic=True, device=device)
    return common.load_saved_params(policy, GAN9)


def gan9_windows():
    """Every cost window (history 1, H=10) of the committed store, on the
    CPU, normalized by the normalizer fitted on the store."""
    from gan_mpc_tpu_torch.data.trajectories import load_trajectories
    from gan_mpc_tpu_torch.data.windows import cost_windows
    from gan_mpc_tpu_torch.runners import common

    cfg = gan9_config()
    trajs = load_trajectories(GAN9_STORE, cfg.mpc.train.num_trajectories,
                              cfg.mpc.train.trajectory_len)
    norm = common.build_normalizer(cfg, trajs, "cpu")
    return cost_windows(norm.normalize_state(torch.tensor(trajs.states)), 1, cfg.mpc.horizon)


def check_gan9_plan(dev):
    """gan/9's plan_batch of 8 expert histories on the card against the
    CPU: U atol 1e-3 (phase 4's), iterations printed."""
    X = gan9_windows()[0][G9_STABLE]
    hU = torch.zeros((X.shape[0], 1, 1))
    cpu = gan9_policy("cpu").plan_batch(X, hU)
    gpu = gan9_policy(dev).plan_batch(X.to(dev), hU.to(dev))
    d = (gpu.U.cpu() - cpu.U).abs().max().item()
    print(f"gan/9 plan_batch (8 expert histories, H=10, iLQR <= 30) GPU vs CPU: max|dU|={d:.3e} "
          f"(atol 1e-3); iterations GPU {gpu.iterations.tolist()} CPU {cpu.iterations.tolist()}; "
          f"trips {gpu.trips} and {cpu.trips}")
    if not d <= 1e-3:
        raise SystemExit("gan/9's plan on the card disagrees with the CPU path")


def check_generator_gradient(dev):
    """One generator minibatch's loss and implicit gradient
    (gan_generator_loss on 16 expert histories of gan/9, every component
    but the expert differentiated) on the card against the CPU: the loss
    within 1e-4 of the windows' mean |loss| (their losses take both signs,
    so the mean nearly cancels), each gradient max|d| <= 1e-3 max|ref|; a
    second call on the card bitwise equal; the CPU's own spread under
    inputs scaled by 1 +- 1e-7 and dynamics weights by 1 +- 1e-6 printed
    beside."""
    from gan_mpc_tpu_torch.policies.losses import gan_generator_loss
    from gan_mpc_tpu_torch.training.masking import policy_components

    comps = ("mpc_weights", "cost_params", "dynamics_params", "critic_params")
    X = gan9_windows()[0][G9_CONVERGED]

    def run(device, x_scale=1.0, w_scale=1.0):
        policy = gan9_policy(device)
        with torch.no_grad():
            for p in policy.dynamics_model.parameters():
                p.mul_(w_scale)
        for name in comps:
            for p in policy_components(policy)[name]:
                p.requires_grad_(True)
        loss, grads = policy.batched_loss_and_grad((X * x_scale).to(device), gan_generator_loss)
        return loss.item(), {k: [g.cpu() for g in grads[k]] for k in comps}

    share = lambda g, ref: {k: max((a - b).abs().max().item() / b.abs().max().item()
                                   for a, b in zip(g[k], ref[k])) for k in comps}
    l_gpu, g_gpu = run(dev)
    l_again, g_again = run(dev)
    l_cpu, g_cpu = run("cpu")
    with torch.no_grad():
        policy = gan9_policy("cpu")
        scale = gan_generator_loss(policy, policy.plan(X)).abs().mean().item()
    spread = {k: 0.0 for k in comps}
    for kw in (dict(x_scale=1 + 1e-7), dict(x_scale=1 - 1e-7), dict(w_scale=1 + 1e-6),
               dict(w_scale=1 - 1e-6)):
        spread = {k: max(v, share(run("cpu", **kw)[1], g_cpu)[k]) for k, v in spread.items()}
    d = share(g_gpu, g_cpu)
    same = l_again == l_gpu and all(torch.equal(a, b) for k in comps
                                    for a, b in zip(g_gpu[k], g_again[k]))
    fmt = lambda m: ", ".join(f"{k} {v:.2e}" for k, v in m.items())
    print(f"gan/9 generator implicit gradient ({len(G9_CONVERGED)} histories, gan_generator_loss) "
          f"GPU vs CPU: loss {l_gpu:.7g} vs {l_cpu:.7g} (|d| {abs(l_gpu - l_cpu):.2e}, "
          f"tol 1e-4 x mean |loss| {scale:.4g}); max|d| / max|ref| {fmt(d)} (tol 1e-3); the CPU's own spread "
          f"{fmt(spread)}; second call bitwise equal: {same}")
    if not (abs(l_gpu - l_cpu) <= 1e-4 * scale and max(d.values()) <= 1e-3):
        raise SystemExit("gan/9's generator gradient on the card disagrees with the CPU path")
    if not same:
        raise SystemExit("gan/9's generator gradient on the card is not deterministic")


@contextlib.contextmanager
def solves_recorded():
    """Each ``batch_ilqr`` call that the policy or the implicit planner
    makes inside the block appends the trips it ran to the yielded list."""
    from gan_mpc_tpu_torch.planner import bilevel
    from gan_mpc_tpu_torch.policies import mpc

    trips, original = [], mpc.batch_ilqr

    def solve(*args, **kwargs):
        sol = original(*args, **kwargs)
        trips.append(sol.trips)
        return sol

    mpc.batch_ilqr = bilevel.batch_ilqr = solve
    try:
        yield trips
    finally:
        mpc.batch_ilqr = bilevel.batch_ilqr = original


def gan9_phase(kernels, card_line, dev):
    """Phase 8: gan/9 loaded as the GAN runner loads it, served closed
    loop, then continued by one GAN epoch. Returns the launches of each."""
    from gan_mpc_tpu_torch.envs.rollout import batch_policy_rollout
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
    from gan_mpc_tpu_torch.runners import common, gan
    from gan_mpc_tpu_torch.training.masking import policy_components

    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = common.setup(gan9_config(**G9_CUTS), True, GAN9_STORE, dev, gen)
    torch.cuda.synchronize()
    cfg, policy = ctx["config"], ctx["policy"]
    H, settings = policy.horizon, policy.settings
    print(f"gan/9 loaded from {GAN9}/config.json and params.msgpack (every component: "
          f"{', '.join(policy_components(policy))}), normalizer fitted on {GAN9_STORE} "
          f"({ctx['trajs'].states.shape[0]} trajectories of {ctx['trajs'].states.shape[1]} "
          f"steps), in {time.perf_counter() - t0:.2f} s; H={H}, iLQR <= "
          f"{settings.max_iterations}, "
          f"fused_ls={settings.fused_ls}")

    # serving
    trips = []

    def act(hist_x, hist_u):
        sol = policy.plan_batch(hist_x, hist_u)
        trips.append(sol.trips)
        return sol.U[:, 0]

    env, env_params, norm = ctx["env_im"], ctx["env_im_params"], ctx["normalizer"]
    batch_policy_rollout(env, env_params, act, norm, WARMUP_STEPS, cfg.mpc.history, SERVE_ENVS,
                         generator=gen)
    trips.clear()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = batch_policy_rollout(env, env_params, act, norm, SERVE_STEPS, cfg.mpc.history,
                              SERVE_ENVS, generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    serve_counts = {name: k.launches for name, k in kernels.items()}
    expected = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips)), fused_mlp_bwd=0)
    returns = ep.rewards.sum(1)
    print(f"gan/9 serving: {SERVE_ENVS} envs x {SERVE_STEPS} control steps (of 1000) on the "
          f"imitator's pendulum in {dt:.3f} s: {SERVE_ENVS * SERVE_STEPS / dt:.2f} env steps/s, "
          f"{SERVE_STEPS / dt:.3f} control steps/s (one GPU: {card_line}); mean return "
          f"{returns.mean().item():.2f} (per env {[round(r, 1) for r in returns.tolist()]}); "
          f"trips per solve mean {np.mean(trips):.2f} max {max(trips)} min {min(trips)}; kernel "
          f"launches {serve_counts} (expected {expected} from the solver's {len(trips)} solves "
          f"and {sum(trips)} trips)")
    if serve_counts != expected:
        raise SystemExit("gan/9 serving did not launch the kernels on every MLP call")
    shapes = {"states": (SERVE_ENVS, SERVE_STEPS, 3), "actions": (SERVE_ENVS, SERVE_STEPS, 1),
              "rewards": (SERVE_ENVS, SERVE_STEPS)}
    for name, shape in shapes.items():
        t = getattr(ep, name)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise SystemExit(f"gan/9 serving output {name} is malformed or not finite")

    # one GAN epoch, each phase watched: its wall time and what it moved
    tcfg = cfg.mpc.train
    phases = {"train_dynamics": tcfg.dynamics, "train_critic": tcfg.critic,
              "train_cost": tcfg.cost}
    watched, originals = {}, {name: getattr(gan, name) for name in phases}
    for name, pcfg in phases.items():
        def watch(*args, _name=name, _fn=getattr(gan, name), **kwargs):
            comps = policy_components(policy)
            before = {k: [p.detach().clone() for p in ps] for k, ps in comps.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            moved = {k for k, ps in comps.items()
                     if any(not torch.equal(p, q) for p, q in zip(ps, before[k]))}
            watched[_name] = (time.perf_counter() - t0, moved)
            return out
        setattr(gan, name, watch)
    opts = gan.phase_optimizers(ctx)
    for k in kernels.values():
        k.launches = 0
    try:
        with solves_recorded() as trips:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            record = gan.gan_epoch(ctx, opts, 1, gen)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(gan, name, fn)
    epoch_counts = {name: k.launches for name, k in kernels.items()}
    dcfg, ccfg = tcfg.dynamics, tcfg.cost
    batches = lambda n, b: max(n // b, 1)
    n_dyn, n_cost = ctx["dyn_train"][0].shape[0], ctx["cost_data"][0][0].shape[0]
    dyn_steps = ((dcfg.warm_start_updates + dcfg.expert_updates) * batches(n_dyn, dcfg.batch_size)
                 + dcfg.num_updates * batches(ctx["replay"].size, dcfg.batch_size))
    gen_steps = ccfg.num_updates * min(batches(n_cost, ccfg.batch_size), ccfg.steps_per_update)
    solves = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips)))
    expected = {"fused_mlp_fwd": solves["fused_mlp_fwd"] + H * dyn_steps + (H + 1) * gen_steps,
                "fused_ls_step": 0, "fused_mlp_bwd": H * dyn_steps + H * gen_steps}
    print(f"gan/9 GAN epoch (one GPU: {card_line}) in {epoch_s:.3f} s; cuts: on-policy episode "
          f"{dcfg.max_interactions_per_episode} of 300 steps at 1 env (noise "
          f"{dcfg.collection_noise}), generator {ccfg.num_updates} update of "
          f"{ccfg.steps_per_update} minibatch steps (of 3 of {batches(n_cost, ccfg.batch_size)}), "
          f"evaluation on {ccfg.eval_windows} windows; the dynamics' updates, the critic "
          f"(plan_batch {tcfg.critic.get_path('plan_batch', 256)}, {tcfg.critic.num_updates} "
          f"updates of batch {tcfg.critic.batch_size}) and the rest as the run's config")
    for name, (secs, moved) in watched.items():
        print(f"  {name}: {secs:.3f} s, moved {sorted(moved)}")
    for key, values in record.items():
        print(f"  {key}: {values}")
    print(f"  kernel launches {epoch_counts} (expected {expected}: {len(trips)} solves "
          f"of {sum(trips)} trips, {dyn_steps} dynamics steps and {gen_steps} generator "
          f"steps of {H} time steps)")
    if epoch_counts != expected:
        raise SystemExit("the GAN epoch did not launch the kernels on every MLP call")
    if not all(v and np.all(np.isfinite(v)) for v in record.values()):
        raise SystemExit("the GAN epoch's losses are missing or not finite")
    ln2 = float(np.log(2.0))
    critic = record["critic_train_losses"] + record["critic_test_losses"]
    if not all(abs(v - ln2) <= 0.05 for v in critic):
        raise SystemExit(f"the critic's losses {critic} are not near ln 2")
    comps = set(policy_components(policy))
    for name, pcfg in phases.items():
        if watched[name][1] != comps - set(pcfg.no_grads):
            raise SystemExit(f"{name} moved {sorted(watched[name][1])}, not its own components")
    return {"gan/9 serving": serve_counts, "gan/9 epoch": epoch_counts}


@contextlib.contextmanager
def run_watched():
    """Times each piece of a training run (``runners.l2``'s module functions,
    ``runners.gan.gan_epoch``) as the run calls it; yields the list of
    (kind, seconds). An evaluation is "selection" inside the re-rank and
    "final" outside it; "midrun" is the periodic evaluation with its
    solver statistics."""
    from gan_mpc_tpu_torch.runners import gan, l2

    timed, inside = [], []

    def watch(kind, fn):
        def watched(*args, **kwargs):
            inside.append(kind)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                inside.pop()
                if kind != "evaluate" or not inside:
                    timed.append(("final" if kind == "evaluate" else kind,
                                  time.perf_counter() - t0))
        return watched

    patched = [(gan, "gan_epoch", "epoch"), (l2, "midrun_eval", "midrun"),
               (l2, "select_best_params", "selection"), (l2, "calibrate_gain", "calibration"),
               (l2, "evaluate", "evaluate"), (l2, "fresh_seed_eval", "fresh")]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, kind in patched:
        setattr(mod, name, watch(kind, getattr(mod, name)))
    try:
        yield timed
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


@contextlib.contextmanager
def update_steps_recorded():
    """Each minibatch step of the dynamics and the cost trainers inside the
    block adds one to the yielded dict's entry."""
    from gan_mpc_tpu_torch.training import cost, dynamics

    steps = {"dynamics": 0, "cost": 0}
    originals = {"dynamics": dynamics.update_pass, "cost": cost.update_pass}

    def counting(name):
        def update_pass(*args, **kwargs):
            indices = args[4] if name == "cost" else args[3]
            steps[name] += indices.shape[0]
            return originals[name](*args, **kwargs)
        return update_pass

    dynamics.update_pass, cost.update_pass = counting("dynamics"), counting("cost")
    try:
        yield steps
    finally:
        dynamics.update_pass, cost.update_pass = originals["dynamics"], originals["cost"]


def gan_run_phase(kernels, card_line, dev):
    """Phase 9: ``runners.gan.run`` on gan/9 with ``G9_RUN_CUTS``, crashed
    after epoch 1 and resumed; the saved run reloaded bitwise. Returns the
    run's launches."""
    import os
    import tempfile

    from gan_mpc_tpu_torch.params import to_jax_params
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
    from gan_mpc_tpu_torch.runners import common, gan, l2

    class Interrupted(RuntimeError):
        pass

    logs = []

    def log_crashing(msg):
        print(f"  {msg}")
        logs.append(msg)
        if msg.startswith("[gan] epoch 1 "):
            raise Interrupted(msg)

    def log(msg):
        print(f"  {msg}")
        logs.append(msg)

    with tempfile.TemporaryDirectory() as workdir:
        cfg = gan9_config(**G9_RUN_CUTS).replace(runtime__workdir=workdir,
                                                 env__trajectories_path=GAN9_STORE)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with solves_recorded() as trips, update_steps_recorded() as steps, \
                run_watched() as timed:
            try:
                gan.run(cfg, log_fn=log_crashing, device=dev)
                raise SystemExit("the GAN run was not interrupted after epoch 1")
            except Interrupted:
                pass
            t_first = time.perf_counter() - t0
            ckpt = l2.checkpointer_for(cfg, "gan")
            if ckpt.latest_step() != 1:
                raise SystemExit("the interrupted GAN run left no epoch-1 checkpoint")
            out = gan.run(cfg, log_fn=log, device=dev)
            torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = {name: k.launches for name, k in kernels.items()}
        H = cfg.mpc.horizon
        solves = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips)))
        expected = {"fused_mlp_fwd": solves["fused_mlp_fwd"] + H * steps["dynamics"]
                    + (H + 1) * steps["cost"],
                    "fused_ls_step": 0, "fused_mlp_bwd": H * (steps["dynamics"] + steps["cost"])}
        run_dir, history = out["run_dir"], out["history"]
        stamp = l2.io.load_json(os.path.join(run_dir, "config.json"))
        files = sorted(os.listdir(run_dir))
        with open(os.path.join(workdir, "metrics", cfg.env.name, "gan.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        cleared = ckpt.latest_step() is None
        # the saved run, reloaded as a continuation loads it
        ctx = common.setup(cfg.replace(mpc__train__init_from_run=run_dir), True, device=dev)
        reloaded = to_jax_params(ctx["policy"])

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tree[k]

    got, want = dict(leaves(reloaded)), dict(leaves(out["params"]))
    bitwise = sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    kinds = {}
    for kind, secs in timed:
        kinds.setdefault(kind, []).append(round(secs, 3))
    print(f"gan/9 run (runners.gan.run, one GPU: {card_line}): {total_s:.3f} s, of it "
          f"{t_first:.3f} s until the interruption after epoch 1; cuts {G9_RUN_CUTS}")
    print(f"  wall s by piece: {kinds}")
    print(f"  selection and gain: {[m for m in logs if m.startswith(('[select]', '[calibrate]'))]}; "
          f"stamped reward {stamp['reward']}, fresh_eval {stamp['fresh_eval']}, "
          f"dm_control_reward {stamp['dm_control_reward']}")
    print(f"  saved {run_dir}: {files}; mpc_weights {out['params']['mpc_weights'].tolist()}; "
          f"reload bitwise equal {bitwise}; checkpoints cleared {cleared}; "
          f"{len(rows)} metrics rows")
    print(f"  kernel launches {counts} (expected {expected}: {len(trips)} solves of "
          f"{sum(trips)} trips, {steps['dynamics']} dynamics and {steps['cost']} generator "
          f"steps of {H} time steps)")
    if not any(m == "[gan] resumed from checkpoint at epoch 1" for m in logs):
        raise SystemExit("the GAN run did not resume from its epoch-1 checkpoint")
    if sum(m.startswith("[gan] epoch 2 return") for m in logs) != 1 or \
            sum(m.startswith("[gan] epoch 1 return") for m in logs) != 1:
        raise SystemExit("the GAN run did not train epoch 1, then epoch 2 alone after resuming")
    if not cleared:
        raise SystemExit("the finished GAN run left its checkpoints")
    if not bitwise:
        raise SystemExit("the saved GAN run does not reload bitwise")
    if files != sorted(["config.json", "params.msgpack", *(f"{n}.json" for n in gan.GAN_HISTORY)]):
        raise SystemExit(f"the saved GAN run holds {files}")
    if out["params"]["mpc_weights"].shape != (5,):
        raise SystemExit("the calibrated gain was not appended to the MPC weights")
    values = [v for vs in history.values() for v in vs] + [stamp["reward"]]
    values += stamp["fresh_eval"]["episodes"]
    if not all(vs for vs in history.values()) or not np.all(np.isfinite(values)):
        raise SystemExit("the GAN run's losses or returns are missing or not finite")
    epochs = {r["step"] for r in rows if "generator_train_loss" in r}
    evals = {r["step"] for r in rows if "eval_reward" in r}
    if epochs != {1, 2} or evals != {2}:
        raise SystemExit(f"gan.jsonl holds epoch rows {epochs} and eval rows {evals}")
    if counts != expected:
        raise SystemExit("the GAN run did not launch the kernels on every MLP call")
    return {"gan run": counts}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gan_mpc_tpu_torch import pin_fp32
    from gan_mpc_tpu_torch.bench import (
        FUSED_LS, HORIZON, ILQR_ITERS, NUM_ENVS, bench_row, card, flagship, run_steps,
    )
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.envs.base import EnvState
    from gan_mpc_tpu_torch.ops import _build
    from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_kernel, reference_ls_step
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        bwd_tile_plan, fused_mlp_backward, fused_mlp_forward, mlp_apply, reference_backward,
        reference_forward, tile_plan,
    )
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve

    pin_fp32()
    dev = torch.device("cuda")
    card_line = card()
    kernels = {"fused_mlp_fwd": fused_mlp_forward, "fused_ls_step": fused_ls_kernel,
               "fused_mlp_bwd": fused_mlp_backward}

    # 1. card, toolchain, build
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.build_libraries(list(kernels))
    for k in kernels.values():
        k.load()
    print(f"build {', '.join(kernels)} (in parallel): {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"  {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            entry = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                              r"(?:I((?:L[ib]\d+E)+)E)?", line)
            if entry:  # the instance, e.g. fused_mlp_fwd_kernel<2, 2> or sum_parts_kernel
                args = re.findall(r"L[ib](\d+)E", entry.group(2) or "")
                print(f"    {entry.group(1)}" + (f"<{', '.join(args)}>" if args else ""))
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    # the kernels' dynamic shared memory
    for name, widths, extra in (("fused_mlp_fwd dynamics", DYNAMICS, 0),
                                ("fused_mlp_fwd cost", COST, 0),
                                ("fused_ls_step dynamics", DYNAMICS, DYNAMICS[0])):
        for tile_rows in (64, 16):
            plan = tile_plan(widths, tile_rows, tile_rows * extra)
            print(f"  {name}, {tile_rows}-row tile: {plan['smem']} B of shared memory, "
                  f"ring of {plan['stages']} stages x {plan['stage_floats'] * 4} B, "
                  f"weight rows per chunk {plan['step']}")
    for name, widths in (("dynamics", DYNAMICS), ("wide", WIDE), ("cost", COST),
                         ("humanoid-class", HUMANOID), ("odd", ODD)):
        for tile_rows in (32, 16):
            plan = bwd_tile_plan(widths, tile_rows)
            if plan is None:
                print(f"  fused_mlp_bwd {name}, {tile_rows}-row tile: does not fit")
                continue
            print(f"  fused_mlp_bwd {name}, {tile_rows}-row tile: {plan['smem']} B of shared "
                  f"memory, planes of row strides {plan['sa']} ({plan['ring_at'] * 4} B), "
                  f"ring of {plan['stages']} stages x {plan['stage_floats'] * 4} B, weight rows "
                  f"per recompute chunk {plan['step']}")

    # 2. kernels against plain versions on the card
    max_err = dict.fromkeys(kernels, 0.0)
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for i, (name, widths, rows) in enumerate(CHECKS):
            layers = random_layers(widths, i, dev)
            x = torch.tensor(rng.standard_normal((rows, widths[0])),
                             dtype=torch.float32, device=dev)
            got = mlp_apply(x, layers)
            ref = reference_forward(x, layers)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            print(f"check fused_mlp_fwd {name} {widths} rows={rows}: "
                  f"max|d|={err:.3e} bound={tol:.3e}")
            if not err <= tol:
                raise SystemExit(f"fused_mlp_fwd disagrees with plain version: {name} rows={rows}")
            max_err["fused_mlp_fwd"] = max(max_err["fused_mlp_fwd"], err)

        for i, (name, lanes, alphas, n, m, gs) in enumerate(LS_CHECKS):
            for j, weights in enumerate(LS_WEIGHTS):
                args = ls_args(lanes, alphas, n, m, gs, weights, 100 * i + j, dev)
                got = fused_ls_kernel(**args)
                ref = reference_ls_step(**args)
                torch.cuda.synchronize()
                errs = []
                for out, g, r in zip(("nx", "u", "cost"), got, ref):
                    err = (g - r).abs().max().item()
                    tol = 1e-4 * max(1.0, r.abs().max().item())
                    if not (err <= tol and tuple(g.shape) == tuple(r.shape)):
                        raise SystemExit(
                            f"fused_ls_step disagrees with plain version: {name} "
                            f"{lanes}x{alphas} weights {weights} output {out}: "
                            f"max|d|={err:.3e} > {tol:.3e}")
                    errs.append(err)
                    max_err["fused_ls_step"] = max(max_err["fused_ls_step"], err)
                print(f"check fused_ls_step {name} {lanes}x{alphas} n={n} m={m} gs={gs} "
                      f"raw={len(weights[0])} squared={weights[2]}: max|d| nx/u/cost "
                      f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}")

        for i, (name, widths, rows) in enumerate(BWD_CHECKS):
            err = check_backward(name, random_layers(widths, 200 + i, dev), rows, rng, dev)
            max_err["fused_mlp_bwd"] = max(max_err["fused_mlp_bwd"], err)

        # an empty call: no rows, zero gradients of the right shapes
        layers = random_layers(DYNAMICS, 299, dev)
        dx, grads = fused_mlp_backward(torch.empty((0, DYNAMICS[0]), device=dev), layers,
                                       torch.empty((0, DYNAMICS[-1]), device=dev))
        torch.cuda.synchronize()
        if tuple(dx.shape) != (0, DYNAMICS[0]) or any(
                t.shape != p.shape or bool(t.any()) for pair, wb in zip(grads, layers)
                for t, p in zip(pair, wb)):
            raise SystemExit("fused_mlp_bwd on 0 rows: gradients are not zeros of the "
                             "weights' shapes")
        print("check fused_mlp_bwd dynamics rows=0: dx empty, every dW and db zero")

        # both MLP kernels on trained weights
        layers = trained_layers(dev)
        x = torch.tensor(rng.standard_normal((128, WIDE[0])), dtype=torch.float32, device=dev)
        got, ref = mlp_apply(x, layers), reference_forward(x, layers)
        torch.cuda.synchronize()
        err, tol = (got - ref).abs().max().item(), 1e-4 * max(1.0, ref.abs().max().item())
        print(f"check fused_mlp_fwd trained dynamics of {CHECKPOINT} {WIDE} rows=128: "
              f"max|d|={err:.3e} bound={tol:.3e}")
        if not err <= tol:
            raise SystemExit("fused_mlp_fwd disagrees with plain version on trained weights")
        max_err["fused_mlp_fwd"] = max(max_err["fused_mlp_fwd"], err)
        err = check_backward("trained dynamics", layers, 128, rng, dev)
        max_err["fused_mlp_bwd"] = max(max_err["fused_mlp_bwd"], err)

        # both MLP kernels on gan/9's trained stacks, at the rows phase 8 gives them
        g9 = gan9_policy(dev)
        g9_stacks = {name: [(w.detach(), b.detach()) for w, b in model.net.stack()]
                     for name, model in (("dynamics", g9.dynamics_model),
                                         ("cost", g9.cost_model))}
        for name, layers in g9_stacks.items():
            widths = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
            for rows in G9_ROWS:
                x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                                 device=dev)
                got, ref = mlp_apply(x, layers), reference_forward(x, layers)
                torch.cuda.synchronize()
                err, tol = (got - ref).abs().max().item(), 1e-4 * max(1.0, ref.abs().max().item())
                print(f"check fused_mlp_fwd gan/9 {name} {widths} rows={rows}: "
                      f"max|d|={err:.3e} bound={tol:.3e}")
                if not err <= tol:
                    raise SystemExit(f"fused_mlp_fwd disagrees with plain version on gan/9's "
                                     f"{name} stack at {rows} rows")
                max_err["fused_mlp_fwd"] = max(max_err["fused_mlp_fwd"], err)
        err = check_backward("gan/9 dynamics", g9_stacks["dynamics"], 128, rng, dev)
        max_err["fused_mlp_bwd"] = max(max_err["fused_mlp_bwd"], err)

        # 3. times and bounds
        print(f"bounds: operations over {F32_PRODUCT_RATE / 1e12:.0f} TFLOP/s (three TF32 "
              f"tensor-core passes per f32-accurate product, {TF32_PEAK / 1e12:.0f} / 3), "
              f"bytes over {MEM_RATE / 1e12:.2f} TB/s")
        timed = {}
        for i, (name, widths, rows) in enumerate(TIMED):
            layers = random_layers(widths, 100 + i, dev)
            x = torch.tensor(rng.standard_normal((rows, widths[0])),
                             dtype=torch.float32, device=dev)
            k = device_ms(lambda: fused_mlp_forward(x, layers))
            p = device_ms(lambda: reference_forward(x, layers))
            b_ms, b_by = mlp_bound(rows, widths)
            timed[("fused_mlp_fwd", name, rows)] = (k, p, b_ms, b_by)
            gf = mlp_flops(rows, widths) / 1e9
            print(f"time fused_mlp_fwd {name} {widths} rows={rows}: kernel {k:.4f} ms "
                  f"({gf / k * 1e3:.0f} GFLOP/s), plain {p:.4f} ms, bound {b_ms:.5f} ms "
                  f"({b_by}), kernel at {100 * b_ms / k:.1f}% of bound")
        for i, (name, widths, rows) in enumerate(BWD_TIMED):
            layers = random_layers(widths, 300 + i, dev)
            x = torch.tensor(rng.standard_normal((rows, widths[0])),
                             dtype=torch.float32, device=dev)
            g = torch.tensor(rng.standard_normal((rows, widths[-1])),
                             dtype=torch.float32, device=dev)
            k = device_ms(lambda: fused_mlp_backward(x, layers, g))
            p = device_ms(lambda: reference_backward(x, layers, g))
            b_ms, b_by = bwd_bound(rows, widths)
            timed[("fused_mlp_bwd", name, rows)] = (k, p, b_ms, b_by)
            print(f"time fused_mlp_bwd {name} {widths} rows={rows}: kernel {k:.4f} ms, "
                  f"plain {p:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
                  f"kernel at {100 * b_ms / k:.1f}% of bound")
        for name, rows in G9_TIMED:
            layers = g9_stacks[name]
            widths = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
            x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                             device=dev)
            k = device_ms(lambda: fused_mlp_forward(x, layers))
            p = device_ms(lambda: reference_forward(x, layers))
            b_ms, b_by = mlp_bound(rows, widths)
            timed[("fused_mlp_fwd", f"gan/9 {name}", rows)] = (k, p, b_ms, b_by)
            print(f"time fused_mlp_fwd gan/9 {name} {widths} rows={rows}: kernel {k:.4f} ms, "
                  f"plain {p:.4f} ms, bound {b_ms:.5f} ms ({b_by}), kernel at "
                  f"{100 * b_ms / k:.1f}% of bound")
        layers, widths = g9_stacks["dynamics"], [4, 200, 200, 200, 3]
        x = torch.tensor(rng.standard_normal((128, 4)), dtype=torch.float32, device=dev)
        g = torch.tensor(rng.standard_normal((128, 3)), dtype=torch.float32, device=dev)
        k = device_ms(lambda: fused_mlp_backward(x, layers, g))
        p = device_ms(lambda: reference_backward(x, layers, g))
        b_ms, b_by = bwd_bound(128, widths)
        timed[("fused_mlp_bwd", "gan/9 dynamics", 128)] = (k, p, b_ms, b_by)
        print(f"time fused_mlp_bwd gan/9 dynamics {widths} rows=128: kernel {k:.4f} ms, "
              f"plain {p:.4f} ms, bound {b_ms:.5f} ms ({b_by}), kernel at "
              f"{100 * b_ms / k:.1f}% of bound")
        for i, (name, lanes, alphas, n, m, gs) in enumerate(LS_TIMED):
            args = ls_args(lanes, alphas, n, m, gs, LS_WEIGHTS[0], 900 + i, dev)
            k = device_ms(lambda: fused_ls_kernel(**args))
            p = device_ms(lambda: reference_ls_step(**args))
            b_ms, b_by = ls_bound(lanes, alphas, n, m, gs)
            timed[("fused_ls_step", name, lanes * alphas)] = (k, p, b_ms, b_by)
            print(f"time fused_ls_step {name} {lanes}x{alphas} rows={lanes * alphas}: "
                  f"kernel {k:.4f} ms, plain {p:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
                  f"kernel at {100 * b_ms / k:.1f}% of bound")

    # 4. the path's pieces on a small input against the CPU plain path
    env_gpu, env_cpu = make_env("cheetah_run", dev), make_env("cheetah_run", "cpu")
    state = env_cpu.reset(env_cpu.default_params(), 8, torch.Generator().manual_seed(SEED))
    hX = torch.zeros((8, 2, 17))
    hX[:, 1] = env_cpu.observe(env_cpu.default_params(), state)
    hU = torch.zeros((8, 1, 6))
    for fused_ls in FUSED_LS:
        small_gpu = flagship(HORIZON, 2, device=dev, seed=SEED, fused_ls=fused_ls)
        small_cpu = flagship(HORIZON, 2, device="cpu", seed=SEED, fused_ls=fused_ls)
        U_cpu = small_cpu.plan_batch(hX, hU).U
        U_gpu = small_gpu.plan_batch(hX.to(dev), hU.to(dev)).U.cpu()
        d_plan = (U_gpu - U_cpu).abs().max().item()
        print(f"small plan_batch (8 envs, 2 iters, fused_ls={fused_ls}) GPU vs CPU: "
              f"max|dU|={d_plan:.3e} (atol 1e-3)")
        if not d_plan <= 1e-3:
            raise SystemExit(f"plan_batch (fused_ls={fused_ls}) on the card disagrees "
                             "with the CPU path")
    u = U_cpu[:, 0]
    s_cpu, r_cpu = env_cpu.step(env_cpu.default_params(), state, u)
    s_gpu, r_gpu = env_gpu.step(
        env_gpu.default_params(),
        EnvState(state.qpos.to(dev), state.qvel.to(dev), state.t.to(dev)), u.to(dev),
    )
    d_step = max((s_gpu.qpos.cpu() - s_cpu.qpos).abs().max().item(),
                 (s_gpu.qvel.cpu() - s_cpu.qvel).abs().max().item(),
                 (r_gpu.cpu() - r_cpu).abs().max().item())
    print(f"cheetah step GPU vs CPU: max|d|={d_step:.3e} (atol 1e-4)")
    if not d_step <= 1e-4:
        raise SystemExit("the physics step on the card disagrees with the CPU path")
    check_update_pass(dev)
    check_implicit_step(dev)
    check_gan9_plan(dev)
    check_generator_gradient(dev)

    # 5. the main path, once per solver setting
    env = make_env("cheetah_run", dev)
    norm = Normalizer.identity(env.obs_size, env.act_size, dev)
    launches, episodes = {}, {}
    for fused_ls in FUSED_LS:
        policy = flagship(device=dev, seed=SEED, fused_ls=fused_ls)
        gen = torch.Generator().manual_seed(SEED)
        _, t_warm = run_steps(policy, env, norm, WARMUP_STEPS, gen)
        for k in kernels.values():
            k.launches = 0
        ep, dt = run_steps(policy, env, norm, STEPS, gen)
        counts = {name: k.launches for name, k in kernels.items()}
        per_step = mlp_calls_per_solve(HORIZON, ILQR_ITERS, fused=fused_ls == "on")
        expected = {name: STEPS * c for name, c in per_step.items()}
        expected["fused_mlp_bwd"] = 0
        launches[f"fused_ls={fused_ls}"] = counts
        episodes[fused_ls] = ep
        print(f"main path fused_ls={fused_ls}: {STEPS} steps x {NUM_ENVS} envs in "
              f"{dt:.3f} s (warmup {WARMUP_STEPS} steps {t_warm:.3f} s); kernel launches "
              f"{counts} (expected {expected} = {STEPS} x {per_step})")
        if counts != expected:
            raise SystemExit(f"the main path (fused_ls={fused_ls}) did not launch the "
                             "kernels on every call")
        shapes = {"states": (NUM_ENVS, STEPS, 17), "actions": (NUM_ENVS, STEPS, 6),
                  "rewards": (NUM_ENVS, STEPS)}
        for name, shape in shapes.items():
            t = getattr(ep, name)
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                raise SystemExit(f"main path output {name} is malformed or not finite")
        print(f"actions in [{ep.actions.min().item():.3f}, {ep.actions.max().item():.3f}], "
              f"mean reward {ep.rewards.mean().item():.4f}")
        print(json.dumps(bench_row(NUM_ENVS * STEPS / dt, card_line, fused_ls)))

    # 6. the training path
    launches["trainer"] = train_phase(episodes["off"], env, kernels, card_line, dev)

    # 7. the cost-trainer path
    launches["cost trainer"] = cost_phase(episodes["off"], kernels, card_line, dev)

    # 8. the GAN slice on the committed run gan/9
    launches.update(gan9_phase(kernels, card_line, dev))

    # 9. the GAN training run on gan/9, interrupted and resumed
    launches.update(gan_run_phase(kernels, card_line, dev))

    # the planner's line-search call (8192 rows) leads the forward kernels'
    # entries, the trainer's call (128 rows) the backward kernel's
    lead = {"fused_mlp_fwd": ("dynamics", 8192), "fused_ls_step": ("line search", 8192),
            "fused_mlp_bwd": ("dynamics", 128)}
    summary = []
    for name, k in kernels.items():
        k_ms, p_ms, b_ms, b_by = timed[(name, *lead[name])]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": sum(launches[path][name] for path in launches),
            "launches_by_path": {path: launches[path][name] for path in launches},
            "max_abs_err": max_err[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes this function
            "by_shape": [
                {"shape": shape, "rows": rows, "ms": t[0], "plain_ms": t[1],
                 "bound_ms": t[2], "bound_by": t[3]}
                for (kname, shape, rows), t in timed.items() if kname == name
            ],
        })
    print(f"chip_smoke total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
