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
       2048 and 128 rows, its evaluation 4096 and 256; the humanoid-class
       row's 41->200->200->200->29 and 29->128->128->10 at 2048 and 128
       rows), plus a ragged row count,
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
       and 128; the 1-env collection 16 and 1) and phase 12 gives them
       (the critic's dataset and the test split 64 histories x 16 = 1024
       and 64; the 4-env collection, evaluations and DAgger rollout 64 and
       4), and fused_mlp_bwd on its dynamics at 128 rows (the dynamics
       trainer, the implicit gradient's rollout pullback);
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
     backward; in the humanoid-class row's: both humanoid stacks forward
     at 2048 and 128 rows, fused_ls_step at 128 x 16 and 128 x 1 with
     n = 29, m = 12);
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
     fits the normalizer on its own committed expert store
     (``trajectories-3332439a79.gmts``, the one its config's
     ``trajectories_path`` names; 24 trajectories); then
     - serving: 16 envs closed loop on the imitator's pendulum for 25
       control steps (2 warmup steps), H=10, iLQR <= 30 with the loop's
       early exit; prints the mean return, the mean and max trips per
       solve and steps/s; fused_mlp_fwd must have launched
       mlp_calls_per_solve(10, trips, solves) times for the trips the
       solver reported;
     - one GAN epoch (runners.gan.gan_epoch, epoch 1 of a continuation):
       the dynamics phase with the config's 12 on-policy updates and its
       warm-start and expert passes cut to 8 of 20 and 3 of 6 (a pass over
       the 24 trajectories' windows is 149 steps), on 1 episode cut to 25
       of 300 steps at 1 env with the collection noise 0.2; the critic
       with plan_batch 256 and 2 updates of batch 128; the generator cut
       to 1 update of 4 minibatch steps of 128 windows (of 3 updates of
       148), evaluation on
       256 windows. Prints each phase's losses and wall time; every loss
       must be finite, the critic's within 0.05 of ln 2, each phase must
       move its own components and leave its no_grads bitwise unchanged,
       and the launches must equal the counts the solver's reported
       solves and trips and the trainers' steps give.
  9. the GAN training run: ``runners.gan.run`` on gan/9's own config,
     continued from gan/9, with ``G9_RUN_CUTS`` (phase 8's epoch cuts; 2
     epochs; evaluation every epoch on 4 envs of 10 steps; a candidate
     pool of 2; the action-goal gain appended as a 5th weight at 1.0 and
     calibrated over 1.0 and 1.4; checkpoints every epoch; DAgger off) in
     a temporary workdir on phase 8's store. The first call's log
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
     and fresh_eval, and the launches.
 10. the humanoid-class row ``H50`` (the reference's third bench row:
     humanoid_stand, 128 envs, H=50, iLQR <= 5, 16 step sizes; the
     flagship's widths on 29 states and 12 actions, weights from seed 0,
     identity normalizer), where "auto" resolves to the materializing
     line search (printed with the candidates' bytes):
     - served with fused_ls off, then on: 1 warmup and 5 timed control
       steps (of the bench's 50-step episodes); env steps/s, trips per
       solve, mean reward; every output finite; the launches of both
       forward kernels equal to mlp_calls_per_solve(50, trips, fused,
       solves, materialize=True) for the trips the solver reported;
     - one plan_batch of 16 of the row's histories on the card and on
       the CPU, cut to one iLQR trip: the served action U[:, 0] atol 1e-3
       and equal iterations, each fused_ls setting; the whole plan's
       difference and the CPU's own spread under 1 +- 1e-7 nudges printed
       beside, and the same at the row's 5 trips (not checked: the
       random-weight row is chaotic at H=50, see ``H50_CHECK_ITERS``);
     - one solve of the 128 histories on the card with each line-search
       strategy, one trip, the dynamics' output layer scaled by 1/32: U
       atol 1e-4 max(1, max|U|) and equal iterations, each fused_ls
       setting.
 11. a committed config from an empty workdir: ``runners.gan.run`` on
     configs/gan_cheetah.yaml with ``G11_CUTS`` (64 expert episodes of the
     config's 1000 steps, so that the reward gate keeps its 5; iLQR <= 5;
     1 epoch of phase 9's epoch cuts; 2 expert epochs; 25-step
     evaluations) in a temporary workdir: it collects the fingerprinted
     store with the scripted cheetah expert, trains and saves the expert
     (no saved one matches the store), runs the epoch. Checks: the
     store's name, shapes (64, 1000, 17), (64, 1000, 6), (64, 1000) and
     sidecar, at least 5 episodes clearing the gate (each total printed),
     the expert's fingerprint equal to the store's and its losses finite,
     both MLP kernels' launches equal to what the recorded solves and
     update steps reckon, a second ``setup`` that reads the store and the
     saved expert without collecting or training, and the collector on
     the card against the CPU over the store's first 20 steps from its
     own draws: each env at the steps before the CPU's own spread of its
     states under 1 +- 1e-7 and 1 +- 2e-7 nudges of the resets reaches
     1e-3 (the stiff ground contact amplifies rounding past that), within
     max(1e-4, twice the spread under those and 1 +- 5e-7 nudges; rewards
     1e-5), at least half the entries so checked, the rest printed. Prints
     the wall time of the collection, the expert's training and
     evaluation, the epoch and the phase.
 12. the fused epochs and a DAgger round: ``runners.gan.run`` on
     configs/gan_pendulum_rung5b.yaml (continued from gan/9, 4 envs, H=10,
     gan/9's widths) with ``G12_CUTS`` (iLQR <= 10 of 30, 2 fused epochs of 20
     collection steps and 1 dynamics pass, 8 warm-start and 3 expert
     passes as phase 8's, evaluation every epoch on 4
     envs of 10 steps, one DAgger round: 4 policy episodes, 32 segments of
     50 steps, 1 fine-tune epoch, 1 extra fused epoch; checkpoints every
     epoch) in a temporary workdir on phase 8's store, interrupted on the
     "[gan/fused] epoch 1 " line and resumed; then ``runners.l2.run`` on
     configs/l2_pendulum.yaml with ``G12_L2_CUTS`` (1 fused epoch, iLQR
     <= 10; setup trains the expert). Checks: both MLP kernels' launches
     equal to what the recorded solves and update steps reckon, none of
     fused_ls_step; the metrics files' fused rows (epochs 1, 2 and the
     extra epoch 1; one DAgger row) and every value finite; the resumed
     run restarting at epoch 2; each saved run reloaded bitwise; DAgger's
     expert segments on the card against the CPU from the same picked
     (qpos, qvel) and noise (phase 11's check: within twice the CPU's
     spread under nudges of the starts); the fused dynamics phase's first
     4 steps from the run's own replay, params and optimizer state on the
     card against the CPU (loss within max(1e-5 |loss|, twice the CPU's
     spread under 1 +- 1e-7 scalings of the replay's states and 1 +- 1e-6
     of the weights), the params' updates within max(1e-7, twice the
     spread)). Prints the wall time of each
     fused epoch beside phase 8's modular epoch, of each piece (the
     collection, dynamics, critic dataset and updates, generator or cost
     steps, test metrics, DAgger's rollout, segments and fine-tune,
     evaluations) and of the phase.
 13. walker and cartpole, and the committed trained checkpoints (each
     served by ``bench.load_checkpoint`` from its own config.json and
     params.msgpack, the normalizer refitted on its committed store under
     runs/expert_trajectories/):
     (a) walker_walk and cartpole_balance stepped on the card and on the
         CPU from the same states and actions (``check_env_steps``);
     (b) both scripted experts' collections on the card against the CPU
         (``check_expert``, phase 11's ``hold_against_cpu``);
     (c) the trained-checkpoint row, the JAX bench's second line:
         cheetah_run gan/4 at 512 envs, 1 warmup and ``G13_GAN4_STEPS``
         timed control steps (the bench times 50-step episodes); env
         steps/s, trips per solve, launches against mlp_calls_per_solve;
     (d) walker_walk gan/0 (8 envs) and cartpole_balance l2/0 (1 env, no
         critic) served ``G13_SERVE_STEPS`` control steps: launches as in
         (c), the mean return beside the run's episode_returns.json
         (printed, not checked);
     (e) configs/gan_walker.yaml (collection, expert, 2 fused epochs, one
         DAgger round) and configs/l2_cartpole_quality.yaml (collection,
         expert, 1 fused epoch) from empty temporary workdirs with
         ``G13_RUNS``' cuts: launches against the recorded solves and
         update steps, the store through its gate, the expert, the metrics
         rows and the saved run reloaded bitwise.
 14. the per-instance planning path (ensemble and LSTM dynamics), goal
     projection, and the trained runs they unlock:
     (a) one ``plan_batch`` on the card and on the CPU from the same
         histories (2 envs, iLQR cut to 2 trips): humanoid_stand gan/0 (an
         8-member ensemble of 41->256^3->29, H=50, planned per instance),
         cheetah gan/0 (goal projection 2) and an LSTM-dynamics policy on
         random weights at configs/gan_cheetah.yaml's widths (its carry
         warmed from random past actions); U atol 1e-3, the CPU's own
         spread under 1 +- 1e-7 nudges printed beside;
     (b) served by ``serve_checkpoint`` (1 warmup step, then timed):
         humanoid_stand gan/0 at 4 envs for 2 steps, humanoid_walk gan/0
         and cheetah gan/0 at 16 envs for 3 steps each; env steps/s,
         seconds a control step, trips per solve, the return a step beside
         the run's episode_returns.json (printed, not checked); launches
         held to ``mlp_calls_per_solve`` with the ensemble's members on
         every dynamics call and the projection's advances, and no
         ``fused_ls_step`` on the per-instance path.
 15. training with ensemble and LSTM dynamics (``ensemble_training_phase``):
     (a) card against CPU (``check_training_against_cpu``), each group
         of numbers (the l2 norm of its difference) within max(its base
         times its size, twice the CPU's own spread when the dynamics'
         weights are scaled by 1 +- 1e-6 and 1 +- 2e-6, and for the
         implicit steps the histories by 1 +- 1e-7 and 1 +- 2e-7: trained
         H=50 solves amplify the kernels' 3xTF32 rounding, by 0.5-0.9 of
         that bound at 2 trips), the four nearest their bounds printed: the
         dynamics trainer's step (the loss and each member tensor's
         gradient, base 1e-4) of configs/humanoid_scale.yaml's 8 x
         41->256^3->29 ensemble on 128 windows of 50 steps from the
         committed store's 1000-step episodes (2048 of them drawn, 128
         taken of those 5e-6 or more from every relu kink,
         ``clear_windows``), teacher forced; one implicit generator step of its
         policy on humanoid_stand gan/0's weights (2 expert histories,
         H=50, CG, 2 iLQR trips; the loss and each component's gradient
         but the expert's, base 1e-3); one implicit generator step of an
         LSTM-dynamics policy at configs/gan_cheetah.yaml's widths under
         bilevel dense and cg (the exact Hessian by double backward), and
         its dynamics step open loop;
     (b) ``runners.gan.run`` on configs/humanoid_scale.yaml from an empty
         temporary workdir holding a copy of the committed store it
         resolves to, with ``G15_CUTS`` (every width, H=50, 8 members; 1
         iLQR trip, 2 fused epochs of 51-step collections, one DAgger
         round), interrupted after fused epoch 1 and resumed: it trains
         and saves the expert, the epochs, the round, the end;
     (c) configs/humanoid_scale_continue.yaml continued from
         humanoid_stand gan/0 for one epoch (``G15_CONTINUE_CUTS``).
     Checks of (b) and (c): both MLP kernels' launches equal to what the
     recorded solves (``mlp_calls_per_solve`` with 8 members, a cost
     step's with its backward ``mlp_calls_per_step``) and dynamics steps
     (8 x 50 forwards and backwards each) reckon, none of fused_ls_step;
     the metrics rows, every value finite; the resume; the saved
     params.msgpack's dynamics kernels stacked (8, in, out), the run
     reloaded bitwise; (c)'s trained kernels moved from gan/0's.
     After each of phases 6-15, both MLP kernels are held against their
     plain versions (as in phase 2) at every (stack, rows) pair that the
     phase's runs gave them and no earlier phase's check held, on the
     runs' own weights (``shapes_recorded``, ``check_recorded``); phases
     13-15's new pairs are also timed as in phase 3 (``time_recorded``).
 16. the bf16 compute path and the associative Riccati
     (``bf16_riccati_phase``):
     (a) the bf16 instances of fused_ls_step (512 x 16, 512 x 1, the
         humanoid-class 128 x 16) and fused_mlp_fwd (the dynamics stack at
         8192 and 512 rows), and at ``BF16_CHECKS``' shapes that the bf16
         products' edge cases meet (K 41 -> 48 and 256 columns on the
         64-row tile, 512 columns on the 16-row tile, 1 row, ragged tiles,
         weights not 16-byte aligned), against their plain bf16 versions,
         max|d| <= 1e-2 max(1, max|ref|) (a hidden activation rounded to
         the other bfloat16 neighbour carries one ulp through the later
         layers) and at most ``BF16_FAR_SHARE`` of the entries beyond 1e-4
         (which the f32 instance on the same inputs must exceed: the bound
         alone does not tell unrounded operands apart); the first five
         timed as in phase 3 beside the f32 instance and, for reference,
         the stack's bf16 chain on cuBLAS; the bound at 989 TFLOP/s (dense
         bf16) or 3.35 TB/s;
     (b) the flagship at compute_dtype="bfloat16", fused_ls off and on: 2
         warmup and ``G16_STEPS`` control steps, launches held to
         ``mlp_calls_per_solve(bf16=True)`` (the dynamics on the bf16
         instances, the terminal cost on the f32 one); one plan of 8
         envs at 2 trips card against CPU (``hold_plan_against_cpu``, the
         spread from the history nudges alone: a weight nudge crosses
         bfloat16 rounding boundaries that the card never crosses);
     (c) the humanoid-class row at bf16 with fused_ls on and the
         materializing line search (``scripts/r5_bench_h50b.sh``'s "+ fused
         LS kernel + materialize"): 1 warmup and ``G16_H50_STEPS`` steps,
         launches as reckoned;
     (d) riccati="associative": one backward pass on the warm start's
         linearization, associative against sequential on the card (k, K,
         the adjoints, G) at H=5 (512 envs) and H=50 (128 envs), within
         ``G16_ASSOC_TOL`` (the passes differ by design), each pass against
         itself in float64 on the CPU within ``G16_F64_TOL``; each pass's
         host ms and device operations (torch.profiler); then both rows
         served with each pass in turns (sequential, associative,
         associative, sequential), launches as reckoned.
 17. the pendulum runs, the video and the cross-evaluation
     (``pendulum_video_phase``):
     (a) the committed pendulum_swingup runs gan/2, 7, 8, 9, 10 and 11,
         each served from its own committed store as the bench serves it
         (``serve_checkpoint``: 16 envs, 1 warmup and 2 timed steps,
         launches as ``mlp_calls_per_solve`` reckons over the reported
         trips), the return over the cut printed beside the reward the run
         recorded; each one's plan of the first histories of 4 envs held
         card against CPU (``hold_plan_against_cpu``: the served action;
         the iterations equal on the lanes where the nudges do not move
         the CPU's own, as a lane that stops early stops where rounding
         puts it);
     (b) the video of phase 12's cut configs/l2_pendulum.yaml run with
         ``mpc.evaluate.save_video`` on and ``G17_VIDEO_STEPS`` evaluation
         steps, on the run's own setup (the committed pendulum expert
         copied into a temporary workdir, phase 8's store):
         ``runners.l2.maybe_save_video``, whose one-env episode runs on
         the card (launches as reckoned), its qpos held against the CPU's
         from the same reset within max(1e-3, twice the CPU's own spread
         under 1 +- 1e-7 nudges of the reset), the written file's frames
         counted; where PIL does not import, the episode
         (``l2.video_episode``) runs and is held, and "video: not
         rendered, PIL absent on this host" is printed;
     (c) where dm_control does not import (the card's host),
         ``runners.l2.dm_cross_eval`` on configs/gan_pendulum_rung5b.yaml
         (10 episodes asked for) gives None, as the JAX runner does.
     Then the MLP kernels at phase 17's new (stack, rows) pairs.
 18. data parallelism over torch.distributed (``data_parallel_phase``; one
     process per rank, ``parallel/launch.py``). The host has one card, so
     the mesh is two gloo ranks sharing it (``G18_RANKS``), and a
     one-rank NCCL group:
     (a) ``dryrun_multichip(2)``'s ranks on the shared card (inside
         (b)'s group) and ``dryrun_multichip(1)`` on NCCL:
         the sharded collection, the dynamics, critic and generator steps,
         the ensemble over "ep", dp x tp and the fused GAN epoch in mesh
         mode at the JAX dryrun's tiny shapes; JAX's line printed, every
         loss finite;
     (b) one fused GAN epoch of phase 12's configs/gan_pendulum_rung5b.yaml
         at its full widths (gan/9's setup on its own store, ``G18_CUTS``)
         from one snapshot and one set of global draws
         (``parallel.checks.fused_epoch_case``), in mesh mode on the two
         ranks and in one process on the card: the parameters (by
         component), the metrics and the replay within max(base, twice
         the single-process epoch's own spread under 1 +- 1e-7 and
         1 +- 2e-7 nudges of its parameters and its collection's start
         states, the nudged epochs run on (b)'s two ranks after the mesh
         epoch, two each); each rank's launches against
         ``mlp_calls_per_solve`` over its own solves and update steps,
         then summed; both wall times printed (no speed claim: the ranks
         share one card and the host);
     (c) ``runners.gan.run`` of the same cut config with
         ``runtime.data_parallel_devices: 2`` on the two ranks,
         interrupted at its epoch-1 log line and resumed, and the same run
         on one rank: rank 0 alone wrote the workdir (one saved run, one
         metrics row, checkpoints cleared), the saved run loads with
         ``bench.load_checkpoint``, and its served action on held-out
         histories is within max(1e-3, twice the spread that (b)'s nudged
         epochs give the served action) of the one-rank run's;
     (d) where the host has two or more cards, (b)'s mesh epoch over NCCL
         across up to four of them, held as in (b); else a line saying so.
     Then the MLP kernels at phase 18's new (stack, rows) pairs.
 19. stacks of any depth and width (the kernels' wide path: the forward
     and the step on clusters of blocks that share each row tile, every
     activation in the blocks' shared memory; the backward in passes of 512
     or 256 columns over a device workspace; the layers read from a table in
     device memory):
     (a) every kernel instance against its plain version on stacks the
         shared-memory tile does not take (``G19_FWD``: 23->1024^3->17,
         23->2048^2->17, 23->4096->17, 23->1000->777->17, 23->200^8->17,
         23->64^30->17 forward at f32 and bf16 at 0, 1, 37, 512 and 8192
         rows, and the step (n = 17, m = 6, the same hidden widths) at
         512 x 16 and 512 x 1; ``G19_BWD``: 23->512^3->17, 23->256^6->17,
         23->200^8->17, 23->1024^3->17 and the 32-layer stack backward at
         128, 512 and 8192 rows, as phase 2's ``check_backward``; and
         ``G19_BWD_BIG``, 23->4096^3->17 and 23->8192^4->17 at 8192 rows,
         past what one partial gradient set an SM would hold, with the
         f32 forward at 8192 rows and step at 512 x 16 on their widths;
         ``G19_FAR``, 23->24576->17, whose activations stream through a
         workspace, and a 70-layer stack, whose table's tail lies in one,
         the forward at f32 and bf16 and the f32 step at ``G19_FAR_ROWS``):
         each call on the wide path
         (``fwd_route``, ``bwd_route``; each forward and step call's cluster
         launch printed and held to the mirror's plan, ``wide_launch``) and
         counting one launch (none at 0
         rows, which launch nothing; the backward's walk and its dW kernel
         one a chunk of ``BWD_CHUNK_ROWS`` rows, as the entry point reports
         them), the f32 instances within 1e-4 max(1,
         max|ref|), the bf16 ones within phase 16's ``BF16_TOL`` and
         ``BF16_FAR_SHARE``; each backward's peak extra device memory
         (``hold_backward_memory``: its gradient set, dx and one chunk's
         workspace, and 23->1024^3->17 at 128 rows within ``G19_MEM_128``
         besides the workspace); the worst case per stack printed; then
         kernel, plain and the stack's cuBLAS chain in f32 and in TF32
         (``linear_chain``, no gate) timed at ``G19_TIMED_ROWS`` with their
         bounds, ``G19_BWD_BIG`` one launch a run, and the backward's dW
         kernel alone (CUDA events around its launches, ``dw_kernel_ms``)
         against the plain a^T g;
     (b) the flagship served with ``G19_SERVE_HIDDEN`` dynamics (cheetah_run,
         512 envs, H=5, 16 step sizes), fused_ls off and on: one plan of 8
         envs at 2 trips card against CPU (U atol 1e-3, as phase 4), then
         1 warmup and ``G19_SERVE_STEPS`` steps with launches as
         ``mlp_calls_per_solve`` reckons (61 a step off, 55 + 6 on);
     (c) configs/gan_cheetah.yaml with its dynamics' hidden widths set to
         each of ``G19_TRAIN_HIDDEN``: a dynamics update pass of 3
         minibatches of 128 windows (drawn clear of the relu kinks by
         phase 15's ``clear_windows``) held card against CPU within
         ``check_update_pass``'s bounds, and one cost-trainer minibatch's
         implicit gradient (iLQR cut to 2 trips) on 16 cost windows whose
         plan is stable (``stable_windows``: a random-weight line search
         flips its argmin on perturbations the size of the kernels' error),
         within max(``check_implicit_step``'s bounds, twice the CPU's own
         spread under such perturbations, ``perturbed_dynamics``: at [512]
         * 3 the CPU's implicit gradient moves by a few 1e-3 under them);
         launches 5
         forward and 5 backward a dynamics step, and
         ``mlp_calls_per_step`` over the reported trips for the cost step;
         each backward one launch of the dW kernel (one chunk);
     then the script's total wall time.
The last two lines are the kernels' JSON summary (the bf16 instances
beside the f32 ones, and the wide backward's dW kernel, which the
backward's calls launch) and {"ok": true, "device": {...}}. Every launch
count is of calls that launch a kernel on the device: a call over 0 rows
counts none. Exits 1 without a CUDA device.
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
HUMANOID_COST = [29, 128, 128, 10]
# the humanoid-class row (phase 10): the line search at 128 envs x 16 step
# sizes = 2048 rows, the rollout, the recompute and the terminal cost at 128
CHECKS += [("humanoid-class", HUMANOID, 2048), ("humanoid-class", HUMANOID, 128),
           ("humanoid-class cost", HUMANOID_COST, 2048),
           ("humanoid-class cost", HUMANOID_COST, 128)]
TIMED = [("dynamics", DYNAMICS, 8192), ("dynamics", DYNAMICS, 512),
         ("dynamics", DYNAMICS, 128), ("cost", COST, 8192), ("cost", COST, 512),
         ("dynamics", DYNAMICS, 2048), ("cost", COST, 2048),
         ("humanoid-class", HUMANOID, 2048), ("humanoid-class", HUMANOID, 128),
         ("humanoid-class cost", HUMANOID_COST, 2048),
         ("humanoid-class cost", HUMANOID_COST, 128)]
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
            ("cost-trainer rollout", 128, 1, 17, 6, 17),
            ("humanoid-class", 128, 16, 29, 12, 29),
            ("humanoid-class rollout", 128, 1, 29, 12, 29)]
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
# the committed GAN run of phase 8 and its own expert store, the one its
# config's trajectories_path names, which its normalizer is fitted on
GAN9 = "runs/trained_models/imitator/pendulum_swingup/gan/9"
GAN9_STORE = "runs/expert_trajectories/pendulum_swingup/trajectories-3332439a79.gmts"
# the store phase 4's histories (G9_STABLE, G9_CONVERGED) are windows of
G9_CHECK_STORE = "runs/expert_trajectories/pendulum_swingup/trajectories-f690b23776.gmts"
# gan/9's stacks at the rows phases 8 and 12 give them: the critic's dataset
# 256 histories x 16 step sizes and 256, a generator step 128 x 16 and 128,
# serving 16 envs x 16 and 16, the 1-env collection 16 and 1; phase 12's
# critic dataset and test split 64 x 16 and 64, its 4-env collection,
# evaluations and DAgger rollout 4 x 16 and 4
G9_ROWS = (4096, 2048, 1024, 256, 128, 64, 16, 4, 1)
G9_TIMED = [("dynamics", 256), ("dynamics", 4096), ("dynamics", 2048), ("dynamics", 128),
            ("cost", 256), ("cost", 4096)]
# 12 of the episode's 1000 control steps (200 until phase 13 came, 100
# until phase 14, 50 until phase 17, 25 until phase 18: the script's time
# stays near half its limit); swing-up takes about 160
SERVE_ENVS, SERVE_STEPS = 16, 12
# phase 8's cuts of gan/9's config (the rest is the run's own). Its own
# store holds 24 trajectories (the f690b23776 store phases 8-12 read
# before holds 10), so a pass over the expert's dynamics windows is 149
# minibatch steps, not 62: the warm-start and refresh passes are cut to
# keep the steps near those phases' earlier count
G9_CUTS = dict(mpc__train__dynamics__max_interactions_per_episode=15,  # of 300 (50 until
               # phase 17, 25 until phase 18: the script's time stays near half its limit)
               mpc__train__dynamics__warm_start_updates=4,  # of 20 (8 until phase 18)
               mpc__train__dynamics__expert_updates=3,  # of 6
               mpc__train__cost__num_updates=1,  # of 3
               mpc__train__cost__steps_per_update=4,  # of 61
               mpc__train__cost__eval_windows=256)
# phase 9's cuts of gan/9's config for runners.gan.run (the rest is the
# run's own): 2 epochs of phase 8's epoch, evaluation every epoch on 4
# envs of 10 steps (of 16 of 1000: the script's time stays near half its
# limit), a pool of 2, and the gain calibrated over 2 gains from 1.0
# appended to gan/9's 4 weights
G9_RUN_CUTS = dict(G9_CUTS, mpc__train__num_epochs=2,  # of 9
                   mpc__evaluate__every_epochs=1,  # of 3
                   mpc__evaluate__midrun_episodes=4,  # of 16
                   mpc__evaluate__candidate_pool=2,  # of 6
                   mpc__evaluate__selection_episodes=4,  # of 16
                   mpc__evaluate__num_runs_for_avg=4,  # of 16
                   mpc__evaluate__fresh_eval_episodes=4,  # of 16
                   mpc__evaluate__max_interactions=5,  # of 1000 (10 until phase 18)
                   mpc__model__cost__calibrate_action_goal_gain=True,
                   mpc__model__cost__gain_grid=[1.0, 1.4],
                   mpc__model__cost__weights__action_goal_gain=1.0,
                   runtime__checkpoint={"every_epochs": 1, "keep": 2},
                   # of 2: the modular loop runs no DAgger round, as JAX's does not (the
                   # fused runs do: phase 12)
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
# phase 10, the reference's humanoid-class row (scripts/r5_bench_h50b.sh:
# humanoid_stand, 128 envs, H=50, iLQR <= 5 at tolerance 1e-4, 16 step
# sizes), at the flagship's widths on the humanoid's 29 states and 12
# actions; the timed control steps are cut from the bench's 50-step episodes
H50 = dict(env="humanoid_stand", num_envs=128, horizon=50, iters=5)
# phase 11: a committed config run from an empty workdir, with these cuts of
# it (the rest is the config's own). env.expert_episode_steps stays 1000: the
# reward gate sums each stored episode whole before it is cut to
# trajectory_len, and over 300 steps no episode of this expert clears 20.
G11_CONFIG = "configs/gan_cheetah.yaml"
G11_CUTS = dict(
    # of mpc.train.num_trajectories = 5: the JAX runner's own oversampling
    # knob, so that the gate (min_expert_reward 20) keeps 5; it enters the
    # collection fingerprint, so the store and the expert are this config's
    env__collect_trajectories=64,
    mpc__solver__max_iterations=5,  # of 50
    mpc__train__num_epochs=1,  # of 2
    mpc__train__dynamics__max_interactions_per_episode=50,  # of 300
    mpc__train__cost__num_updates=1,  # of 3
    mpc__train__cost__steps_per_update=4,  # of 9 (1,176 train windows / batch 128)
    mpc__evaluate__max_interactions=25,  # of 1000: the imitator's and the expert's episodes
    mpc__evaluate__fresh_eval_episodes=2,  # of 16 (the default)
    expert_prediction__train__num_epochs=2,  # of 10
)
G11_CHECK_STEPS = 20  # the collector held card against CPU over the store's first steps
G11_NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 2e-7, 1 - 2e-7)
G11_REPRODUCIBLE = 1e-3  # the CPU's own spread of a lane's states up to which it is checked
# the card's rounding enters every operation of every step, not the resets
# alone, so its drift is held against nudges of the resets up to 5e-7 (a few
# ulp; on an H100 it reached 1.8x the spread of the 1e-7 and 2e-7 nudges
# where a lane nears a contact event)
G11_WIDE_NUDGES = (1 + 5e-7, 1 - 5e-7)
# phase 12: the fused epochs and a DAgger round. The GAN run is
# configs/gan_pendulum_rung5b.yaml (continued from gan/9, on phase 8's store)
# with these cuts (the rest is the config's own: 4 envs, H=10, iLQR <= 30,
# gan/9's widths, 3 generator steps of 128 histories, the critic on 64; its
# 10 dm_control episodes give None where dm_control does not import):
G12_CONFIG = "configs/gan_pendulum_rung5b.yaml"
G12_CUTS = dict(
    mpc__train__num_epochs=2,  # of 9
    # of 30 (until phase 19 came: the script's time stays near 900 s on slower hosts)
    mpc__solver__max_iterations=10,
    mpc__train__dynamics__warm_start_updates=8,  # of 20 passes (see G9_CUTS)
    mpc__train__dynamics__expert_updates=3,  # of 6
    mpc__train__dynamics__max_interactions_per_episode=20,  # of 300
    mpc__train__dynamics__num_updates=1,  # of 12 passes of 61 minibatch steps
    mpc__evaluate__every_epochs=1,  # of 3
    # of 1000: evaluations and DAgger's policy episodes (10 until phase 18)
    mpc__evaluate__max_interactions=5,
    mpc__evaluate__midrun_episodes=4,  # of 16
    mpc__evaluate__candidate_pool=2,  # of 6
    mpc__evaluate__selection_episodes=4,  # of 16
    mpc__evaluate__num_runs_for_avg=4,  # of 16
    mpc__evaluate__fresh_eval_episodes=4,  # of 16 (the default)
    expert_prediction__dagger__rounds=1,  # of 2
    expert_prediction__dagger__policy_episodes=4,  # of 8
    # of 384 (32 until phase 18: 4 policy episodes of 5 steps give 20 states)
    expert_prediction__dagger__num_segments=16,
    expert_prediction__dagger__segment_steps=50,  # of 200
    expert_prediction__dagger__finetune_epochs=1,  # of 8
    expert_prediction__dagger__extra_epochs=1,  # of 15
    runtime__checkpoint={"every_epochs": 1, "keep": 2},  # of every 10
)
# the L2 run: configs/l2_pendulum.yaml (random cost and dynamics, H=5, 1 env)
# on the same store, with these cuts
G12_L2_CONFIG = "configs/l2_pendulum.yaml"
G12_L2_CUTS = dict(
    mpc__solver__max_iterations=10,  # of 100 (random weights)
    mpc__train__num_epochs=1,  # of 2
    mpc__train__dynamics__max_interactions_per_episode=20,  # of 300
    mpc__evaluate__max_interactions=10,  # of 1000
    mpc__evaluate__fresh_eval_episodes=2,  # of 16 (the default)
    expert_prediction__train__num_epochs=1,  # of 40, where setup trains the expert
)
G12_DYN_CHECK_STEPS = 4  # the fused dynamics phase held card against CPU over its first steps
# phase 13: walker and cartpole, and the committed trained checkpoints
G13_ENV_ENVS = 32  # (a): envs stepped on the card and on the CPU from the same states
G13_CARTPOLE_STEPS = 100  # (a): cart-pole steps (smooth: no contact)
G13_AIRBORNE_STEPS = 20  # (a): walker steps in the air, no contact switching on
G13_EXPERT_ENVS, G13_EXPERT_STEPS = 16, 20  # (b): each scripted expert's check
G13_GAN4_STEPS = 3  # (c): timed control steps of the gan/4 row, after 1 warmup step
# (d): the cut episode of walker gan/0 and cartpole l2/0 (15 until phase 17, 8 until the
# phase 19 (a) backwards of G19_BWD_BIG came: the script's time stays near 900 s)
G13_SERVE_STEPS = 4
# (e): the two configs that walker and cartpole unlock, from empty workdirs,
# cut in the way of G12_CUTS (the rest is the config's own: widths, horizon,
# the critic, the stores' 1000-step episodes through the reward gate, the
# walker's 8 envs and DAgger's reward weighting)
G13_CUTS = dict(
    mpc__evaluate__dm_control_episodes=0,  # of 5: the cross-evaluation is not ported
    mpc__solver__max_iterations=5,  # of 30 / 20 (untrained weights)
    mpc__train__dynamics__max_interactions_per_episode=20,  # of 300
    mpc__train__dynamics__num_updates=1,  # of 12 / 5 passes
    mpc__evaluate__every_epochs=1,  # of 2 / 5
    # of 1000: evaluations and DAgger's policy episodes (10 until phase 18)
    mpc__evaluate__max_interactions=5,
    mpc__evaluate__midrun_episodes=4,  # of 6 / 16
    mpc__evaluate__candidate_pool=2,  # of 4 / 6
    mpc__evaluate__selection_episodes=4,  # of 12 / 16
    mpc__evaluate__num_runs_for_avg=4,  # of 8
    mpc__evaluate__fresh_eval_episodes=4,  # of 16 (the default)
    expert_prediction__train__num_epochs=2,  # of 24 / 40
    expert_prediction__eval_runs=1,  # of 4 / 3: the expert's own evaluation episodes
)
G13_RUNS = [
    ("gan", "configs/gan_walker.yaml", dict(
        G13_CUTS,
        mpc__train__num_epochs=1,  # of 16 (2 until phase 18)
        expert_prediction__dagger__rounds=1,  # of 2
        expert_prediction__dagger__policy_episodes=4,  # of 8
        # of 256 (32 until phase 18: 4 policy episodes of 5 steps give 20 states)
        expert_prediction__dagger__num_segments=16,
        expert_prediction__dagger__segment_steps=50,  # of 200
        expert_prediction__dagger__finetune_epochs=1,  # of 8
        expert_prediction__dagger__extra_epochs=0,  # of 8: the round ends in one evaluation
    )),
    ("l2", "configs/l2_cartpole_quality.yaml", dict(G13_CUTS, mpc__train__num_epochs=1)),  # of 10
]
# phase 14: the per-instance path (ensemble, LSTM dynamics), goal projection,
# and the trained runs they unlock
G14_STAND = "runs/trained_models/imitator/humanoid_stand/gan/0"  # 8 x 41->256^3->29, H=50
G14_WALK = "runs/trained_models/imitator/humanoid_walk/gan/0"  # 41->256^3->29, H=10
G14_CHEETAH0 = "runs/trained_models/imitator/cheetah_run/gan/0"  # goal projection 2, H=10
G14_CHECK_ENVS, G14_CHECK_ITERS = 2, 2  # (a): the card-against-CPU plans
G14_LSTM_CONFIG = "configs/gan_cheetah.yaml"  # (a): its widths with dynamics.use: lstm
# (b): humanoid_stand gan/0, after 1 warmup step (2 steps until G19_BWD_BIG came)
G14_STAND_ENVS, G14_STAND_STEPS = 4, 1
G14_SERVE_ENVS, G14_SERVE_STEPS = 16, 3  # (b): humanoid_walk gan/0 and cheetah gan/0
# phase 15: training with ensemble and LSTM dynamics. (b) is
# configs/humanoid_scale.yaml from an empty temporary workdir holding a copy
# of the committed store it resolves to, with these cuts of depth (every
# width, H=50, the 8 members, CG bilevel, 4 envs, the critic's plan_batch 32
# and the cost batch 16 are the config's own):
G15_CONFIG = "configs/humanoid_scale.yaml"
G15_STORE = "runs/expert_trajectories/humanoid_stand/trajectories-e0c6da4a17.gmts"
G15_CUTS = dict(
    mpc__solver__max_iterations=1,  # of 30: iLQR trips a solve
    mpc__train__num_epochs=2,  # of 12
    mpc__train__trajectory_len=60,  # of 300: 8 x 9 cost windows, 8 x 10 dynamics windows
    mpc__train__dynamics__max_interactions_per_episode=51,  # of 300: one 50-step window an env
    mpc__train__dynamics__warm_start_updates=1,  # of 3 (the default)
    mpc__evaluate__every_epochs=1,  # of 2
    mpc__evaluate__max_interactions=2,  # of 1000: every evaluation and DAgger's policy episodes
    mpc__evaluate__num_runs_for_avg=2,  # of 8
    mpc__evaluate__candidate_pool=2,  # of 3
    mpc__evaluate__selection_episodes=2,  # of 8
    mpc__evaluate__fresh_eval_episodes=2,  # of 16 (the default)
    expert_prediction__train__num_epochs=1,  # of 20
    expert_prediction__dagger__rounds=1,  # of 2
    expert_prediction__dagger__policy_episodes=2,  # of 4
    expert_prediction__dagger__num_segments=4,  # of 128
    expert_prediction__dagger__segment_steps=20,  # of 200
    expert_prediction__dagger__finetune_epochs=1,  # of 8
    expert_prediction__dagger__extra_epochs=0,  # of 4: the round ends in one evaluation
)
# (c): configs/humanoid_scale_continue.yaml (from humanoid_stand gan/0, no
# DAgger) for one epoch, cut as (b)
G15_CONTINUE = "configs/humanoid_scale_continue.yaml"
G15_CONTINUE_CUTS = dict({k: v for k, v in G15_CUTS.items()
                          if not k.startswith("expert_prediction__")},
                         mpc__train__num_epochs=1)  # of 20
G15_DYN_WINDOWS = 128  # (a): the dynamics minibatch, the config's batch size
G15_CHECK_HISTORIES, G15_CHECK_ITERS = 2, 2  # (a): the implicit steps held card against CPU
# (a): the CPU's own spread: its dynamics weights scaled (phase 14's 1e-6 and
# twice it), and the implicit steps' histories (phase 11's nudges)
G15_WEIGHT_NUDGES = (1 + 1e-6, 1 - 1e-6, 1 + 2e-6, 1 - 2e-6)
G15_INPUT_NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 2e-7, 1 - 2e-7)
G15_KINK_MARGIN = 5e-6  # (a): the dynamics steps' windows sit this far from every relu kink
G15_EPISODE_STEPS = 1000  # (a): the committed store's episodes, the dynamics step's window pool
G15_DYN_POOL = 2048  # (a): of whose windows this many are drawn and scanned for kinks
G15_LSTM_CONFIG = "configs/gan_cheetah.yaml"  # (a): its widths with dynamics.use: lstm
H50_STEPS = 5  # (10 until phase 17 came: the script's time stays near half its limit)
H50_CHECK_ENVS = 16  # the card-against-CPU plan
# The random-weight row is chaotic at H=50: its dynamics grow every
# rollout (|X| ~ 5e4) and 1e-7 nudges of the input move the CPU's own plan
# by its own size (phase 10 prints this). So the two numeric checks cut
# the solve to one iLQR trip (rollout, linearization, Riccati, line search
# of 16 step sizes and the winner), and the materialize-against-recompute
# check also scales the dynamics' output layer by 1/32 (a power of two),
# which keeps the rollouts bounded.
H50_CHECK_ITERS = 1
H50_DYN_SCALE = 1.0 / 32.0
# phase 17: the committed pendulum runs served on their own stores (after 1
# warmup step; the card-against-CPU plan on the first histories of 4 envs),
# the video of phase 12's cut L2 run (its setup reading the committed
# pendulum expert), the cross-evaluation without dm_control
G17_RUNS = [f"runs/trained_models/imitator/pendulum_swingup/gan/{n}" for n in (2, 7, 8, 9, 10, 11)]
G17_SERVE_ENVS, G17_SERVE_STEPS = 16, 2
G17_CHECK_ENVS = 4
G17_EXPERT = "runs/trained_models/expert/pendulum_swingup/0"
G17_VIDEO_STEPS = 40  # (b): of G12_L2_CUTS' 10, so that the rendered pendulum moves
# phase 18: data parallelism. (b) and (c) run phase 12's config at its full
# widths (4 envs, H=10, iLQR <= 30, gan/9's stacks, 3 generator steps of 128
# histories, the critic and the test split on 64) with these cuts; the
# runners' periodic evaluation is off, so the saved params are the epoch's
G18_CUTS = dict(
    mpc__train__num_epochs=1,  # of 9
    mpc__train__num_trajectories=8,  # of the store's 24: a pass is 49 minibatch steps, not 149
    mpc__train__dynamics__warm_start_updates=1,  # of 20 passes
    mpc__train__dynamics__expert_updates=3,  # of 6
    mpc__train__dynamics__max_interactions_per_episode=11,  # of 300: 1 window an env at H=10
    mpc__train__dynamics__num_updates=1,  # of 12 passes
    mpc__train__cost__num_updates=1,  # of 3 generator steps
    mpc__evaluate__every_epochs=0,  # of 3
    mpc__evaluate__max_interactions=5,  # of 1000
    mpc__evaluate__num_runs_for_avg=1,  # of 16
    mpc__evaluate__fresh_eval_episodes=0,  # of 16 (the default): none
    expert_prediction__dagger__rounds=0,  # of 2 (phase 12 runs one)
    runtime__checkpoint={"every_epochs": 1, "keep": 2},  # of every 10
)
G18_RANKS = ["cuda:0", "cuda:0"]  # two gloo ranks sharing the card
G18_NCCL = ["cuda:0"]  # (a): a one-rank NCCL group
# (b): the single-process epoch's own spread, as phases 11 and 15 take theirs;
# the spread of the generator losses is heavy-tailed (on the CPU 3.5e-6 to
# 1.2e-4 over these and 1 +- 5e-7), so two nudges can miss it
G18_NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 2e-7, 1 - 2e-7)
# (b): the bounds' floors, the metrics' relative to max(1, |value|). The
# critic's and the generator's losses are means over 64-128 planned lanes of
# gan/9's solves, which rounding-sized nudges move by up to 4.6e-2 a lane
# (scripts/diag_gan9_conditioning.py): their spread under a few nudges is
# heavy-tailed (1.2e-4 against 3.5e-6 from one nudge to the next on the CPU),
# so they have a floor of their own
G18_BASE = {"params": 1e-7, "metrics": 1e-5, "planned": 1e-3, "replay": 1e-5,
            "action": 1e-3}
G18_PLANNED = ("critic_loss", "generator_loss", "critic_test_loss", "generator_test_loss")
G18_SERVE = 16  # (b), (c): held-out histories served by each epoch's or run's policy
G18_TIMEOUT = 600.0  # seconds a rank waits on a collective before it raises
# phase 16: the bf16 compute path and the associative Riccati
# (a): the step as (kernel, name, lanes, step sizes, n, m, gs, offset) on the
# dynamics stack [n + m, 200, 200, 200, n], the forward as (kernel, name, rows,
# widths, offset); offset 1 puts every weight tensor one float into its buffer,
# so that no weight view is 16-byte aligned. The first BF16_TIMED are the bf16
# paths' own calls, also timed; the rest are the edge cases of the bf16
# products: K 41 -> 48 on the 64-row tile, 256 columns on it (the ensemble
# member and gan/4's stacks), a 512-wide stack on the 16-row tile, 1 row,
# ragged last tiles of both tile heights, unaligned weights on both
ENSEMBLE_MEMBER = [41, 256, 256, 256, 29]
WIDEST = [23, 512, 512, 17]
BF16_CHECKS = [
    ("fused_ls_step", "line search", 512, 16, 17, 6, 17, 0),
    ("fused_ls_step", "rollout", 512, 1, 17, 6, 17, 0),
    ("fused_ls_step", "humanoid-class", 128, 16, 29, 12, 29, 0),
    ("fused_mlp_fwd", "dynamics", 8192, DYNAMICS, 0),
    ("fused_mlp_fwd", "dynamics", 512, DYNAMICS, 0),
    ("fused_ls_step", "humanoid-class line search", 512, 16, 29, 12, 29, 0),
    ("fused_ls_step", "one row", 1, 1, 17, 6, 17, 0),
    ("fused_ls_step", "ragged", 513, 16, 17, 6, 12, 0),
    ("fused_ls_step", "unaligned", 512, 16, 17, 6, 17, 1),
    ("fused_ls_step", "unaligned rollout", 512, 1, 17, 6, 17, 1),
    ("fused_mlp_fwd", "ensemble member", 8192, ENSEMBLE_MEMBER, 0),
    ("fused_mlp_fwd", "wide", 8192, WIDE, 0),
    ("fused_mlp_fwd", "widest", 512, WIDEST, 0),
    ("fused_mlp_fwd", "dynamics", 1, DYNAMICS, 0),
    ("fused_mlp_fwd", "dynamics ragged", 8200, DYNAMICS, 0),
    ("fused_mlp_fwd", "dynamics ragged", 37, DYNAMICS, 0),
    ("fused_mlp_fwd", "dynamics unaligned", 8192, DYNAMICS, 1),
    ("fused_mlp_fwd", "dynamics unaligned", 512, DYNAMICS, 1),
]
BF16_TIMED = 5
BF16_TOL = 1e-2  # x max(1, max|ref|): see bf16_kernels_phase
BF16_FAR_SHARE = 0.02  # of the entries beyond 1e-4 of plain bf16: see bf16_kernels_phase
G16_STEPS = 3  # (b): timed flagship control steps at bf16 each way, after WARMUP_STEPS
G16_CHECK_ENVS, G16_CHECK_ITERS = 8, 2  # (b): the plan held card against CPU
G16_H50_STEPS = 2  # (c): timed H=50 control steps at bf16, after 1 warmup step
G16_TURN_STEPS = {"flagship": 3, "humanoid-class": 2}  # (d): control steps of each turn
G16_ASSOC_TOL = {5: 2e-3, 50: 2e-2}  # (d): associative against sequential, by horizon
G16_F64_TOL = 1e-3  # (d): each pass on the card against itself in float64 on the CPU
# phase 19: stacks the shared-memory tile does not take
G19_FWD = [
    ("1024^3", [23, 1024, 1024, 1024, 17]),
    ("2048^2", [23, 2048, 2048, 17]),
    ("4096", [23, 4096, 17]),
    ("1000-777", [23, 1000, 777, 17]),
    ("200^8", [23] + [200] * 8 + [17]),
    ("64^30", [23] + [64] * 30 + [17]),
]
G19_FWD_ROWS = (0, 1, 37, 512, 8192)
G19_LS = ((512, 16), (512, 1))  # lanes x step sizes; n = 17, m = 6: G19_FWD's stacks
# (a): the forward's and the step's routes that take a workspace, at G19_FAR_ROWS
# rows (the step 1 alpha a lane): a hidden layer too wide for a cluster of 16's
# shared memory (its activations stream through device memory), and a stack
# deeper than the table the launch's parameters hold (its further layers in the
# workspace's head)
G19_FAR = [("24576 streamed", [23, 24576, 17]), ("70 layers", [23] + [32] * 69 + [17])]
G19_FAR_ROWS = 37
G19_BWD = [
    ("512^3", [23, 512, 512, 512, 17]),
    ("256^6", [23] + [256] * 6 + [17]),
    ("200^8", [23] + [200] * 8 + [17]),
    ("1024^3", [23, 1024, 1024, 1024, 17]),
    ("64^30", [23] + [64] * 30 + [17]),
]
G19_BWD_ROWS = (128, 512, 8192)
# (a): backwards past what one partial gradient set per SM could hold (17.8 GB
# and 106.5 GB of them on 132 SMs): checked, memory held, timed once
G19_BWD_BIG = [("4096^3", [23, 4096, 4096, 4096, 17], 8192),
               ("8192^4", [23] + [8192] * 4 + [17], 8192)]
G19_MEM_SLACK = 2**21  # (a): the caching allocator's rounding, at most
# (a): 23->1024^3->17 at 128 rows, besides its workspace: about 8 partial sets of its
# parameters, what the shared-memory path's rule would take at that row count (132 took 1.13 GB)
G19_MEM_128 = 68.5e6
G19_SHARE_ROWS = 512  # (a): the bf16 instances' share beyond 1e-4 is held from here on
G19_TIMED_ROWS = {"fwd": (8192, 512), "ls": ((512, 16),), "bwd": (8192, 128)}
G19_SERVE_HIDDEN = (1024, 1024, 1024)  # (b)
G19_SERVE_STEPS = 3  # (b): timed control steps each way, after 1 warmup step
G19_TRAIN_HIDDEN = ([512, 512, 512], [256] * 6)  # (c)
G19_FLIP_POOL = 128  # (c): cost windows drawn, of which the first stable ones are taken
G19_FLIP_NOISE = 1e-5  # (c): x max|y| on the dynamics' outputs: the kernels' error at 512 wide
G19_FLIP_DRAWS = 4
G19_FLIP_TOL = 1e-3  # (c): phase 4's plan tolerance; a window whose plan moves further is left
# one H100 SXM (NVIDIA's data sheet): dense TF32 on the tensor cores, HBM3.
# An f32-accurate product takes three TF32 passes (hi x hi, hi x lo, lo x
# hi), so the least time for f32 products is their operations over a third
# of the TF32 rate; the f32 FMA pipes (67 TFLOP/s) are slower than that.
TF32_PEAK = 495e12
F32_PRODUCT_RATE = TF32_PEAK / 3
BF16_PEAK = 989e12  # dense bf16 on the tensor cores: the bound of the bf16 instances
MEM_RATE = 3.35e12


# phases 13-15 time the kernels at every new (stack, rows) pair: runs of 20
# launches (21 until the phase 19 (a) backwards of G19_BWD_BIG came: the
# script's time stays near 900 s)
RECORDED_REPS = 7


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


def bound(ops, nbytes, rate=F32_PRODUCT_RATE):
    """(bound_ms, bound_by): the least time for ``ops`` operations at
    ``rate`` (f32-accurate products unless said otherwise) and ``nbytes``
    of device-memory traffic."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / MEM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mlp_bound(rows, widths, rate=F32_PRODUCT_RATE):
    """Input rows read and output rows written once, weights read once."""
    nbytes = 4 * (rows * (widths[0] + widths[-1]) + mlp_weight_floats(widths))
    return bound(mlp_flops(rows, widths), nbytes, rate)


def ls_bound(lanes, alphas, n, m, gs, rate=F32_PRODUCT_RATE, hidden=(200, 200, 200)):
    """The step's operations: the dynamics MLP, the control law
    (dx, K dx, u) and the stage cost (three pseudo-Huber norms, the
    action-goal difference, the weighted sum) and the residual add, per
    row. Bytes: every input read once (per-lane rows once per lane, the
    weights once), every output written once."""
    rows = lanes * alphas
    widths = [n + m, *hidden, n]
    per_row = n + 2 * m * n + 3 * m + (2 * m + 4 * m + 3 * gs + 12) + n
    ops = mlp_flops(rows, widths) + rows * per_row
    in_floats = rows * n + rows + lanes * (n + m + m + m * n + gs + m) + 4
    out_floats = rows * (n + m + 1)
    return bound(ops, 4 * (in_floats + out_floats + mlp_weight_floats(widths)), rate)


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
    dW move by a whole term; rounding moves a pre-activation by ~1e-6 (by
    a few 1e-6 at 4096 columns). After the first pass only the redrawn
    rows are looked at again: the others have not changed."""
    fin = layers[0][0].shape[0]
    draw = lambda n: torch.tensor(rng.standard_normal((n, fin)), dtype=torch.float32,
                                  device=device)
    x, redrawn = draw(rows), 0
    todo = torch.arange(rows, device=device)
    while True:
        h = x[todo]
        near = torch.zeros(h.shape[0], dtype=torch.bool, device=device)
        for w, b in layers[:-1]:
            z = h @ w + b
            near |= (z.abs() < margin).any(1)
            h = torch.relu(z)
        todo = todo[near]
        if todo.numel() == 0:
            return x, redrawn
        redrawn += todo.numel()
        x[todo] = draw(todo.numel())


def random_layers(widths, seed, device):
    rng = np.random.default_rng(seed)
    return [
        (torch.tensor(rng.standard_normal((a, b)) / np.sqrt(a), dtype=torch.float32,
                      device=device),
         torch.tensor(0.1 * rng.standard_normal(b), dtype=torch.float32, device=device))
        for a, b in zip(widths[:-1], widths[1:])
    ]


def offset_copy(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements into a buffer
    of its own (offset 1 of a float32 tensor: no longer 16-byte aligned)."""
    buf = t.new_empty(t.numel() + offset)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def offset_layers(layers, offset):
    """``layers`` (a split W0 as a pair) with every tensor ``offset_copy``'d."""
    if not offset:
        return layers
    copy = lambda t: offset_copy(t, offset)  # noqa: E731
    return [(tuple(map(copy, w)) if isinstance(w, tuple) else copy(w), copy(b))
            for w, b in layers]


def trained_layers(device):
    """The dynamics stack of CHECKPOINT, loaded as a user would: the
    msgpack tree into a LearnedDynamics. A missing file raises."""
    from gan_mpc_tpu_torch.models.dynamics import LearnedDynamics, ResidualMLPDynamicsNet
    from gan_mpc_tpu_torch.params import dynamics_from_jax_params, load_msgpack

    tree = load_msgpack(CHECKPOINT)
    model = LearnedDynamics(ResidualMLPDynamicsNet(17, 6, hidden=tuple(WIDE[1:-1])))
    dynamics_from_jax_params(tree["dynamics_params"], model)
    return [(w.detach(), b.detach()) for w, b in model.requires_grad_(False).to(device).net.stack()]


def check_backward(name, layers, rows, rng, dev, errs=None, big=False):
    """fused_mlp_bwd against reference_backward on rows clear of kinks:
    every output within 1e-4 max(1, max|ref|), a second call bitwise equal.
    Returns the largest max|d|; on the wide path its largest over dW and
    db, the dW kernel's outputs, also goes to ``errs["fused_mlp_bwd_dw"]``.
    With ``big`` (``G19_BWD_BIG``) the 3xTF32 model, whose per-tile products
    would take tiles x the largest layer in memory (68.7 GB for 8192 x 8192
    at 8192 rows), is not computed."""
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        bwd_model_args, fused_mlp_backward, reference_backward, reference_backward_3xtf32,
    )

    widths = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x, redrawn = clear_of_kinks(rng, rows, layers, dev)
    g = torch.tensor(rng.standard_normal((rows, widths[-1])), dtype=torch.float32, device=dev)
    dx, grads = fused_mlp_backward(x, layers, g)
    rdx, rgrads = reference_backward(x, layers, g)
    model = bwd_model_args(rows, widths, sms)
    mdx, mgrads = (dx, grads) if big else reference_backward_3xtf32(x, layers, g, **model)
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
        if errs is not None and model.get("chunk_rows") and out != "dx":
            errs["fused_mlp_bwd_dw"] = max(errs.get("fused_mlp_bwd_dw", 0.0), err)
    # the cross-tile sums run in a fixed order: a second call gives the same bits
    again = fused_mlp_backward(x, layers, g)
    same = all(torch.equal(a, b) for a, b in zip(flat(*again), flat(dx, grads)))
    print(f"check fused_mlp_bwd {name} {widths} rows={rows} ({redrawn} rows redrawn "
          f"clear of relu kinks): max|d| over dx, {len(layers)} dW and db {worst:.3e}, "
          f"at most {100 * worst_share:.1f}% of its output's bound ("
          + ("3xTF32 model not computed" if big else f"to the 3xTF32 model "
             f"{100 * to_model:.1f}%") + f"); second call bitwise equal: {same}")
    if not same:
        raise SystemExit(f"fused_mlp_bwd is not deterministic: {name} rows={rows}")
    return worst


def ls_args(lanes, alphas, n, m, gs, weights, seed, device, offset=0, hidden=(200, 200, 200)):
    """Inputs of one line-search step, drawn from ``seed``, with the stage
    weights from ``MPCCost.stage_weights``, the dynamics' ``hidden`` widths
    and W0 split once (every weight tensor ``offset`` floats into a buffer
    of its own: ``offset_layers``)."""
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
        layers=offset_layers(split_w0(random_layers([n + m, *hidden, n], seed, device), n),
                             offset),
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
                * mlp_calls_per_solve(policy.horizon, ILQR_ITERS,
                                       materialize=False)["fused_mlp_fwd"]}
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
    per_step = mlp_calls_per_step(policy.horizon, ILQR_ITERS, materialize=False)
    per_eval = mlp_calls_per_solve(policy.horizon, ILQR_ITERS, materialize=False)
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
    """Every cost window (history 1, H=10) of ``G9_CHECK_STORE``, on the
    CPU, normalized by the normalizer fitted on that store."""
    from gan_mpc_tpu_torch.data.trajectories import load_trajectories
    from gan_mpc_tpu_torch.data.windows import cost_windows
    from gan_mpc_tpu_torch.runners import common

    cfg = gan9_config()
    trajs = load_trajectories(G9_CHECK_STORE, cfg.mpc.train.num_trajectories,
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


def gan9_phase(kernels, card_line, dev, wall):
    """Phase 8: gan/9 loaded as the GAN runner loads it, served closed
    loop, then continued by one GAN epoch. Returns the launches of each;
    keeps the epoch's wall seconds in ``wall`` for phase 12."""
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
    expected = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips), materialize=False),
                    fused_mlp_bwd=0)
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
            wall["gan/9 modular epoch"] = epoch_s
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
    solves = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips), materialize=False))
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
def run_watched(extra=()):
    """Times each piece of a training run (``runners.l2``'s module functions,
    ``runners.gan.gan_epoch``, and the (module, name, kind) of ``extra``) as
    the run calls it; yields the list of (kind, seconds). An evaluation is
    "selection" inside the re-rank and "final" outside it; "midrun" is the
    periodic evaluation with its solver statistics."""
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
               (l2, "evaluate", "evaluate"), (l2, "fresh_seed_eval", "fresh"), *extra]
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
        solves = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips), materialize=False))
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


def humanoid_phase(kernels, card_line, dev):
    """Phase 10: the humanoid-class row ``H50`` served with fused_ls off
    and on, its launches held to ``mlp_calls_per_solve(materialize=True)``
    over the trips the solver reported; then one plan held card against
    CPU and materialize against recompute on the card. Returns the
    launches of both serving runs, summed."""
    from gan_mpc_tpu_torch.bench import FUSED_LS, bench_row, flagship, run_steps
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.planner.batch_ilqr import ls_materializes, mlp_calls_per_solve

    t_phase = time.perf_counter()
    H, B, iters = H50["horizon"], H50["num_envs"], H50["iters"]
    env = make_env(H50["env"], dev)
    n, m = env.obs_size, env.act_size
    norm = Normalizer.identity(n, m, dev)
    policy = lambda fused, it=iters, device=dev, ls="auto": flagship(
        H, it, n, m, device, SEED, fused, ls_materialize=ls)
    settings = policy("off").settings
    mat = ls_materializes(settings, H, B, n, m)
    cand = 4 * H * B * settings.num_alphas * (n + m)
    print(f"humanoid-class row ({H50['env']}, {B} envs, H={H}, iLQR <= {iters} at tolerance "
          f"{settings.grad_norm_tol}, {settings.num_alphas} step sizes; dynamics "
          f"{n + m}->200->200->200->{n}, cost {n}->128->128->10): ls_materialize="
          f"{settings.ls_materialize!r} resolves to {'materialize' if mat else 'recompute'} "
          f"(candidates {cand} B, limit {32 * 1024 * 1024} B)")
    if not mat:
        raise SystemExit("the humanoid-class row did not resolve to the materializing line search")

    counts, histories = {}, None
    for fused in FUSED_LS:
        pol = policy(fused)
        gen = torch.Generator().manual_seed(SEED)
        _, t_warm = run_steps(pol, env, norm, 1, gen, B)
        for k in kernels.values():
            k.launches = 0
        with solves_recorded() as trips:
            ep, dt = run_steps(pol, env, norm, H50_STEPS, gen, B)
        got = {name: k.launches for name, k in kernels.items()}
        expected = dict(mlp_calls_per_solve(H, sum(trips), fused == "on", len(trips),
                                            materialize=True), fused_mlp_bwd=0)
        print(f"humanoid-class fused_ls={fused}: {H50_STEPS} control steps x {B} envs in "
              f"{dt:.3f} s (warmup 1 step {t_warm:.3f} s): {B * H50_STEPS / dt:.2f} env steps/s, "
              f"{dt / H50_STEPS:.3f} s a control step (one GPU: {card_line}); trips per solve "
              f"{trips}; mean reward {ep.rewards.mean().item():.4f}; kernel launches {got} "
              f"(expected {expected})")
        print(json.dumps(bench_row(B * H50_STEPS / dt, card_line, fused, H50["env"], B, iters, H)))
        if got != expected:
            raise SystemExit(f"the humanoid-class row (fused_ls={fused}) did not launch the "
                             "kernels on every MLP call")
        shapes = {"states": (B, H50_STEPS, n), "actions": (B, H50_STEPS, m),
                  "rewards": (B, H50_STEPS), "qpos": (B, H50_STEPS, 15)}
        for name, shape in shapes.items():
            t = getattr(ep, name)
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                raise SystemExit(f"humanoid-class output {name} is malformed or not finite")
        counts = {k: counts.get(k, 0) + v for k, v in got.items()}
        if histories is None:  # the first control step's histories: zero past, reset obs
            histories = torch.zeros((B, 2, n))
            histories[:, 1] = ep.states[:, 0].cpu()
    hU = torch.zeros((B, 1, m))

    # the card against the CPU: one plan of 16 histories, cut to one trip
    hX = histories[:H50_CHECK_ENVS]
    hU16 = hU[:H50_CHECK_ENVS]
    plan = lambda pol, x, device: pol.plan_batch(x.to(device), hU16.to(device))
    for fused in FUSED_LS:
        gpu = plan(policy(fused, H50_CHECK_ITERS), hX, dev)
        cpu_pol = policy(fused, H50_CHECK_ITERS, "cpu")
        cpu = plan(cpu_pol, hX, "cpu")
        nudged = [plan(cpu_pol, hX * s, "cpu").U - cpu.U for s in (1 + 1e-7, 1 - 1e-7)]
        spread0 = max(dU[:, 0].abs().max().item() for dU in nudged)
        spread = max(dU.abs().max().item() for dU in nudged)
        d0 = (gpu.U[:, 0].cpu() - cpu.U[:, 0]).abs().max().item()
        d = (gpu.U.cpu() - cpu.U).abs().max().item()
        same_it = torch.equal(gpu.iterations.cpu(), cpu.iterations)
        print(f"humanoid-class plan_batch ({H50_CHECK_ENVS} histories, H={H}, {H50_CHECK_ITERS} "
              f"iLQR trip, fused_ls={fused}) GPU vs CPU: served action max|dU[:, 0]|={d0:.3e} "
              f"(atol 1e-3; the CPU's own under 1 +- 1e-7 nudges {spread0:.3e}); whole plan "
              f"max|dU|={d:.3e} of max|U| {cpu.U.abs().max().item():.4g} (the CPU's own "
              f"{spread:.3e}); iterations GPU {gpu.iterations.tolist()} CPU "
              f"{cpu.iterations.tolist()}")
        if not (d0 <= 1e-3 and same_it):
            raise SystemExit(f"the humanoid-class plan (fused_ls={fused}) on the card disagrees "
                             "with the CPU path")
    # at the row's own iterations, for the record: the plan is chaotic
    cpu_pol = policy("off", iters, "cpu")
    cpu = plan(cpu_pol, hX, "cpu")
    spread = max((plan(cpu_pol, hX * s, "cpu").U - cpu.U).abs().max().item()
                 for s in (1 + 1e-7, 1 - 1e-7))
    d = (plan(policy("off"), hX, dev).U.cpu() - cpu.U).abs().max().item()
    print(f"  at iLQR <= {iters} (not checked): GPU vs CPU max|dU|={d:.3e}, the CPU's own "
          f"spread under 1 +- 1e-7 nudges {spread:.3e}, max|U| {cpu.U.abs().max().item():.4g}")

    # materialize against recompute on the card, on the same inputs
    for fused in FUSED_LS:
        sols = {}
        for mode in ("materialize", "recompute"):
            pol = policy(fused, H50_CHECK_ITERS, ls=mode)
            with torch.no_grad():
                w, b = pol.dynamics_model.net.stack()[-1]
                w.mul_(H50_DYN_SCALE)
                b.mul_(H50_DYN_SCALE)
            sols[mode] = pol.plan_batch(histories.to(dev), hU.to(dev))
        a, r = sols["materialize"], sols["recompute"]
        d = (a.U - r.U).abs().max().item()
        tol = 1e-4 * max(1.0, r.U.abs().max().item())
        same_it = torch.equal(a.iterations, r.iterations)
        print(f"humanoid-class materialize vs recompute on the card ({B} histories, "
              f"{H50_CHECK_ITERS} trip, dynamics output x {H50_DYN_SCALE}, fused_ls={fused}): "
              f"max|dU|={d:.3e} (atol {tol:.3e}); iterations equal: {same_it}")
        if not (d <= tol and same_it):
            raise SystemExit(f"the materializing line search (fused_ls={fused}) disagrees with "
                             "the recompute on the card")
    print(f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s")
    return counts


@contextlib.contextmanager
def calls_refused(*targets):
    """Inside the block each (module, name) of ``targets`` raises when
    called."""
    originals = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def refuse(name):
        def refused(*args, **kwargs):
            raise SystemExit(f"{name} was called again")
        return refused

    for mod, name in targets:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def check_collector(cfg, dev):
    """The scripted cheetah expert's collection on the card against the
    CPU over the store's first ``G11_CHECK_STEPS`` steps, from the store's
    own resets and noise (the generator seeded with seed + 7, drawn on the
    CPU). The cheetah's stiff ground contact amplifies rounding: after a
    contact event a lane's states move by 1e-2 to 1 under 1e-7 nudges of
    its resets, on the CPU alone. So a lane is checked at the steps before
    the CPU's own spread of its states (under the ``G11_NUDGES`` scalings
    of the resets) first reaches ``G11_REPRODUCIBLE``, there within
    max(base, twice the spread over the checked lanes under those and the
    ``G11_WIDE_NUDGES``); the rest is printed, not checked. Returns the
    card's collection."""
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.runners import common

    n, steps = common.collection_size(cfg), cfg.get_path("env.expert_episode_steps", 1000)
    env_c, sigma = make_env(cfg.env.name, "cpu"), cfg.get_path("env.expert_noise", 0.25)
    gen = torch.Generator().manual_seed(cfg.seed + 7)
    init = env_c.reset(env_c.default_params(), n, gen)
    noise = torch.randn((steps, n, env_c.act_size), generator=gen)[:G11_CHECK_STEPS]
    gpu = expert_rollout(cfg.env.name, init, noise, sigma, dev)
    hold_expert(cfg.env.name, init, noise, sigma, gpu, "collector", "the store's draws")
    return gpu


def expert_rollout(env_name, init, noise, noise_sigma, device, scale=1.0):
    """The scripted expert of ``env_name`` collected on ``device`` from the
    start states ``init`` scaled by ``scale``, with the standard normal
    ``noise`` (T, n, act) and DART noise ``noise_sigma``."""
    from gan_mpc_tpu_torch.envs import EnvState, make_env
    from gan_mpc_tpu_torch.runners import collect

    env = make_env(env_name, device)
    start = EnvState(qpos=(init.qpos.cpu() * scale).to(env.device),
                     qvel=(init.qvel.cpu() * scale).to(env.device), t=init.t.to(env.device))
    return collect.collect_expert_trajectories(env, init.qpos.shape[0], num_steps=noise.shape[0],
                                               init_state=start, noise=noise.cpu(),
                                               noise_sigma=noise_sigma)


def hold_expert(env_name, init, noise, noise_sigma, gpu, label, draws):
    """``hold_against_cpu`` of the card's expert rollout ``gpu`` against
    ``expert_rollout`` on the CPU from the same ``init`` and ``noise``, and
    the CPU's from ``init`` scaled by the ``G11_NUDGES`` and
    ``G11_WIDE_NUDGES``. Returns the largest checked share of tolerance."""
    run = lambda scale=1.0: expert_rollout(env_name, init, noise, noise_sigma, "cpu", scale)
    return hold_against_cpu(label, draws, gpu, run(), [run(s) for s in G11_NUDGES],
                            [run(s) for s in G11_WIDE_NUDGES])


def hold_against_cpu(label, draws, gpu, cpu, nudged, wide):
    """Hold a scripted expert's rollout on the card (``gpu``, a
    ``TrajectorySet`` of n lanes x T steps) against the CPU's (``cpu``)
    from the same start states and noise: each lane at the steps before
    the CPU's own spread of its states under the ``nudged`` runs (its
    start states scaled by 1 +- 1e-7 and 1 +- 2e-7) first reaches
    ``G11_REPRODUCIBLE``, within max(base, twice the spread under those
    and the ``wide`` nudges) over the checked lanes; at least half the
    entries checked, the rest printed. Returns the largest checked
    deviation as a share of its tolerance."""
    n, T = cpu.states.shape[:2]
    wide = nudged + wide

    def moves(field, runs):  # (n, T): the card's and the nudged CPU runs' largest moves
        want = getattr(cpu, field)
        move = lambda c: np.abs(getattr(c, field) - want).reshape(n, T, -1).max(-1)
        return move(gpu), np.max([move(c) for c in runs], axis=0)

    checked = np.maximum.accumulate(moves("states", nudged)[1], axis=1) < G11_REPRODUCIBLE
    fmt = lambda a: " ".join(f"{v:.2e}" for v in a)
    print(f"  {label} GPU vs CPU ({n} envs x {T} steps, {draws}): checked "
          f"{int(checked.sum())} of {n * T} (env, step) entries, {int(checked.all(1).sum())} "
          f"envs at every step (the CPU's own spread of their states under 1 +- 1e-7 and "
          f"1 +- 2e-7 nudges of the starts below {G11_REPRODUCIBLE})")
    worst = 0.0
    for field, base in (("states", 1e-4), ("actions", 1e-4), ("executed_actions", 1e-4),
                        ("rewards", 1e-5)):
        d, spread = moves(field, wide)
        tol = np.maximum(base, 2.0 * np.where(checked, spread, 0.0).max(0))
        d_checked = np.where(checked, d, 0.0).max(0)
        worst = max(worst, float((d_checked / tol).max()))
        print(f"    {field}: checked max|d| per step [{fmt(d_checked)}], atol [{fmt(tol)}]; "
              f"all envs (not checked) max|d| [{fmt(d.max(0))}], the CPU's own spread "
              f"under nudges up to 5e-7 [{fmt(spread.max(0))}]")
        if np.any(checked & (d > tol[None])):
            raise SystemExit(f"the {label} on the card disagrees with the CPU: {field}")
    print(f"    largest checked max|d| / atol: {worst:.3f}")
    if checked.mean() < 0.5:
        raise SystemExit(f"fewer than half the {label}'s entries are reproducible on the CPU")
    return worst


def fresh_run_phase(kernels, card_line, dev):
    """Phase 11: ``runners.gan.run`` on ``G11_CONFIG`` with ``G11_CUTS``
    from an empty workdir: it collects the fingerprinted store, trains and
    saves the expert, runs the epoch; then the store, the expert and the
    launches are checked, a second ``setup`` reads both without collecting
    or training, and the collector is held card against CPU. Returns the
    run's launches."""
    import os
    import tempfile

    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.data.trajectories import read_gmts
    from gan_mpc_tpu_torch.params import expert_to_jax_params, load_msgpack
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
    from gan_mpc_tpu_torch.runners import common, expert, gan

    t_phase = time.perf_counter()

    def log(msg):
        print(f"  {msg}")

    with tempfile.TemporaryDirectory() as workdir:
        cfg = Config.from_yaml(G11_CONFIG).replace(runtime__workdir=workdir, **G11_CUTS)
        print(f"fresh run ({G11_CONFIG} from an empty workdir, one GPU: {card_line}); cuts "
              f"{G11_CUTS}")
        for k in kernels.values():
            k.launches = 0
        watched = [(common, "collect_expert_trajectories", "collection"),
                   (expert, "train_expert", "expert training"),
                   (expert, "average_return", "expert evaluation")]
        t0 = time.perf_counter()
        with solves_recorded() as trips, update_steps_recorded() as steps, \
                run_watched(watched) as timed:
            out = gan.run(cfg, log_fn=log, device=dev)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {name: k.launches for name, k in kernels.items()}
        H = cfg.mpc.horizon
        solves = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips), materialize=False))
        expected = {"fused_mlp_fwd": solves["fused_mlp_fwd"] + H * steps["dynamics"]
                    + (H + 1) * steps["cost"],
                    "fused_ls_step": 0, "fused_mlp_bwd": H * (steps["dynamics"] + steps["cost"])}

        path, fp = common.trajectories_path(cfg), common.collection_fingerprint(cfg)
        states, actions, rewards = read_gmts(path)  # in the order collected
        totals = rewards.sum(1)
        gate, wanted = cfg.mpc.train.min_expert_reward, cfg.mpc.train.num_trajectories
        n_clear = int((totals > gate).sum())
        expert_dirs = sorted(os.listdir(common.expert_model_dir(cfg)))
        expert_dir = os.path.join(common.expert_model_dir(cfg), expert_dirs[0])
        with open(os.path.join(expert_dir, "config.json")) as f:
            stamp = json.load(f)
        sidecar = os.path.exists(path + ".exec.npz")
        saved_expert = load_msgpack(os.path.join(expert_dir, "params.msgpack"))
        # a second setup in the same workdir reads the store and the expert
        with calls_refused((common, "collect_expert_trajectories"), (expert, "run")):
            ctx = common.setup(cfg, True, device=dev)
        served = expert_to_jax_params(ctx["policy"].expert_model)

    kinds = {}
    for kind, secs in timed:
        kinds.setdefault(kind, []).append(round(secs, 3))
    print(f"  store {os.path.basename(path)} (fingerprint {fp}): states {states.shape}, "
          f"actions {actions.shape}, rewards {rewards.shape}, sidecar "
          f"{sidecar}; {n_clear} of {len(totals)} clear min_expert_reward={gate} "
          f"({wanted} asked for)")
    print(f"  total reward of each trajectory: {[round(float(t), 2) for t in totals]}")
    print(f"  expert {expert_dirs}: fingerprint {stamp['collection_fingerprint']}, loss "
          f"{stamp['loss']}, avg_reward {stamp['avg_reward']}")
    print(f"  run {run_s:.3f} s, wall s by piece: {kinds}; saved {out['run_dir']}")
    print(f"  kernel launches {counts} (expected {expected}: {len(trips)} solves of "
          f"{sum(trips)} trips, {steps['dynamics']} dynamics and {steps['cost']} generator "
          f"steps of {H} time steps)")
    n, steps_full = common.collection_size(cfg), cfg.get_path("env.expert_episode_steps", 1000)
    if os.path.basename(path) != f"trajectories-{fp}.gmts" or not sidecar:
        raise SystemExit(f"the run's store is {path}, sidecar {sidecar}")
    if (states.shape, actions.shape, rewards.shape) != (
            (n, steps_full, 17), (n, steps_full, 6), (n, steps_full)):
        raise SystemExit("the collected store has the wrong shapes")
    if n_clear < wanted:
        raise SystemExit(f"only {n_clear} trajectories clear the gate, {wanted} asked for")
    if expert_dirs != ["0"] or stamp["collection_fingerprint"] != fp or not np.all(
            np.isfinite([stamp["loss"]["train_loss"], stamp["loss"]["test_loss"]])):
        raise SystemExit("the trained expert was not saved with the store's fingerprint and "
                         "finite losses")

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(tree[k])

    a, b = dict(leaves(served)), dict(leaves(saved_expert))
    if sorted(a) != sorted(b) or not all(np.array_equal(a[k], b[k]) for k in a):
        raise SystemExit("the second setup did not serve the saved expert")
    print("  second setup: the store read and the saved expert loaded, nothing collected or "
          "trained again")
    if counts != expected:
        raise SystemExit("the fresh run did not launch the kernels on every MLP call")
    history = out["history"]
    if not all(vs and np.all(np.isfinite(vs)) for vs in history.values()):
        raise SystemExit("the fresh run's losses or returns are missing or not finite")

    t0 = time.perf_counter()
    gpu = check_collector(cfg, dev)
    same = np.array_equal(gpu.states, states[:, :G11_CHECK_STEPS])
    print(f"  the card's {G11_CHECK_STEPS}-step collection equals the store's first steps "
          f"bitwise: {same}; check {time.perf_counter() - t0:.1f} s")
    print(f"phase 11 wall time {time.perf_counter() - t_phase:.1f} s")
    return counts


@contextlib.contextmanager
def shapes_recorded():
    """Inside the block every call of the two MLP kernels' wrappers records
    its stack and rows: {(kernel, widths, rows): the stack's weights at the
    first such call (detached copies)}. One dictionary lookup per call."""
    from gan_mpc_tpu_torch.ops import fused_mlp

    seen = {}

    def recording(name):
        def wrap(original):
            def call(self, x, layers, *rest):
                key = (name, tuple([x.shape[1]] + [w.shape[1] for w, _ in layers]),
                       x.shape[0])
                if key not in seen:
                    seen[key] = [(w.detach().clone(), b.detach().clone()) for w, b in layers]
                return original(self, x, layers, *rest)
            return call
        return wrap

    with wrapped(fused_mlp.FusedMlpKernel, "__call__", recording("fused_mlp_fwd")), \
            wrapped(fused_mlp.FusedMlpBwdKernel, "__call__", recording("fused_mlp_bwd")):
        yield seen


def check_recorded(label, seen, checked, rng, dev, max_err):
    """Each MLP kernel held against its plain version at every (stack,
    rows) that ``seen`` (``shapes_recorded``) holds and ``checked`` does
    not, on the run's own weights: the forward on standard normal rows
    within 1e-4 max(1, max|ref|) (as phase 2), the backward by
    ``check_backward``. Adds the keys to ``checked``."""
    from gan_mpc_tpu_torch.ops.fused_mlp import fused_mlp_forward, reference_forward

    new = sorted(k for k in seen if k not in checked)
    print(f"{label}: the MLP kernels at the {len(new)} (stack, rows) pairs of {len(seen)} "
          f"its runs gave them that no earlier check held, on the runs' weights")
    for key in new:
        name, widths, rows = key
        layers = seen[key]
        if name == "fused_mlp_bwd":
            err = check_backward(label, layers, rows, rng, dev) if rows else 0.0
        else:
            x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                             device=dev)
            got, ref = fused_mlp_forward(x, layers), reference_forward(x, layers)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item() if rows else 0.0
            tol = 1e-4 * max(1.0, ref.abs().max().item() if rows else 0.0)
            print(f"check fused_mlp_fwd {label} {list(widths)} rows={rows}: "
                  f"max|d|={err:.3e} bound={tol:.3e}")
            if not (err <= tol and tuple(got.shape) == tuple(ref.shape)):
                raise SystemExit(f"fused_mlp_fwd disagrees with plain version at {label}'s "
                                 f"stack {list(widths)}, {rows} rows")
        max_err[name] = max(max_err[name], err)
        checked.add(key)


@contextlib.contextmanager
def wrapped(module, name, wrapper):
    """Inside the block ``module.name`` is ``wrapper(original)``."""
    original = getattr(module, name)
    setattr(module, name, wrapper(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def check_fused_dynamics(snap, cfg, dev):
    """The fused epoch's dynamics phase (``fused_epoch.dynamics_steps``)
    on the card against the CPU: from the replay, the dynamics params, the
    optimizer's state and the first ``G12_DYN_CHECK_STEPS`` rows of
    ``dyn_perm`` that the run's first fused epoch started from. The mean
    loss within max(1e-5 |loss|, twice the CPU's own spread) and the
    params' updates within max(1e-7, twice the spread), the spread under
    the replay's states scaled by 1 +- 1e-7 and the dynamics weights by
    1 +- 1e-6 (the kernels' split-TF32 products are a few 1e-6 off f32
    ones, phase 2)."""
    import copy
    from types import SimpleNamespace

    from gan_mpc_tpu_torch.data.buffers import ReplayBuffer
    from gan_mpc_tpu_torch.runners import common
    from gan_mpc_tpu_torch.training import fused_epoch
    from gan_mpc_tpu_torch.training.masking import masked_adam

    dcfg = cfg.mpc.train.dynamics

    def run(device, scale=1.0, w_scale=1.0):
        model = common.build_dynamics_model(cfg, 3, 1).to(device)
        with torch.no_grad():
            for p, q in zip(model.parameters(), snap["params"]):
                p.copy_(q * w_scale)
        opt = masked_adam({"dynamics_params": list(model.parameters())}, [], dcfg.learning_rate)
        opt.load_state_dict(copy.deepcopy(snap["opt"]))  # loading keeps same-device tensors
        states, actions, next_states = (t.to(device) for t in snap["replay"])
        replay = ReplayBuffer(states * scale, actions, next_states * scale,
                              size=states.shape[0])
        start = [p.detach().clone() for p in model.parameters()]
        loss = fused_epoch.dynamics_steps(SimpleNamespace(dynamics_model=model), opt, replay,
                                          snap["dyn_perm"], snap["gamma"],
                                          snap["teacher_forcing"])
        return loss, [(p.detach() - q).cpu() for p, q in zip(model.parameters(), start)]

    l_gpu, p_gpu = run(dev)
    l_cpu, p_cpu = run("cpu")
    spread_l, spread_p = 0.0, 0.0
    for kw in (dict(scale=1 + 1e-7), dict(scale=1 - 1e-7), dict(w_scale=1 + 1e-6),
               dict(w_scale=1 - 1e-6)):
        l_n, p_n = run("cpu", **kw)
        spread_l = max(spread_l, abs(l_n - l_cpu))
        spread_p = max(spread_p, max((a - b).abs().max().item() for a, b in zip(p_n, p_cpu)))
    d_l = abs(l_gpu - l_cpu)
    d_p = max((a - b).abs().max().item() for a, b in zip(p_gpu, p_cpu))
    tol_l, tol_p = max(1e-5 * abs(l_cpu), 2 * spread_l), max(1e-7, 2 * spread_p)
    print(f"  fused dynamics phase GPU vs CPU ({len(snap['dyn_perm'])} steps of "
          f"{snap['dyn_perm'].shape[1]} replay windows of {snap['replay'][0].shape[0]}, "
          f"teacher forcing {snap['teacher_forcing']}): loss {l_gpu:.7g} vs {l_cpu:.7g} "
          f"(|d| {d_l:.2e}, tol {tol_l:.2e}, the CPU's own spread {spread_l:.2e}); the "
          f"params' updates (largest {max(u.abs().max().item() for u in p_cpu):.2e}) max|d| "
          f"{d_p:.2e} (tol {tol_p:.2e}, the CPU's own spread {spread_p:.2e})")
    if not (d_l <= tol_l and d_p <= tol_p):
        raise SystemExit("the fused dynamics phase on the card disagrees with the CPU")


def check_dagger_segments(seg, dev):
    """DAgger's expert segments of the run (the card's) against the CPU's
    from the same picked (qpos, qvel) and noise (``hold_expert``)."""
    _, kw, gpu = seg
    return hold_expert("pendulum_swingup", kw["init_state"], kw["noise"], kw["noise_sigma"], gpu,
                       "DAgger expert segments", "the run's picks and noise")


def fused_phase(kernels, card_line, dev, wall):
    """Phase 12: the fused epochs and a DAgger round. ``runners.gan.run`` on
    ``G12_CONFIG`` with ``G12_CUTS`` (interrupted after fused epoch 1,
    resumed: epoch 2, the DAgger round and its extra fused epoch, the end),
    then ``runners.l2.run`` on ``G12_L2_CONFIG`` with ``G12_L2_CUTS``, each
    in a temporary workdir on phase 8's store; their launches against the
    recorded solves and update steps, their metrics files, the resume and
    the saved run; then DAgger's expert segments and the fused dynamics
    phase card against CPU. Prints each fused epoch's wall time beside
    phase 8's modular epoch (``wall``). Returns each run's launches."""
    import copy
    import os
    import tempfile

    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.params import to_jax_params
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
    from gan_mpc_tpu_torch.runners import collect, common, expert, gan, l2
    from gan_mpc_tpu_torch.training import critic, fused_epoch

    t_phase = time.perf_counter()

    class Interrupted(RuntimeError):
        pass

    logs = []

    def log(msg):
        print(f"  {msg}")
        logs.append(msg)

    def log_crashing(msg):
        log(msg)
        if msg.startswith("[gan/fused] epoch 1 "):
            raise Interrupted(msg)

    captured = {}

    def capture_segments(original):
        def segments(env, n, **kw):
            out = original(env, n, **kw)
            captured["segments"] = (n, kw, out)
            return out
        return segments

    def capture_dynamics(original):
        def dynamics_steps(policy, optimizer, replay, dyn_perm, gamma, teacher_forcing,
                           *args, **kw):
            if "dynamics" not in captured:
                n = max(replay.size, 1)
                captured["dynamics"] = dict(
                    params=[p.detach().cpu().clone() for p in policy.dynamics_model.parameters()],
                    opt=copy.deepcopy(optimizer.state_dict()),
                    replay=tuple(t[:n].cpu().clone() for t in (replay.states, replay.actions,
                                                                replay.next_states)),
                    dyn_perm=dyn_perm[:G12_DYN_CHECK_STEPS].cpu(), gamma=gamma,
                    teacher_forcing=teacher_forcing)
            return original(policy, optimizer, replay, dyn_perm, gamma, teacher_forcing,
                            *args, **kw)
        return dynamics_steps

    def timed_epochs(original):
        def make(*args, **kw):
            epoch = original(*args, **kw)

            def timed(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = epoch(*a, **k)
                torch.cuda.synchronize()
                epochs.append(time.perf_counter() - t0)
                return out
            return timed
        return make

    pieces = [(fused_epoch, "collect_episode", "collection"),
              (fused_epoch, "dynamics_steps", "dynamics"),
              (fused_epoch, "critic_dataset", "critic dataset"),
              (critic, "update_pass", "critic updates"),
              (fused_epoch, "cost_steps", "generator or cost"),
              (fused_epoch, "gan_test_metrics", "test metrics"),
              (fused_epoch, "l2_test_metric", "test metrics"),
              (collect, "policy_rollout", "DAgger rollout"),
              (collect, "collect_expert_trajectories", "expert segments"),
              (gan, "train_expert", "DAgger fine-tune"),
              (expert, "train_expert", "expert training")]
    results = {}
    for family, config, cuts in (("gan", G12_CONFIG, G12_CUTS), ("l2", G12_L2_CONFIG,
                                                                  G12_L2_CUTS)):
        epochs = []
        with tempfile.TemporaryDirectory() as workdir:
            cfg = Config.from_yaml(config).replace(runtime__workdir=workdir,
                                                   env__trajectories_path=GAN9_STORE, **cuts)
            print(f"fused {family} run ({config} in a temporary workdir on {GAN9_STORE}, one "
                  f"GPU: {card_line}); cuts {cuts}")
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            with wrapped(collect, "collect_expert_trajectories", capture_segments), \
                    wrapped(fused_epoch, "dynamics_steps", capture_dynamics), \
                    wrapped(l2, "make_fused_epoch", timed_epochs), \
                    solves_recorded() as trips, update_steps_recorded() as steps, \
                    run_watched(pieces) as timed:
                if family == "gan":
                    try:
                        gan.run(cfg, log_fn=log_crashing, device=dev)
                        raise SystemExit("the fused GAN run was not interrupted after epoch 1")
                    except Interrupted:
                        pass
                    if l2.checkpointer_for(cfg, "gan").latest_step() != 1:
                        raise SystemExit("the interrupted fused GAN run left no epoch-1 "
                                         "checkpoint")
                    out = gan.run(cfg, log_fn=log, device=dev)
                else:
                    out = l2.run(cfg, log_fn=log, device=dev)
                torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = {name: k.launches for name, k in kernels.items()}
            H = cfg.mpc.horizon
            solves = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips),
                                              materialize=False))
            expected = {"fused_mlp_fwd": solves["fused_mlp_fwd"] + H * steps["dynamics"]
                        + (H + 1) * steps["cost"], "fused_ls_step": 0,
                        "fused_mlp_bwd": H * (steps["dynamics"] + steps["cost"])}
            with open(os.path.join(workdir, "metrics", cfg.env.name, f"{family}.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            cleared = l2.checkpointer_for(cfg, family) is None or \
                l2.checkpointer_for(cfg, family).latest_step() is None
            trained_expert = os.path.isdir(common.expert_model_dir(cfg))
            reloaded = to_jax_params(common.setup(cfg.replace(
                mpc__train__init_from_run=out["run_dir"]), family == "gan", device=dev)["policy"])
        kinds = {}
        for kind, secs in timed:
            kinds.setdefault(kind, []).append(round(secs, 3))
        print(f"  {family} run {run_s:.3f} s; fused epochs {[round(e, 3) for e in epochs]} s "
              f"(phase 8's modular epoch {wall.get('gan/9 modular epoch', float('nan')):.3f} s); "
              f"wall s by piece: {kinds}")
        init_run = cfg.mpc.train.get_path("init_from_run")
        print("  setup " + ("trained and saved an expert (none saved in the workdir matched "
                            "the store)" if trained_expert else
                            f"took every component, the expert included, from {init_run}"))
        print(f"  kernel launches {counts} (expected {expected}: {len(trips)} solves of "
              f"{sum(trips)} trips, {steps['dynamics']} dynamics and {steps['cost']} "
              f"{'generator' if family == 'gan' else 'cost'} steps of {H} time steps)")
        if counts != expected:
            raise SystemExit(f"the fused {family} run did not launch the kernels on every MLP "
                             "call")
        fused_keys = set(l2.FUSED_RECORDS[family][f][1] for f in l2.FUSED_RECORDS[family])
        epoch_rows = [r for r in rows if fused_keys <= set(r)]
        dagger_rows = [r for r in rows if "dagger_test_loss" in r]
        losses = [v for r in rows for k, v in r.items() if k not in ("step", "time")]
        print(f"  {family}.jsonl: {len(rows)} rows, fused epoch rows at steps "
              f"{[r['step'] for r in epoch_rows]}, DAgger rows {dagger_rows}, eval rows at "
              f"{[r['step'] for r in rows if 'eval_reward' in r]}")
        if not np.all(np.isfinite(losses)) or any(not vs for vs in out["history"].values()) or \
                not np.all(np.isfinite([v for vs in out["history"].values() for v in vs])):
            raise SystemExit(f"the fused {family} run's metrics are missing or not finite")
        want_epochs = [1, 2, 1] if family == "gan" else [1]
        if [r["step"] for r in epoch_rows] != want_epochs or \
                len(dagger_rows) != (1 if family == "gan" else 0) or not cleared:
            raise SystemExit(f"the fused {family} run wrote {len(epoch_rows)} epoch rows and "
                             f"{len(dagger_rows)} DAgger rows, checkpoints cleared {cleared}")
        got = dict(leaves_of(reloaded))
        if sorted(got) != sorted(dict(leaves_of(out["params"]))) or not all(
                np.array_equal(v, dict(leaves_of(out["params"]))[k]) for k, v in got.items()):
            raise SystemExit(f"the saved fused {family} run does not reload bitwise")
        print(f"  saved {out['run_dir']} reloads bitwise; stamped reward {out['avg_reward']:.2f}")
        results[family] = counts
        if family == "gan":
            resumed = [m for m in logs if m.startswith("[gan/fused] epoch")]
            if "[gan] resumed from checkpoint at epoch 1" not in logs or not \
                    resumed[1].startswith("[gan/fused] epoch 2 "):
                raise SystemExit("the fused GAN run did not restart at epoch 2")
            snapshot = captured.pop("dynamics")
            check_dagger_segments(captured.pop("segments"), dev)
            check_fused_dynamics(snapshot, cfg, dev)
        captured.clear()
    print(f"phase 12 wall time {time.perf_counter() - t_phase:.1f} s")
    return {"fused gan run": results["gan"], "fused l2 run": results["l2"]}


def check_env_steps(dev):
    """Phase 13 (a): walker_walk and cartpole_balance stepped on the card and
    on the CPU from the same states and actions, each step's qpos, qvel and
    reward within tol x max(1, max|CPU's|): the cart-pole for
    ``G13_CARTPOLE_STEPS`` steps from its resets (1e-5: smooth, no contact);
    the walker one step from its resets, heels and toes in the ground (qvel
    1e-4: the velocity comes out of a 9 x 9 solve through the contacts, as
    in the CPU tests against JAX), and ``G13_AIRBORNE_STEPS`` steps in the
    air (1e-5), every contact point kept 0.2 or more above the ground."""
    from gan_mpc_tpu_torch.envs import EnvState, make_env
    from gan_mpc_tpu_torch.envs.planar import contact_points, forward_kinematics

    B, rng = G13_ENV_ENVS, np.random.default_rng(SEED)
    cp, wk = make_env("cartpole_balance", "cpu"), make_env("walker_walk", "cpu")
    s_cp = cp.reset(cp.default_params(), B, torch.Generator().manual_seed(SEED))
    s_wk = wk.reset(wk.default_params(), B, torch.Generator().manual_seed(SEED))
    q_air = torch.zeros((B, 9))
    q_air[:, 1] = 2.5
    q_air += 0.1 * torch.tensor(rng.standard_normal((B, 9)), dtype=torch.float32)
    qd_air = 0.5 * torch.tensor(rng.standard_normal((B, 9)), dtype=torch.float32)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    cases = [
        ("cartpole_balance", "from its resets", s_cp.qpos, s_cp.qvel,
         f32(rng.uniform(-1.2, 1.2, (G13_CARTPOLE_STEPS, B, 1))), (1e-5, 1e-5, 1e-5)),
        ("walker_walk", "from its resets, in contact", s_wk.qpos, s_wk.qvel,
         f32(rng.uniform(-1.3, 1.3, (1, B, 6))), (1e-5, 1e-4, 1e-5)),
        ("walker_walk", "in the air", q_air, qd_air,
         f32(rng.uniform(-1.0, 1.0, (G13_AIRBORNE_STEPS, B, 6))), (1e-5, 1e-5, 1e-5)),
    ]
    for name, where, q, qd, us, tol in cases:
        envs = {"cpu": make_env(name, "cpu"), "gpu": make_env(name, dev)}
        states = {k: EnvState(q.to(e.device), qd.to(e.device),
                              torch.zeros(B, dtype=torch.int32, device=e.device))
                  for k, e in envs.items()}
        worst = [0.0, 0.0, 0.0]
        for t, u in enumerate(us):
            out = {}
            for k, e in envs.items():
                states[k], reward = e.step(e.default_params(), states[k], u.to(e.device))
                out[k] = (states[k].qpos, states[k].qvel, reward)
            for i, (g, c) in enumerate(zip(out["gpu"], out["cpu"])):
                err = (g.cpu() - c).abs().max().item() / max(1.0, c.abs().max().item())
                worst[i] = max(worst[i], err)
                if not (err <= tol[i] and bool(torch.isfinite(g).all())):
                    raise SystemExit(f"{name} {where}: the step on the card disagrees with the "
                                     f"CPU at step {t} ({('qpos', 'qvel', 'reward')[i]} "
                                     f"{err:.2e} > {tol[i]:.0e} of scale)")
            if where == "in the air":
                model = envs["cpu"].model(envs["cpu"].default_params())
                angles, origins, _ = forward_kinematics(model, states["cpu"].qpos)
                if contact_points(model, angles, origins)[..., 1].min().item() <= 0.1:
                    raise SystemExit("the walker came within 0.1 of the ground in the air")
        print(f"  {name} {where}: {B} envs x {len(us)} steps, GPU vs CPU max|d| / max(1, "
              f"max|ref|) qpos {worst[0]:.2e} qvel {worst[1]:.2e} reward {worst[2]:.2e} "
              f"(tol {tol[0]:.0e} / {tol[1]:.0e} / {tol[2]:.0e})")


def check_expert(env_name, noise_sigma, dev):
    """Phase 13 (b): a scripted expert's collection (``G13_EXPERT_ENVS`` x
    ``G13_EXPERT_STEPS``, DART noise ``noise_sigma``) on the card against
    the CPU from the same resets and noise (drawn from seed 0 on the CPU),
    by ``hold_expert``."""
    from gan_mpc_tpu_torch.envs import make_env

    env_c = make_env(env_name, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    init = env_c.reset(env_c.default_params(), G13_EXPERT_ENVS, gen)
    noise = torch.randn((G13_EXPERT_STEPS, G13_EXPERT_ENVS, env_c.act_size), generator=gen)
    gpu = expert_rollout(env_name, init, noise, noise_sigma, dev)
    return hold_expert(env_name, init, noise, noise_sigma, gpu, f"{env_name} scripted expert",
                       "resets and noise from seed 0")


def serve_checkpoint(run_dir, num_envs, steps, kernels, card_line, dev):
    """Serve a committed trained run as the bench does (``bench.load_checkpoint``:
    its config, every component, the normalizer refitted on its committed
    store) for 1 warmup and ``steps`` timed control steps of ``num_envs``
    envs; the launches held to ``mlp_calls_per_solve`` over the trips the
    solver reported (an ensemble's members launch on every dynamics call, a
    goal projection adds its H advances, the per-instance path reads no
    fused step). Returns (launches, episode, seconds, trips, checkpoint)."""
    from gan_mpc_tpu_torch.bench import load_checkpoint, run_steps
    from gan_mpc_tpu_torch.planner.batch_ilqr import ls_materializes, mlp_calls_per_solve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt = load_checkpoint(run_dir, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    policy, env, s = ckpt.policy, ckpt.env, ckpt.policy.settings
    dyn = policy.dynamics_model
    members = getattr(dyn, "num_members", 1)
    H, n, m = policy.horizon, env.obs_size + dyn.carry_size, env.act_size
    mat = ls_materializes(s, H, num_envs, n, m)
    # "auto" is on for the card's inputs; the per-instance path reads no fused step
    fused = policy.batch_native and s.fused_ls in ("on", "auto")
    served = dict(env_params=ckpt.env_params, history=ckpt.history)
    gen = torch.Generator().manual_seed(SEED)
    _, t_warm = run_steps(policy, env, ckpt.normalizer, 1, gen, num_envs, **served)
    for k in kernels.values():
        k.launches = 0
    with solves_recorded() as trips:
        ep, dt = run_steps(policy, env, ckpt.normalizer, steps, gen, num_envs, **served)
    got = {name: k.launches for name, k in kernels.items()}
    expected = dict(mlp_calls_per_solve(H, sum(trips), fused, len(trips), materialize=mat,
                                        members=members,
                                        projection=policy.goal_projection > 0),
                    fused_mlp_bwd=0)
    nets = [mm.net for mm in dyn.members] if members > 1 else [dyn.net]
    widths = lambda st: [st[0][0].shape[0]] + [w.shape[1] for w, _ in st]
    stacks = {"dynamics": (f"{members} x " if members > 1 else "") + str(widths(nets[0].stack())),
              "cost": str(widths(policy.cost_model.net.stack()))}
    print(f"{ckpt.name} served from {run_dir} (loaded in {load_s:.2f} s: its config.json, "
          f"params.msgpack with{'' if policy.critic_model is not None else 'out'} a critic, the "
          f"normalizer refitted on its committed store): {num_envs} envs x {steps} control steps "
          f"in {dt:.3f} s (warmup 1 step {t_warm:.3f} s): {num_envs * steps / dt:.2f} env steps/s, "
          f"{dt / steps:.3f} s a control step (one GPU: {card_line}); H={H}, iLQR <= "
          f"{s.max_iterations}, fused_ls={s.fused_ls}, "
          f"{'batch-native' if policy.batch_native else 'per-instance'} path, goal projection "
          f"{policy.goal_projection}, history {ckpt.history}, stacks {stacks}; "
          f"trips per solve {trips}; kernel launches {got} (expected {expected})")
    if got != expected:
        raise SystemExit(f"{ckpt.name} did not launch the kernels on every MLP call")
    for name, shape in (("states", (num_envs, steps, env.obs_size)),
                        ("actions", (num_envs, steps, m)), ("rewards", (num_envs, steps))):
        t = getattr(ep, name)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise SystemExit(f"{ckpt.name} output {name} is malformed or not finite")
    return got, ep, dt, trips, ckpt


def fresh_fused_run(family, config, cuts, kernels, card_line, dev):
    """Phase 13 (e): ``runners.{gan,l2}.run`` on ``config`` with ``cuts`` from
    an empty temporary workdir (it collects the store with the scripted
    expert, trains the expert, trains the fused epochs and, for the GAN run,
    the DAgger round); the launches against the recorded solves and update
    steps, the store, the metrics file and the saved run reloaded bitwise.
    Returns the launches."""
    import os
    import tempfile

    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.data.trajectories import load_trajectories
    from gan_mpc_tpu_torch.params import to_jax_params
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve
    from gan_mpc_tpu_torch.runners import collect, common, expert, gan, l2
    from gan_mpc_tpu_torch.training import critic, fused_epoch

    pieces = [(common, "collect_expert_trajectories", "store collection"),
              (expert, "train_expert", "expert training"),
              (fused_epoch, "collect_episode", "collection"),
              (fused_epoch, "dynamics_steps", "dynamics"),
              (fused_epoch, "critic_dataset", "critic dataset"),
              (critic, "update_pass", "critic updates"),
              (fused_epoch, "cost_steps", "generator or cost"),
              (collect, "policy_rollout", "DAgger rollout"),
              (collect, "collect_expert_trajectories", "expert segments"),
              (gan, "train_expert", "DAgger fine-tune")]
    logs = []

    def log(msg):
        print(f"  {msg}")
        logs.append(msg)

    with tempfile.TemporaryDirectory() as workdir:
        cfg = Config.from_yaml(config).replace(runtime__workdir=workdir, **cuts)
        print(f"fresh fused {family} run ({config} from an empty temporary workdir, one GPU: "
              f"{card_line}); cuts {cuts}")
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with solves_recorded() as trips, update_steps_recorded() as steps, \
                run_watched(pieces) as timed:
            out = (gan if family == "gan" else l2).run(cfg, log_fn=log, device=dev)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {name: k.launches for name, k in kernels.items()}
        H = cfg.mpc.horizon
        solves = dict(mlp_calls_per_solve(H, sum(trips), solves=len(trips), materialize=False))
        expected = {"fused_mlp_fwd": solves["fused_mlp_fwd"] + H * steps["dynamics"]
                    + (H + 1) * steps["cost"], "fused_ls_step": 0,
                    "fused_mlp_bwd": H * (steps["dynamics"] + steps["cost"])}
        store = load_trajectories(common.trajectories_path(cfg), num_trajectories=1000,
                                  trajectory_len=cfg.get_path("env.expert_episode_steps", 1000),
                                  min_reward=-1.0)
        gated = common.load_store(cfg, common.trajectories_path(cfg))
        with open(os.path.join(workdir, "metrics", cfg.env.name, f"{family}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        experts = os.listdir(common.expert_model_dir(cfg))
        reloaded = to_jax_params(common.setup(cfg.replace(
            mpc__train__init_from_run=out["run_dir"]), family == "gan", device=dev)["policy"])
    kinds = {}
    for kind, secs in timed:
        kinds.setdefault(kind, []).append(round(secs, 3))
    totals = np.round(store.rewards.sum(1), 1).tolist()
    print(f"  {family} run {run_s:.3f} s; wall s by piece: {kinds}")
    print(f"  store {os.path.basename(common.trajectories_path(cfg))}: states "
          f"{store.states.shape}, episode returns {totals}; {gated.states.shape[0]} clear "
          f"min_expert_reward={cfg.mpc.train.get_path('min_expert_reward', 500.0)}; experts "
          f"saved {experts}")
    print(f"  kernel launches {counts} (expected {expected}: {len(trips)} solves of "
          f"{sum(trips)} trips, {steps['dynamics']} dynamics and {steps['cost']} "
          f"{'generator' if family == 'gan' else 'cost'} steps of {H} time steps)")
    if counts != expected:
        raise SystemExit(f"the fresh {family} run of {config} did not launch the kernels on "
                         "every MLP call")
    if store.states.shape[0] != common.collection_size(cfg) or not gated.states.shape[0] or \
            experts != ["0"]:
        raise SystemExit(f"the fresh {family} run of {config} collected no usable store or "
                         "saved no expert")
    fused_keys = set(l2.FUSED_RECORDS[family][f][1] for f in l2.FUSED_RECORDS[family])
    epoch_rows = [r for r in rows if fused_keys <= set(r)]
    dagger_rows = [r for r in rows if "dagger_test_loss" in r]
    values = [v for r in rows for k, v in r.items() if k not in ("step", "time")]
    want_epochs = list(range(1, cfg.mpc.train.num_epochs + 1))
    print(f"  {family}.jsonl: {len(rows)} rows, fused epoch rows at steps "
          f"{[r['step'] for r in epoch_rows]}, DAgger rows {dagger_rows}; stamped reward "
          f"{out['avg_reward']:.2f}")
    if [r["step"] for r in epoch_rows] != want_epochs or not np.all(np.isfinite(values)) or \
            len(dagger_rows) != cfg.get_path("expert_prediction.dagger.rounds", 0):
        raise SystemExit(f"the fresh {family} run of {config} wrote unexpected metrics rows")
    got, want = dict(leaves_of(reloaded)), dict(leaves_of(out["params"]))
    if sorted(got) != sorted(want) or not all(np.array_equal(v, want[k]) for k, v in got.items()):
        raise SystemExit(f"the saved fresh {family} run of {config} does not reload bitwise")
    return counts


def walker_cartpole_phase(kernels, card_line, dev):
    """Phase 13: walker and cartpole, and the committed trained checkpoints
    (see the module's docstring). Returns the launches of each path."""
    import os

    from gan_mpc_tpu_torch.bench import DEFAULT_CHECKPOINT, NUM_ENVS, bench_row
    from gan_mpc_tpu_torch.config import Config

    t_phase = time.perf_counter()
    wall, launches = {}, {}
    t0 = time.perf_counter()
    print("phase 13 (a): the envs on the card against the CPU")
    check_env_steps(dev)
    wall["(a) envs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("phase 13 (b): the scripted experts on the card against the CPU")
    for env_name, noise in (("walker_walk", 0.1), ("cartpole_balance", 0.25)):
        check_expert(env_name, noise, dev)
    wall["(b) experts"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("phase 13 (c): the trained-checkpoint row, the JAX bench's second line")
    got, ep, dt, trips, ckpt = serve_checkpoint(DEFAULT_CHECKPOINT, NUM_ENVS, G13_GAN4_STEPS,
                                                kernels, card_line, dev)
    settings = ckpt.policy.settings
    print(json.dumps(bench_row(NUM_ENVS * G13_GAN4_STEPS / dt, card_line, settings.fused_ls,
                               ckpt.name, NUM_ENVS, settings.max_iterations, ckpt.policy.horizon,
                               settings.num_alphas, settings.ls_materialize)))
    print(f"  mean trips per solve {np.mean(trips):.2f} of {settings.max_iterations}")
    launches["gan/4 serving"] = got
    wall["(c) gan/4 row"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("phase 13 (d): walker gan/0 and cartpole l2/0 served at their configs' "
          "num_parallel_envs")
    for run, config in (("walker_walk/gan/0", "configs/gan_walker.yaml"),
                        ("cartpole_balance/l2/0", "configs/l2_cartpole_quality.yaml")):
        run_dir = os.path.join("runs/trained_models/imitator", run)
        cfg = Config.from_yaml(config)
        n = cfg.runtime.num_parallel_envs
        got, ep, _, _, _ = serve_checkpoint(run_dir, n, G13_SERVE_STEPS, kernels, card_line, dev)
        with open(os.path.join(run_dir, "episode_returns.json")) as f:
            recorded = json.load(f)
        T_rec = cfg.mpc.train.dynamics.max_interactions_per_episode
        mean = ep.rewards.sum(1).mean().item()
        print(f"  {run}: mean return {mean:.3f} over a cut episode of {G13_SERVE_STEPS} control "
              f"steps ({mean / G13_SERVE_STEPS:.4f} a step); the run's episode_returns.json: "
              f"mean {np.mean(recorded):.3f} over its {len(recorded)} training episodes of "
              f"{T_rec} steps with collection noise "
              f"{cfg.mpc.train.dynamics.collection_noise} ({np.mean(recorded) / T_rec:.4f} a "
              f"step); printed, not checked")
        launches[f"{run} serving"] = got
    wall["(d) walker and cartpole served"] = time.perf_counter() - t0

    print("phase 13 (e): the walker and cartpole configs from empty workdirs")
    for family, config, cuts in G13_RUNS:
        t0 = time.perf_counter()
        name = os.path.basename(config)
        launches[f"{name} fresh run"] = fresh_fused_run(family, config, cuts, kernels,
                                                        card_line, dev)
        wall[f"(e) {name}"] = time.perf_counter() - t0
    print(f"phase 13 wall s by piece: { {k: round(v, 1) for k, v in wall.items()} }; phase 13 "
          f"wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


def first_histories(ckpt, num_envs, device):
    """The first control step's histories of ``num_envs`` envs of a served
    run, as the closed loop builds them: a zero past, then the normalized
    observation of a reset drawn from a generator seeded with ``SEED``; zero
    past actions."""
    env, norm = ckpt.env, ckpt.normalizer
    state = env.reset(ckpt.env_params, num_envs, torch.Generator().manual_seed(SEED))
    hX = torch.zeros((num_envs, ckpt.history + 1, env.obs_size), device=device)
    hX[:, -1] = norm.normalize_state(env.observe(ckpt.env_params, state))
    return hX, torch.zeros((num_envs, ckpt.history, env.act_size), device=device)


def hold_plan_against_cpu(label, gpu_policy, cpu_policy, hX, hU, dev, weight_nudges=True,
                          iterations_where_stable=False):
    """One ``plan_batch`` on the card and on the CPU from the same histories
    (CPU tensors): the served action U[:, 0] within max(1e-3, twice the
    CPU's own spread) and equal iterations, the spread being the largest
    move of the CPU's served action when hX is scaled by 1 +- 1e-7 or the
    dynamics' weights by 1 +- 1e-6 (phase 12's nudges: the kernel's
    arithmetic is a few 1e-6 off f32, and trained solves amplify that; at
    H=50, 2 trips move humanoid_stand gan/0's action by 3e-3 under them).
    Without ``weight_nudges`` only hX is scaled: at bf16 a 1e-6 scaling
    moves weights across bfloat16 rounding boundaries (a spread of 1e-2 to
    0.13), which the card, running the CPU's weights, never crosses.
    The whole plan's difference and spread are printed, not checked: its
    later actions flip with the line search on rounding, as phase 10's
    do. With ``iterations_where_stable`` the iterations are held equal on
    the lanes where the nudges do not move the CPU's own, and printed on
    the others: a lane that stops early stops where its gradient's norm
    crosses the solver's tolerance, which rounding moves (phase 17: gan/9's
    lanes stop anywhere in 22-30 under 1e-7 nudges on the CPU)."""
    cpu = cpu_policy.plan_batch(hX, hU)
    gpu = gpu_policy.plan_batch(hX.to(dev), hU.to(dev))
    sols = [cpu_policy.plan_batch(hX * s, hU) for s in (1 + 1e-7, 1 - 1e-7)]
    weights = list(cpu_policy.dynamics_model.parameters())
    saved = [w.detach().clone() for w in weights]
    with torch.no_grad():
        for s in (1 + 1e-6, 1 - 1e-6) if weight_nudges else ():
            for w, w0 in zip(weights, saved):
                w.copy_(w0 * s)
            sols.append(cpu_policy.plan_batch(hX, hU))
        for w, w0 in zip(weights, saved):
            w.copy_(w0)
    nudged = [sol.U - cpu.U for sol in sols]
    spread0 = max(dU[:, 0].abs().max().item() for dU in nudged)
    spread = max(dU.abs().max().item() for dU in nudged)
    d0 = (gpu.U[:, 0].cpu() - cpu.U[:, 0]).abs().max().item()
    d = (gpu.U.cpu() - cpu.U).abs().max().item()
    tol = max(1e-3, 2.0 * spread0)
    its = torch.stack([cpu.iterations] + [sol.iterations for sol in sols])
    lo, hi = its.min(0).values, its.max(0).values
    held = lo == hi if iterations_where_stable else torch.ones_like(lo, dtype=torch.bool)
    same_it = torch.equal(gpu.iterations.cpu()[held], cpu.iterations[held])
    print(f"{label} plan_batch ({hX.shape[0]} envs, iLQR <= "
          f"{gpu_policy.settings.max_iterations}, H={gpu_policy.horizon}) GPU vs CPU: served "
          f"action max|dU[:, 0]|={d0:.3e} (atol {tol:.3e}: max(1e-3, twice the CPU's own "
          f"{spread0:.3e} under the nudges)); whole plan max|dU|={d:.3e} of max|U| "
          f"{cpu.U.abs().max().item():.4g} (the CPU's own {spread:.3e}); iterations GPU "
          f"{gpu.iterations.tolist()} CPU {cpu.iterations.tolist()} (under the nudges "
          f"{lo.tolist()} to {hi.tolist()}; held equal on {int(held.sum())} of {len(held)} "
          "lanes)")
    if not (d0 <= tol and same_it and bool(torch.isfinite(gpu.U).all())):
        raise SystemExit(f"the {label} plan on the card disagrees with the CPU path")


def per_instance_phase(kernels, card_line, dev):
    """Phase 14: the per-instance path and goal projection, card against
    CPU, and the trained runs they unlock served (see the module's
    docstring). Returns the launches of each served run."""
    import dataclasses
    import os

    from gan_mpc_tpu_torch.bench import load_checkpoint
    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.runners import common

    t_phase = time.perf_counter()
    wall, launches = {}, {}
    cut = lambda pol: setattr(pol, "settings", dataclasses.replace(
        pol.settings, max_iterations=G14_CHECK_ITERS))

    t0 = time.perf_counter()
    print("phase 14 (a): the per-instance path and goal projection on the card against the CPU")
    for label, run in (("humanoid_stand gan/0 (ensemble of 8)", G14_STAND),
                       ("cheetah gan/0 (goal projection 2)", G14_CHEETAH0)):
        gpu, cpu = load_checkpoint(run, dev), load_checkpoint(run, "cpu")
        for ck in (gpu, cpu):
            cut(ck.policy)
        hX, hU = first_histories(cpu, G14_CHECK_ENVS, "cpu")
        hold_plan_against_cpu(label, gpu.policy, cpu.policy, hX, hU, dev)
    cfg = Config.from_yaml(G14_LSTM_CONFIG).replace(
        mpc__model__dynamics__use="lstm", mpc__solver__max_iterations=G14_CHECK_ITERS)
    lstm_gpu, lstm_cpu = (common.build_policy(cfg, 17, 6, device=d) for d in (dev, "cpu"))
    rng = np.random.default_rng(SEED)
    hX = torch.tensor(0.3 * rng.standard_normal((G14_CHECK_ENVS, 2, 17)), dtype=torch.float32)
    hU = torch.tensor(0.3 * rng.standard_normal((G14_CHECK_ENVS, 1, 6)), dtype=torch.float32)
    lstm = lstm_gpu.dynamics_model.net
    print(f"LSTM dynamics (random weights from seed {cfg.seed}, {G14_LSTM_CONFIG}'s widths): cell "
          f"{lstm.cell.features} features, head {[w.shape[0] for w, _ in lstm.stack()] + [17]}, "
          f"planner state {17 + lstm_gpu.dynamics_model.carry_size}, cost net in "
          f"{lstm_gpu.cost_model.net.stack()[0][0].shape[0]}")
    hold_plan_against_cpu("LSTM dynamics (carry warmed from history_U)", lstm_gpu, lstm_cpu, hX,
                          hU, dev)
    wall["(a) card vs CPU"] = time.perf_counter() - t0

    print("phase 14 (b): the trained runs served")
    for run, num_envs, steps in ((G14_STAND, G14_STAND_ENVS, G14_STAND_STEPS),
                                 (G14_WALK, G14_SERVE_ENVS, G14_SERVE_STEPS),
                                 (G14_CHEETAH0, G14_SERVE_ENVS, G14_SERVE_STEPS)):
        t0 = time.perf_counter()
        got, ep, dt, trips, ckpt = serve_checkpoint(run, num_envs, steps, kernels, card_line, dev)
        cfg = common.load_run_config(run)
        with open(os.path.join(run, "episode_returns.json")) as f:
            recorded = json.load(f)
        T_rec = cfg.mpc.train.dynamics.max_interactions_per_episode
        mean = ep.rewards.sum(1).mean().item()
        name = run.split("imitator/")[1]
        print(f"  {name}: {num_envs * steps / dt:.2f} env steps/s, {dt / steps:.3f} s a control "
              f"step, trips per solve mean {np.mean(trips):.2f} of "
              f"{ckpt.policy.settings.max_iterations}; return {mean / steps:.4f} a step over "
              f"{steps} control steps from rest; the run's episode_returns.json: "
              f"{np.mean(recorded) / T_rec:.4f} a step (mean {np.mean(recorded):.3f} over "
              f"{len(recorded)} training episodes of {T_rec} steps with collection noise "
              f"{cfg.get_path('mpc.train.dynamics.collection_noise', 0.0)}); printed, not "
              "checked")
        launches[f"{name} serving"] = got
        wall[f"(b) {name}"] = time.perf_counter() - t0
    print(f"phase 14 wall s by piece: { {k: round(v, 1) for k, v in wall.items()} }; phase 14 "
          f"wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


@contextlib.contextmanager
def training_recorded():
    """Inside the block: each ``batch_ilqr`` call of the policy or the
    implicit planner appends (trips, lanes, whether a cost trainer's step
    made it) to the yielded dict's "solves"; "dynamics" and "cost" count
    the trainers' minibatch steps (``update_steps_recorded``)."""
    from gan_mpc_tpu_torch.planner import bilevel
    from gan_mpc_tpu_torch.policies import mpc
    from gan_mpc_tpu_torch.training import cost

    inside = []

    def solving(original):
        def solve(problem, x0, *args, **kwargs):
            sol = original(problem, x0, *args, **kwargs)
            rec["solves"].append((sol.trips, x0.shape[0], bool(inside)))
            return sol
        return solve

    def marking(original):
        def update_pass(*args, **kwargs):
            inside.append(True)
            try:
                return original(*args, **kwargs)
            finally:
                inside.pop()
        return update_pass

    with update_steps_recorded() as rec, wrapped(mpc, "batch_ilqr", solving), \
            wrapped(bilevel, "batch_ilqr", solving), wrapped(cost, "update_pass", marking):
        rec["solves"] = []
        yield rec


def reckon_training(rec, policy):
    """The launches of what ``training_recorded`` recorded, on ``policy``'s
    horizon, state and action widths, solver settings and members: each
    solve ``mlp_calls_per_solve`` (a cost step's, with its backward,
    ``mlp_calls_per_step``), each dynamics step E x H forwards and as many
    backwards."""
    from gan_mpc_tpu_torch.planner.batch_ilqr import ls_materializes, mlp_calls_per_solve
    from gan_mpc_tpu_torch.planner.bilevel import mlp_calls_per_step

    H, members = policy.horizon, getattr(policy.dynamics_model, "num_members", 1)
    n = policy.x_size + policy.dynamics_model.carry_size
    m = policy.expert_model.u_size
    expected = {"fused_mlp_fwd": members * H * rec["dynamics"], "fused_ls_step": 0,
                "fused_mlp_bwd": members * H * rec["dynamics"]}
    for trips, lanes, in_cost in rec["solves"]:
        reckon = mlp_calls_per_step if in_cost else mlp_calls_per_solve
        count = reckon(H, trips, materialize=ls_materializes(policy.settings, H, lanes, n, m),
                       members=members)
        for name, c in count.items():
            expected[name] += c
    if sum(c for _, _, c in rec["solves"]) != rec["cost"]:
        raise SystemExit("a cost step made other than one solve")
    return expected


def held(label, got, ref, spreads, base, group):
    """``got`` against ``ref`` ({name: array}) by groups of names
    (``group(name)``): each group's difference (the l2 norm over its
    entries) within max(its base (``base`` times the norm of its ref),
    twice the largest move of the CPU's own result under the nudges
    ``spreads`` ([{name: array}])). Prints the four groups nearest their
    bounds. Returns whether every group holds and is finite."""
    groups = {}
    for name in ref:
        groups.setdefault(group(name), []).append(name)
    norm = lambda d, names: float(np.sqrt(sum(float(np.sum(np.square(
        np.asarray(d[n], np.float64) - np.asarray(ref[n], np.float64)))) for n in names)))
    rows, ok = [], True
    for g, names in groups.items():
        d = norm(got, names)
        spread = max(norm(s, names) for s in spreads)
        size = float(np.sqrt(sum(float(np.sum(np.square(np.asarray(ref[n], np.float64))))
                                 for n in names)))
        bound = max(base * size, 2.0 * spread)
        finite = all(bool(np.all(np.isfinite(got[n]))) for n in names)
        ok = ok and finite and d <= bound
        rows.append((d / bound if bound else float("inf"), g, d, spread, bound, size))
    rows.sort(reverse=True)
    for share, g, d, spread, bound, size in rows[:4]:
        print(f"  {label} {g}: |d| {d:.3e}, the CPU's spread {spread:.3e}, bound {bound:.3e} "
              f"(|ref| {size:.3e}, {100 * share:.1f}% of the bound)")
    print(f"{label}: {len(groups)} groups of {len(ref)} tensors, the worst {rows[0][1]} at "
          f"{100 * rows[0][0]:.1f}% of its bound")
    return ok


@contextlib.contextmanager
def scaled(tensors, s):
    """Inside the block each of ``tensors`` is scaled by ``s`` in place."""
    saved = [t.detach().clone() for t in tensors]
    with torch.no_grad():
        for t, t0 in zip(tensors, saved):
            t.mul_(s)
    try:
        yield
    finally:
        with torch.no_grad():
            for t, t0 in zip(tensors, saved):
                t.copy_(t0)


def dynamics_loss_and_grads(model, windows, teacher_forcing):
    """{loss, every parameter's gradient} of the dynamics trainer's mean
    multi-step loss on ``windows`` (the update pass's step before Adam),
    numpy on the host."""
    from gan_mpc_tpu_torch.training.dynamics import multistep_prediction_loss

    model.requires_grad_(True)
    try:
        loss = multistep_prediction_loss(model, *windows, 0.9, teacher_forcing).mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        model.requires_grad_(False)
    out = {"loss": loss.detach()}
    out.update({name: g for (name, _), g in zip(model.named_parameters(), grads)})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def implicit_loss_and_grads(policy, hX):
    """{loss, every gradient} of one generator step (``gan_generator_loss``
    through the implicit gradient; every component but the expert
    differentiated), numpy on the host."""
    from gan_mpc_tpu_torch.policies.losses import gan_generator_loss
    from gan_mpc_tpu_torch.training.masking import policy_components

    comps = ("mpc_weights", "cost_params", "dynamics_params", "critic_params")
    try:
        for name in comps:
            for p in policy_components(policy)[name]:
                p.requires_grad_(True)
        loss, grads = policy.batched_loss_and_grad(hX, gan_generator_loss)
    finally:
        policy.requires_grad_(False)
    out = {"loss": loss.detach().cpu().numpy()}
    out.update({f"{name}[{i}]": g.detach().cpu().numpy()
                for name in comps for i, g in enumerate(grads[name])})
    return out


def clear_windows(model, windows, teacher_forcing, n, rng):
    """``n`` of the (X, U, Y) ``windows`` (CPU tensors), taken in an order
    drawn from ``rng``, on which every hidden pre-activation of every MLP
    call of the CPU's multi-step loss sits ``G15_KINK_MARGIN`` or more from
    the relu kink, as phase 2 draws its backward rows: at a kink the
    derivative jumps, and the card's rounding, a few 1e-6, would move a
    unit's gradient by a whole row's share. Every call has one row a
    window."""
    from gan_mpc_tpu_torch.ops import fused_mlp
    from gan_mpc_tpu_torch.training.dynamics import multistep_prediction_loss

    near = [torch.full((windows[0].shape[0],), float("inf"))]

    def recording(plain):
        def forward(x, layers, *bf16):
            h = x
            for w, b in layers[:-1]:
                pre = h @ w + b
                near[0] = torch.minimum(near[0], pre.abs().amin(-1))
                h = torch.relu(pre)
            return plain(x, layers, *bf16)
        return forward

    with wrapped(fused_mlp, "reference_forward", recording), torch.no_grad():
        multistep_prediction_loss(model, *windows, 0.9, teacher_forcing)
    keep = [i for i in rng.permutation(windows[0].shape[0])
            if near[0][i] >= G15_KINK_MARGIN][:n]
    print(f"  {int((near[0] >= G15_KINK_MARGIN).sum())} of {windows[0].shape[0]} windows sit "
          f"{G15_KINK_MARGIN:.0e} or more from every relu kink; {n} of them taken")
    if len(keep) < n:
        raise SystemExit("too few windows clear of the relu kinks")
    pick = torch.tensor(np.asarray(keep))
    return tuple(t[pick] for t in windows)


def hold_training_step(label, compute, gpu_model, cpu_model, gpu_args, cpu_args, base,
                       group=lambda name: name, input_nudges=False):
    """``compute(model, *args)`` on the card and on the CPU, the CPU's own
    spread from its dynamics weights scaled by ``G15_WEIGHT_NUDGES`` (and
    with ``input_nudges`` its first argument by ``G15_INPUT_NUDGES``);
    ``held`` by ``group``. Returns whether every group holds."""
    t0 = time.perf_counter()
    got = compute(gpu_model, *gpu_args)
    ref = compute(cpu_model, *cpu_args)
    weights = list(getattr(cpu_model, "dynamics_model", cpu_model).parameters())
    spreads = []
    for s in G15_WEIGHT_NUDGES:
        with scaled(weights, s):
            spreads.append(compute(cpu_model, *cpu_args))
    for s in G15_INPUT_NUDGES if input_nudges else ():
        spreads.append(compute(cpu_model, cpu_args[0] * s, *cpu_args[1:]))
    ok = held(label, got, ref, spreads, base, group)
    print(f"  {label}: {time.perf_counter() - t0:.1f} s{'' if ok else ': DISAGREES'}")
    return ok


def check_training_against_cpu(dev):
    """Phase 15 (a): the dynamics trainer's step and the implicit
    generator step of humanoid_scale's policy and of an LSTM-dynamics
    policy, card against CPU (the module's docstring)."""
    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.data.windows import cost_windows, sequence_windows
    from gan_mpc_tpu_torch.runners import common

    rng = np.random.default_rng(SEED)
    cfg = Config.from_yaml(G15_CONFIG)
    trajs = common.load_store(cfg, G15_STORE)
    norm = common.build_normalizer(cfg, trajs, "cpu")
    states = norm.normalize_state(torch.tensor(trajs.states))
    H = cfg.mpc.horizon
    # the dynamics step's windows from the store's whole episodes (the
    # config trains on their first 300 steps): more of them sit clear of
    # the relu kinks
    whole = common.load_store(cfg.replace(mpc__train__trajectory_len=G15_EPISODE_STEPS),
                              G15_STORE)
    pool = sequence_windows(norm.normalize_state(torch.tensor(whole.states)),
                            norm.normalize_action(torch.tensor(whole.dynamics_actions)), H)
    pick = torch.from_numpy(rng.choice(pool[0].shape[0], G15_DYN_POOL, replace=False))
    pool = tuple(t[pick] for t in pool)
    component = lambda name: name.split("[")[0]  # the implicit steps' groups
    failed = []

    # the ensemble's dynamics step: fresh weights from the config's seed
    gpu, cpu = (common.build_policy(cfg, 29, 12, device=d) for d in (dev, "cpu"))
    print(f"phase 15 (a): {G15_CONFIG}'s dynamics trainer step "
          f"({cfg.mpc.model.dynamics.ensemble.num_members} x "
          f"{[29 + 12] + list(cfg.mpc.model.dynamics.ensemble.mlp.hidden) + [29]}, "
          f"{G15_DYN_WINDOWS} windows of {H} steps from the committed store, teacher forced)")
    windows = clear_windows(cpu.dynamics_model, pool, True, G15_DYN_WINDOWS, rng)
    if not hold_training_step("ensemble dynamics step", dynamics_loss_and_grads,
                              gpu.dynamics_model, cpu.dynamics_model,
                              ([t.to(dev) for t in windows], True), (list(windows), True),
                              1e-4):
        failed.append("ensemble dynamics step")

    # the implicit generator step on humanoid_stand gan/0's trained weights
    ccfg = cfg.replace(mpc__solver__max_iterations=G15_CHECK_ITERS)
    gpu, cpu = (common.load_saved_params(common.build_policy(ccfg, 29, 12, True, device=d),
                                         G14_STAND) for d in (dev, "cpu"))
    hX, _ = cost_windows(states, cfg.mpc.history, H)
    hX = hX[torch.from_numpy(rng.choice(hX.shape[0], G15_CHECK_HISTORIES, replace=False))]
    print(f"phase 15 (a): one implicit generator step of {G15_CONFIG}'s policy on "
          f"humanoid_stand gan/0's weights ({G15_CHECK_HISTORIES} expert histories, H={H}, "
          f"iLQR <= {G15_CHECK_ITERS}, bilevel {cfg.mpc.solver.bilevel})")
    if not hold_training_step("ensemble implicit step", implicit_loss_and_grads, gpu, cpu,
                              (hX.to(dev),), (hX,), 1e-3, component, True):
        failed.append("ensemble implicit step")

    # an LSTM-dynamics policy on random weights: both bilevel solvers, then
    # its dynamics trainer step (open loop: the carry threads through)
    hL = torch.tensor(0.3 * rng.standard_normal((G15_CHECK_HISTORIES, 2, 17)),
                      dtype=torch.float32)
    for solver in ("dense", "cg"):
        lcfg = Config.from_yaml(G15_LSTM_CONFIG).replace(
            mpc__model__dynamics__use="lstm", mpc__solver__max_iterations=G15_CHECK_ITERS,
            mpc__solver__bilevel=solver)
        gpu, cpu = (common.build_policy(lcfg, 17, 6, True, device=d) for d in (dev, "cpu"))
        print(f"phase 15 (a): one implicit generator step of an LSTM-dynamics policy "
              f"({G15_LSTM_CONFIG}'s widths, random weights, H={lcfg.mpc.horizon}, bilevel "
              f"{solver}: the exact Hessian by double backward)")
        if not hold_training_step(f"LSTM implicit step ({solver})", implicit_loss_and_grads,
                                  gpu, cpu, (hL.to(dev),), (hL,), 1e-3, component, True):
            failed.append(f"LSTM implicit step ({solver})")
    T = lcfg.mpc.horizon
    print(f"phase 15 (a): the LSTM dynamics trainer step ({G15_DYN_WINDOWS} windows of {T} "
          "steps, open loop)")
    lw = clear_windows(cpu.dynamics_model, tuple(torch.tensor(
        0.5 * rng.standard_normal((4 * G15_DYN_WINDOWS, T, w)), dtype=torch.float32)
        for w in (17, 6, 17)), False, G15_DYN_WINDOWS, rng)
    if not hold_training_step("LSTM dynamics step", dynamics_loss_and_grads, gpu.dynamics_model,
                              cpu.dynamics_model, ([t.to(dev) for t in lw], False),
                              (list(lw), False), 1e-4):
        failed.append("LSTM dynamics step")
    if failed:
        raise SystemExit(f"phase 15 (a): on the card {failed} disagree with the CPU path")


def ensemble_training_run(label, config, cuts, interrupt, kernels, card_line, dev):
    """Phase 15 (b), (c): ``runners.gan.run`` on ``config`` with ``cuts`` in
    an empty temporary workdir holding a copy of the committed store it
    resolves to (interrupted after fused epoch 1 and resumed where
    ``interrupt``); the launches against the recorded solves and steps,
    the metrics, the saved run's stacked leaves, the run reloaded bitwise.
    Returns (the launches, the saved params)."""
    import os
    import shutil
    import tempfile

    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.params import load_msgpack, to_jax_params
    from gan_mpc_tpu_torch.runners import collect, common, expert, gan, l2
    from gan_mpc_tpu_torch.training import critic, fused_epoch

    class Interrupted(RuntimeError):
        pass

    def log(msg):
        print(f"  {msg}")
        logs.append(msg)

    def log_crashing(msg):
        log(msg)
        if msg.startswith("[gan/fused] epoch 1 "):
            raise Interrupted(msg)

    pieces = [(common, "collect_expert_trajectories", "store collection"),
              (expert, "train_expert", "expert training"),
              (expert, "average_return", "expert evaluation"),
              (fused_epoch, "collect_episode", "collection"),
              (fused_epoch, "dynamics_steps", "dynamics"),
              (fused_epoch, "critic_dataset", "critic dataset"),
              (critic, "update_pass", "critic updates"),
              (fused_epoch, "cost_steps", "generator"),
              (fused_epoch, "gan_test_metrics", "test metrics"),
              (collect, "policy_rollout", "DAgger rollout"),
              (collect, "collect_expert_trajectories", "expert segments"),
              (gan, "train_expert", "DAgger fine-tune")]
    logs = []
    t_run = time.perf_counter()
    resolved = common.trajectories_path(Config.from_yaml(config))
    if resolved != G15_STORE:
        raise SystemExit(f"{config} resolves to {resolved}, not the committed {G15_STORE}")
    with tempfile.TemporaryDirectory() as workdir:
        cfg = Config.from_yaml(config).replace(runtime__workdir=workdir, **cuts)
        store = common.trajectories_path(cfg)
        os.makedirs(os.path.dirname(store))
        for suffix in ("", ".exec.npz"):
            shutil.copyfile(G15_STORE + suffix, store + suffix)
        print(f"{label}: {config} from an empty temporary workdir with the committed store "
              f"{G15_STORE} it resolves to (one GPU: {card_line}); cuts {cuts}")
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        with training_recorded() as rec, run_watched(pieces) as timed:
            if interrupt:
                try:
                    gan.run(cfg, log_fn=log_crashing, device=dev)
                except Interrupted:
                    print("  (interrupted after fused epoch 1; resuming)")
                else:
                    raise SystemExit(f"{label}: the run was not interrupted")
            out = gan.run(cfg, log_fn=log, device=dev)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        counts = {name: k.launches for name, k in kernels.items()}
        expected = reckon_training(rec, out["policy"])
        with open(os.path.join(workdir, "metrics", cfg.env.name, "gan.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        expert_dir = common.expert_model_dir(cfg)
        experts = sorted(os.listdir(expert_dir)) if os.path.isdir(expert_dir) else []
        saved = load_msgpack(os.path.join(out["run_dir"], "params.msgpack"))
        reloaded = to_jax_params(common.setup(cfg.replace(
            mpc__train__init_from_run=out["run_dir"]), True, device=dev)["policy"])
    kinds = {}
    for kind, secs in timed:
        kinds.setdefault(kind, []).append(round(secs, 3))
    solves = rec["solves"]
    members = cfg.mpc.model.dynamics.ensemble.num_members
    print(f"  {label}: {run_s:.3f} s; wall s by piece: {kinds}")
    print(f"  kernel launches {counts} (expected {expected}: {len(solves)} solves of "
          f"{sum(t for t, _, _ in solves)} trips at {sorted(set(b for _, b, _ in solves))} "
          f"lanes, {rec['dynamics']} dynamics and {rec['cost']} generator steps of "
          f"{cfg.mpc.horizon} time steps, {members} members)")
    if counts != expected:
        raise SystemExit(f"{label} did not launch the kernels on every MLP call")
    if interrupt and "[gan] resumed from checkpoint at epoch 1" not in logs:
        raise SystemExit(f"{label} did not resume from its epoch-1 checkpoint")
    if "store collection" in kinds:
        raise SystemExit(f"{label} collected a store: the committed one was not read")
    want_experts = [] if cfg.get_path("mpc.train.init_from_run") else ["0"]
    fused_keys = set(k for _, k in l2.FUSED_RECORDS["gan"].values())
    epoch_rows = [r["step"] for r in rows if fused_keys <= set(r)]
    dagger_rows = [r for r in rows if "dagger_test_loss" in r]
    values = [v for r in rows for k, v in r.items() if k not in ("step", "time")]
    values += [v for vs in out["history"].values() for v in vs]
    print(f"  gan.jsonl: {len(rows)} rows, fused epoch rows at steps {epoch_rows}, "
          f"{len(dagger_rows)} DAgger rows; experts saved {experts}; stamped reward "
          f"{out['avg_reward']:.2f}; history {out['history']}")
    if epoch_rows != list(range(1, cfg.mpc.train.num_epochs + 1)) or experts != want_experts \
            or len(dagger_rows) != cfg.get_path("expert_prediction.dagger.rounds", 0) or \
            not np.all(np.isfinite(values)) or not np.isfinite(out["avg_reward"]):
        raise SystemExit(f"{label} wrote unexpected metrics or experts, or values not finite")
    shapes = {k: tuple(np.asarray(v["kernel"]).shape)
              for k, v in saved["dynamics_params"]["params"].items()}
    widths = [41] + list(cfg.mpc.model.dynamics.ensemble.mlp.hidden) + [29]
    want = {f"Dense_{i}": (members, a, b) for i, (a, b) in enumerate(zip(widths[:-1],
                                                                          widths[1:]))}
    print(f"  params.msgpack dynamics kernels {shapes}")
    if shapes != want:
        raise SystemExit(f"{label} saved no stacked ({members}, ...) dynamics leaves")
    got, want = dict(leaves_of(reloaded)), dict(leaves_of(out["params"]))
    if sorted(got) != sorted(want) or not all(np.array_equal(v, want[k]) for k, v in got.items()):
        raise SystemExit(f"the saved run of {label} does not reload bitwise")
    return counts, out["params"]


def ensemble_training_phase(kernels, card_line, dev):
    """Phase 15: training with ensemble and LSTM dynamics (see the module's
    docstring). Returns the launches of each run."""
    from gan_mpc_tpu_torch.params import load_msgpack

    t_phase = time.perf_counter()
    wall, launches = {}, {}
    t0 = time.perf_counter()
    check_training_against_cpu(dev)
    wall["(a) card vs CPU"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    launches["humanoid_scale run"], _ = ensemble_training_run(
        "phase 15 (b)", G15_CONFIG, G15_CUTS, True, kernels, card_line, dev)
    wall["(b) humanoid_scale"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    launches["humanoid_scale_continue run"], params = ensemble_training_run(
        "phase 15 (c)", G15_CONTINUE, G15_CONTINUE_CUTS, False, kernels, card_line, dev)
    start = dict(leaves_of(load_msgpack(G14_STAND + "/params.msgpack")))
    moved = {k: float(np.abs(v - start[k]).max()) for k, v in leaves_of(params)
             if k.startswith(("dynamics_params", "cost_params", "critic_params"))}
    print(f"  (c) moved from humanoid_stand gan/0 by at most {max(moved.values()):.3e} "
          f"(dynamics {max(v for k, v in moved.items() if k.startswith('dynamics')):.3e})")
    if not all(v > 0 for k, v in moved.items() if k.endswith("kernel")):
        raise SystemExit("phase 15 (c) left a trained kernel where humanoid_stand gan/0 had it")
    wall["(c) humanoid_scale_continue"] = time.perf_counter() - t0
    print(f"phase 15 wall s by piece: { {k: round(v, 1) for k, v in wall.items()} }; phase 15 "
          f"wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


def linear_chain(x, layers):
    """The stack through ``torch.nn.functional.linear`` and relu, W given
    (out, in): cuBLAS GEMMs, a yardstick of time only, which the port never
    calls. On bf16 tensors (the counterpart of JAX's plain-XLA bf16 route)
    it rounds every output to bfloat16, so it is not the bf16 kernels'
    function; on f32 tensors it is the plain version, in TF32 where
    ``torch.backends.cuda.matmul.allow_tf32`` is set."""
    h = x
    for i, (wt, b) in enumerate(layers):
        h = torch.nn.functional.linear(h, wt, b)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def bf16_kernels_phase(kernels, max_err, timed, dev):
    """Phase 16 (a): each bf16 instance against its plain bf16 version at
    ``BF16_CHECKS``, the first ``BF16_TIMED`` then timed beside the f32
    instance, the plain version and the stack's bf16 chain on cuBLAS
    (``linear_chain``, for reference). The bound on the difference: max|d| <=
    1e-2 max(1, max|ref|). Both sides multiply bfloat16-rounded operands
    exactly and sum in f32, in other orders, so a hidden activation can
    round to the other bfloat16 neighbour (one ulp, 2^-8 relative) and
    carry that through the later layers. That bound alone cannot tell the
    bf16 instance from the f32 one (which stays a few 1e-3 of max|ref|
    from plain bf16), so the share of the entries beyond 1e-4 is held to
    ``BF16_FAR_SHARE`` as well: a flip is rare (0.2-0.4% on the card),
    while operands left unrounded move nearly every entry, and the f32
    instance on the same inputs must lie beyond that share (the check's
    power on these inputs)."""
    from gan_mpc_tpu_torch.ops.fused_ls import reference_ls_step
    from gan_mpc_tpu_torch.ops.fused_mlp import reference_forward

    rng = np.random.default_rng(SEED + 16)
    print(f"phase 16 (a) bounds: operations over {BF16_PEAK / 1e12:.0f} TFLOP/s (dense bf16), "
          f"bytes over {MEM_RATE / 1e12:.2f} TB/s")
    for i, (kind, name, rows, *shape) in enumerate(BF16_CHECKS):
        bf16, f32 = kernels[f"{kind}_bf16"], kernels[kind]
        if kind == "fused_ls_step":
            alphas, n, m, gs, offset = shape
            args = ls_args(rows, alphas, n, m, gs, LS_WEIGHTS[3], 1600 + i, dev, offset)
            got, ref = bf16(**args), reference_ls_step(**args, bf16=True)
            run = lambda k: k(**args)  # noqa: E731
            plain = lambda: reference_ls_step(**args, bf16=True)  # noqa: E731
            widths = [n + m, 200, 200, 200, n]
            # the chain's input rows: the MLP's [x, u]
            x = torch.tensor(rng.standard_normal((rows * alphas, n + m)), dtype=torch.float32,
                             device=dev)
            key, label = (name, rows * alphas), f"{rows}x{alphas} n={n} m={m}"
        else:
            widths, offset = shape
            layers = offset_layers(random_layers(widths, 1600 + i, dev), offset)
            x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                             device=dev)
            got, ref = (bf16(x, layers),), (reference_forward(x, layers, True),)
            run = lambda k: k(x, layers)  # noqa: E731
            plain = lambda: reference_forward(x, layers, True)  # noqa: E731
            key, label = (name, rows), f"{widths} rows={rows}"
        label += " (weights not 16-byte aligned)" if offset else ""
        unrounded = run(f32)
        unrounded = unrounded if isinstance(unrounded, tuple) else (unrounded,)
        torch.cuda.synchronize()
        errs, far = [], []
        for g, r in zip(got, ref):
            err = (g - r).abs().max().item()
            tol = BF16_TOL * max(1.0, r.abs().max().item())
            errs.append(err)
            far.append(((g - r).abs() > 1e-4).float().mean().item())
            if not (err <= tol and far[-1] <= BF16_FAR_SHARE
                    and tuple(g.shape) == tuple(r.shape)):
                raise SystemExit(f"{bf16.name} disagrees with its plain bf16 version: {name} "
                                 f"{label}: max|d|={err:.3e} (bound {tol:.3e}), beyond 1e-4: "
                                 f"{100 * far[-1]:.3f}% (bound {100 * BF16_FAR_SHARE:.0f}%)")
        far_f32 = ((unrounded[0] - ref[0]).abs() > 1e-4).float().mean().item()
        if not far_f32 > BF16_FAR_SHARE:
            raise SystemExit(f"phase 16 (a) {name} {label}: the f32 instance lies within "
                             f"{100 * BF16_FAR_SHARE:.0f}% of plain bf16 ({100 * far_f32:.3f}% "
                             "beyond 1e-4), so the check cannot tell the instances apart")
        max_err[bf16.name] = max(max_err.get(bf16.name, 0.0), max(errs))
        line = (f"check {bf16.name} {name} {label}: max|d| "
                f"{' / '.join(f'{e:.3e}' for e in errs)} (bound {BF16_TOL} max(1, max|ref|)), "
                f"beyond 1e-4: {' / '.join(f'{100 * f:.3f}%' for f in far)} (bound "
                f"{100 * BF16_FAR_SHARE:.0f}%; the f32 instance's first output "
                f"{100 * far_f32:.2f}%)")
        if i < BF16_TIMED:
            b_ms, b_by = (ls_bound(rows, alphas, n, m, gs, BF16_PEAK) if kind == "fused_ls_step"
                          else mlp_bound(rows, widths, BF16_PEAK))
            k_ms, f_ms, p_ms = device_ms(lambda: run(bf16)), device_ms(lambda: run(f32)), \
                device_ms(plain)
            xb = x.to(torch.bfloat16)
            lb = [(w.T.contiguous().to(torch.bfloat16), b.to(torch.bfloat16))
                  for w, b in random_layers(widths, 1600 + i, dev)]
            c_ms = device_ms(lambda: linear_chain(xb, lb))
            timed[(bf16.name, *key)] = (k_ms, p_ms, b_ms, b_by)
            line += (f"; time kernel {k_ms:.4f} ms, the f32 instance {f_ms:.4f} ms, plain bf16 "
                     f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), kernel at "
                     f"{100 * b_ms / k_ms:.1f}% of bound; the stack's bf16 chain on cuBLAS "
                     f"(F.linear + relu, bf16 outputs: not this function, no gate) {c_ms:.4f} ms")
        print(line)


def count(kernels):
    return {name: k.launches for name, k in kernels.items()}


def serve_counted(policy, env, norm, steps, gen, num_envs, kernels, warmup=1):
    """``warmup`` control steps, then ``steps`` counted and timed: (episode,
    seconds, launches by kernel, the trips of each solve)."""
    from gan_mpc_tpu_torch.bench import run_steps

    run_steps(policy, env, norm, warmup, gen, num_envs)
    for k in kernels.values():
        k.launches = 0
    with solves_recorded() as trips:
        ep, dt = run_steps(policy, env, norm, steps, gen, num_envs)
    return ep, dt, count(kernels), trips


def hold_launches(label, got, horizon, trips, fused, materialize, bf16):
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve

    want = dict.fromkeys(got, 0)
    want.update(mlp_calls_per_solve(horizon, sum(trips), fused, len(trips),
                                    materialize=materialize, bf16=bf16))
    print(f"  {label}: kernel launches {got} (expected {want}; trips per solve {trips})")
    if got != want:
        raise SystemExit(f"{label} did not launch the kernels as mlp_calls_per_solve reckons")


def check_finite(label, ep, shapes):
    for name, shape in shapes.items():
        t = getattr(ep, name)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise SystemExit(f"{label} output {name} is malformed or not finite")


def bf16_serving_phase(kernels, card_line, dev):
    """Phase 16 (b) and (c): the flagship row at bf16 with fused_ls off and
    on, one plan held card against CPU, then the humanoid-class row at bf16
    with fused_ls on and the materializing line search. Returns the
    launches of each run."""
    from gan_mpc_tpu_torch.bench import (
        FUSED_LS, HORIZON, ILQR_ITERS, NUM_ENVS, bench_row, flagship,
    )
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.planner.batch_ilqr import ls_materializes

    launches = {}
    env = make_env("cheetah_run", dev)
    norm = Normalizer.identity(env.obs_size, env.act_size, dev)
    for fused in FUSED_LS:
        policy = flagship(device=dev, seed=SEED, fused_ls=fused, compute_dtype="bfloat16")
        gen = torch.Generator().manual_seed(SEED)
        ep, dt, got, trips = serve_counted(policy, env, norm, G16_STEPS, gen, NUM_ENVS, kernels,
                                           WARMUP_STEPS)
        label = f"phase 16 (b) flagship bf16 fused_ls={fused}"
        print(f"{label}: {G16_STEPS} steps x {NUM_ENVS} envs in {dt:.3f} s, "
              f"{NUM_ENVS * G16_STEPS / dt:.2f} env steps/s (one GPU: {card_line})")
        hold_launches(label, got, HORIZON, trips, fused == "on", False, True)
        check_finite(label, ep, {"states": (NUM_ENVS, G16_STEPS, 17),
                                 "actions": (NUM_ENVS, G16_STEPS, 6),
                                 "rewards": (NUM_ENVS, G16_STEPS)})
        print(json.dumps(bench_row(NUM_ENVS * G16_STEPS / dt, card_line, fused,
                                   compute_dtype="bfloat16", num_steps=G16_STEPS)))
        launches[f"bf16 flagship fused_ls={fused}"] = got

    # one plan card against CPU, the bound from the history nudges alone
    env_cpu = make_env("cheetah_run", "cpu")
    state = env_cpu.reset(env_cpu.default_params(), G16_CHECK_ENVS,
                          torch.Generator().manual_seed(SEED))
    hX = torch.zeros((G16_CHECK_ENVS, 2, 17))
    hX[:, 1] = env_cpu.observe(env_cpu.default_params(), state)
    hU = torch.zeros((G16_CHECK_ENVS, 1, 6))
    for fused in FUSED_LS:
        small = lambda device: flagship(HORIZON, G16_CHECK_ITERS, device=device, seed=SEED,
                                        fused_ls=fused, compute_dtype="bfloat16")
        hold_plan_against_cpu(f"phase 16 (b) bf16 fused_ls={fused}", small(dev), small("cpu"),
                              hX, hU, dev, weight_nudges=False)

    # (c) the humanoid-class row at bf16, fused_ls on, the materializing line search
    H, B, iters = H50["horizon"], H50["num_envs"], H50["iters"]
    henv = make_env(H50["env"], dev)
    n, m = henv.obs_size, henv.act_size
    policy = flagship(H, iters, n, m, dev, SEED, "on", compute_dtype="bfloat16")
    if not ls_materializes(policy.settings, H, B, n, m):
        raise SystemExit("the bf16 humanoid-class row did not resolve to materialize")
    gen = torch.Generator().manual_seed(SEED)
    ep, dt, got, trips = serve_counted(policy, henv, Normalizer.identity(n, m, dev),
                                       G16_H50_STEPS, gen, B, kernels)
    label = "phase 16 (c) humanoid-class bf16 fused_ls=on materialize"
    print(f"{label}: {G16_H50_STEPS} steps x {B} envs in {dt:.3f} s, {B * G16_H50_STEPS / dt:.2f} "
          f"env steps/s, {dt / G16_H50_STEPS:.3f} s a control step (one GPU: {card_line})")
    hold_launches(label, got, H, trips, True, True, True)
    check_finite(label, ep, {"states": (B, G16_H50_STEPS, n), "actions": (B, G16_H50_STEPS, m),
                             "rewards": (B, G16_H50_STEPS)})
    print(json.dumps(bench_row(B * G16_H50_STEPS / dt, card_line, "on", H50["env"], B, iters, H,
                               compute_dtype="bfloat16", num_steps=G16_H50_STEPS)))
    launches["bf16 humanoid-class fused_ls=on"] = got
    return launches


def linearization(policy, env, B, dev):
    """The problem's linearization at the warm start of B reset envs
    (time-major): A, Bm, cx, cu, cxx, cuu, cux and the initial reg."""
    from gan_mpc_tpu_torch.planner.batch_ilqr import batch_rollout

    state = env.reset(env.default_params(), B, torch.Generator().manual_seed(SEED))
    hX = torch.zeros((B, 2, env.obs_size), device=dev)
    hX[:, 1] = env.observe(env.default_params(), state)
    hU = torch.zeros((B, 1, env.act_size), device=dev)
    with torch.no_grad():
        xc0, goal_X, init_U, u_goal = policy._start(hX, hU)
        prob = policy._problem(goal_X.transpose(0, 1), u_goal.transpose(0, 1), order=0,
                               serving=True)
        U = init_U.transpose(0, 1).contiguous()
        X, _ = batch_rollout(prob, U, xc0)
        reg = torch.full((B,), policy.settings.reg_init, device=dev)
        return (*prob.dynamics_jac(X[:-1], U), *prob.quad(X, U), reg)


def device_launches(fn):
    """The device operations (kernels, copies, sets) ``fn`` queues, counted
    by torch.profiler; None where the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)
    return n or None


def host_ms(fn, reps=5):
    """Median wall ms of ``fn()`` to a synchronize, after one warmup call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def associative_phase(kernels, card_line, dev):
    """Phase 16 (d): one backward pass on the same linearization,
    associative against sequential on the card, at H=5 (the flagship, 512
    envs) and H=50 (the humanoid-class row, 128 envs): the two differ by
    design (the associative pass propagates the value function without the
    Levenberg-Marquardt term and with a 1e-6 ridge), by up to
    ``G16_ASSOC_TOL`` max(1, max|ref|) (the JAX test's 2e-3 at H=5; 6.2e-3
    measured in float64 at H=50), and each pass on the card is held to
    itself in float64 on the CPU within ``G16_F64_TOL`` (rounding alone).
    Then the two rows served with each pass in turns (sequential,
    associative, associative, sequential). Returns the launches."""
    from gan_mpc_tpu_torch.bench import HORIZON, ILQR_ITERS, NUM_ENVS, flagship
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.planner.batch_ilqr import (
        _backward, _backward_associative, ls_materializes,
    )
    from gan_mpc_tpu_torch.planner.parallel_riccati import scan_combines

    rows = {"flagship": ("cheetah_run", NUM_ENVS, HORIZON, ILQR_ITERS),
            "humanoid-class": (H50["env"], H50["num_envs"], H50["horizon"], H50["iters"])}
    launches = {}
    for row, (env_name, B, H, iters) in rows.items():
        env = make_env(env_name, dev)
        n, m = env.obs_size, env.act_size
        lin = linearization(flagship(H, iters, n, m, dev, SEED), env, B, dev)
        passes = {"sequential": lambda *a: _backward(*a),
                  "associative": lambda *a: _backward_associative(*a, 0.0)}
        out = {name: fn(*lin) for name, fn in passes.items()}
        lin64 = [t.cpu().double() for t in lin]
        names = ("k", "K", "adjoints", "G")
        worst = []
        for name, fn in passes.items():
            ref64 = fn(*lin64)
            for q, got, ref in zip(names, out[name], ref64):
                rel = (got.cpu().double() - ref).abs().max().item() / max(1.0, ref.abs().max()
                                                                          .item())
                worst.append(rel)
                if not rel <= G16_F64_TOL:
                    raise SystemExit(f"phase 16 (d) {row}: the {name} pass's {q} on the card is "
                                     f"{rel:.3e} from float64 on the CPU (bound {G16_F64_TOL})")
        gaps = []
        for q, a, s in zip(names, out["associative"], out["sequential"]):
            gaps.append((a - s).abs().max().item() / max(1.0, s.abs().max().item()))
        tol = G16_ASSOC_TOL[H]
        print(f"phase 16 (d) {row} (H={H}, {B} envs, one backward on the warm start's "
              f"linearization): associative vs sequential on the card, max|d| / max(1, max|ref|) "
              f"k {gaps[0]:.3e}, K {gaps[1]:.3e}, adjoints {gaps[2]:.3e}, G {gaps[3]:.3e} (bound "
              f"{tol}); each pass vs itself in float64 on the CPU at most {max(worst):.3e} (bound "
              f"{G16_F64_TOL})")
        if not max(gaps) <= tol:
            raise SystemExit(f"phase 16 (d) {row}: the associative pass disagrees with the "
                             "sequential one on the card")
        for name, fn in passes.items():
            ms = host_ms(lambda: fn(*lin))
            ops = device_launches(lambda: fn(*lin))
            print(f"  {name} backward, H={H}, {B} lanes: {ms:.3f} ms (host clock to a "
                  f"synchronize, median of 5), device operations "
                  f"{ops if ops is not None else 'not measured'}"
                  + (f"; {scan_combines(H + 1)} + {scan_combines(H)} batched combines (value "
                     f"and costate scans)" if name == "associative" else f"; {H} steps"))

        # served in turns
        policies = {r: flagship(H, iters, n, m, dev, SEED, riccati=r) for r in passes}
        mat = ls_materializes(policies["sequential"].settings, H, B, n, m)
        norm = Normalizer.identity(n, m, dev)
        steps = G16_TURN_STEPS[row]
        secs = {r: [] for r in passes}
        for turn, r in enumerate(("sequential", "associative", "associative", "sequential")):
            gen = torch.Generator().manual_seed(SEED + turn)
            ep, dt, got, trips = serve_counted(policies[r], env, norm, steps, gen, B, kernels)
            check_finite(f"phase 16 (d) {row} {r}", ep, {"actions": (B, steps, m)})
            hold_launches(f"phase 16 (d) {row} riccati={r} turn {turn + 1}", got, H, trips,
                          False, mat, False)
            secs[r].append(dt / steps)
            launches[f"{row} riccati={r} turn {turn + 1}"] = got
        print(f"phase 16 (d) {row} served (fused_ls=off, {B} envs, {steps} steps a turn, one GPU: "
              f"{card_line}): s a control step sequential {secs['sequential']}, associative "
              f"{secs['associative']}; associative / sequential "
              f"{sum(secs['associative']) / sum(secs['sequential']):.3f}")
    return launches


def bf16_riccati_phase(kernels, card_line, dev, max_err, timed):
    """Phase 16: the bf16 compute path and the associative Riccati (see
    the module's docstring). Returns the launches of each run."""
    t_phase = time.perf_counter()
    wall = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        bf16_kernels_phase(kernels, max_err, timed, dev)
    wall["(a) kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = bf16_serving_phase(kernels, card_line, dev)
    wall["(b, c) bf16 rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(associative_phase(kernels, card_line, dev))
    wall["(d) associative"] = time.perf_counter() - t0
    print(f"phase 16 wall s by piece: { {k: round(v, 1) for k, v in wall.items()} }; phase 16 "
          f"wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


def pendulum_runs_phase(kernels, card_line, dev):
    """Phase 17 (a): the committed pendulum runs, each served from its own
    store (``serve_checkpoint``: launches as reckoned over the trips the
    solver reported), the return over the cut printed beside the reward
    the run recorded over 1000 steps; each one's plan of
    ``G17_CHECK_ENVS`` first histories held card against CPU
    (``hold_plan_against_cpu``: the served action; the iterations on the
    lanes where the nudges do not move the CPU's own)."""
    from gan_mpc_tpu_torch.bench import load_checkpoint
    from gan_mpc_tpu_torch.runners import common

    launches = {}
    for run in G17_RUNS:
        got, ep, dt, trips, ckpt = serve_checkpoint(run, G17_SERVE_ENVS, G17_SERVE_STEPS,
                                                    kernels, card_line, dev)
        with open(f"{run}/config.json") as f:
            recorded = json.load(f)["reward"]
        returns = ep.rewards.sum(1)
        print(f"  {run} on {common.trajectories_path(common.load_run_config(run))}: return over "
              f"the {G17_SERVE_STEPS} steps mean {returns.mean().item():.4f} (per env "
              f"{[round(r, 3) for r in returns.tolist()]}); the run recorded {recorded} over "
              "1000 steps")
        cpu = load_checkpoint(run, "cpu")
        hX, hU = first_histories(cpu, G17_CHECK_ENVS, "cpu")
        hold_plan_against_cpu(run.split("imitator/")[1], ckpt.policy, cpu.policy, hX, hU, dev,
                              iterations_where_stable=True)
        launches[run.split("imitator/")[1]] = got
    return launches


def video_phase(kernels, card_line, dev):
    """Phase 17 (b): the video of phase 12's cut ``configs/l2_pendulum.yaml``
    run with ``mpc.evaluate.save_video`` on and ``G17_VIDEO_STEPS``
    evaluation steps, on the run's own setup (the
    committed pendulum expert copied into a temporary workdir, gan/9's
    store): ``runners.l2.maybe_save_video``, whose one-env episode runs
    on the card, launches as reckoned; its qpos held against the CPU's
    from the same reset on the same weights and normalizer, within
    max(1e-3, twice the CPU's own spread under 1 +- 1e-7 nudges of the
    reset); the written file's frames. Where PIL does not import, the
    episode (``l2.video_episode``) runs and is held all the same, and the
    rendering is left to the CPU tests. Returns the episode's launches."""
    import os
    import shutil
    import tempfile

    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs.base import EnvState
    from gan_mpc_tpu_torch.planner.batch_ilqr import ls_materializes
    from gan_mpc_tpu_torch.runners import common, l2
    from gan_mpc_tpu_torch.training.masking import load_policy_state, policy_state
    from gan_mpc_tpu_torch.utils import video

    present = {}
    for module in ("PIL", "imageio"):
        try:
            __import__(module)
            present[module] = True
        except ImportError:
            present[module] = False
    print(f"phase 17 (b): on this host PIL {'imports' if present['PIL'] else 'is absent'}, "
          f"imageio {'imports' if present['imageio'] else 'is absent'}")
    with tempfile.TemporaryDirectory() as workdir:
        shutil.copytree(G17_EXPERT, os.path.join(workdir, "trained_models", "expert",
                                                 "pendulum_swingup", "0"))
        cfg = Config.from_yaml(G12_L2_CONFIG).replace(
            runtime__workdir=workdir, env__trajectories_path=GAN9_STORE,
            **dict(G12_L2_CUTS, mpc__evaluate__save_video=True,
                   mpc__evaluate__max_interactions=G17_VIDEO_STEPS))
        ctx = common.setup(cfg, False, device=dev, generator=torch.Generator().manual_seed(SEED))
        policy, s = ctx["policy"], ctx["policy"].settings
        episodes = []

        def capture(original):
            def call(*args, **kwargs):
                episodes.append(original(*args, **kwargs))
                return episodes[-1]
            return call

        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with solves_recorded() as trips, wrapped(l2, "video_episode", capture):
            if present["PIL"]:
                path = l2.maybe_save_video(cfg, ctx, os.path.join(workdir, "run"),
                                           torch.Generator().manual_seed(SEED))
            else:
                l2.video_episode(cfg, ctx, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = count(kernels)
        ep = episodes[0]
        steps = ep.qpos.shape[1]
        H, n, m = policy.horizon, ctx["env_im"].obs_size, ctx["env_im"].act_size
        print(f"  the video's episode: 1 env x {steps} control steps on the card in {dt:.3f} s "
              f"(one GPU: {card_line}), H={H}, iLQR <= {s.max_iterations}")
        hold_launches("the video's episode", got, H, trips,
                      policy.batch_native and s.fused_ls in ("on", "auto"),
                      ls_materializes(s, H, 1, n, m), False)
        # the same episode on the CPU: the card's weights and normalizer
        cpu = common.setup(cfg, False, device="cpu",
                           generator=torch.Generator().manual_seed(SEED))
        load_policy_state(cpu["policy"], policy_state(policy))
        norm = ctx["normalizer"]
        cpu["normalizer"] = Normalizer(norm.state_mean.cpu(), norm.state_std.cpu(),
                                       norm.action_mean.cpu(), norm.action_std.cpu())
        q0, v0 = ep.qpos[:, 0].cpu(), ep.qvel[:, 0].cpu()

        def cpu_qpos(scale):
            init = EnvState(q0 * scale, v0, torch.zeros(1, dtype=torch.int32))
            return l2.video_episode(cfg, cpu, init_state=init).qpos

        ref = cpu_qpos(1.0)
        spread = max((cpu_qpos(sc) - ref).abs().max().item() for sc in (1 + 1e-7, 1 - 1e-7))
        d, tol = (ep.qpos.cpu() - ref).abs().max().item(), max(1e-3, 2.0 * spread)
        print(f"  its qpos card vs CPU from the same reset: max|d|={d:.3e} (atol {tol:.3e}: "
              f"max(1e-3, twice the CPU's own {spread:.3e} under 1 +- 1e-7 nudges of the reset))")
        if not (d <= tol and bool(torch.isfinite(ep.qpos).all())):
            raise SystemExit("the video's episode on the card disagrees with the CPU path")
        if not present["PIL"]:
            print("  video: not rendered, PIL absent on this host")
            return {"video episode": got}
        frames = video.render_episode(cfg.env.imitator.name, ep.qpos[0].cpu().numpy())
        if path.endswith(".gif"):  # PIL's GIF writer merges a frame equal to the one before
            from PIL import Image

            want = 1 + sum(not np.array_equal(a, b) for a, b in zip(frames[1:], frames[:-1]))
            with Image.open(path) as gif:
                written = gif.n_frames
        else:
            import imageio.v2 as imageio

            want, written = len(frames), len(imageio.mimread(path))
        print(f"  video: {os.path.basename(path)} of {os.path.getsize(path)} bytes, {written} "
              f"frames (expected {want} of the {steps} rendered)")
        if written != want:
            raise SystemExit("the video does not hold the episode's frames")
    return {"video episode": got}


def dm_absent_phase():
    """Phase 17 (c): where dm_control does not import (the card's host),
    ``runners.l2.dm_cross_eval`` gives None for a config that asks for the
    cross-evaluation, as the JAX runner does."""
    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.envs import dm_eval
    from gan_mpc_tpu_torch.runners import l2

    cfg = Config.from_yaml(G12_CONFIG)
    episodes = cfg.mpc.evaluate.dm_control_episodes
    if dm_eval.dm_control_available():
        print(f"phase 17 (c): dm_control imports on this host: {G12_CONFIG}'s {episodes} "
              "cross-evaluation episodes would run (not run here)")
        return
    got = l2.dm_cross_eval(cfg, {})
    print(f"phase 17 (c): dm_control does not import on this host; dm_cross_eval on "
          f"{G12_CONFIG} ({episodes} episodes asked for): {got}, as the JAX runner gives")
    if got is not None:
        raise SystemExit("dm_cross_eval ran without dm_control")


def pendulum_video_phase(kernels, card_line, dev):
    """Phase 17: (a) the committed pendulum runs on their own stores, (b)
    the video path, (c) the cross-evaluation without dm_control. Returns
    the launches of each run."""
    t_phase = time.perf_counter()
    wall = {}
    print("phase 17 (a): the committed pendulum runs served on their own stores")
    launches = pendulum_runs_phase(kernels, card_line, dev)
    wall["(a) pendulum runs"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    launches.update(video_phase(kernels, card_line, dev))
    wall["(b) video"] = time.perf_counter() - t0
    dm_absent_phase()
    print(f"phase 17 wall s by piece: { {k: round(v, 1) for k, v in wall.items()} }; phase 17 "
          f"wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


class Stop(RuntimeError):
    """18 (c): the data-parallel run stopped at its epoch-1 log line."""


class StopAt:
    """18 (c): a log function the ranks can be sent: prints each line (rank
    0 alone calls it), raises ``Stop`` after the one that starts with
    ``prefix``."""

    def __init__(self, prefix=None):
        self.prefix = prefix

    def __call__(self, msg):
        print(f"  {msg}", flush=True)
        if self.prefix is not None and msg.startswith(self.prefix):
            raise Stop(msg)


def mesh_ranks(device, case, n, nudges):
    """18 (a) and (b) on each rank of one group of ``n``: ``dryrun_rank``,
    then ``case``'s fused epoch in mesh mode with its MLP calls, solves and
    update steps recorded, then the rank's share of the single-process
    epochs under ``nudges`` (``nudged_epoch``: nudges r, r + n, ... on rank
    r). Rank 0 returns the epoch's result, the dryrun's losses, every
    rank's launches, records and epoch seconds, and the nudged epochs in
    the order of ``nudges``."""
    import torch.distributed as dist

    from gan_mpc_tpu_torch.parallel.checks import fused_epoch_case
    from gan_mpc_tpu_torch.parallel.dryrun import dryrun_rank

    losses = dryrun_rank(device, n)
    synchronize(device)
    t0 = time.perf_counter()
    with shapes_recorded() as seen, solves_recorded() as trips, \
            update_steps_recorded() as steps:
        out = fused_epoch_case(device, case, n)
    synchronize(device)
    mine = dict(launches=out["launches"], trips=list(trips), steps=dict(steps),
                seconds=time.perf_counter() - t0,
                seen={k: [(w.cpu(), b.cpu()) for w, b in v] for k, v in seen.items()})
    rank = dist.get_rank()
    mine["nudged"] = [(i, nudged_epoch(device, case, nudges[i]))
                      for i in range(rank, len(nudges), n)]
    every = [None] * n
    dist.all_gather_object(every, mine)
    nudged = [epoch for _, epoch in sorted(p for r in every for p in r.pop("nudged"))]
    return dict(out, losses=losses, ranks=every, nudged=nudged)


def nudged_epoch(device, case, s):
    """18 (b): ``case``'s epoch in one process (no mesh), its parameters and
    its collection's start states scaled by ``s`` (the mesh moves the
    collection's rounding at every step, as a nudged start does)."""
    from gan_mpc_tpu_torch.parallel.checks import fused_epoch_case

    draws = dict(case["draws"], reset_qpos=case["draws"]["reset_qpos"] * np.float32(s))
    return fused_epoch_case(device, dict(case, params=scaled_tree(case["params"], s),
                                         draws=draws))


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reckon_epoch(trips, steps, horizon):
    """The MLP kernels' launches of a fused GAN epoch (phase 12's count): the
    solves' forwards over their trips, H a dynamics step and H + 1 a
    generator step forwards, H a step backwards."""
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve

    solves = dict(mlp_calls_per_solve(horizon, sum(trips), solves=len(trips),
                                      materialize=False))
    return {"fused_mlp_fwd": solves["fused_mlp_fwd"] + horizon * steps["dynamics"]
            + (horizon + 1) * steps["cost"], "fused_ls_step": 0,
            "fused_mlp_bwd": horizon * (steps["dynamics"] + steps["cost"])}


def epoch_snapshot(cfg, dev):
    """18 (b): gan/9's run set up from ``cfg`` on the card, as plain data for
    ``fused_epoch_case``, with one set of global draws from a seeded
    generator; and the held-out histories (normalized) the policies serve."""
    from gan_mpc_tpu_torch.params import to_jax_params
    from gan_mpc_tpu_torch.runners import common, l2

    ctx = common.setup(cfg, True, device=dev, generator=torch.Generator().manual_seed(cfg.seed))
    kw = l2.fused_epoch_kwargs(cfg, ctx, "gan")
    kw.pop("chunk_updates")
    (X, Y), (tX, tY) = ctx["cost_data"]
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    H, n, T, B = cfg.mpc.horizon, kw["num_envs"], kw["episode_steps"], kw["batch_size"]
    k = kw["critic_plan_batch"]
    g = torch.Generator().manual_seed(SEED)
    reset = ctx["env_im"].reset(ctx["env_im_params"], n, g)
    draws = dict(
        reset_qpos=host(reset.qpos), reset_qvel=host(reset.qvel), reset_t=host(reset.t),
        noise=host(torch.randn((T, n, ctx["env_im"].act_size), generator=g)),
        dyn_perm=host(torch.randint(n * (T - H), (kw["dynamics_updates"]
                                                   * max(X.shape[0] // B, 1), B), generator=g)),
        exp_perm=host(torch.randint(ctx["dyn_train"][0].shape[0], (kw["expert_dyn_updates"], B),
                                    generator=g)),
        plan_idx=host(torch.randperm(X.shape[0], generator=g)[:k]),
        shuffle=host(torch.randperm(2 * k, generator=g)),
        crit_perm=host(torch.randint(2 * k, (kw["critic_updates"], B), generator=g)),
        cost_perm=host(torch.randint(X.shape[0], (kw["cost_updates"], B), generator=g)))
    norm = ctx["normalizer"]
    case = {"family": "gan", "config": cfg.to_dict(), "sizes": (3, 1),
            "params": to_jax_params(ctx["policy"]),
            "normalizer": {f: host(getattr(norm, f)) for f in
                           ("state_mean", "state_std", "action_mean", "action_std")},
            "data": {"exp_X": host(X), "exp_Y": host(Y), "test_X": host(tX), "test_Y": host(tY),
                     "dyn": tuple(host(t) for t in ctx["dyn_train"])},
            "replay_capacity": cfg.mpc.train.dynamics.replay_buffer_size, "kwargs": kw,
            "draws": draws, "teacher_forcing": True}
    return case, tX[:G18_SERVE]


def served_action(cfg, tree, hX, dev):
    """The first action the policy of ``tree`` plans on histories ``hX``."""
    from gan_mpc_tpu_torch.params import from_jax_params
    from gan_mpc_tpu_torch.runners import common

    policy = from_jax_params(tree, common.build_policy(cfg, 3, 1, True, dev))
    with torch.no_grad():
        return policy.plan_batch(hX, hX.new_zeros((hX.shape[0], 1, 1))).U[:, 0].cpu()


def by_component(tree):
    out = {}
    for name, leaf in leaves_of(tree):
        out.setdefault(name.split("/")[0], []).append((name, leaf))
    return out


def hold_epoch(label, got, single, nudged):
    """18 (b), (d): ``got``'s parameters (by component), metrics and replay
    against ``single``'s within max(base, twice the spread of ``nudged``
    against ``single``)."""
    def held(what, d, spread, base):
        tol = max(base, 2 * spread)
        print(f"    {label} {what}: max|d| {d:.3e} (tol {tol:.3e}, the single process's own "
              f"spread {spread:.3e})")
        if not d <= tol:
            raise SystemExit(f"phase 18 {label}: {what} is beyond the single-process epoch's "
                             "own spread")

    comps = by_component(single["params"])
    got_leaves = dict(leaves_of(got["params"]))
    nudged_leaves = [dict(leaves_of(n["params"])) for n in nudged]
    for comp, items in comps.items():
        d = max(np.abs(got_leaves[name] - leaf).max() for name, leaf in items)
        spread = max(np.abs(n[name] - leaf).max() for n in nudged_leaves for name, leaf in items)
        held(f"params {comp}", d, spread, G18_BASE["params"])
    for name, value in single["metrics"].items():
        spread = max(abs(n["metrics"][name] - value) for n in nudged)
        base = G18_BASE["planned" if name in G18_PLANNED else "metrics"]
        held(f"metric {name} ({value:.6g})", abs(got["metrics"][name] - value), spread,
             base * max(1.0, abs(value)))
    if got["replay"]["size"] != single["replay"]["size"]:
        raise SystemExit(f"phase 18 {label}: the replay holds {got['replay']['size']} windows, "
                         f"the single process's {single['replay']['size']}")
    for name in ("states", "actions", "next_states"):
        ref = single["replay"][name]
        spread = max(np.abs(n["replay"][name] - ref).max() for n in nudged)
        held(f"replay {name}", np.abs(got["replay"][name] - ref).max(), spread,
             G18_BASE["replay"])


def epoch_reference(cfg, dev, label):
    """18 (b), (d): ``epoch_snapshot`` of ``cfg`` and its fused epoch in one
    process on the card (launches against the reckoning, (stack, rows)
    pairs recorded)."""
    from gan_mpc_tpu_torch.parallel.checks import fused_epoch_case

    case, hX = epoch_snapshot(cfg, dev)
    synchronize(dev)
    t0 = time.perf_counter()
    with shapes_recorded() as seen, solves_recorded() as trips, \
            update_steps_recorded() as steps:
        single = fused_epoch_case(dev, case)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    want = reckon_epoch(trips, steps, cfg.mpc.horizon)
    if single["launches"] != want:
        raise SystemExit(f"{label}: the single-process epoch launched {single['launches']}, "
                         f"reckoned {want}")
    return dict(case=case, hX=hX, single=single, seen=seen, seconds=seconds)


def nudged_spread(cfg, ref, nudged, dev):
    """18 (b): ``ref`` with the nudged epochs and the spread they give the
    served action on the held-out histories."""
    hX = ref["hX"]
    a_single = served_action(cfg, ref["single"]["params"], hX, dev)
    spread = max((served_action(cfg, n["params"], hX, dev) - a_single).abs().max().item()
                 for n in nudged)
    return dict(ref, nudged=nudged, serve_spread=spread)


def dp_run_check(cfg, devices, ref, dev, workdir, label):
    """18 (c): ``runners.gan.run`` of ``cfg`` on one rank per entry of
    ``devices``, interrupted at its epoch-1 log line and resumed, and on one
    rank: rank 0 alone wrote the workdir, both saved runs load with
    ``bench.load_checkpoint``, and the served action on ``ref``'s histories
    is within max(1e-3, twice ``ref``'s nudged epochs' spread)."""
    import os

    from gan_mpc_tpu_torch.bench import load_checkpoint
    from gan_mpc_tpu_torch.runners import gan, l2

    dp_cfg = cfg.replace(runtime__data_parallel_devices=len(devices))
    t0 = time.perf_counter()
    try:
        gan.run(dp_cfg, log_fn=StopAt("[gan/fused] epoch 1 "), device=dev, devices=devices)
        raise SystemExit(f"{label}: the data-parallel run was not interrupted")
    except Stop:
        pass
    if l2.checkpointer_for(dp_cfg, "gan").latest_step() != 1:
        raise SystemExit(f"{label}: the interrupted run left no epoch-1 checkpoint")
    out = gan.run(dp_cfg, log_fn=StopAt(), device=dev, devices=devices)
    dp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = gan.run(cfg.replace(runtime__workdir=os.path.join(workdir, "one")), log_fn=None,
                  device=dev)
    one_s = time.perf_counter() - t0
    family_dir = os.path.dirname(out["run_dir"])
    with open(os.path.join(cfg.runtime.workdir, "metrics", cfg.env.name, "gan.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    epoch_rows = [r["step"] for r in rows if "episode_return" in r]
    left = os.listdir(os.path.join(cfg.runtime.workdir, "checkpoints", cfg.env.name, "gan"))
    print(f"  {label} the data-parallel run on {devices}, interrupted and resumed: {dp_s:.1f} s "
          f"(two spawns); the one-rank run {one_s:.1f} s; the workdir holds "
          f"{os.listdir(family_dir)} under {family_dir}, metrics epoch rows {epoch_rows}, "
          f"checkpoints left {left}")
    if os.listdir(family_dir) != [os.path.basename(out["run_dir"])] or epoch_rows != [1] or left:
        raise SystemExit(f"{label}: the workdir holds more than rank 0's files")
    served = {}
    hX = ref["hX"]
    for name, run in (("data parallel", out), ("one rank", one)):
        ckpt = load_checkpoint(run["run_dir"], dev)
        with torch.no_grad():
            served[name] = ckpt.policy.plan_batch(
                hX, hX.new_zeros((hX.shape[0], 1, 1))).U[:, 0].cpu()
    d = (served["data parallel"] - served["one rank"]).abs().max().item()
    tol = max(G18_BASE["action"], 2 * ref["serve_spread"])
    params_d = max(np.abs(a - dict(leaves_of(one["params"]))[n]).max()
                   for n, a in leaves_of(out["params"]))
    print(f"  {label} both saved runs load with bench.load_checkpoint; served action on "
          f"{G18_SERVE} held-out histories: max|d| {d:.3e} (tol {tol:.3e}: twice the nudged "
          f"epochs' {ref['serve_spread']:.3e}); saved params max|d| {params_d:.3e}")
    if not d <= tol:
        raise SystemExit(f"{label}: the data-parallel run serves beyond the bound")


def g18_config(workdir):
    """Phase 12's config continued from gan/9 on its own store, cut by
    ``G18_CUTS``, in ``workdir``."""
    import os

    from gan_mpc_tpu_torch.config import Config

    return Config.from_yaml(G12_CONFIG).replace(
        runtime__workdir=os.path.join(workdir, "dp"), env__trajectories_path=GAN9_STORE,
        **G18_CUTS)


def data_parallel_phase(kernels, card_line, dev):
    """Phase 18 (module docstring): (a)-(d). Returns (launches by path, the
    (stack, rows) pairs the ranks' and the single process's epochs gave
    the MLP kernels)."""
    import tempfile

    from gan_mpc_tpu_torch.parallel import launch
    from gan_mpc_tpu_torch.parallel.checks import fused_epoch_on_ranks
    from gan_mpc_tpu_torch.parallel.dryrun import dryrun_line, dryrun_multichip

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as workdir:
        cfg = g18_config(workdir)
        print(f"phase 18: data parallelism ({G12_CONFIG} continued from gan/9 on "
              f"{GAN9_STORE}; cuts {G18_CUTS}); ranks {G18_RANKS} over gloo (one GPU: "
              f"{card_line})")
        # (b) in one process on the card
        ref = epoch_reference(cfg, dev, "phase 18 (b)")
        case, single, seen = ref["case"], ref["single"], ref["seen"]
        launches["phase 18 single-process epoch"] = single["launches"]

        # (a) and (b) on the two ranks in one group, the nudged epochs after
        # the mesh epoch on the same ranks; then (a) on NCCL
        t0 = time.perf_counter()
        mesh = launch.spawn(mesh_ranks, G18_RANKS, (case, len(G18_RANKS), G18_NUDGES),
                            G18_TIMEOUT)
        mesh_s = time.perf_counter() - t0
        ref = nudged_spread(cfg, ref, mesh.pop("nudged"), dev)
        nudged = ref["nudged"]
        print(dryrun_line(len(G18_RANKS), mesh["losses"]))
        t0 = time.perf_counter()
        dryrun_multichip(len(G18_NCCL), G18_NCCL, G18_TIMEOUT)
        print(f"  (a) the one-rank NCCL dryrun {time.perf_counter() - t0:.1f} s (spawn included)")
        total = {}
        for rank, rec in enumerate(mesh["ranks"]):
            want = reckon_epoch(rec["trips"], rec["steps"], cfg.mpc.horizon)
            print(f"  (b) rank {rank}: {len(rec['trips'])} solves of {sum(rec['trips'])} trips, "
                  f"{rec['steps']['dynamics']} dynamics and {rec['steps']['cost']} generator "
                  f"steps at its rows; launches {rec['launches']} (reckoned {want}); epoch "
                  f"{rec['seconds']:.3f} s")
            if rec["launches"] != want:
                raise SystemExit(f"phase 18 (b): rank {rank}'s launches are not as reckoned")
            for name, count in rec["launches"].items():
                total[name] = total.get(name, 0) + count
            for key, layers in rec["seen"].items():
                seen.setdefault(key, [(w.to(dev), b.to(dev)) for w, b in layers])
        launches[f"phase 18 mesh epoch ({len(G18_RANKS)} ranks, summed)"] = total
        print(f"  (b) the fused GAN epoch: one process {ref['seconds']:.3f} s; mesh mode on "
              f"{len(G18_RANKS)} ranks sharing the card {max(r['seconds'] for r in mesh['ranks']):.3f}"
              f" s ({mesh_s:.1f} s with the spawn, (a)'s dryrun and the {len(G18_NUDGES)} nudged "
              f"epochs); launches summed {total}, "
              f"one process {single['launches']}; the ranks share one card and the host, so "
              "this is no speed figure")
        hold_epoch("(b) mesh against one process", mesh, single, nudged)

        # (c) the data-parallel run, interrupted and resumed, and the one-rank run
        dp_run_check(cfg, G18_RANKS, ref, dev, workdir, "(c)")

    # (d) NCCL across cards
    count = torch.cuda.device_count()
    if count >= 2:
        devices = [f"cuda:{i}" for i in range(min(count, 4))]
        t0 = time.perf_counter()
        across = fused_epoch_on_ranks(case, devices, G18_TIMEOUT)
        print(f"  (d) the mesh epoch over NCCL on {devices}: {time.perf_counter() - t0:.1f} s")
        hold_epoch("(d) NCCL across cards against one process", across, single, nudged)
    else:
        print("  (d) the host has one card: NCCL across cards not run")
    print(f"phase 18 wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, seen


def scaled_tree(tree, s):
    """Every leaf of a parameter tree scaled by ``s`` (float32)."""
    if isinstance(tree, dict):
        return {k: scaled_tree(v, s) for k, v in tree.items()}
    return (np.asarray(tree) * np.float32(s)).astype(np.float32)



def time_recorded(label, seen, keys, timed):
    """Time each MLP kernel and its plain version at the (stack, rows)
    pairs ``keys`` of ``seen`` (``shapes_recorded``) on the runs' own weights,
    as phase 3 does but over ``RECORDED_REPS`` runs, and add them to
    ``timed``."""
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        fused_mlp_backward, fused_mlp_forward, reference_backward, reference_forward,
    )

    rng = np.random.default_rng(SEED)
    for name, widths, rows in sorted(keys):
        if not rows:
            continue
        layers = seen[(name, widths, rows)]
        x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                         device=layers[0][0].device)
        ms = lambda fn: device_ms(fn, reps=RECORDED_REPS)  # noqa: E731
        if name == "fused_mlp_bwd":
            g = torch.tensor(rng.standard_normal((rows, widths[-1])), dtype=torch.float32,
                             device=x.device)
            k = ms(lambda: fused_mlp_backward(x, layers, g))
            p = ms(lambda: reference_backward(x, layers, g))
            b_ms, b_by = bwd_bound(rows, list(widths))
        else:
            k = ms(lambda: fused_mlp_forward(x, layers))
            p = ms(lambda: reference_forward(x, layers))
            b_ms, b_by = mlp_bound(rows, list(widths))
        timed[(name, f"{label} {list(widths)}", rows)] = (k, p, b_ms, b_by)
        print(f"time {name} {label} {list(widths)} rows={rows}: kernel {k:.4f} ms, plain "
              f"{p:.4f} ms, bound {b_ms:.5f} ms ({b_by}), kernel at {100 * b_ms / k:.1f}% of "
              f"bound")


def leaves_of(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves_of(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


@contextlib.contextmanager
def tensor_core_products():
    """The plain bf16 versions (``reference_forward(..., bf16=True)``,
    ``reference_ls_step(..., bf16=True)``) with each product of bfloat16
    operands taken by cuBLAS on the tensor cores, f32 accumulation and
    output (``torch.mm(..., out_dtype=torch.float32)``), inside the block:
    the bf16 instances' function on the units they use, the yardstick of
    their rounding spread (phase 19 (a)). The port never calls it."""
    from gan_mpc_tpu_torch.ops import fused_ls, fused_mlp

    def on_tensor_cores(a, w):
        return torch.mm(a.to(torch.bfloat16), w.to(torch.bfloat16), out_dtype=torch.float32)

    saved = fused_mlp.bf16_mm, fused_ls.bf16_mm
    fused_mlp.bf16_mm = fused_ls.bf16_mm = on_tensor_cores
    try:
        yield
    finally:
        fused_mlp.bf16_mm, fused_ls.bf16_mm = saved


@contextlib.contextmanager
def tf32_products():
    """cuBLAS float32 products in TF32 inside the block (the script pins
    full f32 elsewhere)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def layer_inputs_and_cotangents(x, layers, g):
    """Plain torch: each layer's input rows a_l and the cotangent rows
    g_{l+1} of its output, for the output cotangent ``g``: what the wide
    backward's walk leaves for its dW kernel."""
    acts, h = [x], x
    for w, b in layers[:-1]:
        h = torch.relu(h @ w + b)
        acts.append(h)
    cots = [g]
    for l in range(len(layers) - 1, 0, -1):
        cots.insert(0, torch.where(acts[l] > 0, cots[0] @ layers[l][0].T, 0.0))
    return acts, cots


def dw_bound(rows, widths):
    """The dW kernel's function: dW_l = a_l^T g_{l+1} (the forward's
    operations) and db_l; bytes: every a_l and g_{l+1} read once, dW and db
    written once."""
    nbytes = 4 * (rows * (sum(widths[:-1]) + sum(widths[1:])) + mlp_weight_floats(widths))
    return bound(mlp_flops(rows, widths) + rows * sum(widths[1:]), nbytes)


def dw_kernel_ms(fn, calls):
    """Device ms a call of ``fn``, a wide backward, spends in its dW
    kernel: the library's CUDA events around each dW launch
    (``fused_mlp_bwd_time_dw``), summed over ``calls`` calls after one
    warmup, per call. (torch.profiler late in the script keeps only some
    of a trace's kernel events, at times none.)"""
    import ctypes

    from gan_mpc_tpu_torch.ops.fused_mlp import fused_mlp_backward

    lib = fused_mlp_backward.load()
    lib.fused_mlp_bwd_time_dw.argtypes = [ctypes.c_int]
    lib.fused_mlp_bwd_dw_ms.restype = ctypes.c_double
    fn()
    torch.cuda.synchronize()
    lib.fused_mlp_bwd_dw_ms()  # clears the total
    lib.fused_mlp_bwd_time_dw(1)
    try:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        lib.fused_mlp_bwd_time_dw(0)
    return lib.fused_mlp_bwd_dw_ms() / calls


def hold_backward_memory(stack, layers, rows, dev):
    """The growth of the allocator's peak over one ``fused_mlp_bwd`` call
    (phase 19 (a)): within the gradient set, dx and the wide path's
    workspace (``bwd_route``: one chunk's planes) plus ``G19_MEM_SLACK``,
    and for 23->1024^3->17 at 128 rows within ``G19_MEM_128`` besides the
    workspace. Prints it beside the partial sets one per SM would take."""
    from gan_mpc_tpu_torch.ops.fused_mlp import bwd_route, fused_mlp_backward

    widths = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.randn((rows, widths[0]), device=dev)
    g = torch.randn((rows, widths[-1]), device=dev)
    params = mlp_weight_floats(widths)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fused_mlp_backward(x, layers, g)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(dev) - base
    del out
    work = bwd_route(rows, widths, sms)[3]
    limit = 4 * (params + x.numel()) + work + G19_MEM_SLACK
    small = widths == [23, 1024, 1024, 1024, 17] and rows == 128
    print(f"  backward {stack} rows={rows}: peak extra memory {grown / 1e6:.1f} MB (bound "
          f"{limit / 1e6:.1f} MB: gradients {4 * params / 1e6:.1f}, dx, workspace "
          f"{work / 1e6:.1f}" + (f"; {G19_MEM_128 / 1e6} MB besides the workspace" if small
                                 else "") + f"); one partial set an SM would be "
          f"{4 * params * sms / 1e9:.2f} GB")
    if not (grown <= limit and (not small or grown - work <= G19_MEM_128)):
        raise SystemExit(f"phase 19 (a): the {stack} backward at {rows} rows took "
                         f"{grown / 1e6:.1f} MB more, beyond its bound")


def wide_kernels_phase(instances, max_err, timed, dev):
    """Phase 19 (a): every kernel instance against its plain version at
    ``G19_FWD`` / ``G19_LS`` / ``G19_BWD`` / ``G19_BWD_BIG`` / ``G19_FAR``, each call on
    the wide path and counting one launch (none at 0 rows; the backward's
    walk and dW kernel one a chunk); each backward's peak extra memory;
    the worst case per stack; then the times at ``G19_TIMED_ROWS`` (the
    module's docstring).

    The bf16 instances: max|d| <= ``BF16_TOL`` max(1, max|ref|) at every
    shape, and the share of entries beyond 1e-4 within max(
    ``BF16_FAR_SHARE``, twice the share by which the same function on the
    tensor cores (cuBLAS, ``tensor_core_products``) lies from the plain
    version) at ``G19_SHARE_ROWS`` rows and more. Wherever two f32 sums of
    one row differ, a hidden activation can round to the other bfloat16
    neighbour (2^-8 relative, carried through the later layers); a stack
    of thousands of roundings a row flips more rows, and tensor-core sums
    (the kernels' m16n8k16 and cuBLAS's) lie further from the plain
    version's FMA sums than another FMA order would. Under 512 rows one
    flipped row is already 2-3% of the entries (37 rows x 17), so there
    the share is printed and max|d| alone is held. The f32 instance must
    lie beyond the share's bound on the same inputs."""
    from gan_mpc_tpu_torch.ops.fused_ls import reference_ls_step
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        BWD_CHUNK_ROWS, bwd_route, fwd_route, reference_backward, reference_dw, reference_forward,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(SEED + 19)
    worst = {}  # (instance, stack) -> (share of the bound, max|d|, share beyond 1e-4, shape)

    share = lambda a, b: ((a - b).abs() > 1e-4).float().mean().item() if b.numel() else 0.0

    def hold(kernel, stack, shape, got, ref, plain=None, unrounded=None, rows=0):
        """``got`` against ``ref``; for a bf16 instance ``plain`` (the
        plain version's outputs on the tensor cores) and ``unrounded`` (the
        f32 instance's) give the share's bound and its power."""
        bound = None
        if plain is not None:
            bound = max(BF16_FAR_SHARE, 2 * max(share(r, p) for r, p in zip(ref, plain)))
        for i, (g, r) in enumerate(zip(got, ref)):
            if tuple(g.shape) != tuple(r.shape):
                raise SystemExit(f"{kernel.name} {stack} {shape}: shape {tuple(g.shape)}, "
                                 f"plain version's {tuple(r.shape)}")
            err = (g - r).abs().max().item() if r.numel() else 0.0
            tol = (1e-4 if bound is None else BF16_TOL) * max(
                1.0, r.abs().max().item() if r.numel() else 0.0)
            far = share(g, r) if bound is not None else 0.0
            held_far = bound is None or rows < G19_SHARE_ROWS or far <= bound
            if not (err <= tol and held_far):
                raise SystemExit(f"{kernel.name} disagrees with its plain version on the {stack} "
                                 f"stack at {shape}: max|d|={err:.3e} (bound {tol:.3e}), beyond "
                                 f"1e-4 {100 * far:.3f}% (bound {100 * (bound or 0):.2f}%)")
            if bound is not None and i == 0 and rows >= G19_SHARE_ROWS \
                    and not share(unrounded[0], r) > bound:
                raise SystemExit(f"phase 19 (a) {stack} {shape}: the f32 instance lies within "
                                 f"{100 * bound:.2f}% of plain bf16, so the check cannot tell "
                                 "the instances apart")
            max_err[kernel.name] = max(max_err.get(kernel.name, 0.0), err)
            if err / tol >= worst.get((kernel.name, stack), (-1.0,))[0]:
                worst[(kernel.name, stack)] = (err / tol, err, far, shape, bound)

    def launched(kernel, fn, times=1):
        before = kernel.launches
        out = fn()
        if kernel.launches != before + times:
            raise SystemExit(f"{kernel.name} counted {kernel.launches - before} launches, "
                             f"expected {times}")
        return out

    def on_wide_path(route, what):
        if route[0] != "wide":
            raise SystemExit(f"phase 19 (a): {what} takes the {route[0]} path, not the wide one")
        return f"wide path, {route[1]}-row tiles, workspace {route[3] / 2**20:.1f} MiB"

    def cluster_launch(kernel, route, what):
        """The forward's or the step's last launch against the mirror's
        plan: the tile height, the cluster (a card that cannot place a
        size gets a smaller one) and whether the activations stream
        through a workspace; one cluster launch."""
        got = kernel.wide_launch()
        if route[0] != "wide" or got["tile_rows"] != route[1] or got["cluster"] > route[3] \
                or bool(got["streamed"]) != route[2]["streamed"]:
            raise SystemExit(f"phase 19 (a): {what} launched {got}, the mirror plans {route[:2]} "
                             f"on clusters of {route[3]}, streamed={route[2]['streamed']}")
        return (f"{got['tile_rows']}-row tiles, clusters of {got['cluster']} (planned "
                f"{route[3]}) x {got['clusters']}, {got['smem']} B of shared memory a block"
                + (", activations streamed" if got["streamed"] else ""))

    f32, bf16 = instances["fused_mlp_fwd"], instances["fused_mlp_fwd_bf16"]
    ls32, ls16 = instances["fused_ls_step"], instances["fused_ls_step_bf16"]
    bwd = instances["fused_mlp_bwd"]
    for i, (stack, widths) in enumerate(G19_FWD):
        layers = random_layers(widths, 1900 + i, dev)
        routes = []
        for rows in G19_FWD_ROWS:
            x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                             device=dev)
            # a call over 0 rows launches nothing and counts nothing
            unrounded = launched(f32, lambda: f32(x, layers), int(rows > 0))
            if rows:
                routes.append(f"{rows}: " + cluster_launch(f32, fwd_route(rows, widths, sms),
                                                           stack))
            hold(f32, stack, f"rows={rows}", (unrounded,), (reference_forward(x, layers),))
            got = launched(bf16, lambda: bf16(x, layers), int(rows > 0))
            with tensor_core_products():
                plain = reference_forward(x, layers, True)
            hold(bf16, stack, f"rows={rows}", (got,), (reference_forward(x, layers, True),),
                 (plain,), (unrounded,), rows)
        for lanes, alphas in G19_LS:
            args = ls_args(lanes, alphas, 17, 6, 17, LS_WEIGHTS[3], 1950 + i, dev,
                           hidden=widths[1:-1])
            unrounded = launched(ls32, lambda: ls32(**args))
            routes.append(f"step {lanes}x{alphas}: " + cluster_launch(
                ls32, fwd_route(lanes * alphas, widths, sms, 23), f"the step on {stack}"))
            hold(ls32, stack, f"{lanes}x{alphas}", unrounded, reference_ls_step(**args))
            got = launched(ls16, lambda: ls16(**args))
            with tensor_core_products():
                plain = reference_ls_step(**args, bf16=True)
            hold(ls16, stack, f"{lanes}x{alphas}", got, reference_ls_step(**args, bf16=True),
                 plain, unrounded, lanes * alphas)
        torch.cuda.synchronize()
        print(f"phase 19 (a) {stack} {widths[:3]}...{widths[-1]} ({len(widths) - 1} layers): "
              + "; ".join(routes))
    for i, (stack, widths) in enumerate(G19_FAR):
        layers = random_layers(widths, 1970 + i, dev)
        rows = G19_FAR_ROWS
        x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32, device=dev)
        unrounded = launched(f32, lambda: f32(x, layers))
        routes = [cluster_launch(f32, fwd_route(rows, widths, sms), stack)]
        hold(f32, stack, f"rows={rows}", (unrounded,), (reference_forward(x, layers),))
        got = launched(bf16, lambda: bf16(x, layers))
        with tensor_core_products():
            plain = reference_forward(x, layers, True)
        hold(bf16, stack, f"rows={rows}", (got,), (reference_forward(x, layers, True),),
             (plain,), (unrounded,), rows)
        args = ls_args(rows, 1, 17, 6, 17, LS_WEIGHTS[3], 1975 + i, dev, hidden=widths[1:-1])
        hold(ls32, stack, f"{rows}x1", launched(ls32, lambda: ls32(**args)),
             reference_ls_step(**args))
        routes.append("step: " + cluster_launch(ls32, fwd_route(rows, widths, sms, 23),
                                                 f"the step on {stack}"))
        torch.cuda.synchronize()
        print(f"phase 19 (a) {stack} ({len(widths) - 1} layers) at {rows} rows: "
              + "; ".join(routes))
    dw = instances["fused_mlp_bwd_dw"]
    big = [(stack, widths, 1980 + len(G19_BWD) + i, (rows,), True)
           for i, (stack, widths, rows) in enumerate(G19_BWD_BIG)]
    for stack, widths, seed, row_counts, is_big in \
            [(s, w, 1980 + i, G19_BWD_ROWS, False) for i, (s, w) in enumerate(G19_BWD)] + big:
        layers = random_layers(widths, seed, dev)
        for rows in row_counts:
            print(f"  backward {stack} rows={rows}: "
                  f"{on_wide_path(bwd_route(rows, widths, sms), stack)}")
            # check_backward calls the kernel twice: the second call must give the same bits;
            # each call runs the walk and the dW kernel once a chunk
            chunks = -(-rows // BWD_CHUNK_ROWS)
            err = launched(dw, lambda: launched(bwd, lambda: check_backward(
                stack, layers, rows, rng, dev, max_err, is_big), 2 * chunks), 2 * chunks)
            if err >= worst.get((bwd.name, stack), (-1.0,))[0]:
                worst[(bwd.name, stack)] = (err, err, 0.0, f"rows={rows}", None)
            max_err[bwd.name] = max(max_err[bwd.name], err)
            hold_backward_memory(stack, layers, rows, dev)
            if is_big:  # the f32 forward and step there too: their contraction runs in segments
                x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                                 device=dev)
                hold(f32, stack, f"rows={rows}", (launched(f32, lambda: f32(x, layers)),),
                     (reference_forward(x, layers),))
                args = ls_args(512, 16, 17, 6, 17, LS_WEIGHTS[3], seed, dev,
                               hidden=widths[1:-1])
                hold(ls32, stack, "512x16", launched(ls32, lambda: ls32(**args)),
                     reference_ls_step(**args))
                del x, args
    for (name, stack), (of_bound, err, far, shape, bound) in worst.items():
        print(f"phase 19 (a) worst {name} {stack}: max|d| {err:.3e} at {shape}"
              + ("" if name == bwd.name else f", {100 * of_bound:.1f}% of its bound")
              + ("" if bound is None else f", beyond 1e-4 {100 * far:.3f}% (bound "
                 f"{100 * bound:.2f}% from {G19_SHARE_ROWS} rows)"))

    # times: kernel, plain and the cuBLAS chain in f32 and TF32; no gate
    ms = lambda fn: device_ms(fn, launches=5, reps=5)  # noqa: E731
    for i, (stack, widths) in enumerate(G19_FWD):
        layers = random_layers(widths, 1900 + i, dev)
        lt = [(w.T.contiguous(), b) for w, b in layers]
        for rows in G19_TIMED_ROWS["fwd"]:
            x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                             device=dev)
            k32, k16 = ms(lambda: f32(x, layers)), ms(lambda: bf16(x, layers))
            p32 = ms(lambda: reference_forward(x, layers))
            c32 = ms(lambda: linear_chain(x, lt))
            with tf32_products():
                ctf = ms(lambda: linear_chain(x, lt))
            b32, by32 = mlp_bound(rows, widths)
            b16, by16 = mlp_bound(rows, widths, BF16_PEAK)
            timed[(f32.name, stack, rows)] = (k32, p32, b32, by32)
            timed[(bf16.name, stack, rows)] = (k16, None, b16, by16)
            print(f"time phase 19 fused_mlp_fwd {stack} rows={rows}: kernel {k32:.4f} ms "
                  f"(bound {b32:.5f} ms, {by32}, {100 * b32 / k32:.1f}%), bf16 instance "
                  f"{k16:.4f} ms (bound {b16:.5f} ms, {100 * b16 / k16:.1f}%), plain {p32:.4f} "
                  f"ms; cuBLAS chain f32 {c32:.4f} ms, TF32 {ctf:.4f} ms")
        for lanes, alphas in G19_TIMED_ROWS["ls"]:
            args = ls_args(lanes, alphas, 17, 6, 17, LS_WEIGHTS[0], 1950 + i, dev,
                           hidden=widths[1:-1])
            k32, k16 = ms(lambda: ls32(**args)), ms(lambda: ls16(**args))
            p32 = ms(lambda: reference_ls_step(**args))
            b32, by32 = ls_bound(lanes, alphas, 17, 6, 17, hidden=widths[1:-1])
            timed[(ls32.name, stack, lanes * alphas)] = (k32, p32, b32, by32)
            print(f"time phase 19 fused_ls_step {stack} {lanes}x{alphas}: kernel {k32:.4f} ms "
                  f"(bound {b32:.5f} ms, {by32}, {100 * b32 / k32:.1f}%), bf16 instance "
                  f"{k16:.4f} ms, plain {p32:.4f} ms")
    for stack, widths, seed, row_counts, one_run in \
            [(s, w, 1980 + i, G19_TIMED_ROWS["bwd"], False) for i, (s, w) in enumerate(G19_BWD)] \
            + big:
        layers = random_layers(widths, seed, dev)
        # G19_BWD_BIG's calls take up to a second: one launch a run, and no TF32 plain
        many = not one_run
        once = ms if many else (lambda fn: device_ms(fn, launches=1, reps=3))
        for rows in row_counts:
            x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                             device=dev)
            g = torch.tensor(rng.standard_normal((rows, widths[-1])), dtype=torch.float32,
                             device=dev)
            k = once(lambda: bwd(x, layers, g))
            p = once(lambda: reference_backward(x, layers, g))
            ptf = None
            if many:
                with tf32_products():
                    ptf = ms(lambda: reference_backward(x, layers, g))
            b_ms, b_by = bwd_bound(rows, widths)
            timed[(bwd.name, stack, rows)] = (k, p, b_ms, b_by)
            # the dW kernel's share of the call, by CUDA events, against the plain a^T g
            acts, cots = layer_inputs_and_cotangents(x, layers, g)
            k_dw = dw_kernel_ms(lambda: bwd(x, layers, g), 5 if many else 1)
            p_dw = once(lambda: reference_dw(acts, cots))
            d_ms, d_by = dw_bound(rows, widths)
            timed[(dw.name, stack, rows)] = (k_dw, p_dw, d_ms, d_by)
            print(f"time phase 19 fused_mlp_bwd {stack} rows={rows}: kernel {k:.4f} ms (bound "
                  f"{b_ms:.5f} ms, {b_by}, {100 * b_ms / k:.1f}%), plain (cuBLAS f32) {p:.4f} "
                  f"ms" + ("" if ptf is None else f", in TF32 {ptf:.4f} ms")
                  + f"; of the kernel's call the dW kernel {k_dw:.4f} ms (bound {d_ms:.5f} ms, "
                  f"{d_by}, {100 * d_ms / k_dw:.1f}%), plain a^T g {p_dw:.4f} ms")


def wide_serving_phase(kernels, card_line, dev):
    """Phase 19 (b): the flagship with ``G19_SERVE_HIDDEN`` dynamics served
    both ways (the module's docstring); returns the launches by path."""
    from gan_mpc_tpu_torch.bench import FUSED_LS, HORIZON, ILQR_ITERS, NUM_ENVS, flagship, run_steps
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve

    env_cpu, env = make_env("cheetah_run", "cpu"), make_env("cheetah_run", dev)
    state = env_cpu.reset(env_cpu.default_params(), 8, torch.Generator().manual_seed(SEED))
    hX = torch.zeros((8, 2, 17))
    hX[:, 1] = env_cpu.observe(env_cpu.default_params(), state)
    hU = torch.zeros((8, 1, 6))
    norm = Normalizer.identity(env.obs_size, env.act_size, dev)
    out = {}
    for fused_ls in FUSED_LS:
        kw = dict(seed=SEED, fused_ls=fused_ls, hidden=G19_SERVE_HIDDEN)
        U_cpu = flagship(HORIZON, 2, device="cpu", **kw).plan_batch(hX, hU).U
        U_gpu = flagship(HORIZON, 2, device=dev, **kw).plan_batch(hX.to(dev), hU.to(dev)).U.cpu()
        d_plan = (U_gpu - U_cpu).abs().max().item()
        print(f"phase 19 (b) plan_batch (8 envs, 2 iters, dynamics hidden {G19_SERVE_HIDDEN}, "
              f"fused_ls={fused_ls}) GPU vs CPU: max|dU|={d_plan:.3e} (atol 1e-3)")
        if not d_plan <= 1e-3:
            raise SystemExit(f"phase 19 (b): the plan (fused_ls={fused_ls}) on the card "
                             "disagrees with the CPU path")
        policy = flagship(device=dev, **kw)
        gen = torch.Generator().manual_seed(SEED)
        _, t_warm = run_steps(policy, env, norm, 1, gen)
        for k in kernels.values():
            k.launches = 0
        ep, dt = run_steps(policy, env, norm, G19_SERVE_STEPS, gen)
        counts = count(kernels)
        per_step = mlp_calls_per_solve(HORIZON, ILQR_ITERS, fused=fused_ls == "on",
                                       materialize=False)
        expected = {name: G19_SERVE_STEPS * per_step.get(name, 0) for name in kernels}
        print(f"phase 19 (b) flagship, dynamics hidden {G19_SERVE_HIDDEN}, fused_ls={fused_ls} "
              f"({card_line}): {G19_SERVE_STEPS} steps x {NUM_ENVS} envs in {dt:.3f} s "
              f"({NUM_ENVS * G19_SERVE_STEPS / dt:.1f} steps/s; warmup step {t_warm:.3f} s); "
              f"launches {counts} (expected {expected})")
        if counts != expected:
            raise SystemExit(f"phase 19 (b): the 1024-wide flagship (fused_ls={fused_ls}) did not "
                             "launch the kernels on every call")
        check_finite(f"phase 19 (b) fused_ls={fused_ls}", ep,
                     {"states": (NUM_ENVS, G19_SERVE_STEPS, 17),
                      "actions": (NUM_ENVS, G19_SERVE_STEPS, 6),
                      "rewards": (NUM_ENVS, G19_SERVE_STEPS)})
        out[f"dynamics {'x'.join(map(str, G19_SERVE_HIDDEN))} fused_ls={fused_ls}"] = counts
    return out


def perturbed_dynamics(draw):
    """Inside the block every dynamics MLP output is perturbed by
    ``G19_FLIP_NOISE`` of its max, normal draws from seed ``draw``: the size
    of the kernels' 3xTF32 error on the 512-wide stacks (phase 19 (c))."""
    from gan_mpc_tpu_torch.models import dynamics

    gen = torch.Generator().manual_seed(draw)

    def wrap(plain):
        def forward(x, layers, *args, **kwargs):
            y = plain(x, layers, *args, **kwargs)
            return y + G19_FLIP_NOISE * y.detach().abs().amax() * torch.randn(
                y.shape, generator=gen).to(y.device)
        return forward
    return wrapped(dynamics, "mlp_apply", wrap)


def stable_windows(cfg, hX, Y, n):
    """The first ``n`` of the cost windows (hX, Y) on which the policy of
    ``cfg`` (2 trips) plans stably on the CPU: each lane's plan moves by
    ``G19_FLIP_TOL`` or less under ``perturbed_dynamics`` (``G19_FLIP_DRAWS``
    draws). A random-weight line search flips its argmin on perturbations of
    that size (on configs/gan_cheetah.yaml at [512] * 3 a lane's plan moved
    by up to 0.13 here and 0.18 on the card's host, whose CPU moved the
    others by a median 2.7e-4 where this one moved them by 2.4e-5), and a
    flipped lane moves the implicit gradient by a whole step; the
    selection reads the CPU alone."""
    from gan_mpc_tpu_torch.runners.common import build_policy

    policy = build_policy(cfg, 17, 6, device="cpu")
    hU = torch.zeros((hX.shape[0], hX.shape[1] - 1, 6))
    with torch.no_grad():
        base = policy.plan_batch(hX, hU).U
        moved = torch.zeros(hX.shape[0])
        for draw in range(G19_FLIP_DRAWS):
            with perturbed_dynamics(draw):
                U = policy.plan_batch(hX, hU).U
            moved = torch.maximum(moved, (U - base).abs().amax(dim=(1, 2)))
    keep = (moved <= G19_FLIP_TOL).nonzero().flatten()[:n]
    print(f"  {int((moved <= G19_FLIP_TOL).sum())} of {hX.shape[0]} cost windows plan stably "
          f"under {G19_FLIP_NOISE:.0e} perturbations of the dynamics (the largest move "
          f"{moved.max().item():.2e}); {n} of them taken")
    if len(keep) < n:
        raise SystemExit("too few cost windows plan stably")
    return hX[keep], Y[keep]


def wide_training_phase(kernels, dev):
    """Phase 19 (c): dynamics-trainer and cost-trainer steps of
    configs/gan_cheetah.yaml at each of ``G19_TRAIN_HIDDEN`` (the module's
    docstring); returns the launches by path."""
    from gan_mpc_tpu_torch.config import Config
    from gan_mpc_tpu_torch.planner.bilevel import mlp_calls_per_step
    from gan_mpc_tpu_torch.policies.losses import l2_imitation_loss
    from gan_mpc_tpu_torch.runners.common import build_policy
    from gan_mpc_tpu_torch.training.dynamics import multistep_prediction_loss, update_pass
    from gan_mpc_tpu_torch.training.masking import masked_adam, policy_components

    cpu = torch.device("cpu")
    dw = kernels["fused_mlp_bwd"].dw  # the wide backward's dW kernel, one launch a call here
    counted = lambda: dict(count(kernels), fused_mlp_bwd_dw=dw.launches)  # noqa: E731
    out = {}
    for hidden in G19_TRAIN_HIDDEN:
        cfg = Config.from_yaml(G11_CONFIG).replace(
            mpc__model__dynamics__mlp__hidden=list(hidden),
            mpc__solver__max_iterations=GRAD_CHECK["iters"])
        dcfg, horizon = cfg.mpc.train.dynamics, cfg.mpc.horizon
        label = f"phase 19 (c) {G11_CONFIG} dynamics hidden {hidden}"

        # the dynamics trainer: the first minibatch's gradients, then an
        # update pass of 3 minibatches on the same windows, indices and
        # weights, as check_update_pass, on windows clear of the relu kinks
        # (phase 15's clear_windows: a 512-wide unit's kink crossed on one
        # side moves its gradient by a whole window's share)
        rng = np.random.default_rng(SEED)
        batch = dcfg.batch_size
        pool = tuple(torch.tensor(rng.standard_normal((12 * batch, horizon, w)),
                                  dtype=torch.float32) for w in (17, 6, 17))
        clear = clear_windows(build_policy(cfg, 17, 6, device=cpu).dynamics_model, pool, False,
                              3 * batch, rng)
        rows = np.concatenate([np.arange(batch)[None], rng.integers(0, 3 * batch, (2, batch))])
        results = []
        for device in (dev, cpu):
            policy = build_policy(cfg, 17, 6, with_critic=True, device=device)
            model = policy.dynamics_model
            opt = masked_adam(policy_components(policy), dcfg.no_grads, dcfg.learning_rate)
            X, U, Y = windows = tuple(t.to(device) for t in clear)
            idx = torch.tensor(rows, device=device)
            for k in [*kernels.values(), dw]:
                k.launches = 0
            multistep_prediction_loss(model, X[idx[0]], U[idx[0]], Y[idx[0]],
                                      dcfg.discount_factor, teacher_forcing=False).mean().backward()
            grads = {name: p.grad.detach().cpu().clone() for name, p in model.named_parameters()}
            opt.zero_grad()
            losses = [update_pass(model, opt, windows, row[None], dcfg.discount_factor,
                                  teacher_forcing=False).item() for row in idx]
            results.append((grads, losses, [p.detach().cpu() for p in model.parameters()],
                            counted()))
        (g_gpu, l_gpu, p_gpu, counts), (g_cpu, l_cpu, p_cpu, _) = results
        expected = {"fused_mlp_fwd": 4 * horizon, "fused_ls_step": 0,
                    "fused_mlp_bwd": 4 * horizon, "fused_mlp_bwd_dw": 4 * horizon}
        d_grad = max((g_gpu[name] - ref).abs().max().item()
                     / (1e-4 * max(1.0, ref.abs().max().item())) for name, ref in g_cpu.items())
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
        d_par = max((a - b).abs().max().item() for a, b in zip(p_gpu, p_cpu))
        lr = dcfg.learning_rate
        print(f"{label}: dynamics update pass (3 x {dcfg.batch_size} windows, open loop) GPU vs "
              f"CPU: first-minibatch gradients at most {100 * d_grad:.1f}% of 1e-4 max(1, "
              f"max|ref|), max rel d loss {d_loss:.3e} (rtol 1e-4), max|d| params {d_par:.3e} "
              f"(atol {2 * 3 * lr:.0e}); launches {counts} (expected {expected}: {horizon} "
              "forward and backward a step, 4 steps, each backward one chunk)")
        if not (d_grad <= 1.0 and d_loss <= 1e-4 and d_par <= 2 * 3 * lr):
            raise SystemExit(f"{label}: the dynamics update pass on the card disagrees with the "
                             "CPU path")
        if counts != expected:
            raise SystemExit(f"{label}: the dynamics trainer did not launch the kernels on every "
                             "MLP call")
        out[f"dynamics trainer {hidden}"] = counts

        # the cost trainer: one minibatch's implicit gradient, as
        # check_implicit_step, on windows whose plan is stable, within
        # max(its bounds, twice the CPU's own spread under perturbations of
        # the dynamics' outputs the size of the kernels' error)
        hX, Yc = stable_windows(cfg, *grad_check_inputs(G19_FLIP_POOL, GRAD_CHECK["seed"]),
                                GRAD_CHECK["windows"])
        comps = ("mpc_weights", "cost_params", "dynamics_params")

        def implicit(device, draw=None):
            policy = build_policy(cfg, 17, 6, device=device)
            for name in comps:
                for p in policy_components(policy)[name]:
                    p.requires_grad_(True)
            for k in [*kernels.values(), dw]:
                k.launches = 0
            with solves_recorded() as trips, contextlib.ExitStack() as stack:
                if draw is not None:
                    stack.enter_context(perturbed_dynamics(draw))
                loss, grads = policy.batched_loss_and_grad(hX.to(device), l2_imitation_loss,
                                                           (Yc.to(device),))
            return (loss.item(), {k: [g.cpu() for g in v] for k, v in grads.items()},
                    counted(), list(trips))

        rel = lambda g, ref: {k: max((a - b).abs().max().item()  # noqa: E731
                                     / max(b.abs().max().item(), 1e-30)
                                     for a, b in zip(g[k], ref[k])) for k in comps}
        l_gpu, g_gpu, counts, trips = implicit(dev)
        l_cpu, g_cpu, _, _ = implicit(cpu)
        d, d_loss = rel(g_gpu, g_cpu), abs(l_gpu - l_cpu) / abs(l_cpu)
        spread, s_loss = dict.fromkeys(comps, 0.0), 0.0
        for draw in range(G19_FLIP_DRAWS):
            l_n, g_n, _, _ = implicit(cpu, draw)
            s_loss = max(s_loss, abs(l_n - l_cpu) / abs(l_cpu))
            spread = {k: max(v, rel(g_n, g_cpu)[k]) for k, v in spread.items()}
        tol_loss = max(1e-4, 2 * s_loss)
        tol = {k: max(1e-3, 2 * v) for k, v in spread.items()}
        expected = dict(mlp_calls_per_step(horizon, sum(trips), steps=len(trips),
                                           materialize=False))
        expected["fused_mlp_bwd_dw"] = expected["fused_mlp_bwd"]  # one chunk each
        fmt = lambda m: ", ".join(f"{k} {v:.2e}" for k, v in m.items())  # noqa: E731
        print(f"{label}: cost-trainer implicit gradient ({GRAD_CHECK['windows']} stable windows, "
              f"trips {trips}) GPU vs CPU: loss {l_gpu:.7g} vs {l_cpu:.7g} (rel {d_loss:.2e}, tol "
              f"{tol_loss:.2e} = max(1e-4, twice the CPU's own {s_loss:.2e})); max|d| / max|ref| "
              f"{fmt(d)} (tol max(1e-3, twice the CPU's own): {fmt(tol)}); launches {counts} "
              f"(expected {expected})")
        if not (d_loss <= tol_loss and all(d[k] <= tol[k] for k in comps)):
            raise SystemExit(f"{label}: the implicit gradient on the card disagrees with the CPU "
                             "path")
        if counts != expected:
            raise SystemExit(f"{label}: the cost step did not launch the kernels on every MLP "
                             "call")
        out[f"cost trainer {hidden}"] = counts
    return out


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
    from gan_mpc_tpu_torch.ops.fused_ls import (
        fused_ls_kernel, fused_ls_kernel_bf16, reference_ls_step,
    )
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        bwd_tile_plan, fused_mlp_backward, fused_mlp_forward, fused_mlp_forward_bf16, mlp_apply,
        reference_backward, reference_forward, tile_plan,
    )
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve

    pin_fp32()
    dev = torch.device("cuda")
    card_line = card()
    kernels = {"fused_mlp_fwd": fused_mlp_forward, "fused_ls_step": fused_ls_kernel,
               "fused_mlp_bwd": fused_mlp_backward}
    # the bf16 instances live in the same libraries (phase 16)
    instances = dict(kernels, fused_mlp_fwd_bf16=fused_mlp_forward_bf16,
                     fused_ls_step_bf16=fused_ls_kernel_bf16)

    # 1. card, toolchain, build
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.build_libraries(list(kernels))
    for k in instances.values():
        k.load()
    print(f"build {', '.join(kernels)} (in parallel): {time.perf_counter() - t0:.2f} s")
    # the wide backward's dW kernel, launched by fused_mlp_bwd's calls on the wide path (phase 19)
    instances["fused_mlp_bwd_dw"] = fused_mlp_backward.dw
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
        per_step = mlp_calls_per_solve(HORIZON, ILQR_ITERS, fused=fused_ls == "on",
                                       materialize=False)
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

    # phases 6-12 record the (stack, rows) of every MLP kernel call; after
    # each, the kernels are held against their plain versions at the pairs
    # that no earlier check held (the counts were read before)
    checked = set()

    # 6. the training path
    with shapes_recorded() as seen:
        launches["trainer"] = train_phase(episodes["off"], env, kernels, card_line, dev)
    check_recorded("phase 6", seen, checked, rng, dev, max_err)

    # 7. the cost-trainer path
    with shapes_recorded() as seen:
        launches["cost trainer"] = cost_phase(episodes["off"], kernels, card_line, dev)
    check_recorded("phase 7", seen, checked, rng, dev, max_err)

    # 8. the GAN slice on the committed run gan/9
    wall = {}
    with shapes_recorded() as seen:
        launches.update(gan9_phase(kernels, card_line, dev, wall))
    check_recorded("phase 8", seen, checked, rng, dev, max_err)

    # 9. the GAN training run on gan/9, interrupted and resumed
    with shapes_recorded() as seen:
        launches.update(gan_run_phase(kernels, card_line, dev))
    check_recorded("phase 9", seen, checked, rng, dev, max_err)

    # 10. the humanoid-class row: H=50, the materializing line search
    with shapes_recorded() as seen:
        launches["humanoid H=50"] = humanoid_phase(kernels, card_line, dev)
    check_recorded("phase 10", seen, checked, rng, dev, max_err)

    # 11. a committed config from an empty workdir: collect, train the expert, run
    with shapes_recorded() as seen:
        launches["fresh gan run"] = fresh_run_phase(kernels, card_line, dev)
    check_recorded("phase 11", seen, checked, rng, dev, max_err)

    # 12. the fused epochs and a DAgger round
    with shapes_recorded() as seen:
        launches.update(fused_phase(kernels, card_line, dev, wall))
    check_recorded("phase 12", seen, checked, rng, dev, max_err)

    # 13. walker and cartpole, and the committed trained checkpoints
    with shapes_recorded() as seen:
        launches.update(walker_cartpole_phase(kernels, card_line, dev))
    new = [key for key in seen if key not in checked]
    check_recorded("phase 13", seen, checked, rng, dev, max_err)
    with torch.no_grad():
        time_recorded("phase 13", seen, new, timed)

    # 14. the per-instance path, goal projection and the runs they unlock
    with shapes_recorded() as seen:
        launches.update(per_instance_phase(kernels, card_line, dev))
    new = [key for key in seen if key not in checked]
    check_recorded("phase 14", seen, checked, rng, dev, max_err)
    with torch.no_grad():
        time_recorded("phase 14", seen, new, timed)

    # 15. training with ensemble and LSTM dynamics: humanoid_scale*.yaml
    with shapes_recorded() as seen:
        launches.update(ensemble_training_phase(kernels, card_line, dev))
    new = [key for key in seen if key not in checked]
    check_recorded("phase 15", seen, checked, rng, dev, max_err)
    with torch.no_grad():
        time_recorded("phase 15", seen, new, timed)

    # 16. the bf16 compute path and the associative Riccati
    launches.update(bf16_riccati_phase(instances, card_line, dev, max_err, timed))

    # 17. the pendulum runs on their own stores, the video, dm_control absent
    with shapes_recorded() as seen:
        launches.update(pendulum_video_phase(kernels, card_line, dev))
    check_recorded("phase 17", seen, checked, rng, dev, max_err)

    # 18. data parallelism: the mesh, the sharded steps, the fused epoch's mesh
    # mode and the data-parallel run over torch.distributed
    phase18, seen = data_parallel_phase(kernels, card_line, dev)
    launches.update(phase18)
    check_recorded("phase 18", seen, checked, rng, dev, max_err)

    # 19. stacks of any depth and width: the kernels' wide path
    t19 = time.perf_counter()
    max_err["fused_mlp_bwd_dw"] = 0.0
    with torch.no_grad():
        wide_kernels_phase(instances, max_err, timed, dev)
    launches.update(wide_serving_phase(kernels, card_line, dev))
    launches.update(wide_training_phase(kernels, dev))
    print(f"phase 19: {time.perf_counter() - t19:.1f} s")

    # the planner's line-search call (8192 rows) leads the forward kernels'
    # entries (at both dtypes), the trainer's call (128 rows) the backward
    # kernel's
    lead = {"fused_mlp_fwd": ("dynamics", 8192), "fused_ls_step": ("line search", 8192),
            "fused_mlp_bwd": ("dynamics", 128), "fused_mlp_fwd_bf16": ("dynamics", 8192),
            "fused_ls_step_bf16": ("line search", 8192),
            # phase 19 (c)'s dynamics trainer at [512] * 3 calls the wide backward at 128 rows
            "fused_mlp_bwd_dw": ("512^3", 128)}
    summary = []
    for name, k in instances.items():
        k_ms, p_ms, b_ms, b_by = timed[(name, *lead[name])]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": sum(launches[path].get(name, 0) for path in launches),
            "launches_by_path": {path: launches[path].get(name, 0) for path in launches},
            "max_abs_err": max_err[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            # no single PyTorch call computes this function (the dW kernel's: every
            # layer's dW and db at once)
            "library_ms": None,
            "dtype": "bfloat16" if getattr(k, "bf16", False) else "float32",
            "bound_rate_tflops": (BF16_PEAK if getattr(k, "bf16", False) else F32_PRODUCT_RATE)
            / 1e12,
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
