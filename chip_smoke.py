#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. print the card (nvidia-smi name and power limit) and the toolchain,
     then build the fused-MLP kernel from ``gan_mpc_tpu_torch/csrc``;
  2. hold the kernel against its plain torch version on the card (TF32
     off) at the shapes the main path gives it, plus a ragged row count
     and the 256-wide stack: max|d| <= 1e-4 * max(1, max|ref|), since f32
     sums run in another order than cuBLAS's;
  3. time kernel and plain version with CUDA events (median of 21 runs of
     20 back-to-back launches, queued behind a device sleep so that host
     overhead is not timed);
  4. check the main path's pieces on a small input against the same code
     on the CPU (plain versions): one flagship plan_batch at 8 envs and 2
     iLQR iterations (U atol 1e-3), one cheetah step (atol 1e-4);
  5. drive the main path: the flagship closed loop (cheetah_run, 512
     envs, H=5, iLQR <= 5, random flax-style weights from seed 0) for 2
     warmup and 20 timed control steps; every MLP call of the planner
     must have launched the kernel, and every output must be finite.
The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. Exits 1 without a CUDA device.
"""

import json
import sys
import time

import numpy as np
import torch

SEED = 0
DYNAMICS = [23, 200, 200, 200, 17]
WIDE = [23, 256, 256, 256, 17]
COST = [17, 128, 128, 10]
# (name, widths, rows): the main path calls the kernel at 512 rows
# (rollout, winner recompute) and 512 * 16 alphas = 8192 (line search)
CHECKS = [
    ("dynamics", DYNAMICS, 8192), ("dynamics", DYNAMICS, 512),
    ("dynamics", DYNAMICS, 1000), ("wide", WIDE, 8192),
    ("cost", COST, 8192), ("cost", COST, 512),
]
TIMED = [("dynamics", DYNAMICS, 8192), ("dynamics", DYNAMICS, 512),
         ("cost", COST, 8192), ("cost", COST, 512)]


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


def random_layers(widths, seed, device):
    rng = np.random.default_rng(seed)
    return [
        (torch.tensor(rng.standard_normal((a, b)) / np.sqrt(a), dtype=torch.float32,
                      device=device),
         torch.tensor(0.1 * rng.standard_normal(b), dtype=torch.float32, device=device))
        for a, b in zip(widths[:-1], widths[1:])
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gan_mpc_tpu_torch import pin_fp32
    from gan_mpc_tpu_torch.bench import (
        HORIZON, ILQR_ITERS, NUM_ENVS, STEPS, WARMUP_STEPS,
        bench_row, card, flagship, run_steps,
    )
    from gan_mpc_tpu_torch.data.normalizer import Normalizer
    from gan_mpc_tpu_torch.envs import make_env
    from gan_mpc_tpu_torch.envs.base import EnvState
    from gan_mpc_tpu_torch.ops import _build
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        fused_mlp_forward, mlp_apply, reference_forward,
    )
    from gan_mpc_tpu_torch.planner.batch_ilqr import mlp_calls_per_solve

    pin_fp32()
    dev = torch.device("cuda")
    card_line = card()

    # 1. card, toolchain, build
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build_library("fused_mlp_fwd")
    fused_mlp_forward.load()
    print(f"build fused_mlp_fwd: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 2. kernel against plain version on the card
    max_err = 0.0
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
            bound = 1e-4 * max(1.0, ref.abs().max().item())
            print(f"check {name} {widths} rows={rows}: max|d|={err:.3e} bound={bound:.3e}")
            if not err <= bound:
                raise SystemExit(f"kernel disagrees with plain version: {name} rows={rows}")
            max_err = max(max_err, err)

        # 3. times
        times = {}
        for i, (name, widths, rows) in enumerate(TIMED):
            layers = random_layers(widths, 100 + i, dev)
            x = torch.tensor(rng.standard_normal((rows, widths[0])),
                             dtype=torch.float32, device=dev)
            k = device_ms(lambda: fused_mlp_forward(x, layers))
            p = device_ms(lambda: reference_forward(x, layers))
            times[(name, rows)] = (k, p)
            gf = mlp_flops(rows, widths) / 1e9
            print(f"time {name} {widths} rows={rows}: kernel {k:.4f} ms "
                  f"({gf / k * 1e3:.0f} GFLOP/s), plain {p:.4f} ms "
                  f"({gf / p * 1e3:.0f} GFLOP/s)")

    # 4. the path's pieces on a small input against the CPU plain path
    small_gpu = flagship(HORIZON, 2, device=dev, seed=SEED)
    small_cpu = flagship(HORIZON, 2, device="cpu", seed=SEED)
    env_gpu, env_cpu = make_env("cheetah_run", dev), make_env("cheetah_run", "cpu")
    state = env_cpu.reset(env_cpu.default_params(), 8, torch.Generator().manual_seed(SEED))
    hX = torch.zeros((8, 2, 17))
    hX[:, 1] = env_cpu.observe(env_cpu.default_params(), state)
    hU = torch.zeros((8, 1, 6))
    U_cpu = small_cpu.plan_batch(hX, hU).U
    U_gpu = small_gpu.plan_batch(hX.to(dev), hU.to(dev)).U.cpu()
    d_plan = (U_gpu - U_cpu).abs().max().item()
    print(f"small plan_batch (8 envs, 2 iters) GPU vs CPU: max|dU|={d_plan:.3e} (atol 1e-3)")
    if not d_plan <= 1e-3:
        raise SystemExit("plan_batch on the card disagrees with the CPU path")
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

    # 5. main path
    policy = flagship(device=dev, seed=SEED)
    env = make_env("cheetah_run", dev)
    norm = Normalizer.identity(env.obs_size, env.act_size, dev)
    gen = torch.Generator().manual_seed(SEED)
    _, t_warm = run_steps(policy, env, norm, WARMUP_STEPS, gen)
    fused_mlp_forward.launches = 0
    ep, dt = run_steps(policy, env, norm, STEPS, gen)
    launches = fused_mlp_forward.launches
    expected = STEPS * mlp_calls_per_solve(HORIZON, ILQR_ITERS)
    print(f"main path: {STEPS} steps x {NUM_ENVS} envs in {dt:.3f} s "
          f"(warmup {WARMUP_STEPS} steps {t_warm:.3f} s); kernel launches "
          f"{launches} (expected {expected} = {STEPS} x "
          f"{mlp_calls_per_solve(HORIZON, ILQR_ITERS)})")
    if launches != expected:
        raise SystemExit("the main path did not launch the kernel on every MLP call")
    shapes = {"states": (NUM_ENVS, STEPS, 17), "actions": (NUM_ENVS, STEPS, 6),
              "rewards": (NUM_ENVS, STEPS)}
    for name, shape in shapes.items():
        t = getattr(ep, name)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise SystemExit(f"main path output {name} is malformed or not finite")
    print(f"actions in [{ep.actions.min().item():.3f}, {ep.actions.max().item():.3f}], "
          f"mean reward {ep.rewards.mean().item():.4f}")
    print(json.dumps(bench_row(NUM_ENVS * STEPS / dt, card_line)))

    k_ms, p_ms = times[("dynamics", 8192)]
    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": fused_mlp_forward.source,
        "replaces": fused_mlp_forward.replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
