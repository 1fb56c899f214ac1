#!/usr/bin/env python3
"""How close the card's implicit generator step of humanoid_scale's policy
comes to the bound ``chip_smoke.py`` phase 15 (a) holds it to, over
several draws of expert histories.

    env PYTHONPATH=. python3 scripts/diag_torch_implicit_spread.py [--draws 4] [--iters 2]

Needs one NVIDIA GPU. Builds the kernels, then builds
configs/humanoid_scale.yaml's policy on humanoid_stand gan/0's weights on
the card and on the CPU (H=50, 8 members, CG, ``--iters`` iLQR trips) and,
for each draw of 2 expert histories from the committed store's cost
windows (draw i from a generator seeded with 100 + i), runs
``chip_smoke.hold_training_step``: the loss and each component's gradient
card against CPU, within max(1e-3 of its size, twice the CPU's own spread
under the phase's weight and history nudges). Prints each group nearest
its bound and, per draw, the worst group's share of its bound; exits 1
where a draw does not hold.
"""

import argparse
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.bench import card
from gan_mpc_tpu_torch.config import Config
from gan_mpc_tpu_torch.data.windows import cost_windows
from gan_mpc_tpu_torch.ops import _build
from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_kernel
from gan_mpc_tpu_torch.ops.fused_mlp import fused_mlp_backward, fused_mlp_forward
from gan_mpc_tpu_torch.runners import common


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--draws", type=int, default=4)
    parser.add_argument("--iters", type=int, default=cs.G15_CHECK_ITERS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("diag_torch_implicit_spread: no CUDA device", file=sys.stderr)
        return 1
    pin_fp32()
    dev = torch.device("cuda")
    print(card())
    kernels = [fused_mlp_forward, fused_ls_kernel, fused_mlp_backward]
    _build.build_libraries(["fused_mlp_fwd", "fused_ls_step", "fused_mlp_bwd"])
    for k in kernels:
        k.load()
    cfg = Config.from_yaml(cs.G15_CONFIG)
    trajs = common.load_store(cfg, cs.G15_STORE)
    norm = common.build_normalizer(cfg, trajs, "cpu")
    states = norm.normalize_state(torch.tensor(trajs.states))
    ccfg = cfg.replace(mpc__solver__max_iterations=args.iters)
    gpu, cpu = (common.load_saved_params(common.build_policy(ccfg, 29, 12, True, device=d),
                                         cs.G14_STAND) for d in (dev, "cpu"))
    hX_all, _ = cost_windows(states, cfg.mpc.history, cfg.mpc.horizon)
    held = []
    for i in range(1, args.draws + 1):
        t0 = time.perf_counter()
        rng = np.random.default_rng(100 + i)
        hX = hX_all[torch.from_numpy(rng.choice(hX_all.shape[0], cs.G15_CHECK_HISTORIES,
                                                replace=False))]
        held.append(cs.hold_training_step(
            f"draw {i} (iLQR <= {args.iters})", cs.implicit_loss_and_grads, gpu, cpu,
            (hX.to(dev),), (hX,), 1e-3, lambda name: name.split("[")[0], True))
        print(f"  draw {i}: {time.perf_counter() - t0:.1f} s")
    print(f"{sum(held)} of {len(held)} draws held")
    return 0 if all(held) else 1


if __name__ == "__main__":
    sys.exit(main())
