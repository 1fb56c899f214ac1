"""Data parallelism across cards over NCCL, one rank per card: the path
``chip_smoke.py`` phase 18 (d) runs where the host has two or more cards,
and what it is held against.

    env PYTHONPATH=. python3 scripts/multicard_data_parallel.py

On a host with N >= 2 cards (up to 4 used):
  1. phase 18 (b)'s fused GAN epoch of configs/gan_pendulum_rung5b.yaml
     (``chip_smoke.G18_CUTS``) in one process on cuda:0 and under the
     parameter nudges (``chip_smoke.epoch_reference`` and
     ``nudged_epoch``), then in mesh mode on one rank per card over NCCL,
     held within twice the single process's spread
     (``chip_smoke.hold_epoch``); each rank's wall time;
  2. the data-parallel run of that config on cuda:0..N-1 (the runners'
     default devices, NCCL), interrupted and resumed, against the one-rank
     run (``chip_smoke.dp_run_check``);
  3. ``tests/test_torch_device_guard.py``: the kernels fed cuda:1 tensors
     with cuda:0 current.
Prints the card and its power limit first; exits non-zero on a host with
fewer than two cards or on any failed check.
"""

import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs


def main() -> int:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        print(f"multicard_data_parallel: {count} CUDA devices, needs two or more",
              file=sys.stderr)
        return 1
    from gan_mpc_tpu_torch import pin_fp32
    from gan_mpc_tpu_torch.bench import card
    from gan_mpc_tpu_torch.ops import _build
    from gan_mpc_tpu_torch.parallel.checks import fused_epoch_on_ranks

    pin_fp32()
    t_start = time.perf_counter()
    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} count {count}")
    _build.build_libraries(["fused_mlp_fwd", "fused_ls_step", "fused_mlp_bwd"])
    dev = torch.device("cuda:0")
    devices = [f"cuda:{i}" for i in range(min(count, 4))]
    with tempfile.TemporaryDirectory() as workdir:
        cfg = cs.g18_config(workdir)
        ref = cs.epoch_reference(cfg, dev, "one process")
        ref = cs.nudged_spread(cfg, ref, [cs.nudged_epoch(dev, ref["case"], s)
                                          for s in cs.G18_NUDGES], dev)
        print(f"the fused GAN epoch in one process on {dev}: {ref['seconds']:.3f} s; launches "
              f"{ref['single']['launches']}")
        t0 = time.perf_counter()
        across = fused_epoch_on_ranks(ref["case"], devices, cs.G18_TIMEOUT)
        print(f"the fused GAN epoch in mesh mode over NCCL on {devices}: "
              f"{time.perf_counter() - t0:.1f} s with the spawn; rank 0's launches "
              f"{across['launches']}")
        cs.hold_epoch("NCCL across cards against one process", across, ref["single"],
                      ref["nudged"])
        cs.dp_run_check(cfg, devices, ref, dev, workdir, "across cards:")
    # the repo's conftest imports JAX, which this path does not need
    guard = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rs", "--noconftest",
                            "-p", "no:cacheprovider",
                            "tests/test_torch_device_guard.py"], capture_output=True, text=True)
    print("tests/test_torch_device_guard.py: " + guard.stdout.strip().splitlines()[-1])
    if guard.returncode != 0:
        print(guard.stdout[-3000:])
        return 1
    print(f"multicard_data_parallel total wall time {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
