#!/usr/bin/env python3
"""Where the fused-MLP backward kernel spends its clocks, phase by phase.

    env PYTHONPATH=. python3 scripts/diag_torch_bwd_phases.py [rows ...]

Builds ``gan_mpc_tpu_torch/csrc/fused_mlp_bwd.cu`` with ``-DBWD_CLOCKS``
(the first consumer thread of block 0 then stamps its SM's clock after
every phase of every tile it walks), launches it on the dynamics stack at
each row count (default 128, 512 and 8192) and prints, per tile of block
0, the clocks between stamps: the tile's loads, each recompute layer, and
dW and the chain step of each layer from the last down, with the card's
name and power limit, and before that the profiler's device time of the
two kernels of a call (the backward and the sum of the blocks' slices).
The stamps cost a few clocks each; the kernel without them is what
``chip_smoke.py`` times.
"""

import ctypes
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.bench import card
from gan_mpc_tpu_torch.ops import _build
from gan_mpc_tpu_torch.ops.fused_mlp import FusedMlpBwdKernel

DYNAMICS = [23, 200, 200, 200, 17]


def main() -> int:
    if not torch.cuda.is_available():
        print("diag_torch_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    pin_fp32()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "fused_mlp_bwd-clocks.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DBWD_CLOCKS", "-o", str(lib_path),
           str(_build.CSRC_DIR / "fused_mlp_bwd.cu")]
    subprocess.run(cmd, check=True, capture_output=True)
    # a wrapper of its own that loads the stamped build
    _build.load_library = lambda name: ctypes.CDLL(str(lib_path))
    kernel = FusedMlpBwdKernel()
    lib = kernel.load()
    lib.fused_mlp_bwd_clocks.argtypes = [ctypes.c_void_p]
    lib.fused_mlp_bwd_clocks.restype = ctypes.c_int

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    draw = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                       device=dev)
    layers = [(draw(a, b) / a ** 0.5, 0.1 * draw(b)) for a, b in zip(DYNAMICS[:-1], DYNAMICS[1:])]
    L = len(layers)
    names = (["loads"] + [f"recompute {l}" for l in range(L - 1)]
             + [f"{kind} {l}" for l in reversed(range(L)) for kind in ("dW", "chain")])
    print(card())
    for rows in [int(a) for a in sys.argv[1:]] or [128, 512, 8192]:
        x, g = draw(rows, DYNAMICS[0]), draw(rows, DYNAMICS[-1])
        for _ in range(3):
            kernel(x, layers, g)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kernel(x, layers, g)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "kernel" in e.key:
                print(f"rows={rows}: {e.key[:90]} {e.count} launches, "
                      f"{e.device_time_total / e.count:.2f} us each (profiler)")
        stamps = (ctypes.c_longlong * 256)()
        n = lib.fused_mlp_bwd_clocks(stamps)
        if n < 2:
            raise SystemExit(f"no stamps (code {n})")
        t = np.array(stamps[:n])
        per_tile = len(names)
        print(f"rows={rows}: block 0 walked {(n - 1) // per_tile} tiles, "
              f"{t[-1] - t[0]} clocks from its first stamp to its last")
        for tile in range((n - 1) // per_tile):
            d = np.diff(t[tile * per_tile: (tile + 1) * per_tile + 1])
            print(f"  tile {tile}: " + ", ".join(f"{k} {v}" for k, v in zip(names, d))
                  + f"; sum {d.sum()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
