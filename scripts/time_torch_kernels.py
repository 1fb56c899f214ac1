#!/usr/bin/env python3
"""Time the port's CUDA kernels and bf16 instances in one or several trees, on one card.

    python3 scripts/time_torch_kernels.py                 # this tree
    python3 scripts/time_torch_kernels.py --check         # errors first
    python3 scripts/time_torch_kernels.py --trees runs/parent . . runs/parent

Times of different processes on different cards do not compare, so two
versions are timed in turns on one card: ``--trees`` starts one process
per tree in the given order (each builds its own kernels from its own
``gan_mpc_tpu_torch/csrc``), e.g. a ``git archive`` of the parent commit
unpacked under the gitignored ``runs/``, then this tree twice, then the
parent again. Each process prints one JSON line: the card, and per kernel
and shape the kernel's and the plain version's time (CUDA events, median
of 21 runs of 20 back-to-back launches, as ``chip_smoke.py`` phase 3).
The shapes and helpers come from the ``chip_smoke.py`` beside this
script, so every tree is timed at the same shapes; the kernels from the
tree the process runs in. The bf16 instances are timed at phase 16 (a)'s
shapes (``BF16_CHECKS``) and at ``EXTRA_CHECKS``, against the plain bf16
version. With ``--check`` it first prints every shape's max|d| against the
plain version without stopping at a disagreement (for the bf16 instances
also the share of entries beyond 1e-4, which phase 16 holds to 2%), which
is the quick look after a kernel was edited.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# beyond chip_smoke.py's shapes: odd widths on the 64-row tile, and the
# widest stack the kernels take (16-row tiles at any row count)
EXTRA_CHECKS = [
    ("odd", [23, 41, 17], 8192),
    ("widest", [23, 512, 512, 17], 300), ("widest", [23, 512, 512, 17], 8192),
]


def bf16_cases(cs, dev):
    """(kernel name, shape, rows, run(instance), plain()) for the bf16
    instances at phase 16 (a)'s shapes and the forward at EXTRA_CHECKS."""
    import numpy as np
    import torch

    from gan_mpc_tpu_torch.ops.fused_ls import (
        fused_ls_kernel_bf16, reference_ls_step,
    )
    from gan_mpc_tpu_torch.ops.fused_mlp import fused_mlp_forward_bf16, reference_forward

    rng = np.random.default_rng(cs.SEED + 16)
    shapes = list(cs.BF16_CHECKS) + [("fused_mlp_fwd", name, rows, widths, 0)
                                     for name, widths, rows in EXTRA_CHECKS]
    for i, (kind, name, rows, *shape) in enumerate(shapes):
        if kind == "fused_ls_step":
            alphas, n, m, gs, offset = shape
            args = cs.ls_args(rows, alphas, n, m, gs, cs.LS_WEIGHTS[3], 1600 + i, dev, offset)
            yield (fused_ls_kernel_bf16, name, rows * alphas,
                   lambda k, args=args: k(**args),
                   lambda args=args: reference_ls_step(**args, bf16=True))
        else:
            widths, offset = shape
            layers = cs.offset_layers(cs.random_layers(widths, 1600 + i, dev), offset)
            x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                             device=dev)
            yield (fused_mlp_forward_bf16, f"{name} {widths}", rows,
                   lambda k, x=x, layers=layers: k(x, layers),
                   lambda x=x, layers=layers: reference_forward(x, layers, True))


def one_tree(check: bool) -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from gan_mpc_tpu_torch import pin_fp32
    from gan_mpc_tpu_torch.bench import card
    from gan_mpc_tpu_torch.ops.fused_ls import fused_ls_kernel, reference_ls_step
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        fused_mlp_backward, fused_mlp_forward, reference_backward, reference_forward,
    )

    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    pin_fp32()
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    draw = lambda rows, width: torch.tensor(rng.standard_normal((rows, width)),
                                            dtype=torch.float32, device=dev)
    out = {"tree": os.getcwd(), "card": card(), "times": []}
    with torch.no_grad():
        if check:
            for i, (name, widths, rows) in enumerate(list(cs.CHECKS) + EXTRA_CHECKS):
                layers = cs.random_layers(widths, i, dev)
                x = draw(rows, widths[0])
                got, ref = fused_mlp_forward(x, layers), reference_forward(x, layers)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                tol = 1e-4 * max(1.0, ref.abs().max().item())
                print(f"check fused_mlp_fwd {name} {widths} rows={rows}: max|d|={err:.3e} "
                      f"bound={tol:.3e} {'ok' if err <= tol else 'DISAGREES'}", flush=True)
            for i, (name, lanes, alphas, n, m, gs) in enumerate(cs.LS_CHECKS):
                args = cs.ls_args(lanes, alphas, n, m, gs, cs.LS_WEIGHTS[i % 5], 100 * i, dev)
                got, ref = fused_ls_kernel(**args), reference_ls_step(**args)
                torch.cuda.synchronize()
                errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
                tols = [1e-4 * max(1.0, r.abs().max().item()) for r in ref]
                ok = all(e <= t for e, t in zip(errs, tols))
                print(f"check fused_ls_step {name} {lanes}x{alphas} n={n} m={m}: max|d| "
                      f"nx/u/cost {errs} {'ok' if ok else 'DISAGREES'}", flush=True)
            for i, (name, widths, rows) in enumerate(cs.BWD_CHECKS):
                layers = cs.random_layers(widths, 200 + i, dev)
                x, _ = cs.clear_of_kinks(rng, rows, layers, dev)
                g = draw(rows, widths[-1])
                got, ref = fused_mlp_backward(x, layers, g), reference_backward(x, layers, g)
                torch.cuda.synchronize()
                flat = lambda out: [out[0]] + [t for pair in out[1] for t in pair]
                shares = [(k - r).abs().max().item() / (1e-4 * max(1.0, r.abs().max().item()))
                          for k, r in zip(flat(got), flat(ref))]
                print(f"check fused_mlp_bwd {name} {widths} rows={rows}: max|d| of dx, dW0, "
                      f"db0, ... as shares of 1e-4 max(1, max|ref|) "
                      f"{[round(v, 4) for v in shares]} "
                      f"{'ok' if max(shares) <= 1.0 else 'DISAGREES'}", flush=True)
            for kernel, shape, rows, run, plain in bf16_cases(cs, dev):
                got, ref = run(kernel), plain()
                got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
                torch.cuda.synchronize()
                errs = [(g - r).abs().max().item() / max(1.0, r.abs().max().item())
                        for g, r in zip(got, ref)]
                far = [((g - r).abs() > 1e-4).float().mean().item() for g, r in zip(got, ref)]
                ok = max(errs) <= cs.BF16_TOL and max(far) <= cs.BF16_FAR_SHARE
                print(f"check {kernel.name} {shape} rows={rows}: max|d| / max(1, max|ref|) "
                      f"{[f'{e:.3e}' for e in errs]}, beyond 1e-4 "
                      f"{[f'{100 * f:.3f}%' for f in far]} {'ok' if ok else 'DISAGREES'}",
                      flush=True)
        for i, (name, widths, rows) in enumerate(cs.TIMED):
            layers = cs.random_layers(widths, 100 + i, dev)
            x = draw(rows, widths[0])
            out["times"].append({
                "kernel": "fused_mlp_fwd", "shape": name, "rows": rows,
                "ms": cs.device_ms(lambda: fused_mlp_forward(x, layers)),
                "plain_ms": cs.device_ms(lambda: reference_forward(x, layers))})
        for i, (name, lanes, alphas, n, m, gs) in enumerate(cs.LS_TIMED):
            args = cs.ls_args(lanes, alphas, n, m, gs, cs.LS_WEIGHTS[0], 900 + i, dev)
            out["times"].append({
                "kernel": "fused_ls_step", "shape": name, "rows": lanes * alphas,
                "ms": cs.device_ms(lambda: fused_ls_kernel(**args)),
                "plain_ms": cs.device_ms(lambda: reference_ls_step(**args))})
        for i, (name, widths, rows) in enumerate(cs.BWD_TIMED):
            layers = cs.random_layers(widths, 300 + i, dev)
            x, g = draw(rows, widths[0]), draw(rows, widths[-1])
            out["times"].append({
                "kernel": "fused_mlp_bwd", "shape": name, "rows": rows,
                "ms": cs.device_ms(lambda: fused_mlp_backward(x, layers, g)),
                "plain_ms": cs.device_ms(lambda: reference_backward(x, layers, g))})
        for kernel, shape, rows, run, plain in bf16_cases(cs, dev):
            out["times"].append({
                "kernel": kernel.name, "shape": shape, "rows": rows,
                "ms": cs.device_ms(lambda: run(kernel)), "plain_ms": cs.device_ms(plain)})
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="print each shape's error against the plain version first")
    ap.add_argument("--trees", nargs="+", help="run one process per tree, in this order")
    args = ap.parse_args()
    if not args.trees:
        return one_tree(args.check)
    script = os.path.abspath(__file__)
    worst = 0
    for tree in args.trees:
        cmd = [sys.executable, script] + (["--check"] if args.check else [])
        worst = max(worst, subprocess.run(cmd, cwd=tree).returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main())
