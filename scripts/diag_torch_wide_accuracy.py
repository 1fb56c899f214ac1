#!/usr/bin/env python3
"""How far the kernels' wide path lies from the plain version on the widest
stacks, and how far the plain version lies from float64.

    python3 scripts/diag_torch_wide_accuracy.py
    cd runs/parent && python3 ../../scripts/diag_torch_wide_accuracy.py

The kernels come from the tree the process runs in (a ``git archive`` of
another commit unpacked under the gitignored ``runs/``, say), the shapes
and helpers from the ``chip_smoke.py`` beside this script. Per stack of
``STACKS``: the forward at 512 and 8192 rows and the line-search step at
512 x 16 (the dynamics' hidden widths the stack's), and the backward at
8192 rows on rows cleared of relu kinks (``chip_smoke.clear_of_kinks``,
the redrawn rows alone), every output as a share of phase 19's bound, 1e-4
max(1, max|plain|): kernel against plain (the check ``chip_smoke.py``
makes), kernel against float64 and plain against float64. A call the tree
cannot make is printed with its error. Exits 1 without a CUDA device.
"""

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACKS = [[23, 4096, 4096, 4096, 17], [23, 8192, 17], [23] + [8192] * 4 + [17]]


def shares(got, plain, exact):
    """(kernel - plain, kernel - f64, plain - f64), each over 1e-4 max(1, max|plain|)."""
    tol = 1e-4 * max(1.0, plain.abs().max().item())
    return ((got - plain).abs().max().item() / tol,
            (got.double() - exact).abs().max().item() / tol,
            (plain.double() - exact).abs().max().item() / tol)


def fmt(v):
    return "kernel-plain {:.3f}, kernel-f64 {:.3f}, plain-f64 {:.3f}".format(*v)


def main() -> int:
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
        print("diag_torch_wide_accuracy: no CUDA device", file=sys.stderr)
        return 1
    pin_fp32()
    dev = torch.device("cuda")
    print(f"tree {os.getcwd()}; {card()}", flush=True)
    for i, widths in enumerate(STACKS):
        layers = cs.random_layers(widths, 2300 + i, dev)
        wide = [(w.double(), b.double()) for w, b in layers]
        rng = np.random.default_rng(2300 + i)
        with torch.no_grad():
            for rows in (512, 8192):
                x = torch.tensor(rng.standard_normal((rows, widths[0])), dtype=torch.float32,
                                 device=dev)
                v = shares(fused_mlp_forward(x, layers), reference_forward(x, layers),
                           reference_forward(x.double(), wide))
                print(f"{widths} forward rows={rows}: {fmt(v)}", flush=True)
            args = cs.ls_args(512, 16, 17, 6, 17, cs.LS_WEIGHTS[3], 2300 + i, dev,
                              hidden=widths[1:-1])
            got, plain = fused_ls_kernel(**args), reference_ls_step(**args)
            far = [(g - p).abs().max().item() / (1e-4 * max(1.0, p.abs().max().item()))
                   for g, p in zip(got, plain)]
            print(f"{widths} step 512x16 (nx, u, cost kernel-plain): "
                  + ", ".join(f"{v:.3f}" for v in far), flush=True)
            del args, got, plain
        x, _ = cs.clear_of_kinks(rng, 8192, layers, dev)
        g = torch.tensor(rng.standard_normal((8192, widths[-1])), dtype=torch.float32, device=dev)
        flat = lambda out: [out[0]] + [t for pair in out[1] for t in pair]  # noqa: E731
        try:
            got = flat(fused_mlp_backward(x, layers, g))
            torch.cuda.synchronize()
        except (RuntimeError, torch.OutOfMemoryError) as e:
            print(f"{widths} backward rows=8192: {str(e).splitlines()[0][:160]}", flush=True)
            torch.cuda.empty_cache()
            continue
        plain = flat(reference_backward(x, layers, g))
        exact = flat(reference_backward(x.double(), wide, g.double()))
        names = ["dx"] + [f"{k}{l}" for l in range(len(layers)) for k in ("dW", "db")]
        for name, k, p, e in zip(names, got, plain, exact):
            print(f"{widths} backward rows=8192 {name}: {fmt(shares(k, p, e))}", flush=True)
        del got, plain, exact, wide
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
