"""Where the port's fused_mlp_bwd dx disagrees with reference_backward.

    env PYTHONPATH=. python3 scripts/diag_torch_bwd_kinks.py   # needs a CUDA card

For the 8192-row dynamics-stack inputs that ``chip_smoke.py``'s backward
check drew before it kept its rows clear of relu kinks (the same seed
and draw order, without the redraws), and for five more seeds, prints
per call: the rows whose dx error exceeds 1e-4 * max(1, max|ref|), each
row's least |hidden pre-activation| (in f64), and the largest error over
the rows whose pre-activations all sit 1e-4 or more from 0.
"""

import numpy as np
import torch

import chip_smoke as cs
from gan_mpc_tpu_torch import pin_fp32
from gan_mpc_tpu_torch.ops.fused_mlp import fused_mlp_backward, reference_backward


def analyse(tag, x, g, layers):
    dx, _ = fused_mlp_backward(x, layers, g)
    rdx, _ = reference_backward(x, layers, g)
    err = (dx - rdx).abs().max(1).values
    tol = 1e-4 * max(1.0, rdx.abs().max().item())
    h = x.double()
    zmin = torch.full((x.shape[0],), float("inf"), device=x.device, dtype=torch.float64)
    for w, b in layers[:-1]:
        z = h @ w.double() + b.double()
        zmin = torch.minimum(zmin, z.abs().min(1).values)
        h = torch.relu(z)
    bad = (err > tol).nonzero().flatten()
    clear = zmin >= 1e-4
    print(f"{tag}: tol {tol:.3e}, max err {err.max().item():.3e}, rows over tol {bad.numel()}, "
          f"their min|z| {[f'{v:.2e}' for v in zmin[bad].tolist()]}, rows with min|z| < 1e-4 "
          f"{int((~clear).sum())}, max err over rows clear of kinks "
          f"{err[clear].max().item():.3e}")


def main():
    pin_fp32()
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    for _, widths, rows in cs.CHECKS:
        rng.standard_normal((rows, widths[0]))
    for i, (_, widths, rows) in enumerate(cs.BWD_CHECKS[:3]):
        f = lambda n: torch.tensor(rng.standard_normal((rows, n)), dtype=torch.float32,
                                   device=dev)
        x, g = f(widths[0]), f(widths[-1])
        if i == 2:
            analyse("chip_smoke's earlier 8192-row inputs", x, g,
                    cs.random_layers(widths, 200 + i, dev))
    for seed in range(1, 6):
        r = np.random.default_rng(seed)
        x = torch.tensor(r.standard_normal((8192, 23)), dtype=torch.float32, device=dev)
        g = torch.tensor(r.standard_normal((8192, 17)), dtype=torch.float32, device=dev)
        analyse(f"seed {seed}", x, g, cs.random_layers(cs.DYNAMICS, 202, dev))


if __name__ == "__main__":
    main()
