#!/usr/bin/env python3
"""Time the port's CUDA kernels and bf16 instances in one or several trees, on one card.

    python3 scripts/time_torch_kernels.py                 # this tree
    python3 scripts/time_torch_kernels.py --check         # errors first
    python3 scripts/time_torch_kernels.py --trees runs/parent . . runs/parent
    python3 scripts/time_torch_kernels.py --bwd --trees runs/parent . . runs/parent
    python3 scripts/time_torch_kernels.py --wide --trees runs/parent . . runs/parent

Times of different processes on different cards do not compare, so two
versions are timed in turns on one card: ``--trees`` starts one process
per tree in the given order (each builds its own kernels from its own
``gan_mpc_tpu_torch/csrc``), e.g. a ``git archive`` of the parent commit
unpacked under the gitignored ``runs/``, then this tree twice, then the
parent again. Each process prints one JSON line: the card, and per kernel
and shape the kernel's and the plain version's time (CUDA events, median
of 21 runs of 20 back-to-back launches, as ``chip_smoke.py`` phase 3),
with a digest of the forward kernels' outputs (bitwise equal across trees
where the digests agree).
The shapes and helpers come from the ``chip_smoke.py`` beside this
script, so every tree is timed at the same shapes; the kernels from the
tree the process runs in. The bf16 instances are timed at phase 16 (a)'s
shapes (``BF16_CHECKS``) and at ``EXTRA_CHECKS``, against the plain bf16
version. With ``--check`` it first prints every shape's max|d| against the
plain version without stopping at a disagreement (for the bf16 instances
also the share of entries beyond 1e-4, which phase 16 holds to 2%), which
is the quick look after a kernel was edited.

With ``--wide`` it times the forward kernels' wide path alone: the f32
and bf16 forward at every ``G19_FWD`` stack at ``G19_TIMED_ROWS["fwd"]``
and the f32 and bf16 step at ``G19_TIMED_ROWS["ls"]``, each with a digest
of its outputs (so that trees can be held bitwise equal) and the plain
version's time; beside the forwards the cuBLAS chain in f32
(``linear_chain``, which the port never calls).

With ``--bwd`` it times the backward kernel alone: at every backward
shape of PERF.md's kernel table (``BWD_SHAPES``: the committed stacks, on
random weights) with a digest of its outputs, so that trees can be held
bitwise equal; then at phase 19's wide shapes (``G19_BWD`` at
``G19_TIMED_ROWS``, one launch a run at ``G19_BWD_BIG``) with the growth of
the allocator's peak over one call. A call a tree cannot make (the
partial sets, one per SM, of an older tree at 23->8192^4->17) is recorded
with its error. With ``--trees`` the parent process then prints, per shape,
each tree's times and whether the digests agree.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the backward's rows of PERF.md's kernel table: (name, widths, rows)
BWD_SHAPES = [
    ("dynamics", [23, 200, 200, 200, 17], 128), ("dynamics", [23, 200, 200, 200, 17], 512),
    ("dynamics", [23, 200, 200, 200, 17], 8192), ("cost", [17, 128, 128, 10], 128),
    ("gan/9 dynamics", [4, 200, 200, 200, 3], 128), ("gan/4", [23, 256, 256, 256, 17], 128),
    ("walker", [6, 200, 200, 200, 5], 128), ("member", [41, 256, 256, 256, 29], 2),
    ("member", [41, 256, 256, 256, 29], 16), ("member", [41, 256, 256, 256, 29], 128),
    ("LSTM head", [64, 128, 128, 17], 2), ("LSTM head", [64, 128, 128, 17], 128),
]


def bwd_times(cs, dev, draw):
    """``--bwd``: the backward's rows, as the module's docstring says."""
    import torch

    from gan_mpc_tpu_torch.ops.fused_mlp import fused_mlp_backward, reference_backward

    flat = lambda out: [out[0]] + [t for pair in out[1] for t in pair]  # noqa: E731
    rows_out = []
    for i, (name, widths, rows) in enumerate(BWD_SHAPES):
        layers = cs.random_layers(widths, 2100 + i, dev)
        x, g = draw(rows, widths[0]), draw(rows, widths[-1])
        got = flat(fused_mlp_backward(x, layers, g))
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in got)).hexdigest()
        rows_out.append({
            "kernel": "fused_mlp_bwd", "shape": f"{name} {widths}", "rows": rows,
            "digest": digest[:16],
            "ms": cs.device_ms(lambda: fused_mlp_backward(x, layers, g)),
            "plain_ms": cs.device_ms(lambda: reference_backward(x, layers, g))})
    wide = [(s, w, r, False) for s, w in cs.G19_BWD for r in cs.G19_TIMED_ROWS["bwd"]]
    wide += [(s, w, r, True) for s, w, r in cs.G19_BWD_BIG]
    for i, (name, widths, rows, big) in enumerate(wide):
        layers = cs.random_layers(widths, 2200 + i, dev)
        x, g = draw(rows, widths[0]), draw(rows, widths[-1])
        row = {"kernel": "fused_mlp_bwd", "shape": f"wide {name}", "rows": rows}
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = flat(fused_mlp_backward(x, layers, g))
            torch.cuda.synchronize()
            row["peak_extra_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
            row["digest"] = hashlib.sha256(
                b"".join(t.cpu().numpy().tobytes() for t in got)).hexdigest()[:16]
            del got
            timed = (lambda fn: cs.device_ms(fn, launches=1, reps=3)) if big else \
                (lambda fn: cs.device_ms(fn, launches=5, reps=5))
            row["ms"] = timed(lambda: fused_mlp_backward(x, layers, g))
            row["plain_ms"] = timed(lambda: reference_backward(x, layers, g))
        except (RuntimeError, torch.OutOfMemoryError) as e:
            row["error"] = str(e).splitlines()[0][:160]
        torch.cuda.empty_cache()
        rows_out.append(row)
        print(json.dumps(row), flush=True)
    return rows_out


def digest(out) -> str:
    """A short hash of a kernel call's outputs (one tensor or a tuple), so
    that trees can be held bitwise equal."""
    import torch

    out = out if isinstance(out, tuple) else (out,)
    torch.cuda.synchronize()
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in out)).hexdigest()[:16]


def wide_times(cs, dev, draw):
    """``--wide``: the forward kernels' wide path, as the module's
    docstring says."""
    import torch

    from gan_mpc_tpu_torch.ops.fused_ls import (
        fused_ls_kernel, fused_ls_kernel_bf16, reference_ls_step,
    )
    from gan_mpc_tpu_torch.ops.fused_mlp import (
        fused_mlp_forward, fused_mlp_forward_bf16, reference_forward,
    )

    ms = lambda fn: cs.device_ms(fn, launches=5, reps=5)  # noqa: E731
    rows_out = []
    for i, (name, widths) in enumerate(cs.G19_FWD):
        layers = cs.random_layers(widths, 2300 + i, dev)
        lt = [(w.T.contiguous(), b) for w, b in layers]
        for rows in cs.G19_TIMED_ROWS["fwd"]:
            x = draw(rows, widths[0])
            for kernel, bf16 in ((fused_mlp_forward, False), (fused_mlp_forward_bf16, True)):
                row = {"kernel": kernel.name, "shape": f"wide {name}", "rows": rows,
                       "digest": digest(kernel(x, layers)),
                       "ms": ms(lambda: kernel(x, layers)),
                       "plain_ms": ms(lambda: reference_forward(x, layers, bf16))}
                if not bf16:
                    row["cublas_f32_ms"] = ms(lambda: cs.linear_chain(x, lt))
                rows_out.append(row)
                print(json.dumps(row), flush=True)
        for lanes, alphas in cs.G19_TIMED_ROWS["ls"]:
            args = cs.ls_args(lanes, alphas, 17, 6, 17, cs.LS_WEIGHTS[0], 2350 + i, dev,
                              hidden=widths[1:-1])
            for kernel, bf16 in ((fused_ls_kernel, False), (fused_ls_kernel_bf16, True)):
                row = {"kernel": kernel.name, "shape": f"wide {name}", "rows": lanes * alphas,
                       "digest": digest(kernel(**args)),
                       "ms": ms(lambda: kernel(**args)),
                       "plain_ms": ms(lambda: reference_ls_step(**args, bf16=bf16))}
                rows_out.append(row)
                print(json.dumps(row), flush=True)
    return rows_out


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


def one_tree(check: bool, bwd: bool = False, wide: bool = False) -> int:
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
    if bwd or wide:
        with torch.no_grad():
            out["times"] = (bwd_times if bwd else wide_times)(cs, dev, draw)
        print(json.dumps(out), flush=True)
        return 0
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
                "digest": digest(fused_mlp_forward(x, layers)),
                "ms": cs.device_ms(lambda: fused_mlp_forward(x, layers)),
                "plain_ms": cs.device_ms(lambda: reference_forward(x, layers))})
        for i, (name, lanes, alphas, n, m, gs) in enumerate(cs.LS_TIMED):
            args = cs.ls_args(lanes, alphas, n, m, gs, cs.LS_WEIGHTS[0], 900 + i, dev)
            out["times"].append({
                "kernel": "fused_ls_step", "shape": name, "rows": lanes * alphas,
                "digest": digest(fused_ls_kernel(**args)),
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
                "kernel": kernel.name, "shape": shape, "rows": rows, "digest": digest(run(kernel)),
                "ms": cs.device_ms(lambda: run(kernel)), "plain_ms": cs.device_ms(plain)})
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="print each shape's error against the plain version first")
    ap.add_argument("--bwd", action="store_true",
                    help="the backward alone: PERF.md's shapes with digests, phase 19's wide ones")
    ap.add_argument("--wide", action="store_true",
                    help="the forward kernels' wide path alone, phase 19's shapes with digests")
    ap.add_argument("--trees", nargs="+", help="run one process per tree, in this order")
    args = ap.parse_args()
    if not args.trees:
        return one_tree(args.check, args.bwd, args.wide)
    script = os.path.abspath(__file__)
    worst, results = 0, []
    for tree in args.trees:
        cmd = [sys.executable, script] + (["--check"] if args.check else []) \
            + (["--bwd"] if args.bwd else []) + (["--wide"] if args.wide else [])
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        print(proc.stderr[-4000:], end="", file=sys.stderr, flush=True)
        worst = max(worst, proc.returncode)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"tree"')]
        results.append(json.loads(lines[-1]) if lines else {"tree": tree, "times": []})
    # per shape: each tree's times, in the order run, and whether the digests agree
    keys = {(t["kernel"], t["shape"], t["rows"]): None for r in results for t in r["times"]}
    for key in keys:
        runs = [next((t for t in r["times"] if (t["kernel"], t["shape"], t["rows"]) == key), {})
                for r in results]
        digests = {t.get("digest") for t in runs if t.get("digest")}
        print(json.dumps({"kernel": key[0], "shape": key[1], "rows": key[2],
                          "trees": args.trees, "ms": [t.get("ms") for t in runs],
                          "plain_ms": [t.get("plain_ms") for t in runs],
                          "cublas_f32_ms": [t.get("cublas_f32_ms") for t in runs],
                          "peak_extra_mb": [t.get("peak_extra_mb") for t in runs],
                          "errors": [t.get("error") for t in runs],
                          "digests_equal": len(digests) == 1 if digests else None}), flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
