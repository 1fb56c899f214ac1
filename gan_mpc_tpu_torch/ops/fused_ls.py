"""Fused line-search / rollout step of the batch iLQR solver.

Counterpart of ``gan_mpc_tpu/ops/fused_ls.py``. One forward-scan step over
(B lanes, A step sizes), row ``b * A + a``:

    u    = Uref + alpha * k + K (x - Xref)          (control law)
    nx   = x + MLP([x, u])                          (residual dynamics)
    cost = w_u sn(u) + w_x sn(x[:gs] - goal)
           + w_ag ag(u - gain * goal_u)             (stage cost)

with ``wvec = [w_u, w_x, w_ag, gain]`` from ``MPCCost.stage_weights``. The
same step serves the line search (A step sizes per lane), the winner
recompute (A = 1, each lane's own step size) and the plain rollout
(alpha = 0, k = 0, K = 0, Xref = x).

The dynamics stack comes with W0 split into its state rows and its
action rows (``split_w0``, once per plan), as the TPU kernel takes it:
``[((W0x (n, h), W0u (m, h)), b0), (W1, b1), ...]``.

``fused_ls_step`` dispatches by device: a CPU tensor runs
``reference_ls_step`` (plain torch, the tests' path); a CUDA tensor always
launches the hand-written kernel ``csrc/fused_ls_step.cu`` (at any B and
A, the JAX package's ``B % 128`` condition being a TPU tile rule, and any
dynamics stack: one the shared-memory tile does not take runs the
kernel's wide path, ``ops.fused_mlp.fwd_route``) or raises. There is no
fallback from the kernel to the plain version.

``bf16=True`` is the TPU kernel's bf16 variant (``compute_dtype=
"bfloat16"``): the MLP's four products (W0's state and action rows, the
hidden layers, the last layer) take bfloat16 operands and accumulate in
f32 (``bf16_mm``); the control law, the stage cost and the residual add
stay f32. On CUDA tensors it launches the kernel's bf16 instance
(``fused_ls_kernel_bf16``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from gan_mpc_tpu_torch.models.cost import pseudo_huber
from gan_mpc_tpu_torch.ops.fused_mlp import (
    WORKSPACE_ARGS,
    Layers,
    bf16_mm,
    call_with_workspace,
    last_wide_launch,
)


def split_w0(layers: Layers, n: int) -> list:
    """The dynamics stack with W0 split into its first ``n`` (state) rows
    and the rest (action rows); views, no copy."""
    (w0, b0), rest = layers[0], list(layers[1:])
    return [((w0[:n], w0[n:]), b0)] + rest


def reference_ls_step(x3, Xref, Uref, alphaBA, k, K, goal, goal_u, wvec,
                      layers: Sequence, *, gs: int, action_goal_squared: bool,
                      ag_scale: float, bf16: bool = False):
    """Plain torch version of the step, the kernel's reference.

    x3 (B, A, n); Xref (B, n); Uref, k (B, m); alphaBA (B, A); K (B, m, n);
    goal (B, gs); goal_u (B, m); wvec (1, 4); ``layers`` as ``split_w0``
    returns them. Returns nx (B, A, n), u (B, A, m), cost (B, A). With
    ``bf16`` the MLP's products are ``bf16_mm``'s.
    """
    mm = bf16_mm if bf16 else torch.matmul
    B, A, n = x3.shape
    m = Uref.shape[-1]
    du = torch.einsum("bmn,ban->bam", K, x3 - Xref[:, None])
    u = Uref[:, None] + alphaBA[..., None] * k[:, None] + du

    (w0x, w0u), b0 = layers[0]
    h = mm(x3.reshape(B * A, n), w0x) + mm(u.reshape(B * A, m), w0u) + b0
    for w, b in layers[1:]:
        h = mm(torch.relu(h), w) + b
    nx = x3 + h.reshape(B, A, n)

    w_u, w_x, w_ag, gain = wvec.reshape(4)
    cost = w_u * pseudo_huber(u) + w_x * pseudo_huber(x3[..., :gs] - goal[:, None])
    dug = u - gain * goal_u[:, None]
    if action_goal_squared:
        ag = ag_scale * torch.sum(dug * dug, -1)
    else:
        ag = ag_scale * pseudo_huber(dug)
    return nx, u, cost + w_ag * ag


class FusedLsKernel:
    """One instance of the CUDA step kernel, f32 or ``bf16``: built on
    first use. ``launches`` counts the calls that launch the kernel on the
    device: a call over 0 rows (B * A = 0) launches nothing and counts
    nothing."""

    source = "gan_mpc_tpu_torch/csrc/fused_ls_step.cu"
    replaces = "gan_mpc_tpu/ops/fused_ls.py:118"

    def __init__(self, bf16: bool = False):
        self.bf16 = bf16
        self.name = "fused_ls_step_bf16" if bf16 else "fused_ls_step"
        self.launches = 0
        self._lib = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            from gan_mpc_tpu_torch.ops._build import load_library

            lib = load_library("fused_ls_step")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.fused_ls_step.argtypes = (
                [p] * 12 + [i] * 6 + [ctypes.c_float, i, ctypes.POINTER(i),
                                      ctypes.POINTER(p), p, ctypes.POINTER(p), i,
                                      *WORKSPACE_ARGS, p]
            )
            lib.fused_ls_step.restype = i
            lib.fused_ls_step_wide_launch.argtypes = [ctypes.POINTER(i)]
            self._lib = lib
        return self._lib

    def wide_launch(self) -> dict:
        """The library's last wide-path launch (``ops.fused_mlp.
        last_wide_launch``; both instances share it)."""
        return last_wide_launch(self.load().fused_ls_step_wide_launch)

    def __call__(self, x3, Xref, Uref, alphaBA, k, K, goal, goal_u, wvec, layers,
                 *, gs: int, action_goal_squared: bool, ag_scale: float):
        inputs = (x3, Xref, Uref, alphaBA, k, K, goal, goal_u, wvec)
        _check_kernel_args(inputs, layers, gs)
        lib = self.load()
        B, A, n = x3.shape
        m = Uref.shape[-1]
        nx = torch.empty_like(x3)
        u = torch.empty((B, A, m), device=x3.device, dtype=x3.dtype)
        cost = torch.empty((B, A), device=x3.device, dtype=x3.dtype)
        (w0x, w0u), b0 = layers[0]
        ws = [w0x] + [w for w, _ in layers[1:]]
        bs = [b0] + [b for _, b in layers[1:]]
        dims = [n + m] + [w.shape[1] for w in ws]
        c_dims = (ctypes.c_int * len(dims))(*dims)
        c_w = (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])
        c_b = (ctypes.c_void_p * len(bs))(*[b.data_ptr() for b in bs])
        # the library launches on the current device: make it the operands'
        with torch.cuda.device(x3.device):
            stream = torch.cuda.current_stream(x3.device).cuda_stream
            err = call_with_workspace(lib.fused_ls_step, (
                *[t.data_ptr() for t in inputs], nx.data_ptr(), u.data_ptr(), cost.data_ptr(),
                B, A, n, m, gs, int(action_goal_squared), float(ag_scale),
                len(ws), c_dims, c_w, w0u.data_ptr(), c_b, int(self.bf16)), x3.device, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} launch failed with code {err} "
                f"(B={B}, A={A}, n={n}, m={m}, dims={dims})"
            )
        if B * A:
            self.launches += 1
        return nx, u, cost


def _check_kernel_args(inputs, layers, gs: int) -> None:
    x3, Xref, Uref, alphaBA, k, K, goal, goal_u, wvec = inputs
    if not x3.is_cuda:
        raise ValueError("the fused line-search kernel takes CUDA tensors only")
    if x3.dim() != 3:
        raise ValueError(f"x3 must be (B, A, n), got {tuple(x3.shape)}")
    B, A, n = x3.shape
    m = Uref.shape[-1] if Uref.dim() == 2 else -1
    expected = {
        "Xref": (Xref, (B, n)), "Uref": (Uref, (B, m)), "alphaBA": (alphaBA, (B, A)),
        "k": (k, (B, m)), "K": (K, (B, m, n)), "goal": (goal, (B, gs)),
        "goal_u": (goal_u, (B, m)), "wvec": (wvec, (1, 4)),
    }
    if not 0 <= gs <= n:
        raise ValueError(f"gs={gs} must lie in [0, n={n}]")
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    (w0x, w0u), b0 = layers[0]
    ws = [w0x, w0u] + [w for w, _ in layers[1:]]
    bs = [b0] + [b for _, b in layers[1:]]
    for t in (*inputs, *ws, *bs):
        if t.device != x3.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"every argument must be a contiguous float32 tensor on {x3.device}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}"
            )
    h = w0x.shape[1]
    if w0x.shape != (n, h) or w0u.shape != (m, h) or b0.shape != (h,):
        raise ValueError(
            f"W0 must be split into ({n}, h) state rows and ({m}, h) action rows, "
            f"got {tuple(w0x.shape)}, {tuple(w0u.shape)}, b0 {tuple(b0.shape)}"
        )
    width = h
    for i, (w, b) in enumerate(layers[1:], start=1):
        if w.dim() != 2 or w.shape[0] != width or b.shape != (w.shape[1],):
            raise ValueError(
                f"layer {i}: W {tuple(w.shape)} / b {tuple(b.shape)} do not chain "
                f"from width {width}"
            )
        width = w.shape[1]
    if width != n:
        raise ValueError(f"the stack ends at width {width}, not the state's {n}")
    if min([h] + [w.shape[1] for w, _ in layers[1:]]) < 1:
        raise ValueError("every layer must be at least 1 wide")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*inputs, *ws, *bs)):
        raise NotImplementedError(
            "the fused line-search step has no backward (neither has the TPU "
            "kernel); run it under torch.no_grad()"
        )


fused_ls_kernel = FusedLsKernel()
fused_ls_kernel_bf16 = FusedLsKernel(bf16=True)


def fused_ls_step(x3, Xref, Uref, alphaBA, k, K, goal, goal_u, wvec, layers, *,
                  gs: int, action_goal_squared: bool, ag_scale: float,
                  bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused line-search / rollout step; shapes as ``reference_ls_step``.

    CPU tensors run ``reference_ls_step``; CUDA tensors run the kernel at
    every B and A, its bf16 instance where ``bf16`` (``compute_dtype=
    "bfloat16"``).
    """
    kw = dict(gs=gs, action_goal_squared=action_goal_squared, ag_scale=ag_scale)
    if x3.is_cuda:
        kernel = fused_ls_kernel_bf16 if bf16 else fused_ls_kernel
        return kernel(x3, Xref, Uref, alphaBA, k, K, goal, goal_u, wvec, layers, **kw)
    return reference_ls_step(x3, Xref, Uref, alphaBA, k, K, goal, goal_u, wvec, layers, **kw,
                             bf16=bf16)
