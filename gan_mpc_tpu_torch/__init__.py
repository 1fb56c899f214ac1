"""PyTorch / CUDA port of ``gan_mpc_tpu`` for NVIDIA Hopper.

Same module layout and names as the JAX package (``ops/``, ``models/``,
``planner/``, ``envs/``, ``data/``, ``policies/``). Imports torch and
numpy only. The batched closed-loop MPC control path runs here; see
``ROADMAP.md`` for what is still to be ported.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``. The entry points run on the card
    unless the caller asks for the CPU, so naming CUDA on a host without a
    card raises here rather than failing later or running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for (the default), but this host has no "
            "CUDA device; pass device='cpu' to run on the CPU"
        )
    return device


def pin_fp32() -> None:
    """Full-f32 matmuls and convolutions (no TF32), as the JAX reference
    runs at matmul precision "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
