"""PyTorch / CUDA port of ``gan_mpc_tpu`` for NVIDIA Hopper.

Same module layout and names as the JAX package (``ops/``, ``models/``,
``planner/``, ``envs/``, ``data/``, ``policies/``). Imports torch and
numpy only. The batched closed-loop MPC control path runs here; see
``ROADMAP.md`` for what is still to be ported.
"""

import torch


def pin_fp32() -> None:
    """Full-f32 matmuls and convolutions (no TF32), as the JAX reference
    runs at matmul precision "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
