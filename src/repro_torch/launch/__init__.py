"""Command-line entry points of the port."""
from __future__ import annotations

import torch


def pin_exact_f32() -> None:
    """Full-precision float32 contractions on a CUDA card: TF32 off for
    matmuls and cuDNN, ``float32_matmul_precision("highest")``.  The ABFT
    guard's tolerance (``reliability.guards.check_eps``) is calibrated for
    exact f32 check contractions; TF32 in them raises false positives."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
