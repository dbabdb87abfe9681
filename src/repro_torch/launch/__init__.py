"""Command-line entry points of the port."""
from __future__ import annotations

import torch

from repro_torch.core.engine import EulerConfig, from_variant
from repro_torch.numerics import NumericsContext, PrecisionPolicy, load_policy
from repro_torch.numerics.backends import guarded
from repro_torch.reliability.guards import GuardConfig


def pin_exact_f32() -> None:
    """Full-precision float32 contractions on a CUDA card: TF32 off for
    matmuls and cuDNN, ``float32_matmul_precision("highest")``.  The ABFT
    guard's tolerance (``reliability.guards.check_eps``) is calibrated for
    exact f32 check contractions; TF32 in them raises false positives."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def build_numerics(args, width: int | None = None, *,
                   guard: bool = False) -> NumericsContext:
    """The numerics of both launchers.  ``--policy`` (inline JSON or a
    file) wins; otherwise ``--euler`` (a paper variant or "exact") at
    ``width`` (default ``--width``) as a uniform policy.  ``--backend``
    picks the engine for every op, under the ABFT guard when ``guard`` is
    set.  A ``width`` builds a ladder level: always uniform."""
    if args.policy and width is None:
        policy = load_policy(args.policy)
    elif args.euler == "exact":
        policy = PrecisionPolicy.uniform(EulerConfig(mode="exact"))
    else:
        policy = PrecisionPolicy.uniform(
            from_variant(width or args.width, args.euler))
    backend = args.backend
    if guard:
        # record every check, so a summary counts clean checks too (the
        # reference's serving launcher records violations only)
        backend = guarded(backend, GuardConfig(record="full")).name
    return NumericsContext(policy=policy, backend=backend)
