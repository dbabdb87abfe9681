"""Quickstart: the EULER-ADAS engine in five minutes.

    python -m repro_torch.examples.quickstart [--device cpu]

1. posit / bounded-posit quantization
2. the stage-adaptive logarithmic multiplier and its error knobs
3. euler_matmul as a drop-in matmul for any model
4. the kernel path (posit words in, quire value out): the encode and
   logmac kernels on a CUDA card, their plain versions on the CPU
5. the unified numerics API: one call, any precision policy, any backend
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import numerics as N
from repro_torch.core import posit as P
from repro_torch.core.engine import euler_matmul, from_variant
from repro_torch.core.metrics import error_metrics
from repro_torch.kernels import ops

from . import cli, device_of


def run(device="cuda") -> dict:
    dev = device_of(str(device))
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    # --- 1. posit quantization --------------------------------------------
    x = t(rng.normal(size=8))
    for cfg in (P.POSIT16, P.BPOSIT16):
        q = P.quantize(x, cfg)
        print(f"{cfg.name}: max quant err {float((q - x).abs().max()):.2e}")

    # --- 2. the ILM error knobs ---------------------------------------------
    a = t(rng.normal(size=(128, 256)))
    b = t(rng.normal(size=(256, 64)))
    exact = a @ b
    mses = {}
    print("\nvariant  (n, m, bounded)   MSE vs exact matmul")
    for v in ("L-1", "L-2", "L-21", "L-21b"):
        cfg = from_variant(16, v)
        out = euler_matmul(a, b, cfg)
        mses[v] = float(error_metrics(out, exact)["mse"])
        print(f"{v:7s} (n={cfg.stages}, m={cfg.trunc}, b={cfg.bounded})"
              f"   {mses[v]:.3e}")

    # --- 3. drop-in for any model --------------------------------------------
    cfg = from_variant(16, "L-21b")
    w = t(rng.normal(size=(256, 10)))
    logits_exact = torch.log_softmax(a[:, :256] @ w, -1)
    logits_euler = torch.log_softmax(euler_matmul(a[:, :256], w, cfg), -1)
    agree = float((logits_exact.argmax(-1) == logits_euler.argmax(-1))
                  .float().mean())
    print(f"\nargmax agreement exact vs EULER-ADAS: {agree:.1%}")

    # --- 4. the kernels (CUDA on the card, plain versions on the CPU) --------
    pat_a = ops.encode(a[:32, :64].contiguous(), cfg.posit)  # posit words
    pat_b = ops.encode(b[:64, :16].contiguous(), cfg.posit)
    quire_out = ops.logmac_matmul(pat_a, pat_b, cfg)
    ref = euler_matmul(a[:32, :64], b[:64, :16], cfg.replace(pre_scale=False))
    kernel_diff = float((quire_out - ref).abs().max())
    print(f"kernel vs engine max abs diff: {kernel_diff:.2e}")

    # --- 5. the unified numerics API -----------------------------------------
    # One call signature over every backend; precision comes from the active
    # policy, so model code never threads an EulerConfig by hand.
    with N.use(cfg):                     # uniform policy, reference engine
        y_ref = N.matmul(a[:32, :64], b[:64, :16])
    with N.use(cfg, backend="cuda"):     # same call, the kernels
        y_cuda = N.matmul(a[:32, :64], b[:64, :16])
    api_diff = float((y_ref - y_cuda).abs().max())
    print(f"\nnumerics API lax_ref vs cuda: {api_diff:.2e} "
          f"(backends: {', '.join(N.available_backends())})")
    print("\nquickstart OK")
    return {"mse": mses, "agree": agree, "kernel_diff": kernel_diff,
            "api_diff": api_diff}


def main(argv=None) -> dict:
    return run(cli(__doc__, argv))


if __name__ == "__main__":
    main()
