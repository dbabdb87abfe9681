"""Mixed per-layer posit precision through the unified numerics API.

    python -m repro_torch.examples.mixed_precision [--device cpu]

The paper's headline feature is a precision-RECONFIGURABLE datapath: one
SIMD engine runs 4xPosit-8, 2xPosit-16 or 1xPosit-32.  A
``PrecisionPolicy`` is that knob in software: here one model runs Posit-8
attention, Posit-16 MLPs and an exact FP32 LM head, through BOTH execution
backends (the reference engine, ``lax_ref``, and the kernels, ``cuda``)
with matching outputs.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch import numerics as N
from repro_torch.core.engine import EulerConfig, from_variant
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model

from . import cli, device_of

CFG = ModelConfig(name="mixed", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                  loss_chunk=32, q_chunk=32, kv_chunk=32)

# P8 attention + P16 MLP + exact head: three widths in one forward pass
POLICY = (N.PrecisionPolicy.uniform(from_variant(16, "L-21b"))
          .with_rule("*attn*", from_variant(8, "L-21b"))
          .with_rule("*head*", EulerConfig(mode="exact")))


def run(device="cuda") -> dict:
    dev = device_of(str(device))
    policy = POLICY
    print("policy resolution:")
    for path, op in [("attn", "qk"), ("attn", "matmul"), ("mlp", "matmul"),
                     ("head", "matmul")]:
        cfg = policy.resolve(path, op)
        print(f"  {path:5s}/{op:7s} -> {cfg.mode:>6s}"
              + (f" posit{cfg.width}" if cfg.mode != "exact" else ""))

    model = Model(CFG, numerics=N.NumericsContext(policy=policy), device=dev)
    params = model.init(0)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, CFG.vocab, (2, 32)), device=dev)

    logits = {}
    with torch.no_grad():
        for backend in ("lax_ref", "cuda"):
            ctx = Ctx(numerics=N.NumericsContext(policy=policy,
                                                 backend=backend))
            h, _ = model.forward(params, ids, ctx)
            logits[backend] = model.head(params, h, ctx)

        diff = float((logits["lax_ref"] - logits["cuda"]).abs().max())
        print(f"\nlax_ref vs cuda max |logit diff|: {diff:.2e}")
        assert diff < 1e-3, diff

        # the policy is live: a uniform-exact run must differ from the mixed
        exact_ctx = Ctx(ecfg=EulerConfig(mode="exact"))
        h, _ = model.forward(params, ids, exact_ctx)
        le = model.head(params, h, exact_ctx)
    live = float((le - logits["lax_ref"]).abs().max())
    assert live > 1e-6, live
    print("mixed-precision output differs from FP32 (policy is active)")

    # policies are plain data: JSON round-trip for configs / CLI flags
    blob = json.dumps(policy.to_dict())
    assert N.PrecisionPolicy.from_dict(json.loads(blob)) == policy
    print(f"policy JSON round-trip OK ({len(blob)} bytes)")
    print("mixed_precision OK")
    return {"diff": diff, "live": live}


def main(argv=None) -> dict:
    return run(cli(__doc__, argv))


if __name__ == "__main__":
    main()
