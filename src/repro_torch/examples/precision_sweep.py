"""Mini Table-VI: accuracy of one trained model evaluated under every
EULER-ADAS operating point (post-training quantized inference), plus a
mixed-precision row driven by a PrecisionPolicy.

    python -m repro_torch.examples.precision_sweep [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch import numerics as N
from repro_torch.core.engine import EulerConfig, VARIANT_NAMES, from_variant
from repro_torch.data import SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training import init_state, make_train_step

from . import cli, device_of

CFG = ModelConfig(name="sweep", family="dense", n_layers=2, d_model=128,
                  n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                  loss_chunk=64, q_chunk=64, kv_chunk=64)

POINTS = tuple((w, v) for w in (8, 16, 32) for v in VARIANT_NAMES)


def run(device="cuda", steps: int = 150, points=POINTS,
        eval_batches: int = 3, seq: int = 128) -> dict:
    """Train ``steps`` FP32 steps, then evaluate top-1 under each
    (width, variant) of ``points`` and the mixed policy on the kernels."""
    dev = device_of(str(device))
    model = Model(CFG, EulerConfig(mode="exact"), device=dev)
    ctx = Ctx(ecfg=model.ecfg)
    opt = AdamW(lr=cosine_schedule(3e-3, 20, 150), weight_decay=0.0)
    state = init_state(model, opt, 0)
    step = make_train_step(model, opt, ctx)
    data = SyntheticLM(vocab=CFG.vocab, seed=4)
    print(f"training FP32 reference ({steps} steps)...")
    for i in range(steps):
        state, out = step(state, data.batch(i, 8, seq, device=dev))

    def top1(ecfg_or_policy):
        if isinstance(ecfg_or_policy, N.PrecisionPolicy):
            policy = ecfg_or_policy
        else:
            policy = N.PrecisionPolicy.uniform(ecfg_or_policy)
        # inference on the kernels (their plain versions on the CPU)
        nctx = N.NumericsContext(policy=policy, backend="cuda")
        m = Model(CFG, numerics=nctx, device=dev)
        c = Ctx(numerics=nctx)
        acc = n = 0
        with torch.no_grad():
            for i in range(500, 500 + eval_batches):
                b = data.batch(i, 8, seq, device=dev)
                h, _ = m.forward(state.params, b["inputs"], c)
                pred = m.head(state.params, h, c).argmax(-1)
                acc += float((pred == b["labels"]).sum())
                n += b["labels"].numel()
        return 100 * acc / n

    rows = {}
    base = top1(EulerConfig(mode="exact"))
    print(f"\nFP32 top-1: {base:.2f}%\n")
    print(f"{'width':>5} {'variant':>7} {'top-1 %':>8} {'delta pp':>9}")
    for width, v in points:
        a = top1(from_variant(width, v))
        rows[(width, v)] = a
        print(f"{width:5d} {v:>7} {a:8.2f} {a - base:+9.2f}")

    # mixed per-layer precision: the knob the paper's SIMD mode switch exposes
    mixed = (N.PrecisionPolicy.uniform(from_variant(16, "L-21b"))
             .with_rule("*attn*", from_variant(8, "L-21b"))
             .with_rule("*head*", EulerConfig(mode="exact")))
    a = top1(mixed)
    rows["mixed"] = a
    print(f"{'mix':>5} {'8a/16m':>7} {a:8.2f} {a - base:+9.2f}"
          "   (P8 attn + P16 mlp + exact head)")
    print("\nprecision_sweep OK")
    return {"fp32": base, "rows": rows, "loss": float(out["loss"])}


def main(argv=None) -> dict:
    return run(cli(__doc__, argv))


if __name__ == "__main__":
    main()
