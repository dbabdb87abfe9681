"""End-to-end example (the paper is an inference engine, so the example
serves): batched autoregressive serving of a small LM through the
EULER-ADAS NCE, comparing precision modes.

    python -m repro_torch.examples.serve_adas [--device cpu]

Serving runs on the kernels (the ``cuda`` backend; their plain versions on
the CPU); the FP32 mode runs ``exact``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import numerics as N
from repro_torch import tree as T
from repro_torch.core.engine import EulerConfig, from_variant
from repro_torch.data import SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.serving import GenerationConfig, RequestBatcher, ServeEngine
from repro_torch.training import init_state, make_train_step

from . import cli, device_of

CFG = ModelConfig(name="adas-lm", family="dense", n_layers=3, d_model=128,
                  n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                  loss_chunk=64, q_chunk=64, kv_chunk=64)

MODES = [
    ("FP32", N.PrecisionPolicy.uniform(EulerConfig(mode="exact"))),
    ("Posit16-exact",
     N.PrecisionPolicy.uniform(EulerConfig(width=16, mode="posit"))),
    ("EULER L-21b", N.PrecisionPolicy.uniform(from_variant(16, "L-21b"))),
    # mixed precision: cheap P8 attention, P16 MLP, exact head — the
    # serving-time knob a PrecisionPolicy adds over a single EulerConfig
    ("Mixed 8a/16m", N.PrecisionPolicy.uniform(from_variant(16, "L-21b"))
     .with_rule("*attn*", from_variant(8, "L-21b"))
     .with_rule("*head*", EulerConfig(mode="exact"))),
]


def run(device="cuda", steps: int = 120, max_new: int = 12,
        requests: int = 8) -> dict:
    dev = device_of(str(device))
    # --- train a small model quickly (FP32) so serving has real weights ---
    print(f"training a small LM (FP32, {steps} steps)...")
    model = Model(CFG, EulerConfig(mode="exact"), device=dev)
    ctx = Ctx(ecfg=model.ecfg)
    opt = AdamW(lr=cosine_schedule(3e-3, 20, 120), weight_decay=0.0)
    state = init_state(model, opt, 0)
    step = make_train_step(model, opt, ctx)
    data = SyntheticLM(vocab=CFG.vocab, seed=1)
    for i in range(steps):
        state, out = step(state, data.batch(i, 8, 128, device=dev))
    print(f"  final loss {float(out['loss']):.3f}")
    params = T.map(lambda p: p.detach(), state.params)  # served, not trained

    # --- serve the same weights under four precision modes ----------------
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab, int(rng.integers(8, 24)))
               for _ in range(requests)]
    outputs, tok_s = {}, {}
    for name, policy in MODES:
        backend = "exact" if name == "FP32" else "cuda"
        nctx = N.NumericsContext(policy=policy, backend=backend)
        m = Model(CFG, remat=False, numerics=nctx, device=dev)
        eng = ServeEngine(m, params, max_len=64, batch=4, numerics=nctx)
        batcher = RequestBatcher(eng, prompt_buckets=(32,))
        for p in prompts:
            batcher.submit(p, max_new=max_new)
        t0 = time.time()
        res = batcher.run(GenerationConfig(max_new_tokens=max_new))
        dt = time.time() - t0
        outputs[name] = np.stack([np.asarray(res[i]) for i in sorted(res)])
        tok_s[name] = max_new * len(res) / dt
        print(f"{name:14s}: {len(res)} reqs, {tok_s[name]:6.1f} tok/s "
              f"({batcher.stats['steps']} steps, "
              f"{batcher.stats['refills']} slot refills)")

    fp32 = outputs["FP32"]
    agree = {}
    for name, _ in MODES:
        agree[name] = float((outputs[name] == fp32).mean())
        print(f"token agreement vs FP32 — {name}: {agree[name]:.1%}")

    # --- EOS semantics: the scheduler stops a request at its first EOS ----
    stream = [int(t) for t in fp32[0]]
    eos = stream[2]  # a token the greedy stream emits at step 2
    b = RequestBatcher(ServeEngine(Model(CFG, EulerConfig(mode="exact"),
                                         remat=False, device=dev),
                                   params, max_len=64, batch=4),
                       prompt_buckets=(32,))
    rid = b.submit(prompts[0], max_new=max_new)
    got = b.run(GenerationConfig(max_new_tokens=max_new, eos_id=eos))[rid]
    got = [int(t) for t in got]
    # the stream up to the first EOS: three tokens unless it came earlier
    assert got == stream[:stream.index(eos) + 1], (got, stream, eos)
    print(f"eos={eos}: request stopped after {len(got)}/{max_new} tokens: "
          f"{got}")
    print("serve_adas OK")
    return {"agree": agree, "tok_per_s": tok_s, "eos_tokens": got}


def main(argv=None) -> dict:
    return run(cli(__doc__, argv))


if __name__ == "__main__":
    main()
