"""Quantization-aware training with the EULER-ADAS engine in the forward
pass (STE gradients), plus fault-tolerant checkpoint/restart.

    python -m repro_torch.examples.train_qat [--device cpu]
"""
from __future__ import annotations

import tempfile

import torch

from repro_torch import tree as T
from repro_torch.core.engine import from_variant
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import deterministic
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training import (init_state, make_train_step, restore_state,
                                  save_state)

from . import cli, device_of

CFG = ModelConfig(name="qat", family="dense", n_layers=2, d_model=128,
                  n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                  loss_chunk=64, q_chunk=64, kv_chunk=64)


def run(device="cuda", steps: int = 100, ckpt_every: int = 40,
        log_every: int = 20, batch: int = 8, seq: int = 128) -> dict:
    dev = device_of(str(device))
    ecfg = from_variant(16, "L-21b")          # the paper's headline config
    model = Model(CFG, ecfg, device=dev)
    ctx = model.make_ctx()                    # Ctx wired to the numerics
    opt = AdamW(lr=cosine_schedule(3e-3, 20, 200), weight_decay=0.0)
    step = make_train_step(model, opt, ctx, grad_accum=2)
    data = SyntheticLM(vocab=CFG.vocab, seed=2)

    # a bit-identical replay needs deterministic kernels on the card
    with tempfile.TemporaryDirectory(prefix="euler_ckpt_") as ckpt, \
            deterministic():
        print(f"QAT under {ecfg.paper_name} ({ecfg.variant}); checkpoints "
              f"-> {ckpt}")
        state = init_state(model, opt, 0)
        losses = []
        for i in range(steps):
            state, out = step(state, data.batch(i, batch, seq, device=dev))
            losses.append(float(out["loss"]))
            if (i + 1) % ckpt_every == 0:
                save_state(ckpt, i + 1, state)
            if i % log_every == 0:
                print(f"  step {i:3d} loss {losses[-1]:.4f}")

        # simulate a crash + restart: restore and replay deterministically
        state2, resume_step = restore_state(ckpt, state, CFG)
        print(f"restored at step {resume_step}; replaying to {steps}...")
        for i in range(resume_step, steps):
            state2, _ = step(state2, data.batch(i, batch, seq, device=dev))
    same = all(torch.equal(a, b) for a, b in
               zip(T.leaves(state.params), T.leaves(state2.params)))
    print(f"bit-identical replay after restart: {same}")
    assert same, "the replay after the restart is not bit-identical"
    print("train_qat OK")
    return {"losses": losses, "resume_step": resume_step, "same": same}


def main(argv=None) -> dict:
    return run(cli(__doc__, argv))


if __name__ == "__main__":
    main()
