"""The port's training checkpoints and launcher: a ``TrainState`` the JAX
trainer wrote (restored bit for bit, then one step within the loss bar of
JAX's own), the port's own checkpoints, a resumed launch replaying bit for
bit, the launcher's step log and refusals, and the SSD's prefix sum under
deterministic algorithms."""
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.data import SyntheticLM as JData
from repro.distributed import checkpoint as JCK
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro.training import init_state as j_init_state
from repro.training import make_train_step as j_make_train_step
from repro_torch import tree as T
from repro_torch.core.engine import EulerConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.models import ssm as TS
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, params_from_jax
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training import (init_state, make_train_step, restore_state,
                                  save_state)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-4, atol=2e-3)  # the model-logits bar
# the reference's training CFG (tests/test_training.py:18)
CFG_KW = dict(name="tiny", family="dense", n_layers=2, d_model=128,
              n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, loss_chunk=32,
              q_chunk=64, kv_chunk=64)
CFG = ModelConfig(**CFG_KW)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 128])
def test_log_step_scan_is_a_prefix_sum(n):
    """The SSD's prefix sum (deterministic on a card, where torch refuses a
    float cumsum under deterministic algorithms) is torch's cumsum up to
    rounding, and runs under the trainer's deterministic mode."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, n, 3)))
    np.testing.assert_allclose(TS.log_step_scan(x, 1).numpy(),
                               torch.cumsum(x, 1).numpy(), rtol=1e-12,
                               atol=1e-12)
    with train.deterministic():
        assert torch.equal(TS.log_step_scan(x, 1), TS.log_step_scan(x, 1))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jax_trainer(compress):
    jm = JModel(JConfig(**CFG_KW), JE.EulerConfig(mode="exact"))
    opt = JAdamW(lr=j_cosine(3e-3, 20, 500), weight_decay=0.01)
    state = j_init_state(jm, opt, jax.random.PRNGKey(0), compress=compress)
    step = jax.jit(j_make_train_step(jm, opt, jm.make_ctx(),
                                     compress_grads=compress))
    return state, step


def _port_trainer(compress):
    tm = Model(CFG, EulerConfig(mode="exact"), device="cpu")
    opt = AdamW(lr=cosine_schedule(3e-3, 20, 500), weight_decay=0.01)
    state = init_state(tm, opt, 1, compress=compress)
    return state, make_train_step(tm, opt, tm.make_ctx(),
                                  compress_grads=compress)


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in b.items()}


@pytest.mark.parametrize("compress", [False, True])
def test_resume_from_jax_checkpoint(tmp_path, compress):
    """A ``TrainState`` the JAX trainer wrote after two steps: restored
    bit for bit (layers and moments unstacked), then one port step within
    the loss bar of JAX's own third step."""
    data = JData(vocab=CFG.vocab, seed=4)
    jstate, jstep = _jax_trainer(compress)
    for i in range(2):
        jstate, _ = jstep(jstate, data.batch(i, 4, 64))
    JCK.save(str(tmp_path), 2, jstate)
    _, want = jstep(jstate, data.batch(2, 4, 64))

    like, step = _port_trainer(compress)
    state, at = restore_state(str(tmp_path), like, CFG)
    assert at == 2 and int(state.step) == 2 and int(state.opt["count"]) == 2
    for name, jtree, ttree in (("params", jstate.params, state.params),
                               ("m", jstate.opt["m"], state.opt["m"]),
                               ("v", jstate.opt["v"], state.opt["v"]),
                               ("ef", jstate.ef, state.ef)):
        if jtree is None:
            assert ttree is None
            continue
        conv = params_from_jax(jax.tree.map(np.asarray, jtree), CFG,
                               device="cpu")
        for a, c in zip(T.leaves(conv), T.leaves(ttree), strict=True):
            assert torch.equal(a, c), name
    assert all(p.requires_grad for p in T.leaves(state.params))
    # the serving launcher's --ckpt-dir reads the same file's params
    served = serve.load_jax_params(str(tmp_path), CFG, "cpu")
    for a, c in zip(T.leaves(served), T.leaves(state.params), strict=True):
        assert torch.equal(a, c)
    _, got = step(state, _torch_batch(data.batch(2, 4, 64)))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               **LOSS_TOL)


def test_port_checkpoint_round_trip(tmp_path):
    """save_state -> restore_state gives the state back bit for bit, with
    its parameters trainable."""
    state, step = _port_trainer(True)
    state, _ = step(state, SyntheticLM(vocab=CFG.vocab, seed=4).batch(0, 4,
                                                                     64))
    save_state(str(tmp_path), 1, state)
    like, _ = _port_trainer(True)
    got, at = restore_state(str(tmp_path), like, CFG)
    assert at == 1
    for a, c in zip(T.leaves(state.tree()), T.leaves(got.tree()),
                    strict=True):
        assert a.dtype == c.dtype and torch.equal(a, c)
    assert all(p.requires_grad for p in T.leaves(got.params))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SMOKE_ARGS = ["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
              "--batch", "2", "--seq", "32", "--log-every", "1"]
# the reference's step line (src/repro/launch/train.py, the log print)
STEP_LINE = re.compile(r"^step +\d+ loss -?\d+\.\d{4} gnorm \d+\.\d{3} "
                       r"lr \d\.\d{2}e[-+]\d{2} \(\d+\.\d{2}s/step\)$")


def test_launcher_trains_with_the_reference_log(capsys):
    rep = train.main(SMOKE_ARGS + ["--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 3 and all(STEP_LINE.match(ln) for ln in steps), steps
    assert lines[-1] == "done"
    assert len(rep["losses"]) == 3 and np.isfinite(rep["losses"]).all()
    assert rep["n_layers"] == 3 and int(rep["state"].step) == 3
    assert not torch.are_deterministic_algorithms_enabled()  # restored


def test_launcher_resume_replays_bit_for_bit(tmp_path, capsys):
    """A run checkpointed at step 2 and at its end, its last checkpoint
    then lost: resuming from step 2 ends on the same parameters."""
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    ref = train.main(SMOKE_ARGS + ["--steps", "3", "--ckpt-dir", whole,
                                   "--ckpt-every", "2", "--compress-grads"])
    shutil.copytree(whole, part)
    shutil.rmtree(os.path.join(part, "step_00000003"))
    with open(os.path.join(part, "LATEST"), "w") as f:
        f.write("step_00000002")
    got = train.main(SMOKE_ARGS + ["--steps", "3", "--ckpt-dir", part,
                                   "--resume", "--compress-grads"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert got["losses"] == ref["losses"][2:]
    for a, b in zip(T.leaves(ref["state"].tree()),
                    T.leaves(got["state"].tree()), strict=True):
        assert torch.equal(a, b)


def test_launcher_refuses_cuda_backend_and_meshes():
    with pytest.raises(RuntimeError, match="lax_ref"):
        train.main(SMOKE_ARGS + ["--steps", "1", "--backend", "cuda"])
    # the production meshes need their worlds (256 and 512 ranks); a
    # world of one refuses them with the count it needs
    for mesh, ranks in (("single", 256), ("multi", 512)):
        with pytest.raises(SystemExit, match=f"launch {ranks} ranks.*"
                                             "this world has 1"):
            train.main(SMOKE_ARGS + ["--mesh", mesh])
    assert train.parser().parse_args([]).arch == "hymba-1.5b"
    assert not train.parser().parse_args([]).smoke  # FULL unless --smoke
