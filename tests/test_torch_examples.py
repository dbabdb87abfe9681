"""The port's examples (``repro_torch.examples``), each run on the CPU
through its ``run(device="cpu", ...)`` with its own assertions: quickstart
and mixed_precision at their own sizes, precision_sweep, serve_adas and
train_qat with a few steps (and precision_sweep with a few operating
points).  Bars: the reference scripts' (``examples/``): mixed_precision's
``lax_ref`` against the kernels' route within 1e-3 and the policy live,
serve_adas's EOS stop, train_qat's bit-identical replay after a restart.
Without a card, ``--device cuda`` (the default) raises.
"""
import pytest
import torch

from repro_torch.examples import (mixed_precision, precision_sweep,
                                  quickstart, serve_adas, train_qat)

torch.set_num_threads(1)


def test_quickstart():
    out = quickstart.run("cpu")
    # the paper's knobs order the error: more stages, less error
    assert out["mse"]["L-2"] < out["mse"]["L-1"] < out["mse"]["L-21"]
    assert out["kernel_diff"] == 0.0 and out["api_diff"] == 0.0


def test_mixed_precision():
    out = mixed_precision.run("cpu")
    assert out["diff"] < 1e-3 and out["live"] > 1e-6


def test_precision_sweep_few_points():
    out = precision_sweep.run("cpu", steps=2, points=((8, "L-21b"),),
                              eval_batches=1, seq=32)
    assert set(out["rows"]) == {(8, "L-21b"), "mixed"}
    assert all(0.0 <= a <= 100.0 for a in out["rows"].values())


def test_serve_adas_few_steps():
    out = serve_adas.run("cpu", steps=1, max_new=3, requests=2)
    assert out["agree"]["FP32"] == 1.0
    assert 1 <= len(out["eos_tokens"]) <= 3


def test_train_qat_replays_bit_identically():
    out = train_qat.run("cpu", steps=3, ckpt_every=2, log_every=1, batch=2,
                        seq=32)
    assert out["resume_step"] == 2 and out["same"]


@pytest.mark.parametrize("mod", [quickstart, mixed_precision,
                                 precision_sweep, serve_adas, train_qat],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_refuse_missing_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
