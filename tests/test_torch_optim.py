"""The port's AdamW, cosine schedule, global-norm clipping and the int8
error-feedback compression against ``repro.optim`` and
``repro.distributed.collectives``, on the same numpy inputs.

Bars, stated before the first run: the schedule, norms, clipping and one
AdamW update within rtol 1e-6; the int8 words and scales, dequantized
values and error-feedback residuals bit-identical (both round half to
even)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as JC
from repro.optim import adamw as JA
from repro_torch import tree as T
from repro_torch.distributed import collectives as TC
from repro_torch.optim import adamw as TA

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=0)


def _tree(rng, scale=1.0):
    """A parameter-shaped tree: a dict with a list of layers."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": {"e": a(40, 8)},
            "layers": [{"w": a(8, 12), "g": a(12)} for _ in range(2)]}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return T.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(got, want, **tol):
    for g, w in zip(T.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("warmup,total", [(20, 500), (0, 10), (5, 5)])
def test_cosine_schedule_matches(warmup, total):
    want, got = JA.cosine_schedule(3e-3, warmup, total), TA.cosine_schedule(
        3e-3, warmup, total)
    for step in [0, 1, 3, 5, 19, 20, 21, 250, 499, 500, 700]:
        np.testing.assert_allclose(float(got(torch.tensor(step))),
                                   float(want(step)), **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match(max_norm):
    tree = _tree(np.random.default_rng(1))
    np.testing.assert_allclose(float(TA.global_norm(_torch(tree))),
                               float(JA.global_norm(_jax(tree))), **TOL)
    want, wn = JA.clip_by_global_norm(_jax(tree), max_norm)
    got, gn = TA.clip_by_global_norm(_torch(tree), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), **TOL)
    _close(got, want, **TOL)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3),
    dict(lr="cosine", weight_decay=0.0),
    dict(lr="cosine", max_grad_norm=0.1),          # the clip is active
    dict(lr=2e-3, max_grad_norm=None, weight_decay=0.1),
    dict(lr=1e-3, state_dtype="bfloat16"),
], ids=["const", "cosine-nowd", "clip", "noclip-wd", "bf16-state"])
def test_adamw_update_matches(kw):
    """One update from the same params and numpy grads (from count 0 and
    from count 7, where the bias corrections and the schedule differ)."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    jkw, tkw = dict(kw), dict(kw)
    if kw["lr"] == "cosine":
        jkw["lr"] = JA.cosine_schedule(3e-3, 2, 10)
        tkw["lr"] = TA.cosine_schedule(3e-3, 2, 10)
    if "state_dtype" in kw:
        jkw["state_dtype"], tkw["state_dtype"] = jnp.bfloat16, torch.bfloat16
    jopt, topt = JA.AdamW(**jkw), TA.AdamW(**tkw)
    jp, tp = _jax(params), _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for count in (0, 7):
        js["count"] = jnp.int32(count)
        ts["count"] = torch.tensor(count, dtype=torch.int32)
        grads = _tree(rng, 0.5)
        jp1, js1, jm = jopt.update(_jax(grads), js, jp)
        tp1, ts1, tm = topt.update(_torch(grads), ts, tp)
        _close(tp1, jp1, **TOL)
        _close(ts1["m"], js1["m"], **TOL)
        _close(ts1["v"], js1["v"], **TOL)
        assert int(ts1["count"]) == int(js1["count"]) == count + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)


@pytest.mark.parametrize("shape,block", [((5000,), 2048), ((64, 33), 128),
                                         ((7,), 2048)])
def test_int8_words_and_scales_bit_identical(shape, block):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[::97] = 0.5 * np.round(x.flat[::97] * 254) / 127  # near .5 ties
    jq, js, jmeta = JC.int8_quantize(jnp.asarray(x), block)
    tq, ts, tmeta = TC.int8_quantize(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and tmeta == (tuple(jmeta[0]), jmeta[1])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TC.int8_dequantize(tq, ts, tmeta).numpy(),
        np.asarray(JC.int8_dequantize(jq, js, jmeta)))
    assert TC.compression_ratio(torch.from_numpy(x), block) == \
        JC.compression_ratio(jnp.asarray(x), block)


def test_error_feedback_bit_identical():
    """Three steps of ``ef_compress`` carrying the residual."""
    rng = np.random.default_rng(8)
    jef = JC.ef_init(_jax(_tree(rng)))
    tef = TC.ef_init(_torch(_tree(rng)))
    for _ in range(3):
        grads = _tree(rng, 1e-2)
        jg, jef = JC.ef_compress(_jax(grads), jef, 64)
        tg, tef = TC.ef_compress(_torch(grads), tef, 64)
        _close(tg, jg, rtol=0, atol=0)
        _close(tef, jef, rtol=0, atol=0)
    assert any(float(e.abs().sum()) > 0 for e in T.leaves(tef))
