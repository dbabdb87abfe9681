"""The SSM conv tail under a posit-word cache, against the JAX reference.

With a ``uint16``/``uint32`` cache the reference stores the conv tail with
XLA's float -> unsigned conversion (truncate toward zero, saturate to
[0, 2^N - 1]); the port keeps those words in int16/int32 storage and must
store and read them back as unsigned.  Held here: the conversion on single
values, and a drain of mamba2 SMOKE and the 4-layer hybrid with a
``uint16`` cache in both packages (the same numpy weights): identical
greedy tokens and identical conv-tail words."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1p3b as JM
from repro.core.engine import from_variant as j_variant
from repro.models.config import ModelConfig as JConfig
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro.serving import GenerationConfig as JGen
from repro.serving import RequestBatcher as JBatcher
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import mamba2_1p3b as TM
from repro_torch.core.engine import EulerConfig
from repro_torch.models import ssm as TS
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import Model as TModel, params_from_jax
from repro_torch.numerics import NumericsContext as TN
from repro_torch.serving import GenerationConfig, RequestBatcher, ServeEngine

torch.set_num_threads(1)

# the 4-layer hybrid of test_torch_ssm.py (layer 1 local, window 8)
LOCAL_HYBRID = dict(name="hyb-local", family="hybrid", n_layers=4,
                    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16,
                    ssm_chunk=8, n_global_layers=1, window=8,
                    loss_chunk=32, q_chunk=16, kv_chunk=16)
ARCHS = {"mamba2": (JM.SMOKE, TM.SMOKE),
         "hybrid-local": (JConfig(**LOCAL_HYBRID), TConfig(**LOCAL_HYBRID))}
VALUES = [-3.7, -0.4, 2.9, 40000.6, 70000.0, 1e10]


@pytest.mark.parametrize("dtype,unsigned", [
    ("uint16", np.uint16), ("uint32", np.uint32)])
def test_conv_words_saturate_as_xla(dtype, unsigned):
    """The six values of the repair: XLA's ``astype`` truncates, then
    saturates; the port's int16/int32 storage holds the same words."""
    want = np.asarray(jnp.asarray(VALUES, jnp.float32).astype(dtype))
    if dtype == "uint16":
        np.testing.assert_array_equal(want, [0, 0, 2, 40000, 65535, 65535])
    storage = {"uint16": torch.int16, "uint32": torch.int32}[dtype]
    got = TS.conv_to_cache(torch.tensor(VALUES), storage)
    assert got.dtype == storage
    np.testing.assert_array_equal(got.numpy().view(unsigned), want)
    np.testing.assert_array_equal(TS.conv_from_cache(got).numpy(),
                                  want.astype(np.float32))


def test_float_conv_cache_is_a_cast():
    x = torch.tensor(VALUES)
    assert torch.equal(TS.conv_to_cache(x, torch.bfloat16),
                       x.to(torch.bfloat16))
    assert torch.equal(TS.conv_from_cache(x.to(torch.bfloat16)),
                       x.to(torch.bfloat16).to(torch.float32))


@pytest.mark.parametrize("arch", ["mamba2", "hybrid-local"])
def test_uint16_cache_drain_matches_reference(arch):
    """A drain with co-scheduling and mid-stream refill on a ``uint16``
    cache: the same tokens and the same conv-tail words as JAX's."""
    jc, tc = ARCHS[arch]
    jm = JModel(jc, j_variant(16, "L-21b").replace(mode="exact"),
                remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, jc.vocab, int(rng.integers(3, 15))).astype(
        np.int32) for _ in range(4)]
    jeng = JEngine(jm, jp, JCtx(ecfg=jm.ecfg), max_len=32, batch=2,
                   cache_dtype=jnp.uint16)
    jb = JBatcher(jeng, prompt_buckets=(16,))
    for p in prompts:
        jb.submit(p, max_new=5)
    want = jb.run(JGen(max_new_tokens=5), key=jax.random.PRNGKey(1))
    nctx = TN.from_ecfg(EulerConfig(mode="exact"))
    tm = TModel(tc, numerics=nctx, device="cpu")
    eng = ServeEngine(tm, tp, TCtx(numerics=nctx), max_len=32, batch=2,
                      cache_dtype="uint16")
    b = RequestBatcher(eng, prompt_buckets=(16,))
    for p in prompts:
        b.submit(p, max_new=5)
    got = b.run(GenerationConfig(max_new_tokens=5))
    assert b.stats["refills"] >= 1
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    jconv = np.asarray(jeng.cache["conv"])
    assert jconv.dtype == np.uint16 and jconv.any()
    tconv = eng.cache["conv"]
    assert tconv.dtype == torch.int16
    np.testing.assert_array_equal(tconv.numpy().view(np.uint16), jconv)
