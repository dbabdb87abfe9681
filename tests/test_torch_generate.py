"""Serving and data entry points of the moe/audio/vlm slice against the
JAX reference: the lockstep ``ServeEngine.generate`` (greedy tokens equal
to JAX's, EOS padding and early exit, cache lifecycle, ``reset_slot``),
the audio/vlm prefill from float frame/patch embeddings and the stub
frontend's batches (``data.batch_for_step(embeddings_dim=...)``).

Bars: greedy tokens and batches exactly; logits within rtol 1e-4 / atol
2e-3 of JAX's (``tests/test_numerics.py:279``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import SyntheticLM as JSynth
from repro.data import batch_for_step as j_batch_for_step
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro.serving import GenerationConfig as JGen
from repro.serving import ServeEngine as JEngine
from repro_torch import configs as TC
from repro_torch.data import SyntheticLM, batch_for_step
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving import GenerationConfig, ServeEngine
from test_torch_families import TOL, _nctx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ("yi-6b", "musicgen-large", "chameleon-34b"):
        cfg = JC.get_config(arch).SMOKE
        jp = JModel(cfg, remat=False).init(jax.random.PRNGKey(0))
        out[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         TC.get_config(arch).SMOKE,
                                         device="cpu"))
    return out


@pytest.mark.parametrize("arch", ["musicgen-large", "chameleon-34b"])
def test_prefill_from_embeddings_matches_reference(weights, arch):
    """The audio/vlm stub frontend: prefill from float frame/patch
    embeddings [2, 16, d] (the reference's own table, gathered by ids),
    L-21b on the reference engine."""
    jcfg, tcfg = JC.get_config(arch).SMOKE, TC.get_config(arch).SMOKE
    assert jcfg.embedding_inputs and tcfg.embedding_inputs
    jp, tp = weights[arch]
    jn, tn = _nctx("lax_ref")
    src = JSynth(vocab=jcfg.vocab, seed=5)
    emb = np.asarray(j_batch_for_step(src, 0, 2, 16,
                                      embeddings_dim=jcfg.d_model)["inputs"])
    assert emb.shape == (2, 16, jcfg.d_model) and emb.dtype == np.float32
    jm = JModel(jcfg, remat=False, numerics=jn)
    tm = TModel(tcfg, numerics=tn, device="cpu")
    want, _ = jax.jit(lambda p, e, c: jm.prefill(p, e, JCtx(numerics=jn),
                                                 c))(
        jp, jnp.asarray(emb), jm.init_cache(2, 16, jnp.float32))
    got, _ = tm.prefill(tp, torch.from_numpy(emb.copy()), TCtx(numerics=tn),
                        tm.init_cache(2, 16, "float32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stub_frontend_batches_match_reference():
    """``batch_for_step(embeddings_dim=...)`` gathers the table's rows by
    the batch's ids: with the reference's table passed in, the batch equals
    the reference's; the port's own seeded table has its shape and scale
    and is the same on every call."""
    src, jsrc = SyntheticLM(vocab=256, seed=3), JSynth(vocab=256, seed=3)
    want = j_batch_for_step(jsrc, 2, 4, 16, embeddings_dim=32)
    table = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (256, 32),
                                         jnp.float32) * 0.02)
    got = batch_for_step(src, 2, 4, 16, embeddings_dim=32, table=table)
    np.testing.assert_array_equal(got["inputs"].numpy(),
                                  np.asarray(want["inputs"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    own = batch_for_step(src, 2, 4, 16, embeddings_dim=32)
    again = batch_for_step(src, 2, 4, 16, embeddings_dim=32)
    assert own["inputs"].shape == (4, 16, 32)
    assert own["inputs"].dtype == torch.float32
    torch.testing.assert_close(own["inputs"], again["inputs"], rtol=0,
                               atol=0)
    assert 0.01 < float(own["inputs"].std()) < 0.03
    with pytest.raises(ValueError, match="embedding table"):
        batch_for_step(src, 2, 4, 16, embeddings_dim=16, table=table)


@pytest.fixture(scope="module")
def yi_engines(weights):
    """yi-6b SMOKE behind both packages' ``ServeEngine`` (batch 4, max_len
    32, L-21b on the reference engine, a uint16 dense cache)."""
    jp, tp = weights["yi-6b"]
    jn, tn = _nctx("lax_ref")
    jm = JModel(JC.get_config("yi-6b").SMOKE, remat=False, numerics=jn)
    tm = TModel(TC.get_config("yi-6b").SMOKE, numerics=tn, device="cpu")
    return (JEngine(jm, jp, max_len=32, batch=4, cache_dtype=jnp.uint16,
                    decode_chunk=3),
            ServeEngine(tm, tp, max_len=32, batch=4, cache_dtype="uint16",
                        decode_chunk=3))


def test_generate_greedy_tokens_match_reference(yi_engines):
    """Lockstep ``generate``: the same greedy tokens as JAX's, with and
    without EOS; an all-EOS batch stops early on both; a paged engine
    refuses."""
    jeng, teng = yi_engines
    prompts = np.random.default_rng(11).integers(
        0, 512, (4, 8)).astype(np.int32)
    want = np.asarray(jeng.generate(jnp.asarray(prompts),
                                    JGen(max_new_tokens=7)))
    got = teng.generate(prompts, GenerationConfig(max_new_tokens=7))
    assert got.shape == (4, 7) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert teng.last_decode_steps == jeng.last_decode_steps == 6
    eos = int(want[0, 2])
    jwant = np.asarray(jeng.generate(jnp.asarray(prompts),
                                     JGen(max_new_tokens=7, eos_id=eos,
                                          pad_id=1)))
    got = teng.generate(prompts, GenerationConfig(max_new_tokens=7,
                                                  eos_id=eos, pad_id=1))
    np.testing.assert_array_equal(got.numpy(), jwant)
    same = np.tile(prompts[:1], (4, 1))
    first = teng.generate(same, GenerationConfig(max_new_tokens=7))
    eos = int(first[0, 2])
    j = int(np.nonzero(first[0].numpy() == eos)[0][0])  # its first step
    out = teng.generate(same, GenerationConfig(max_new_tokens=7,
                                               eos_id=eos))
    assert (out[:, :j + 1] == first[:, :j + 1]).all()
    assert (out[:, j + 1:] == 0).all()
    assert teng.last_decode_steps == 3 * ((j + 2) // 3)  # whole chunks
    assert teng.generate(prompts, GenerationConfig(max_new_tokens=0)
                         ).shape == (4, 0)
    with pytest.raises(ValueError, match="batch of 4"):
        teng.generate(prompts[:2], GenerationConfig(max_new_tokens=2))


def test_generate_resets_and_reset_slot(yi_engines):
    """``generate`` starts from a zero cache every call (the same tokens
    twice), and ``reset_slot`` zeroes only its slot's rows."""
    _, teng = yi_engines
    prompts = np.random.default_rng(12).integers(
        0, 512, (4, 8)).astype(np.int32)
    a = teng.generate(prompts, GenerationConfig(max_new_tokens=4))
    b = teng.generate(prompts, GenerationConfig(max_new_tokens=4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(bool(c[:, 2].any()) for c in teng.cache.values())
    teng.reset_slot(2)
    for c in teng.cache.values():
        assert not bool(c[:, 2].any())
        assert bool(c[:, 1].any())


def test_generate_under_a_temperature_runs(yi_engines):
    _, teng = yi_engines
    prompts = np.ones((4, 8), np.int32)
    out = teng.generate(prompts, GenerationConfig(
        max_new_tokens=4, temperature=0.8, top_k=10), key=(3, 0))
    again = teng.generate(prompts, GenerationConfig(
        max_new_tokens=4, temperature=0.8, top_k=10), key=(3, 0))
    assert out.shape == (4, 4)
    torch.testing.assert_close(out, again, rtol=0, atol=0)


@pytest.mark.parametrize("arch,extra", [
    ("llama4-scout-17b-a16e", ["--paged", "--cache-dtype", "uint16"]),
    ("arctic-480b", []),
    ("musicgen-large", ["--paged", "--cache-dtype", "uint16"]),
    ("chameleon-34b", []),
    ("nemotron-4-15b", ["--layers", "1"])])
def test_launcher_serves_every_new_family(arch, extra):
    """``launch/serve.py --arch`` takes the new ids (the audio and vlm
    families from token ids); ``--layers`` cuts the depth."""
    from repro_torch.launch import serve
    rep = serve.main(["--arch", arch, "--device", "cpu", "--backend", "cuda",
                      "--requests", "3", "--max-new", "3", "--batch", "2",
                      "--max-len", "64"] + extra)
    cfg = TC.get_config(arch).SMOKE
    assert rep["tokens"] == 9 and rep["d_model"] == cfg.d_model
    assert rep["n_layers"] == (1 if "--layers" in extra else cfg.n_layers)
    assert all(0 <= t < cfg.vocab for v in rep["results"].values()
               for t in v)
