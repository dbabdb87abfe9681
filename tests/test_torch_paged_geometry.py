"""Paged flash-decode at the geometries of the moe, audio and vlm
families against the JAX reference: the port's plain version (what the
CUDA kernel is held to on the card) and JAX's Pallas kernel in interpret
mode on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import from_variant as j_variant
from repro_torch.core.engine import from_variant as t_variant

torch.set_num_threads(1)


@pytest.mark.parametrize("KV,G,hd", [(8, 5, 128), (32, 1, 64), (8, 8, 128)])
def test_paged_decode_at_the_new_geometries_matches_reference(KV, G, hd):
    """Paged flash-decode at llama4-scout's (group 5), musicgen's
    (multi-head, group 1) and chameleon's (group 8) geometry: the port's
    plain version (what the CUDA kernel is held to on the card) against
    JAX's Pallas kernel in interpret mode on the same numpy inputs, within
    the kernel bar of 1e-3; the two lie the same distance from the gather
    reference (at (8, 5, 128) above the 0.05 of ``tests/test_kvcache.py``:
    the flash algorithm's, not the port's)."""
    from repro.core import posit as JP
    from repro.kernels import paged_decode as JPD
    from repro_torch.core import posit as TP
    from repro_torch.kernels import paged_decode as TPD
    je, te = j_variant(16, "L-21b"), t_variant(16, "L-21b")
    B, ps, nlp = 4, 16, 16
    pos = np.array([37, 100, 250, 5], np.int32)
    table = np.full((B, nlp), JPD.NULL_PAGE, np.int32)
    nxt = JPD.RESERVED_PAGES
    for r in range(B):
        for j in range(int(pos[r]) // ps + 1):
            table[r, j] = nxt
            nxt += 1
    rng = np.random.default_rng(0)
    n = JPD.RESERVED_PAGES + B * nlp
    kf = rng.standard_normal((n, ps, KV, hd)).astype(np.float32)
    vf = rng.standard_normal((n, ps, KV, hd)).astype(np.float32)
    kf[:JPD.RESERVED_PAGES] = vf[:JPD.RESERVED_PAGES] = 0.0
    q = rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)

    def jwords(a):
        return JP.to_storage(JP.encode_from_float(jnp.asarray(a), je.posit),
                             je.posit)

    def twords(a):
        return TP.to_storage(TP.encode_from_float(torch.from_numpy(a),
                                                  te.posit), te.posit)

    jargs = (jnp.asarray(q), jwords(kf), jwords(vf), jnp.asarray(table),
             jnp.asarray(pos))
    targs = (torch.from_numpy(q), twords(kf), twords(vf),
             torch.from_numpy(table), torch.from_numpy(pos))
    for window in (None, 24):
        jout = np.asarray(JPD.paged_flash_decode(
            *jargs, window, pc=je.posit, cfg_qk=je, cfg_pv=je,
            interpret=True))
        jref = np.asarray(JPD.paged_attention_reference(
            *jargs, pc=je.posit, window=window))
        tout = TPD.paged_flash_decode_plain(
            *targs, window, pc=te.posit, cfg_qk=te, cfg_pv=te).numpy()
        tref = TPD.paged_attention_reference(
            *targs, pc=te.posit, window=window).numpy()
        assert tout.shape == jout.shape == (B, 1, KV * G * hd)
        assert np.abs(tout - jout).max() <= 1e-3
        np.testing.assert_allclose(tref, jref, rtol=1e-4, atol=2e-3)
        assert abs(np.abs(tout - tref).max()
                   - np.abs(jout - jref).max()) <= 1e-3
