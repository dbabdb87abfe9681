"""The mamba2 and hymba SMOKE models of the port against the JAX reference
through ``params_from_jax``: prefill and decode logits on the reference
engine and on the kernels' route (their plain versions on the CPU; JAX's
Pallas kernels in interpret mode)."""
import jax
import numpy as np
import pytest
import torch

from test_torch_ssm import ARCHS, JModel, _nctx, check_logits
from repro_torch.models.transformer import params_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name in ("mamba2", "hymba"):
        jc, tc = ARCHS[name]
        jp = JModel(jc, remat=False).init(jax.random.PRNGKey(0))
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                         device="cpu"))
    return out


@pytest.mark.parametrize("backend", ["lax_ref", "cuda"])
@pytest.mark.parametrize("arch", ["mamba2", "hymba"])
def test_smoke_logits_match_reference(weights, arch, backend):
    check_logits(*ARCHS[arch], *weights[arch], *_nctx(backend))
