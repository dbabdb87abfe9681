"""The port's data-parallel train step on two gloo ranks against its
one-process step and the JAX package's single-device ``jax.grad``.

The reference's ``launch/train.py --mesh`` places the train state
replicated and lets GSPMD split the batch: its numbers are one device's,
up to the order of f32 sums.  The port's step holds each rank's rows,
takes every activation's pow2 pre-scale over the data group, normalises
the loss by the global batch and sums the gradients over the group.

Bars, stated before the first run: on a batch whose shards have different
local pre-scales (rank 1's tokens embed as sparse spikes), every pre-scale
of the forward bit-equal to the one-process run's, in call order; the loss
and every gradient leaf within relative 1e-6 (relative L2 per leaf) of the
one-process step's, and so the step's loss and parameters; for the
reference CFG and mamba2 SMOKE the summed gradients within relative L2
1e-3 per leaf of JAX's single-device ``jax.grad`` (the bar of
``test_torch_grad_parity.py``).  The launcher on a two-rank data mesh
logs the one-process launcher's losses within relative 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JData
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.launch import train
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim import AdamW
from repro_torch.training import TrainState, make_train_step
from test_torch_grad_parity import ARCHS, GRAD_REL_L2
from torch_ranks import (collect, dp_rank, launcher_rank, model_of,
                         record_scales, run_jax, spawn, start, torch_tree,
                         wait_jax)

torch.set_num_threads(1)

DP_REL = 1e-6
LAUNCH = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu", "--steps",
          "2", "--batch", "2", "--seq", "32", "--log-every", "1"]


def _numpy(tree):
    return T.map(lambda t: t.detach().numpy().copy(), tree)


def _case(arch: str, spiky: bool):
    """(arch, port parameters as numpy, global batch).  Spiky: the token
    rows of rank 1 (batch rows 2, 3) use the upper half of the vocabulary,
    whose embedding rows keep 4 of d values and shrink the rest by 2^-12,
    so after the norms their activations' mean log2 lies far below rank
    0's."""
    jc, _ = ARCHS[arch]
    jp = JModel(jc).init(jax.random.PRNGKey(0))
    p = _numpy(params_from_jax(jax.tree.map(np.asarray, jp), jc,
                               device="cpu"))
    B = 4 if spiky else 2
    b = {k: np.asarray(v).astype(np.int64)
         for k, v in JData(vocab=jc.vocab, seed=3).batch(0, B, 64).items()}
    if spiky:
        half = jc.vocab // 2
        for k in b:
            b[k][:2] %= half
            b[k][2:] = b[k][2:] % half + half
        p["embed"]["e"][half:, 4:] *= 2.0 ** -12
    return arch, p, b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    proc = run_jax(f"""
        import jax, numpy as np
        from repro.core import engine as JE
        from repro.data import SyntheticLM as JData
        from repro.models.transformer import Model as JModel
        from repro_torch import tree as T
        from repro_torch.models.transformer import params_from_jax
        from test_torch_grad_parity import ARCHS
        out = {{}}
        for arch in ("cfg", "mamba2"):
            jc, _ = ARCHS[arch]
            jp = JModel(jc).init(jax.random.PRNGKey(0))
            b = {{k: np.asarray(v) for k, v in
                 JData(vocab=jc.vocab, seed=3).batch(0, 2, 64).items()}}
            jm = JModel(jc, JE.from_variant(16, "L-21b"))
            fn = jax.value_and_grad(lambda p: jm.loss(p, b, jm.make_ctx()),
                                    has_aux=True)
            (_, _), g = jax.jit(fn)(jp)
            leaves = T.leaves(params_from_jax(jax.tree.map(np.asarray, g),
                                              jc, device="cpu"))
            for i, leaf in enumerate(leaves):
                out[f"{{arch}}_{{i}}"] = leaf.numpy()
        np.savez(r"{tmp / 'jax.npz'}", **out)
    """)
    cases = {"cfg_spiky": _case("cfg", True),
             "mamba2_spiky": _case("mamba2", True),
             "cfg": _case("cfg", False), "mamba2": _case("mamba2", False)}
    launch = start(launcher_rank, 2, tmp / "launch", LAUNCH)
    ranks = spawn(dp_rank, 2, tmp / "dp", cases)
    launch = collect(launch)
    wait_jax(proc)
    return cases, ranks, launch, dict(np.load(tmp / "jax.npz"))


def _one_process(arch, p_np, batch_np):
    model = model_of(arch)
    ctx = Ctx(numerics=model.numerics)
    params = T.map(lambda t: t.requires_grad_(True), torch_tree(p_np))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with torch.no_grad():
        scales = record_scales(lambda: model.loss(params, batch, ctx))
    loss, _ = model.loss(params, batch, ctx)
    grads = torch.autograd.grad(loss, T.leaves(params))
    opt = AdamW(lr=1e-3)
    state = TrainState(params=params, opt=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32))
    new, metrics = make_train_step(model, opt, ctx)(state, batch)
    return scales, loss.detach(), grads, metrics["loss"], new.params


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("name", ["cfg_spiky", "mamba2_spiky"])
def test_dp_step_equals_one_process_step(runs, name):
    cases, ranks, _, _ = runs
    scales, loss, grads, step_loss, step_params = _one_process(*cases[name])
    for r in ranks:
        got = r[name]
        assert [s for s, _ in got["scales"]] == [s for s, _ in scales]
        assert abs(float(got["loss"]) - float(loss)) <= DP_REL * abs(
            float(loss))
        for g, w in zip(T.leaves(got["grads"]), grads, strict=True):
            assert _rel(g, w) <= DP_REL
        assert abs(float(got["step_loss"]) - float(step_loss)) <= \
            DP_REL * abs(float(step_loss))
        for a, b in zip(T.leaves(got["step_params"]),
                        T.leaves(step_params), strict=True):
            assert _rel(a, b) <= DP_REL
    # the shards' own scales differ from the global ones somewhere
    local_differs = sum(g != s for r in ranks
                        for s, g in r[name]["scales"])
    assert local_differs > 0
    print(f"{name}: {len(scales)} pre-scales bit-equal; "
          f"{local_differs} rank-local scales differ from them")


@pytest.mark.parametrize("arch", ["cfg", "mamba2"])
def test_dp_grads_match_jax(runs, arch):
    _, ranks, _, want = runs
    for r in ranks:
        for i, g in enumerate(T.leaves(r[arch]["grads"])):
            w = torch.from_numpy(want[f"{arch}_{i}"])
            assert _rel(g, w) <= GRAD_REL_L2, (arch, i)


def test_launcher_on_a_data_mesh(runs):
    _, _, launch, _ = runs
    ref = train.main(LAUNCH)
    for r in launch:
        for a, b in zip(r["losses"], ref["losses"], strict=True):
            assert abs(a - b) <= DP_REL * abs(b)


def test_rank_rows_refuses_an_uneven_batch():
    from repro_torch.training import rank_rows

    class _Mesh:
        shape, axis_names, coord = {"data": 3}, ("data",), {"data": 0}

        def group(self, axes):
            return object()

    ctx = Ctx(mesh=_Mesh())
    with pytest.raises(ValueError, match="does not split over 3"):
        rank_rows({"inputs": torch.zeros((4, 2))}, ctx)
