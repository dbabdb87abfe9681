"""The port's expert-parallel MoE on gloo ranks against the JAX package's
``moe_apply`` under a mesh (its ``shard_map`` branch, jitted on 8 host
devices): llama4-smoke on (data, model) = (1, 2), (2, 2), and (2, 2) with
``moe_fsdp`` (the ZeRO-3 gather, in f32 and in bfloat16).

The operands separate a rank's statistics from the whole tensor's: the
experts of model shard 1 are scaled by 2^6, and so are the token rows of
data shard 1.  There the reference's mesh run differs from its
single-device run (local pre-scales and per-rank capacity), and the port
must follow the mesh run.  Bars: outputs within the logits bar of
``test_torch_families.py`` (rtol 1e-4, atol 2e-3) taken at the outputs'
scale (atol 2e-3 times the largest |y|: the scaled operands put the
outputs near 1e10, where the f32 sum orders of XLA's dot and torch's bmm
part some small elements of a row by a few percent), the aux loss within
rtol 1e-6 (only the order of its f32 sums differs), ``moe_fsdp`` with no
gather dtype bit for bit the run without it.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import llama4_scout_17b_a16e as JL
from repro.models import layers as JLy
from test_torch_families import TOL
from torch_ranks import moe_rank, run_jax, spawn, wait_jax

torch.set_num_threads(1)

RUNS4 = {"ep": {}, "fsdp": {"moe_fsdp": True},
         "fsdp_bf16": {"moe_fsdp": True, "moe_gather_dtype": torch.bfloat16}}


def _numpy_tree(p):
    if isinstance(p, dict):
        return {k: _numpy_tree(v) for k, v in p.items()}
    return np.array(p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    cfg = JL.SMOKE
    p = _numpy_tree(JLy.moe_init(jax.random.PRNGKey(1), cfg))
    half = cfg.n_experts // 2
    for n in ("wi", "wg", "wo"):          # model shard 1's experts
        p[n]["w"][half:] *= 64.0
    x = np.random.default_rng(0).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    x[2:] *= 64.0                         # data shard 1's rows
    np.savez(tmp / "in.npz", x=x, router=p["router"]["w"], wi=p["wi"]["w"],
             wg=p["wg"]["w"], wo=p["wo"]["w"])
    proc = run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import llama4_scout_17b_a16e as JL
        from repro.core.engine import from_variant
        from repro.launch.mesh import make_mesh
        from repro.models.layers import Ctx, moe_apply
        from repro.numerics import NumericsContext
        d = np.load(r"{tmp / 'in.npz'}")
        p = {{"router": {{"w": d["router"]}}, "wi": {{"w": d["wi"]}},
              "wg": {{"w": d["wg"]}}, "wo": {{"w": d["wo"]}}}}
        nctx = NumericsContext.from_ecfg(from_variant(16, "L-21b"),
                                         backend="lax_ref")
        runs = {{"single": (None, {{}}), "ep12": ((1, 2), {{}}),
                 "ep": ((2, 2), {{}}), "fsdp": ((2, 2), {{"moe_fsdp": True}}),
                 "fsdp_bf16": ((2, 2), {{"moe_fsdp": True,
                                        "moe_gather_dtype": jnp.bfloat16}})}}
        out = {{}}
        for name, (shape, kw) in runs.items():
            mesh = make_mesh(shape, ("data", "model")) if shape else None
            ctx = Ctx(numerics=nctx, mesh=mesh, **kw)
            y, aux = jax.jit(lambda p, x: moe_apply(p, x, ctx, JL.SMOKE))(
                p, d["x"])
            out[name], out[name + "_aux"] = np.asarray(y), np.asarray(aux)
        np.savez(r"{tmp / 'jax.npz'}", **out)
    """)
    port12 = spawn(moe_rank, 2, tmp / "r2", p, x, {"ep12": {}})
    port22 = spawn(moe_rank, 4, tmp / "r4", p, x, RUNS4)
    wait_jax(proc)
    return dict(np.load(tmp / "jax.npz")), port12, port22


def _rows(ranks, name):
    """The global output from (data, model) ranks in row-major order:
    data rank i's rows from model rank 0, which equals model rank 1's."""
    msz = 2
    blocks = []
    for i in range(len(ranks) // msz):
        a, b = (ranks[i * msz + m][name]["y"] for m in range(msz))
        assert torch.equal(a, b)
        blocks.append(a)
    return torch.cat(blocks).numpy()


@pytest.mark.parametrize("name", ["ep12", "ep", "fsdp", "fsdp_bf16"])
def test_expert_parallel_follows_the_reference_mesh_run(runs, name):
    want, port12, port22 = runs
    ranks = port12 if name == "ep12" else port22
    got = _rows(ranks, name)
    tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(want[name]).max())
    # the operands make the mesh run differ from one device's
    assert not np.allclose(want[name], want["single"], **tol)
    np.testing.assert_allclose(got, want[name], **tol)
    for r in ranks:
        np.testing.assert_allclose(float(r[name]["aux"]),
                                   float(want[name + "_aux"]), rtol=1e-6)


def test_zero3_gather(runs):
    """The f32 gather reproduces the run without it bit for bit; the
    bfloat16 gather halves the gathered bytes."""
    _, _, port22 = runs
    for r in port22:
        assert torch.equal(r["fsdp"]["y"], r["ep"]["y"])
        assert r["ep"]["bytes"]["all_gather"] == 0
        f32, bf16 = (r[n]["bytes"]["all_gather"] for n in ("fsdp",
                                                          "fsdp_bf16"))
        # wi, wg [2, 128, 128] and wo [2, 128, 128] per rank, 4 bytes each
        assert f32 == 3 * 2 * 128 * 128 * 4 and bf16 * 2 == f32
