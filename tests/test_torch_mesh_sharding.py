"""The port's sharding rules, blocks, mesh figures and elastic restore
against the JAX package's (``repro.distributed.sharding``,
``repro.launch.mesh``, ``repro.distributed.checkpoint``).

The rules are pure functions of a tree and a mesh: both packages run on
the same stand-in meshes here, no process or device needed.  Bars: every
spec equal, entry by entry, to the reference's; blocks equal to numpy's
slices.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as JC
from repro.distributed import sharding as JSH
from repro.launch import mesh as JM
from repro.models.transformer import Model as JModel
from repro_torch import configs as TC
from repro_torch import tree as T
from repro_torch.distributed import checkpoint as CK
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as TM
from repro_torch.models.transformer import Model as TModel

torch.set_num_threads(1)


class _FakeMesh:
    def __init__(self, shape, coord=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coord = coord


class _K:  # the reference's DictKey
    def __init__(self, k):
        self.key = k


SINGLE = _FakeMesh({"data": 16, "model": 16})
MULTI = _FakeMesh({"pod": 2, "data": 16, "model": 16})
mk = lambda *s: np.zeros(s, np.float32)  # noqa: E731

# every case of tests/test_distributed.py:42-95, with its literal answer
PARAM_CASES = [
    (["embed", "e"], (256000, 4096), JP("model", None)),
    (["layers", "attn", "wq", "w"], (32, 4096, 4096), JP(None, None, "model")),
    (["layers", "attn", "wo", "w"], (32, 4096, 4096), JP(None, "model", None)),
    (["layers", "mlp", "wi", "w"], (32, 4096, 11008), JP(None, None, "model")),
    (["layers", "ln1", "g"], (32, 4096), JP(None, None)),
    (["layers", "moe", "wi", "w"], (32, 128, 4096, 320),
     JP(None, "model", None, None)),
    (["layers", "attn", "wk", "w"], (32, 4096, 20), JP(None, None, None)),
]


@pytest.mark.parametrize("names,shape,want", PARAM_CASES)
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_spec_cases(names, shape, want, fsdp):
    for mesh in (SINGLE, MULTI):
        j = JSH.param_spec([_K(n) for n in names], mk(*shape), mesh,
                           fsdp_experts=fsdp)
        t = SH.param_spec([_K(n) for n in names], mk(*shape), mesh,
                          fsdp_experts=fsdp)
        assert tuple(t) == tuple(j)
        # the port's own paths (str keys) give the same spec
        assert tuple(SH.param_spec(names, mk(*shape), mesh,
                                   fsdp_experts=fsdp)) == tuple(j)
    if not fsdp:
        assert tuple(SH.param_spec(names, mk(*shape), SINGLE)) == tuple(want)


def test_opt_spec_and_cache_spec_cases():
    assert SH.opt_spec(SH.P(None, "model"), (4096, 11008), SINGLE) == \
        ("data", "model")
    assert SH.opt_spec(SH.P("data", None), (4096, 4096), SINGLE) == \
        ("data", None)
    for ps, shape in [((None, "model"), (4096, 11008)),
                      (("data", None), (4096, 4096)),
                      ((None, None, None), (32, 4096, 20)), ((), ())]:
        for mesh in (SINGLE, MULTI):
            for z in (True, False):
                assert tuple(SH.opt_spec(SH.P(*ps), shape, mesh, z)) == \
                    tuple(JSH.opt_spec(JP(*ps), shape, mesh, z))
    assert SH.cache_spec(SINGLE, (32, 128, 32768, 16, 128)) == \
        (None, "data", None, "model", None)
    assert SH.cache_spec(SINGLE, (32, 1, 524288, 5, 64)) == \
        (None, None, "model", None, None)
    for shape in [(32, 128, 32768, 16, 128), (32, 1, 524288, 5, 64),
                  (4, 6, 100, 2, 8), (2, 32, 64, 16, 16)]:
        for mesh in (SINGLE, MULTI):
            assert tuple(SH.cache_spec(mesh, shape)) == \
                tuple(JSH.cache_spec(mesh, shape))


def test_batch_spec_and_axes():
    for mesh in (SINGLE, MULTI, _FakeMesh({"model": 4})):
        assert SH.data_axes(mesh) == JSH.data_axes(mesh)
        assert SH.dp_size(mesh) == JSH.dp_size(mesh)
        for extra, b in [(1, None), (1, 64), (2, 3), (0, 32)]:
            assert tuple(SH.batch_spec(mesh, extra, b)) == \
                tuple(JSH.batch_spec(mesh, extra, b))


def _jax_specs(jtree_specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jtree_specs, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_smoke_param_trees_match_reference(arch):
    """Every leaf of the config's SMOKE parameters under the (16, 16) and
    (2, 16, 16) meshes, with and without fsdp_experts: the port's spec of
    its per-layer leaf is the reference's spec of the stacked leaf less
    the [L] dim; on the reference's own (stacked) tree the port's rules
    give the reference's specs."""
    jcfg = JC.get_config(arch).SMOKE
    jtree = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    ttree = TModel(TC.get_config(arch).SMOKE, device="cpu").init(0)
    n = 0
    for mesh in (SINGLE, MULTI):
        for fsdp in (False, True):
            want = _jax_specs(JSH.params_pspecs(jtree, mesh,
                                                fsdp_experts=fsdp))
            same = SH.params_pspecs(jtree, mesh, fsdp_experts=fsdp)
            for (path, _), got in zip(T.leaves_with_path(jtree),
                                      SH.shardings_in_order(jtree, same)):
                assert tuple(got) == want[T.keystr(path)], path
            for path, leaf in T.leaves_with_path(ttree):
                got = SH.param_spec(path, leaf, mesh, fsdp_experts=fsdp)
                if path[0] == "layers":
                    key = T.keystr(("layers",) + path[2:])
                    assert (None,) + tuple(got) == want[key], path
                else:
                    assert tuple(got) == want[T.keystr(path)], path
                n += 1
    assert n == 4 * len(T.leaves(ttree))


def test_opt_and_cache_shardings_match_reference():
    jcfg, tcfg = (JC.get_config("gemma2-2b").SMOKE,
                  TC.get_config("gemma2-2b").SMOKE)
    jtree = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    for mesh in (SINGLE, MULTI):
        want = _opt_specs_jax(jtree, mesh)
        got = SH.opt_shardings(jtree, mesh)
        for (path, _), (m, spec) in zip(T.leaves_with_path(jtree),
                                        SH.shardings_in_order(jtree, got)):
            assert m is mesh and tuple(spec) == want[T.keystr(path)]
    cache = TModel(tcfg, device="cpu").init_cache(16, 32)
    for mesh in (SINGLE, _FakeMesh({"data": 4, "model": 2})):
        got = SH.shardings_in_order(cache, SH.cache_shardings(mesh, cache))
        for (path, leaf), (_, spec) in zip(T.leaves_with_path(cache), got):
            assert tuple(spec) == tuple(JSH.cache_spec(mesh, tuple(
                leaf.shape))), path


@pytest.mark.parametrize("mesh", [SINGLE, MULTI], ids=["single", "multi"])
def test_params_and_batch_shardings_and_local_shards(mesh):
    """``params_shardings`` pairs the mesh with the reference's spec of
    every leaf, ``batch_shardings`` with its ``batch_spec``, and
    ``local_shards`` cuts each leaf as ``local_shard`` does."""
    jtree = jax.eval_shape(JModel(JC.get_config("gemma2-2b").SMOKE).init,
                           jax.random.PRNGKey(0))
    want = _jax_specs(JSH.params_pspecs(jtree, mesh))
    got = SH.shardings_in_order(jtree, SH.params_shardings(jtree, mesh))
    for (path, _), (m, spec) in zip(T.leaves_with_path(jtree), got,
                                    strict=True):
        assert m is mesh and tuple(spec) == want[T.keystr(path)], path
    batch = {"inputs": mk(32, 8), "labels": mk(32, 8), "embeds": mk(3, 8, 4)}
    for name, (m, spec) in zip(sorted(batch), SH.shardings_in_order(
            batch, SH.batch_shardings(mesh, batch)), strict=True):
        x = batch[name]
        assert m is mesh and tuple(spec) == tuple(
            JSH.batch_spec(mesh, x.ndim - 1, x.shape[0])), name
    coord = dict.fromkeys(mesh.axis_names, 1)
    tree = {"a": torch.arange(64.0).reshape(32, 2), "b": [torch.ones(3)]}
    sh = {"a": (mesh, SH.batch_spec(mesh, 1, 32)), "b": [(mesh, SH.P())]}
    cut = SH.local_shards(tree, sh, coord)
    assert torch.equal(cut["a"], SH.local_shard(tree["a"], sh["a"][1], mesh,
                                                coord))
    assert torch.equal(cut["b"][0], tree["b"][0])


def _opt_specs_jax(jtree, mesh) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    return {jax.tree_util.keystr(p): tuple(JSH.opt_spec(
        JSH.param_spec(p, leaf, mesh), tuple(leaf.shape), mesh))
        for p, leaf in flat}


@pytest.mark.parametrize("spec", [("data", "model"), (("pod", "data"), None),
                                  (None, "model"), ("model", ("pod", "data"))])
def test_local_shard_blocks_tile_the_tensor(spec):
    """Each coordinate's block is numpy's slice (the first axis of a tuple
    major), and the blocks of all coordinates tile the tensor once."""
    shape = {"pod": 2, "data": 2, "model": 3}
    mesh = _FakeMesh(shape)
    x = np.arange(12 * 12, dtype=np.float32).reshape(12, 12)
    seen = np.zeros_like(x)
    for pod in range(2):
        for data in range(2):
            for model in range(3):
                c = {"pod": pod, "data": data, "model": model}
                blk = SH.local_shard(x, SH.P(*spec), mesh, c)
                idx = []
                for dim, ax in enumerate(spec):
                    axes = ax if isinstance(ax, tuple) else (ax,)
                    if ax is None:
                        idx.append(slice(None))
                        continue
                    n = int(np.prod([shape[a] for a in axes]))
                    i = 0
                    for a in axes:
                        i = i * shape[a] + c[a]
                    idx.append(slice(i * 12 // n, (i + 1) * 12 // n))
                np.testing.assert_array_equal(blk, x[tuple(idx)])
                seen[tuple(idx)] += 1
    reps = np.prod([v for k, v in shape.items()
                    if not any(k == a or (isinstance(a, tuple) and k in a)
                               for a in spec)])
    assert (seen == reps).all()
    t = torch.from_numpy(x)
    c = {"pod": 1, "data": 0, "model": 2}
    assert torch.equal(SH.local_shard(t, SH.P(*spec), mesh, c),
                       torch.from_numpy(np.ascontiguousarray(
                           SH.local_shard(x, SH.P(*spec), mesh, c))))


def test_elastic_restore_onto_another_mesh(tmp_path):
    """As tests/test_distributed.py:159: a tree written from a (4, 2) mesh
    (every rank's block put back in place), restored onto (2, 4): each
    rank of the new mesh gets its block."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    m1 = _FakeMesh({"data": 4, "model": 2})
    spec = SH.P("data", "model")
    full = torch.zeros_like(w)
    for d in range(4):
        for m in range(2):
            c = {"data": d, "model": m}
            full[d * 2:(d + 1) * 2, m * 4:(m + 1) * 4] = SH.local_shard(
                w, spec, m1, c)
    tree = {"w": full, "opt": {"count": torch.tensor(7)}}
    CK.save(str(tmp_path), 3, tree)
    for d in range(2):
        for m in range(4):
            m2 = _FakeMesh({"data": 2, "model": 4}, {"data": d, "model": m})
            sh = {"w": (m2, spec), "opt": {"count": SH.replicated(m2)}}
            got, step, _ = CK.restore(str(tmp_path), tree, shardings=sh)
            assert step == 3 and int(got["opt"]["count"]) == 7
            assert torch.equal(got["w"], w[d * 4:(d + 1) * 4,
                                           m * 2:(m + 1) * 2])


def test_hw_holds_the_h100_under_the_reference_keys():
    assert set(TM.HW) | {"hbm_bytes"} == set(JM.HW)
    for k, v in TM.HW.items():
        assert v != JM.HW[k], k   # no TPU figure carried over
    assert TM.HW["peak_bf16_flops"] == 989e12
    assert TM.HW["hbm_bandwidth"] == 3.35e12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.HW["hbm_bytes"]


def test_make_mesh_refuses_another_world_size(tmp_path):
    """A mesh needs exactly its ranks (in a world of one gloo rank)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            TM.make_mesh((2, 2), ("data", "model"), device="cpu")
        mesh = TM.make_mesh((1,), ("data",), device="cpu")
        assert mesh.shape == {"data": 1} and mesh.coord == {"data": 0}
        assert mesh.group("data") is None and mesh.index("data") == 0
    finally:
        dist.destroy_process_group()
