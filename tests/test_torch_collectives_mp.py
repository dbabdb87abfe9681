"""The port's collectives on gloo ranks against the JAX package's
(``repro.distributed.collectives``): ``compressed_psum`` and
``compressed_pmean`` over 8 ranks bit for bit against the reference's
under ``shard_map`` on 8 host devices (within one ulp of its ``jax.jit``),
and within its bar of the exact sum
(``tests/test_distributed.py:231``, relative 0.02); ``bucketed`` equal to
the reference's plan; the group statistics of a tensor whose rows are
split over the ranks equal to the whole tensor's (the pow2 pre-scale,
logfxp's max, the plain version of the fused encode); the autograd
collectives' values and gradients; the tree all-reduce and broadcast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as JC
from repro_torch import tree as T
from repro_torch.core import engine as TE
from repro_torch.core import logmult as TLM
from repro_torch.core.posit import PositConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import posit_codec as PC
from torch_ranks import collectives_rank, run_jax, spawn, wait_jax

torch.set_num_threads(1)

WORLD = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    rng = np.random.default_rng(0)
    # the reference test's draw (normal rows), 4100 long: a padded block
    x = rng.normal(size=(WORLD, 4100)).astype(np.float32)
    # rows whose own pow2 scales differ: 2^(3 * rank), a few zeros and a
    # sparse spike, so no row's statistics are the whole tensor's
    y = (rng.normal(size=(WORLD, 96))
         * np.exp2(3.0 * np.arange(WORLD))[:, None]).astype(np.float32)
    y[:, ::7] = 0.0
    y[5, 1] = 3e4
    np.save(tmp / "x.npy", x)
    jax_proc = run_jax(f"""
        import jax, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.distributed.collectives import (compressed_pmean,
                                                   compressed_psum)
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((8,), ("data",))
        x = np.load(r"{tmp / 'x.npy'}")
        out = {{}}
        for name, fn in (("psum", compressed_psum),
                         ("pmean", compressed_pmean)):
            f = jax.shard_map(lambda xl: fn(xl, "data"), mesh=mesh,
                              in_specs=P("data", None),
                              out_specs=P("data", None), check_vma=False)
            out[name] = np.asarray(f(x))
            out[name + "_jit"] = np.asarray(jax.jit(f)(x))
        np.savez(r"{tmp / 'jax.npz'}", **out)
    """)
    got = spawn(collectives_rank, WORLD, tmp / "ranks", x, y)
    wait_jax(jax_proc)
    return x, y, got, dict(np.load(tmp / "jax.npz"))


@pytest.mark.parametrize("name", ["psum", "pmean"])
def test_compressed_allreduce_matches_reference(ranks, name):
    """Bit for bit against the reference's shard_map as its own test runs
    it (tests/test_distributed.py:213); under jax.jit XLA:CPU rounds two
    values of the last, padded block one ulp apart from its eager run, so
    there the bar is one ulp."""
    x, _, got, want = ranks
    port = np.concatenate([g[name].numpy() for g in got])
    np.testing.assert_array_equal(port, want[name])
    ulps = np.abs(port.view(np.int32) - want[name + "_jit"].view(np.int32))
    assert ulps.max() <= 1
    exact = x.sum(0, keepdims=True) / (WORLD if name == "pmean" else 1)
    rel = np.abs(port - exact).max() / (np.abs(exact).max() + 1e-9)
    assert rel < 0.02, rel
    assert np.array_equal(port[0], port[7])     # every rank has the result


def test_group_statistics_are_the_whole_tensors(ranks):
    _, y, got, _ = ranks
    whole = torch.from_numpy(y)
    s = TE._pow2_scale(whole)
    assert all(float(g["scale"]) == float(s) for g in got)
    assert any(float(g["local_scale"]) != float(s) for g in got)
    fe = TLM.fxp_frac_exp(whole, 8)
    assert all(int(g["frac_exp"]) == int(fe) for g in got)
    words, ws = PC.encode_prescaled_plain(whole, PositConfig(16, 1, 3))
    assert float(ws) == float(s)
    port = torch.cat([g["words"] for g in got])
    assert torch.equal(port, words)
    # and what the local statistics would give differs
    local = torch.cat([PC.encode_prescaled_plain(whole[r:r + 1],
                                                 PositConfig(16, 1, 3))[0]
                       for r in range(WORLD)])
    assert not torch.equal(local, words)


def test_autograd_collectives(ranks):
    _, _, got, _ = ranks
    total = sum(r + 1 for r in range(WORLD))
    for r, g in enumerate(got):
        assert torch.equal(g["reduce_sum"], torch.full((3,), float(total)))
        assert torch.equal(g["reduce_sum_grad"], torch.arange(3.0))
        assert torch.equal(g["copy_grad"], torch.full((2,), float(total)))
        blocks = torch.cat([torch.arange(6.0).reshape(2, 3) + 10 * q
                            for q in range(WORLD)], 1)
        assert torch.equal(g["gathered"], blocks)
        coef = torch.arange(float(blocks.numel())).reshape(blocks.shape)
        assert torch.equal(g["gather_grad"],
                           WORLD * coef[:, 3 * r:3 * (r + 1)])


def test_tree_all_reduce_and_broadcast(ranks):
    _, _, got, _ = ranks
    s = sum(range(WORLD))
    for g in got:
        t = g["tree_sum"]
        assert torch.equal(t["a"], torch.full((2, 2), 2.0 * s))
        assert torch.equal(t["b"][0], torch.full((5,), float(s)))
        assert torch.equal(t["b"][1], torch.arange(3) * WORLD + s)
        assert torch.equal(g["bcast"]["w"], torch.zeros(4))
        assert torch.equal(g["bcast"]["n"], torch.tensor([0]))


def test_multi_pod_mesh_joins_pod_and_data(ranks):
    """On (pod, data, model) = (2, 2, 2) a rank's data group spans pod
    and data (4 ranks of its model index), pod major."""
    _, _, got, _ = ranks
    for r, g in enumerate(got):
        size, index, total, coord = g["joint"]
        assert coord == {"pod": r // 4, "data": r // 2 % 2, "model": r % 2}
        assert size == 4 and index == coord["pod"] * 2 + coord["data"]
        assert total == sum(q for q in range(WORLD) if q % 2 == r % 2)


@pytest.mark.parametrize("bucket_bytes", [1, 4 << 20, 64 << 20])
def test_bucketed_plan_matches_reference(bucket_bytes):
    shapes = {"a": (1024, 1024), "b": [(1024, 1024), (8,)],
              "c": {"z": (300, 7), "y": (2, 2, 2)}}

    def build(make):
        return {"a": make(shapes["a"]), "b": [make(s) for s in shapes["b"]],
                "c": {k: make(s) for k, s in shapes["c"].items()}}

    jt = build(jnp.zeros)
    tt = build(torch.zeros)
    want = [[jax.tree_util.keystr(p) for p in b]
            for b in JC.bucketed(jt, bucket_bytes)]
    got = [[T.keystr(p) for p in b] for b in C.bucketed(tt, bucket_bytes)]
    assert got == want
    assert [k for b in got for k in b] == [
        T.keystr(p) for p, _ in T.leaves_with_path(tt)]
