"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``build_cell``, and on small fake meshes.

(a) For gemma2-2b, hymba-1.5b and arctic-480b at each applicable shape on
the 16 x 16 mesh, the JAX ``build_cell`` (no compile) runs in a
subprocess on 512 host devices (the 16 x 16 mesh takes 256).  Bars,
stated before the first run:
``params_total``, ``params_active``, ``scope_trips``, ``model_flops``,
``cache_bytes``, ``fsdp_experts`` and ``grad_accum`` equal; the port's
per-rank placed bytes of the parameters, the two AdamW moments and the
caches equal the sum over the same leaves of JAX's
``sharding.shard_shape(leaf.shape)`` bytes, exactly.

(b) The port's dry run of SMOKE configs at a cut-down shape on fake 2 x 2
and 2 x 2 x 2 meshes (rank 0 of a ``fake`` process group, meta
tensors), train, prefill and decode: every record ``ok`` with its
memory, analytic counts and collectives, and the collectives that the
placement issues recorded.  gemma2 SMOKE with one KV head (MQA), which
does not divide the model axis, takes the sequence-sharded decode: its
rank's cache holds half of the positions.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.launch import dryrun as D
from torch_ranks import SRC

torch.set_num_threads(1)

ARCHS = ("gemma2-2b", "hymba-1.5b", "arctic-480b")
META_KEYS = ("params_total", "params_active", "scope_trips", "model_flops",
             "cache_bytes", "fsdp_experts", "grad_accum")
CELLS = [(a, s) for a, s, ok in C.all_cells() if ok and a in ARCHS]


class _Mesh:
    """The 16 x 16 mesh as the rules and ``build_cell`` read it, with no
    process group (nothing is run)."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}
    coord = {"data": 0, "model": 0}

    def group(self, axes):
        return None


JAX_CELLS = """
    import json, numpy as np, jax
    from repro.launch import dryrun as D
    from repro.launch.mesh import make_production_mesh

    def placed(tree, shardings):
        leaves = jax.tree.leaves(tree)
        shards = jax.tree.leaves(shardings)
        assert len(leaves) == len(shards)
        return int(sum(np.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
                       for l, s in zip(leaves, shards)))

    mesh = make_production_mesh(multi_pod=False)
    out = {}
    for arch, shape in CELLS:
        fn, args, in_sh, out_sh, meta = D.build_cell(arch, shape, mesh)
        if meta["kind"] == "train":
            (st, _), (sts, _) = args, in_sh
            rec = {"params": placed(st.params, sts.params),
                   "opt": placed(st.opt["m"], sts.opt["m"])
                   + placed(st.opt["v"], sts.opt["v"])}
        else:
            rec = {"params": placed(args[0], in_sh[0]),
                   "cache": placed(args[-1], in_sh[-1])}
        rec["meta"] = {k: meta[k] for k in KEYS if k in meta}
        out[f"{arch}/{shape}"] = rec
    print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    code = (f"CELLS = {CELLS!r}\nKEYS = {META_KEYS!r}\n"
            + textwrap.dedent(JAX_CELLS))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def _bytes(tree) -> int:
    return D._nbytes(tree)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_meta_and_placed_bytes_equal_jax(jax_cells, arch, shape):
    want = jax_cells[f"{arch}/{shape}"]
    cell = D.build_cell(arch, shape, _Mesh())
    got = {k: cell.meta[k] for k in META_KEYS if k in cell.meta}
    assert got == want["meta"]
    assert _bytes(cell.parts["params"]) == want["params"]
    if "opt" in want:
        opt = cell.parts["opt"]
        assert _bytes([opt["m"], opt["v"]]) == want["opt"]
    else:
        assert _bytes(cell.parts["cache"]) == want["cache"]


TRAIN = {"seq_len": 32, "global_batch": 8, "kind": "train"}
PREFILL = {"seq_len": 64, "global_batch": 4, "kind": "prefill"}
DECODE = {"seq_len": 64, "global_batch": 8, "kind": "decode"}


def _smoke(arch, **kw):
    return dataclasses.replace(C.get_config(arch).SMOKE, **kw)


FAKE_CELLS = {
    "gemma2 train 2x2": ("gemma2-2b", {}, TRAIN, (2, 2), None),
    "gemma2 prefill 2x2": ("gemma2-2b", {}, PREFILL, (2, 2), None),
    "gemma2 decode 2x2": ("gemma2-2b", {}, DECODE, (2, 2), None),
    "gemma2 MQA decode 2x2": ("gemma2-2b", {"n_kv_heads": 1}, DECODE,
                              (2, 2), None),
    "gemma2 train 2x2x2": ("gemma2-2b", {}, TRAIN, (2, 2, 2), None),
    "hymba decode 2x2x2": ("hymba-1.5b", {}, DECODE, (2, 2, 2), None),
    "llama4 prefill 2x2x2": ("llama4-scout-17b-a16e", {}, PREFILL,
                             (2, 2, 2), None),
    "arctic ZeRO-3 train 2x2": ("arctic-480b", {}, TRAIN, (2, 2), True),
}


@pytest.fixture(scope="module")
def fake_pg():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(FAKE_CELLS))
def test_fake_mesh_cells_run(fake_pg, name):
    arch, kw, spec, mesh_shape, fsdp = FAKE_CELLS[name]
    rec = D.run_cell(arch, spec["kind"], len(mesh_shape) == 3,
                     cfg_override=_smoke(arch, **kw), mesh_shape=mesh_shape,
                     shape_spec=spec, fsdp_experts=fsdp)
    assert rec.get("ok"), rec.get("error")
    assert rec["n_devices"] == (8 if len(mesh_shape) == 3 else 4)
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["per_device_total"]
    assert rec["fits_hbm"] and rec["analytic"]["dot_flops_global"] > 0
    assert rec["analytic"]["dot_flops_global"] == \
        rec["analytic"]["dot_flops_global"] // rec["n_devices"] * \
        rec["n_devices"]
    colls = rec["collectives"]
    assert set(colls) >= {"all-reduce", "all-gather", "reduce-scatter",
                          "all-to-all", "collective-permute"}
    assert colls["all-reduce"]["count"] > 0
    assert colls["all-reduce"]["max_group"] == rec["n_devices"]
    if spec["kind"] == "train":     # ZeRO-1: reduce-scatter, all-gather
        assert colls["reduce-scatter"]["count"] > 0
        assert colls["all-gather"]["count"] > 0
    if kw.get("n_kv_heads") == 1:   # the sequence-sharded decode
        mesh = _Mesh()
        mesh.shape = dict(zip(("data", "model"), mesh_shape))
        cell = D.build_cell(arch, spec["kind"], mesh,
                            cfg_override=_smoke(arch, **kw), shape_spec=spec)
        k = cell.parts["cache"]["k"]
        assert k.shape[2] == spec["seq_len"] // 2 and k.shape[3] == 1
