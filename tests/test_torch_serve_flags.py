"""The serving launcher's ``--policy``, ``--eos-id`` and ``--stream``, and
the ``build_numerics`` it shares with the training launcher: a policy JSON
(inline or a file) resolves to the same ``EulerConfig`` per (layer path,
op kind) in both packages."""
import argparse
import json
import re

import numpy as np
import pytest
import torch

from repro.launch.train import build_numerics as j_build_numerics
from repro.numerics import ecfg_to_dict as j_ecfg_to_dict
from repro_torch.launch import serve
from repro_torch.launch import build_numerics
from repro_torch.numerics import ecfg_to_dict, load_policy

torch.set_num_threads(1)

POLICY = {"default": {"width": 16, "variant": "L-21b"},
          "rules": [{"pattern": "*attn*", "op": "qk",
                     "cfg": {"width": 8, "variant": "L-1b"}},
                    {"pattern": "*mlp*", "op": None,
                     "cfg": {"width": 32, "variant": "L-22b"}},
                    {"pattern": "head", "op": None,
                     "cfg": {"mode": "exact"}}]}
PATHS = ["", "attn", "mlp", "head", "ssm", "layer3/attn", "layer3/mlp"]
OPS = ["dot_general", "matmul", "qk", "pv", "elementwise"]
SERVE = ["--device", "cpu", "--arch", "gemma2-2b", "--requests", "3",
         "--max-new", "4", "--batch", "2", "--max-len", "64"]


def _args(**kw):
    base = dict(policy="", euler="L-21b", width=16, backend="lax_ref")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("where", ["inline", "file"])
def test_policy_resolves_as_the_reference(tmp_path, where):
    spec = json.dumps(POLICY)
    if where == "file":
        path = tmp_path / "policy.json"
        path.write_text(spec)
        spec = str(path)
    want = j_build_numerics(_args(policy=spec))
    got = build_numerics(_args(policy=spec))
    assert got.backend == want.backend == "lax_ref"
    assert got.cfg_for("layer3/attn", "qk").width == 8
    assert got.cfg_for("mlp", "matmul").width == 32
    assert got.cfg_for("head", "matmul").mode == "exact"
    for path in PATHS:
        for op in OPS:
            assert ecfg_to_dict(got.cfg_for(path, op)) == j_ecfg_to_dict(
                want.cfg_for(path, op)), (path, op)


@pytest.mark.parametrize("euler,width", [("L-21b", 16), ("L-1", 8),
                                         ("exact", 16)])
def test_uniform_numerics_as_the_reference(euler, width):
    want = j_build_numerics(_args(euler=euler, width=width))
    got = build_numerics(_args(euler=euler, width=width))
    assert ecfg_to_dict(got.policy.default) == j_ecfg_to_dict(
        want.policy.default)
    assert not got.policy.rules


def test_serve_policy_flag(tmp_path):
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(POLICY))
    rep = serve.main(SERVE + ["--policy", str(path), "--guard"])
    nctx = rep["engine"].ctx.numerics
    assert nctx.policy == load_policy(str(path))
    assert nctx.backend == "guarded:lax_ref"
    assert rep["tokens"] == 12


def test_serve_eos_id_stops_a_request():
    base = serve.main(SERVE)["results"]
    rid = min(base)
    eos = int(base[rid][1])                  # that request's second token
    got = serve.main(SERVE + ["--eos-id", str(eos)])["results"]
    assert len(got[rid]) == 2 and int(got[rid][-1]) == eos
    for r, toks in got.items():          # every request stops at its first
        hits = np.flatnonzero(np.asarray(base[r]) == eos)  # eos, if any
        n = hits[0] + 1 if len(hits) else len(base[r])
        np.testing.assert_array_equal(toks, base[r][:n])


def test_serve_stream_prints_each_completion(capsys):
    rep = serve.main(SERVE + ["--stream"])
    out = capsys.readouterr().out
    done = re.findall(r"\] req (\d+) done \((\d+) tokens\)", out)
    assert sorted(int(r) for r, _ in done) == sorted(rep["results"])
    assert all(int(n) == 4 for _, n in done)
    quiet = serve.main(SERVE)
    assert " done (" not in capsys.readouterr().out
    assert quiet["tokens"] == rep["tokens"]
