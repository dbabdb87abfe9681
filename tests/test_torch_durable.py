"""Durable serving in the port: checkpoints (their protocol, and crossing
between the packages both ways), the failover policy, the sampler, and
the launcher's ``--ckpt-dir``/``--snapshot-dir``/``--resume``.
``test_torch_resume.py`` holds kill-and-resume and the supervisor."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as JG
from repro.core.engine import from_variant as j_variant
from repro.distributed import checkpoint as JCK
from repro.models.layers import Ctx as JCtx
from repro.models.transformer import Model as JModel
from repro.numerics import NumericsContext as JN
from repro_torch.distributed import checkpoint as CK
from repro_torch.distributed import failover as F
from repro_torch.serving import GenerationConfig, make_key, split_key
from repro_torch.serving.engine import _sample

torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"cache": {"k": torch.from_numpy(rng.integers(
                          -2**15, 2**15, (2, 3, 4)).astype(np.int16)),
                      "state": torch.from_numpy(
                          rng.standard_normal((2, 5)).astype(np.float32))},
            "key": np.asarray([7, 3], np.uint32),
            "w": [torch.from_numpy((scale * rng.standard_normal(6)).astype(
                np.float32)).to(torch.bfloat16), np.int32(4)],
            "none": None}


def _assert_tree_equal(a, b):
    fa, fb = CK._flatten(a), CK._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), p)


def test_checkpoint_round_trip_latest_keep_and_crc(tmp_path):
    rng = np.random.default_rng(0)
    d = str(tmp_path)
    trees = [_tree(rng) for _ in range(4)]
    for step, t in enumerate(trees, 1):
        CK.save(d, step, t, keep=2, extra={"step": step})
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003",
                                     "step_00000004"]
    assert CK.latest_step(d) == 4
    got, step, extra = CK.restore(d, trees[0])
    assert step == 4 and extra == {"step": 4}
    _assert_tree_equal(got, trees[3])
    got, _, _ = CK.restore(d, trees[0], step=3)
    _assert_tree_equal(got, trees[2])
    assert CK.read_extra(d) == ({"step": 4}, 4)
    # an unfinished write (no manifest, never renamed) is ignored
    os.makedirs(os.path.join(d, "step_00000009.tmp", "arrays"))
    assert CK.latest_step(d) == 4
    # a bit flip in a leaf fails its crc
    leaf = os.path.join(d, "step_00000004", "arrays", "0.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 1
    open(leaf, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="crc mismatch"):
        CK.restore(d, trees[0])
    # LATEST naming a directory without its manifest: no checkpoint
    os.remove(os.path.join(d, "step_00000004", "MANIFEST.json"))
    assert CK.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        CK.restore(d, trees[0])


def test_checkpoint_structure_and_shape_mismatch_raise(tmp_path):
    rng = np.random.default_rng(1)
    t = _tree(rng)
    CK.save(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="structure mismatch"):
        CK.restore(str(tmp_path), {"a": t["key"]})
    bad = dict(t, key=np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="shape mismatch"):
        CK.restore(str(tmp_path), bad)


def _jax_tree(rng):
    return {"cache": {"k": jnp.asarray(rng.integers(0, 2**16, (2, 3, 4))
                                       .astype(np.uint16)),
                      "state": jnp.asarray(rng.standard_normal((2, 5))
                                           .astype(np.float32))},
            "key": jax.random.PRNGKey(3),
            "w": [jnp.asarray(rng.standard_normal(6).astype(np.float32))
                  .astype(jnp.bfloat16), np.int32(4)],
            "none": None}


def test_jax_checkpoint_read_by_the_port_bit_equal(tmp_path):
    """JAX writes (a bfloat16 leaf and uint16 words among the leaves): the
    port's ``restore_numpy`` and ``restore`` give the same bits."""
    jt = _jax_tree(np.random.default_rng(2))
    JCK.save(str(tmp_path), 5, jt, extra={"who": "jax"})
    got = CK.restore_numpy(str(tmp_path))
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jt)[0]}
    assert list(got) == list(want)
    for path, v in want.items():
        if v.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(got[path].view(np.uint32) >> 16,
                                          v.view(np.uint16))
            assert got[path].dtype == np.float32
        else:
            assert got[path].dtype == v.dtype, path
            np.testing.assert_array_equal(got[path], v)
    tree, step, extra = CK.restore(str(tmp_path),
                                   _tree(np.random.default_rng(0)))
    assert step == 5 and extra == {"who": "jax"}
    assert tree["w"][0].dtype == torch.bfloat16
    assert torch.equal(tree["w"][0].view(torch.int16), torch.tensor(
        np.asarray(jt["w"][0]).view(np.int16)))
    assert tree["cache"]["k"].dtype == torch.int16
    np.testing.assert_array_equal(
        tree["cache"]["k"].numpy().view(np.uint16),
        np.asarray(jt["cache"]["k"]))


def test_port_checkpoint_read_by_jax_bit_equal(tmp_path):
    """The port writes: JAX's ``restore`` gives the same bits, and the
    files equal the ones JAX writes for the same values."""
    rng = np.random.default_rng(3)
    tt = _tree(rng)
    CK.save(str(tmp_path / "port"), 2, tt)
    jt = {"cache": {"k": jnp.asarray(tt["cache"]["k"].numpy().view(
                        np.uint16)),
                    "state": jnp.asarray(tt["cache"]["state"].numpy())},
          "key": jnp.asarray(tt["key"]),
          "w": [jnp.asarray(tt["w"][0].float().numpy()).astype(jnp.bfloat16),
                tt["w"][1]], "none": None}
    back, step, _ = JCK.restore(str(tmp_path / "port"), jt)
    assert step == 2
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(jt)[0]):
        assert a.dtype == b.dtype, jax.tree_util.keystr(p)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    JCK.save(str(tmp_path / "jax"), 2, jt)
    mj = json.load(open(tmp_path / "jax" / "step_00000002" / "MANIFEST.json"))
    mp = json.load(open(tmp_path / "port" / "step_00000002" /
                        "MANIFEST.json"))
    assert {k: v for k, v in mj.items() if k != "time"} == \
        {k: v for k, v in mp.items() if k != "time"}
    for i in range(len(mj["leaves"])):
        a = (tmp_path / "jax" / "step_00000002" / "arrays" / f"{i}.npy")
        b = (tmp_path / "port" / "step_00000002" / "arrays" / f"{i}.npy")
        assert a.read_bytes() == b.read_bytes(), i


def test_port_serves_a_jax_params_checkpoint(tmp_path):
    """A ``{"params"}`` checkpoint written by the JAX package, served through
    the launcher's ``--ckpt-dir``: the served model's prefill logits are the
    JAX model's."""
    from repro_torch.launch import serve
    jn = JN.from_ecfg(j_variant(16, "L-21b"), backend="lax_ref")
    jm = JModel(JG.SMOKE, remat=False, numerics=jn)
    jp = jm.init(jax.random.PRNGKey(5))
    JCK.save(str(tmp_path), 7, {"params": jp})
    rep = serve.main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                      "--requests", "2", "--max-new", "2", "--batch", "2",
                      "--max-len", "64"])
    eng = rep["engine"]
    ids = np.random.default_rng(6).integers(0, JG.SMOKE.vocab, (2, 16))
    want, _ = jm.prefill(jp, jnp.asarray(ids, jnp.int32), JCtx(numerics=jn),
                         jm.init_cache(2, 16, jnp.float32))
    got, _ = eng.model.prefill(eng.params, torch.from_numpy(ids), eng.ctx,
                               eng.model.init_cache(2, 16, "float32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# the failover policy (the cases the reference's tests hold it to)
# ---------------------------------------------------------------------------

def test_dead_host_detection():
    clk = Clock()
    mon = F.HeartbeatMonitor(["h0", "h1", "h2"], dead_after_s=10, clock=clk)
    for step in range(5):
        clk.t += 1
        for h in ("h0", "h1", "h2"):
            mon.beat(h, step)
    clk.t += 11  # h2 goes silent
    mon.beat("h0", 6)
    mon.beat("h1", 6)
    assert mon.dead_hosts() == ["h2"]
    assert set(mon.alive()) == {"h0", "h1"}


@pytest.mark.parametrize("beats,want", [
    # liveness-only beats (same step) do not reset the step timer
    ([(1.0, 1)] + [(1.0 + 0.2 * i, 1) for i in range(1, 6)] + [(4.0, 2)],
     0.8 * 1.0 + 0.2 * 3.0),
    # a multi-step advance averages over its steps
    ([(6.0, 3)], 2.0),
    # a step regression (restarted host) re-anchors and keeps the history
    ([(1.0, 5), (2.0, 1), (3.0, 2)], 0.8 * 0.2 + 0.2 * 1.0),
], ids=["idle-beats", "multi-step", "regression"])
def test_step_ewma(beats, want):
    clk = Clock()
    mon = F.HeartbeatMonitor(["h0"], dead_after_s=1e9, clock=clk)
    for t, step in beats:
        clk.t = t
        mon.beat("h0", step)
    assert mon.hosts["h0"].step_ewma == pytest.approx(want)


def test_straggler_detection():
    clk = Clock()
    hosts = [f"h{i}" for i in range(8)]
    mon = F.HeartbeatMonitor(hosts, dead_after_s=1e9, clock=clk)
    det = F.StragglerDetector(k_mad=4.0, patience=2)
    for step in range(1, 8):
        for h in hosts:
            mon.beat(h, step)
        clk.t += 1.0
        for h in hosts[:-1]:
            mon.hosts[h].step_ewma = 1.0
        mon.hosts["h7"].step_ewma = 3.0
        out = det.update(mon)
    assert out == ["h7"]


@pytest.mark.parametrize("hosts,alive,want", [
    (["h0", "h1", "h2"], ["h0", "h1"], F.Action.ELASTIC_DOWN),
    (["h0", "h1"], ["h0"], F.Action.ABORT),
], ids=["elastic-down", "abort"])
def test_policy_on_death(hosts, alive, want):
    clk = Clock()
    mon = F.HeartbeatMonitor(hosts, dead_after_s=5, clock=clk)
    pol = F.FailoverPolicy(min_hosts=2)
    for h in hosts:
        mon.beat(h, 1)
    clk.t += 10
    for h in alive:
        mon.beat(h, 2)
    d = pol.decide(mon, F.StragglerDetector(), step=2)
    assert d.action == want
    if want == F.Action.ELASTIC_DOWN:
        assert d.drop_hosts == tuple(sorted(set(hosts) - set(alive)))


def test_policy_straggler_escalation():
    clk = Clock()
    hosts = [f"h{i}" for i in range(4)]
    mon = F.HeartbeatMonitor(hosts, dead_after_s=1e9, clock=clk)
    det = F.StragglerDetector(k_mad=2.0, patience=1, min_hosts=3)
    pol = F.FailoverPolicy(min_hosts=2, straggler_grace=3)
    actions = []
    for step in range(1, 8):
        for h in hosts:
            mon.beat(h, step)
        for h in hosts[:-1]:
            mon.hosts[h].step_ewma = 1.0
        mon.hosts["h3"].step_ewma = 10.0
        actions.append(pol.decide(mon, det, step).action)
    assert F.Action.CHECKPOINT_NOW in actions       # first response
    assert actions[-1] == F.Action.ELASTIC_DOWN     # escalates


def test_plan_elastic_mesh_and_replay():
    assert F.plan_elastic_mesh(256, 16) == (16, 16)
    assert F.plan_elastic_mesh(240, 16) == (15, 16)
    with pytest.raises(ValueError):
        F.plan_elastic_mesh(8, 16)
    plan = F.replay_plan(ckpt_step=10, failed_step=13, grad_accum=2)
    assert plan == {"resume_step": 10, "replay_steps": [11, 12, 13],
                    "microbatches_per_step": 2}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_split_key_is_a_counter():
    k = make_key(9)
    k1, s0 = split_key(k)
    k2, s1 = split_key(k1)
    assert k1 == (9, 1) and k2 == (9, 2) and s0 != s1
    assert split_key(k)[1] == s0


def test_sample_greedy_topk_and_distribution():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    greedy = _sample(logits, GenerationConfig(), 123)
    assert torch.equal(greedy, torch.argmax(logits, -1).to(torch.int32))
    top3 = torch.topk(logits, 3, -1).indices
    gen = GenerationConfig(temperature=2.0, top_k=3)
    for sub in range(200):
        t = _sample(logits, gen, sub)
        assert bool((top3 == t[:, None].long()).any(-1).all())
    # temperature sampling draws from softmax(logits / T)
    small = torch.tensor([[1.0, 0.0, -1.0, 0.5]])
    gen = GenerationConfig(temperature=0.8)
    draws = np.bincount([int(_sample(small, gen, s)[0]) for s in range(4000)],
                        minlength=4) / 4000
    want = torch.softmax(small[0] / 0.8, -1).numpy()
    np.testing.assert_allclose(draws, want, atol=0.03)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b"])
def test_launcher_snapshot_and_resume(tmp_path, arch):
    """A sampled drain with snapshots, then ``--resume`` from its last
    snapshot in a fresh launch: the same tokens for every request."""
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--arch", arch, "--backend", "cuda",
              "--batch", "2", "--max-len", "64", "--temperature", "0.8",
              "--snapshot-dir", str(tmp_path)]
    if arch == "gemma2-2b":
        common += ["--paged", "--cache-dtype", "uint16"]
    full = serve.main(common + ["--requests", "3", "--max-new", "6",
                                "--snapshot-every", "2"])
    assert len(full["snapshot_s"]) >= 2 and min(full["snapshot_bytes"]) > 0
    assert CK.latest_step(str(tmp_path)) is not None
    resumed = serve.main(common + ["--resume"])
    assert set(resumed["results"]) == set(full["results"])
    for rid, toks in full["results"].items():
        np.testing.assert_array_equal(resumed["results"][rid], toks)
