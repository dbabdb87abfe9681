"""The port's fault-injection campaign: its helpers against the JAX
campaign's, determinism for a seed, the paper's orderings and the guard
arm's bars (the reference's ``--smoke`` / ``--smoke --guard`` asserts), on
the campaign's TINY model on the CPU."""
import json

import numpy as np
import torch

from repro.reliability import campaign as JC
from repro_torch.launch import faultcamp
from repro_torch.reliability import campaign as TC

torch.set_num_threads(1)


def test_tiny_config_and_helpers_match_reference():
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "mlp", "dtype",
              "q_chunk", "kv_chunk"):
        assert getattr(TC.TINY, f) == getattr(JC.TINY, f), f
    for a, b in zip(TC._traffic(6, 128, 0), JC._traffic(6, 128, 0)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = rng.integers(0, 5, int(rng.integers(0, 9))).tolist()
        b = rng.integers(0, 5, int(rng.integers(0, 9))).tolist()
        assert TC.edit_distance(a, b) == JC.edit_distance(a, b)
    base = {0: np.asarray([1, 2, 3]), 1: np.asarray([4, 5])}
    res = {0: np.asarray([1, 9, 3]), 1: np.asarray([4, 5])}
    assert TC._compare(base, res, {0: 1, 1: 0}) == JC._compare(
        base, res, {0: 1, 1: 0})


def test_campaign_deterministic_for_a_seed():
    kw = dict(widths=(16,), roles=("regime_run",), n_requests=2, max_new=6,
              rate=5e-3, device="cpu")
    a, b = TC.run_campaign(**kw), TC.run_campaign(**kw)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["config"]["device"] == "cpu"


def test_faultcamp_smoke_orderings(tmp_path):
    """``faultcamp --smoke`` asserts the paper's orderings (bounded below
    unbounded, regime above fraction) and writes the campaign JSON."""
    out = tmp_path / "camp.json"
    camp = faultcamp.main(["--smoke", "--device", "cpu", "--out", str(out)])
    assert camp["summary"]["ordering"] == {
        "bounded_below_unbounded": True, "regime_worse_than_fraction": True}
    assert json.loads(out.read_text())["summary"] == json.loads(
        json.dumps(camp["summary"]))


def test_campaign_guard_arm_bars():
    """The guarded arm on regime-bit faults: detection >= 0.9, zero false
    positives on the clean arm, and the guarded clean drain's tokens equal
    the unguarded ones."""
    camp = TC.run_campaign(widths=(16,), roles=("regime_run",), n_requests=3,
                           max_new=8, guard=True, device="cpu")
    g = camp["summary"]["guard"]
    assert g["false_positives"] == 0
    assert g["detection_rate_regime"] is not None
    assert g["detection_rate_regime"] >= 0.9
    for fmt in camp["formats"].values():
        assert fmt["guard_clean"]["tokens_equal_unguarded"]
        assert fmt["roles"]["regime_run"]["guarded"]["injected_ops"] > 0
