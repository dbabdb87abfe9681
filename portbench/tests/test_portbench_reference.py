"""The reference and the comparison that decides ``correct``, on the CPU at
SMOKE size: the frozen codec against the port's, the harness's whole run
against the port's plain path (sound: correct), the control (the port's
P8 path: not correct), and the timed path broken underneath in each way
a serving cell can break (not correct)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import run as R
from portbench.reference import posit as RP
from portbench_smoke import smoke_cell

torch.set_num_threads(2)
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("width", [8, 16])
def test_frozen_codec_matches_the_port(width):
    from repro_torch.core import logmult, posit
    from repro_torch.core.engine import from_variant
    cfg = from_variant(width, "L-21b")
    f = RP.variant(width, "L-21b")
    g = torch.Generator().manual_seed(width)
    x = torch.randn(1 << 16, generator=g) * torch.exp2(
        torch.randint(-12, 12, (1 << 16,), generator=g).float())
    x[:4] = torch.tensor([0.0, -0.0, 1e-40, float("inf")])
    words = torch.arange(1 << width, dtype=torch.int64)
    x = torch.cat([x, posit.decode_to_float(words, cfg.posit)])
    np.testing.assert_array_equal(RP.encode(x, f).numpy(),
                                  posit.encode_from_float(x, cfg.posit))
    v, r = RP.planes(x, f)
    pv, pr = logmult.ilm_planes_from_float(x, cfg.posit, cfg.stages,
                                           cfg.trunc, None)
    np.testing.assert_array_equal(v.numpy(), pv.numpy())
    np.testing.assert_array_equal(r.numpy(), pr.numpy())


def _run(c, program=None, width=None):
    return R.run_cell(c, SEED, 4.0, False, device="cpu",
                      program=program or R.import_program(), width=width)


# Sound runs over 8 seeds (this one and 2147483661-73) read a widest gap of
# 0 to 0.0216 and a mean gap of 0 to 1.25e-3 here: 13 of 16 runs read 0, the
# rest one token each that a decode step's batch-wide pre-scale tipped on a
# near tie (dense 2.9e-3 on this seed, hybrid 0.0216 and 5.5e-3; over 18-27
# tokens one such token sets the mean).  The P8 control reads 0.62-0.88 and
# 0.21-0.36 on three, the broken steps below 0.19-1.19 and 0.017-0.36.  The
# smoke cell's limits, 0.1 and 0.01, lie between with more room above the
# sound runs.
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_sound_run_is_correct(tmp_path, family):
    out = _run(smoke_cell(tmp_path, family))
    assert out["correct"], out["checks"]
    assert out["checks"]["compared_tokens"]["value"] >= 8


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_control_is_not_correct(tmp_path, family):
    out = _run(smoke_cell(tmp_path, family), width=8)
    assert not out["correct"], out["checks"]


def _broken(fault):
    """The port with its decode step broken underneath the scheduler."""
    P = R.import_program()
    base = P.ServeEngine

    class Broken(base):
        def step_slots(self, gen, tok, pos, active, key, level=None):
            act = np.asarray(active, bool)
            if fault == "state_unchanged":
                saved = {k: v.clone() for k, v in self.cache.items()}
                out, key = super().step_slots(gen, tok, pos, active, key,
                                              level)
                for k, v in self.cache.items():
                    v.copy_(saved[k])
                return out, key
            if fault == "half_the_batch":
                rows = np.flatnonzero(act)
                keep = act.copy()
                keep[rows[len(rows) // 2:]] = False
                out, key = super().step_slots(gen, tok, pos, keep, key,
                                              level)
                out = np.where(keep, out, 0)
                return out, key
            out, key = super().step_slots(gen, tok, pos, active, key, level)
            out = out.copy()
            first = np.flatnonzero(act)[:1]
            out[first] = (out[first] + 1) % self.model.cfg.vocab
            return out, key

    P.ServeEngine = Broken
    return P


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "token_altered"])
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_broken_step_is_not_correct(tmp_path, family, fault):
    out = _run(smoke_cell(tmp_path, family), program=_broken(fault))
    assert not out["correct"], (fault, out["checks"])
