"""The closed-form counts against the port's cost model: a prefill's dot
FLOPs on the ``exact`` backend (every contraction one dot) at SMOKE size,
and the roofline's least time on its two sides."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import counts
from portbench.shapes import Shapes
from portbench.weights import make_params

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b"])
def test_prefill_flops_match_the_cost_model(arch):
    from repro_torch import configs
    from repro_torch.analysis import costmodel
    from repro_torch.core.engine import EulerConfig
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model
    from repro_torch.numerics import NumericsContext

    cfg = configs.get_config(arch).SMOKE
    s = Shapes.of(dataclasses.asdict(cfg))
    T = 32   # one flash chunk (q_chunk 32): the prefill computes T x T
    nctx = NumericsContext.from_ecfg(EulerConfig(mode="exact"))
    model = Model(cfg, remat=False, numerics=nctx, device="cpu")
    params = make_params(s, 5, "cpu")
    cache = model.init_cache(1, T)
    ids = torch.randint(0, cfg.vocab, (1, T))
    got = costmodel.analyze(
        lambda: model.prefill(params, ids, Ctx(numerics=nctx), cache))
    want = (2 * counts.matmul_params(s) * T + 2 * counts.head_params(s)
            + counts.attention_flops(s, 0, T, full_square=True)
            + s.fam.mixer_prompt_flops(s) * T)
    assert got["dot_flops"] == want


def test_causal_context_is_capped_at_the_window():
    s = Shapes.of({"family": "hybrid", "n_layers": 3, "d_model": 8,
                   "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "d_ff": 8,
                   "vocab": 16, "window": 4, "n_global_layers": 1})
    # layers 0, 1 and 2 are global (first, middle, last) at 3 layers
    assert [s.window_of(i) for i in range(3)] == [None, None, None]
    s5 = dataclasses.replace(s, n_layers=5)
    assert [s5.window_of(i) for i in range(5)] == [None, 4, None, 4, None]
    one = dataclasses.replace(s5, n_layers=1, n_global_layers=0)
    # positions 0..9 see 1, 2, 3, 4, 4, ... keys
    assert counts.attention_flops(one, 0, 10) == 4 * 8 * (1 + 2 + 3 + 4 * 7)


def test_least_time_sides():
    s = Shapes.of({"family": "dense", "n_layers": 1, "d_model": 4096,
                   "n_heads": 32, "n_kv_heads": 4, "head_dim": 128,
                   "d_ff": 11008, "vocab": 64000})
    # one row: the weight words' bytes bound it
    one = counts.contract_least_s(s, 1, 16, 0)
    words = sum(k * n for _, k, n in s.projections()) * 2
    assert one == pytest.approx(
        sum(((k + k * n) * 2 + 4 * n) / counts.PEAK_BYTES
            for _, k, n in s.projections()))
    assert one == pytest.approx(words / counts.PEAK_BYTES, rel=1e-3)
    # 4096 rows: the tensor rate bounds it
    big = counts.contract_least_s(s, 4096, 16, 0)
    assert big == pytest.approx(
        2 * 4096 * sum(k * n for _, k, n in s.projections())
        / counts.PEAK_FLOPS)
