"""The metric arithmetic on synthetic timestamps, spans and device
events: rates over the whole window, tails over its samples, a stall in
the window moving the gap tail, the per-layer readers."""
from __future__ import annotations

import importlib.util
import statistics
import os

import numpy as np
import pytest

from portbench import counts, trace
from portbench.loop import Req, Span, endtoend
from portbench.shapes import Shapes

HERE = os.path.dirname(os.path.abspath(__file__))
METRICS = os.path.join(HERE, "..", "metrics")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _req(rid, submit, times):
    return Req(rid, 0, None, submit, tokens=list(times))


def test_rate_is_over_the_whole_window():
    # 2 requests, tokens every 0.5 s from t=10; window [10, 20]
    a = _req(0, 9.0, np.arange(10.0, 30.0, 0.5))
    b = _req(1, 9.5, np.arange(12.0, 16.0, 0.5))
    m = endtoend([a, b], 10.0, 10.0)
    # a: 21 tokens in [10, 20]; b: 8 in [12, 15.5]
    assert m["output_tok_s"] == (21 + 8) / 10.0
    # first tokens at 10 and 12: submit to first token 1000 and 2500 ms
    assert m["ttft_p50_ms"] == 1750.0
    assert abs(m["itl_p95_ms"] - 500.0) < 1e-9


def test_tokens_outside_the_window_do_not_count():
    a = _req(0, 0.0, [1.0, 2.0, 11.0, 12.0, 25.0])
    m = endtoend([a], 10.0, 10.0)
    assert m["output_tok_s"] == 0.2
    assert m["ttft_p50_ms"] is None        # its first token came before


def test_a_stall_moves_the_gap_tail():
    reqs = [_req(i, 0.0, np.arange(1.0 + 0.01 * i, 60.0, 0.2))
            for i in range(4)]
    calm = endtoend(reqs, 5.0, 40.0)["itl_p95_ms"]
    stalled = []
    for r in reqs:   # every request waits 3 s behind a prefill at t=20
        t = np.asarray(r.tokens)
        stalled.append(_req(r.rid, 0.0, np.where(t > 20.0, t + 3.0, t)))
    # one gap in ~200 per request is 3 s: under the 95th percentile
    assert endtoend(stalled, 5.0, 40.0)["itl_p95_ms"] == calm
    many = []
    for r in reqs:   # a stall every 2 s
        t = np.asarray(r.tokens)
        many.append(_req(r.rid, 0.0, t + 1.5 * np.floor(t / 2.0)))
    assert endtoend(many, 5.0, 40.0)["itl_p95_ms"] > 1.5 * calm


def _rec(spans, tr=None, traced=(), seconds=10.0, paged=True):
    s = Shapes.of({"family": "dense", "n_layers": 2, "d_model": 64,
                   "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                   "d_ff": 128, "vocab": 500})
    return {"seconds": seconds, "spans": spans, "shapes": s,
            "serve": {"width": 16, "paged": paged, "cache_dtype": "uint16"},
            "launches": {"logmac": 30, "logmac_mma": 30,
                         "posit_encode_prescaled": 60},
            "trace": tr, "traced_spans": list(traced)}


def test_span_readers():
    spans = [Span("prefill", 0.0, 2.0, 1024, others=1, real=1000),
             Span("prefill", 2.0, 3.0, 512, others=0, real=500),
             Span("step", 3.0, 3.5, 4, (10, 20, 30, 40)),
             Span("step", 3.5, 4.5, 2, (11, 21))]
    rec = _rec(spans)
    assert _reader("prefill_stall_pct")(rec) == 20.0
    assert _reader("prefill_ms_per_ktok")(rec) == 3000.0 / 1.5
    assert _reader("decode_step_ms")(rec) == 750.0
    # logmac_mma repeats logmac's launches and is left out
    assert _reader("launches_per_ktok")(rec) == 90 / (1506 / 1e3)


def test_device_readers_from_events():
    groups = {"contract": {"logmac_mma_kernel", "pe_encode_kernel"},
              "paged_decode": {"pd_scores_kernel"}}
    spans = [Span("prefill", 100.0, 100.6, 64, real=64),
             Span("step", 100.6, 101.0, 2, (5, 9))]
    # the device clock is 1000 s ahead of the host's
    evs = [("void logmac_mma_kernel<2>(float*)", 1100.01, 0.2),
           ("void (anonymous namespace)::pe_encode_kernel<16, 1, 3>()",
            1100.25, 0.05),
           ("at::native::vectorized_elementwise_kernel<4>", 1100.3, 0.1),
           ("pd_scores_kernel", 1100.7, 0.1)]
    tr = trace.reduce_events(evs, spans, 100.0, 101.0, groups)
    assert abs(tr["busy_s"] - 0.45) < 1e-9
    assert abs(tr["by_group"]["contract"] - 0.25) < 1e-9
    assert abs(tr["by_group"]["fallback"] - 0.1) < 1e-9
    assert tr["device_ops"][0][0] == "logmac_mma_kernel"
    idle = dict(tr["idle_gaps"])
    assert abs(sum(idle.values()) - 0.55) < 1e-6
    # the device clock read 1000.01 s ahead: the gaps at 100.2-100.24 and
    # 100.39-100.69 fall in the prefill, the last 0.21 s in the step
    assert abs(idle["prefill_slot"] - 0.34) < 1e-6
    assert abs(idle["step_slots"] - 0.21) < 1e-6
    rec = _rec(spans, tr, spans)
    assert abs(_reader("idle_pct")(rec) - 55.0) < 1e-6
    assert abs(_reader("fallback_pct")(rec) - 100 * 0.1 / 0.45) < 1e-9
    for name in ("roofline_pct.contract", "roofline_pct.paged_decode",
                 "mfu_pct"):
        v = _reader(name)(rec)
        assert v is not None and 0 < v < 100
    mfu = (counts.prefill_flops(rec["shapes"], 64)
           + counts.decode_flops(rec["shapes"], (5, 9))) / counts.PEAK_FLOPS
    assert abs(_reader("mfu_pct")(rec) - 100 * mfu / 1.0) < 1e-12


def test_readers_return_nothing_without_a_trace():
    rec = _rec([], None, (), paged=False)
    for name in ("fallback_pct", "idle_pct", "mfu_pct",
                 "roofline_pct.contract", "roofline_pct.paged_decode"):
        assert _reader(name)(rec) is None
    assert _reader("decode_step_ms")(rec) is None


def test_base_names():
    assert trace.base_name("void logmac_kernel<16, 3>(float const*)") == \
        "logmac_kernel"
    assert trace.base_name(
        "void (anonymous namespace)::store_kernel<float, unsigned short>"
        "(float const*)") == "store_kernel"
    assert trace.base_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH"


def test_spread_readings_follow_the_bound_rules():
    """``spread.py``: interquartile range over the median per set, five
    times the wider, the tightness reading without each set's farthest
    run, and the spread of all runs."""
    from portbench import spread as SP
    a = [10.0, 10.2, 9.8, 10.1, 9.9, 14.0]
    b = [10.0, 10.1, 9.9, 10.3, 9.7, 10.0]
    r = SP.readings([a, b])
    q = statistics.quantiles(a, n=4)
    assert r["spreads"][0] == pytest.approx((q[2] - q[0]) / 10.05)
    assert r["rule_of_five"] == pytest.approx(
        min(max(5 * max(r["spreads"]), 0.01), 0.25))
    assert r["tightness"] == pytest.approx(
        (SP.spread(a[:5]) + SP.spread([10.0, 10.1, 9.9, 9.7, 10.0])) / 2)
    assert r["tightness"] < r["spreads"][0]
    assert r["looseness"] == pytest.approx(SP.spread(a + b))
    assert r["median_shift"] == pytest.approx((10.0 - 10.05) / 10.05)
