"""Online ABFT guards for the posit datapath: detect, escalate, recover.

Counterpart of ``repro.reliability.guards``.  A ``guarded:<base>``
numerics backend (``repro_torch.numerics.backends``) runs every
contraction through :func:`guard_call`:

* **ABFT checksum**: ``rowsum(A.B) == A.(rowsum(B))``.  The op's output is
  summed over the rhs-free dims and compared with the check contraction
  ``A . bsum``, computed independently in exact f32 over the
  posit-quantized operands.  The tolerance is calibrated per
  :class:`EulerConfig` (:func:`check_eps`) and scales with
  ``sum_k |a_ik| * sum_j |b_kj|``.  A non-finite row sum always trips.
  The check assumes exact f32 contractions: on a CUDA card TF32 must be
  off (``repro_torch.launch.pin_exact_f32``).
* **NaR / saturation sentinels**: the output re-encoded to posit words,
  NaR and regime-saturated words counted per call.
* **detect -> escalate ladder**: on a violation the op is recomputed
  through the same base backend along :func:`escalation_ladder` (same
  precision with a fresh fault draw, then wider posits, then exact), each
  rung re-checked at its own tolerance.

The reference gates the ladder with ``lax.cond`` and sends stats out of
the trace with ``jax.debug.callback``.  Eagerly, the gate is a host ``if``
on ``bool(violation.any())`` (one device sync per guarded op) and the
stats are recorded by a direct call.  Under ``record="events"`` the clean
path records nothing, as in the reference; the sentinel counts are only
computed when a call is recorded.
"""
from __future__ import annotations

import dataclasses
import math
import threading

import torch

from repro_torch.core import engine as _E
from repro_torch.core.engine import EulerConfig
from repro_torch.kernels import posit_codec as _codec

RECORD_MODES = ("events", "full", "off")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Static guard policy.

    ``margin`` multiplies the calibrated per-config epsilon
    (:func:`check_eps`).  ``max_retries`` bounds the escalation ladder (0 =
    detect-only: violations are counted and surfaced, never recomputed;
    the scheduler's retry path).  ``retry_same`` puts a same-precision
    recompute first.  ``record``: "events" records only violated calls,
    "full" every check, "off" nothing.  ``quantize_check``: True runs the
    check over the posit-quantized operands (the precise profile); False
    over the raw f32 operands with the tolerance widened by
    :func:`quant_eps` (the fast profile)."""

    margin: float = 8.0
    atol: float = 1e-6
    max_retries: int = 3
    retry_same: bool = True
    sentinels: bool = True
    record: str = "events"
    quantize_check: bool = True

    def __post_init__(self):
        if self.record not in RECORD_MODES:
            raise ValueError(
                f"unknown record mode {self.record!r}; one of {RECORD_MODES}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.margin <= 0:
            raise ValueError(f"margin must be > 0, got {self.margin}")


DEFAULT = GuardConfig()

_POSIT_MODES = ("posit", "euler", "quant_only")


# --------------------------------------------------------------------------
# Tolerance calibration
# --------------------------------------------------------------------------

def check_eps(cfg: EulerConfig) -> float:
    """Calibrated relative ABFT tolerance floor for one config: f32
    accumulation order for "exact"/"posit"/"quant_only", the ILM error
    ~2^-(3n+2) + 2^-(m+3) for "euler", plus the output re-quantization
    step when ``out_quant`` is on."""
    if cfg.mode in ("exact", "posit", "quant_only"):
        eps = 1e-6
    elif cfg.mode == "logfxp":
        eps = 2.0 ** -(2 * cfg.stages + 2)
    elif cfg.mode == "euler":
        eps = 2.0 ** -(3 * cfg.stages + 2)
        if cfg.trunc is not None:
            eps += 2.0 ** -(cfg.trunc + 3)
    else:
        eps = 1e-4
    if cfg.out_quant and cfg.mode != "exact":
        eps += 2.0 ** -(cfg.posit.frac_window - 3)
    return eps


def quant_eps(cfg: EulerConfig) -> float:
    """Relative operand-quantization error bound for the raw-operand check
    profile (half an ULP of the fraction window with 2x headroom); zero
    for modes that consume raw f32 operands."""
    if cfg.mode not in _POSIT_MODES:
        return 0.0
    return 2.0 ** -(cfg.posit.frac_window - 2)


def _quantize_like(x, cfg: EulerConfig):
    """The operand value the base datapath consumes: pre-scaled posit
    quantization for posit-word modes, plain f32 otherwise.  On the card
    the pre-scale is the cuda base's own (``posit_quantize_prescaled``);
    the check recomputes it from the raw operand, so corrupted words of
    the base show up in the residual."""
    xf = torch.as_tensor(x).to(torch.float32)
    if cfg.mode not in _POSIT_MODES:
        return xf
    if cfg.pre_scale:
        return _codec.posit_quantize_prescaled(xf, cfg.posit)[0]
    return _codec.posit_quantize(xf, cfg.posit)


def _rhs_free(b_ndim: int, dimension_numbers):
    (lc, rc), (lb, rb) = dimension_numbers
    return tuple(d for d in range(b_ndim) if d not in rc and d not in rb)


def abft_residual(out, aq, bq, dimension_numbers):
    """(delta, budget): |rowsum(out) - aq.rowsum(bq)| and sum_k |a||b|,
    both shaped like the output's batch + lhs-free dims."""
    rfree = _rhs_free(bq.ndim, dimension_numbers)
    if rfree:
        bsum = bq.sum(dim=rfree, keepdim=True)
        babs = bq.abs().sum(dim=rfree, keepdim=True)
    else:
        bsum, babs = bq, bq.abs()
    check = _E.dot_general(aq, bsum, dimension_numbers)
    budget = _E.dot_general(aq.abs(), babs, dimension_numbers)
    nfree = len(rfree)
    got = out.to(torch.float32)
    if nfree:
        got = got.sum(dim=tuple(range(out.ndim - nfree, out.ndim)))
    check = check.reshape(got.shape)
    budget = budget.reshape(got.shape)
    return (got - check).abs(), budget


def violation(out, aq, bq, dimension_numbers, cfg: EulerConfig,
              gcfg: GuardConfig = DEFAULT):
    """Per-row violation flags: residual above the calibrated tolerance, or
    a non-finite row sum."""
    delta, budget = abft_residual(out, aq, bq, dimension_numbers)
    eps = check_eps(cfg)
    if not gcfg.quantize_check:
        eps += quant_eps(cfg)
    tol = gcfg.margin * eps * budget + gcfg.atol
    return (delta > tol) | ~torch.isfinite(delta)


# --------------------------------------------------------------------------
# Sentinels
# --------------------------------------------------------------------------

def sentinel_counts(out, cfg: EulerConfig):
    """(nar, saturated) word counts of the output re-encoded to posit (one
    host read of both)."""
    nar, sat = _codec.posit_sentinels(
        torch.as_tensor(out).to(torch.float32), cfg.posit,
        cfg.pre_scale).tolist()
    return nar, sat


# --------------------------------------------------------------------------
# Escalation ladder
# --------------------------------------------------------------------------

def _upwidth(cfg: EulerConfig, width: int) -> EulerConfig:
    """cfg transplanted to a wider posit word (variant knobs re-derived from
    the paper's per-width table when the variant is a named one)."""
    keep = dict(mode=cfg.mode, simd=cfg.simd, out_quant=cfg.out_quant,
                accum=cfg.accum, fuse_planes=cfg.fuse_planes,
                pre_scale=cfg.pre_scale, dtype=cfg.dtype)
    try:
        return _E.from_variant(width, cfg.variant, **keep)
    except (ValueError, KeyError):
        return cfg.replace(width=width)


def escalation_ladder(cfg: EulerConfig,
                      gcfg: GuardConfig = DEFAULT) -> tuple[EulerConfig, ...]:
    """The bounded recompute sequence for a violated op: same precision
    (``retry_same``), each next-higher posit width, then exact, cut to
    ``max_retries`` rungs keeping exact as the last."""
    if gcfg.max_retries <= 0:
        return ()
    steps: list[EulerConfig] = []
    if gcfg.retry_same and cfg.mode != "exact":
        steps.append(cfg)
    if cfg.mode in _POSIT_MODES:
        for w in (8, 16, 32):
            if w > cfg.width:
                steps.append(_upwidth(cfg, w))
    steps.append(cfg.replace(mode="exact"))
    if len(steps) > gcfg.max_retries:
        steps = steps[:gcfg.max_retries - 1] + [steps[-1]]
    return tuple(steps)


# --------------------------------------------------------------------------
# Stats accumulator
# --------------------------------------------------------------------------

_LOCK = threading.Lock()
_STATS: dict[str, dict] = {}
_EVENTS: list[dict] = []

_COUNTERS = ("checks", "violations", "retries", "recovered", "unrecovered",
             "nar_words", "saturated_words", "sentinel_words")


def _key(path: str, op: str) -> str:
    return f"{path or '.'}|{op}"


def _record(path, op, words, viol, rows, retries, recovered, unrecovered,
            nar, sat):
    with _LOCK:
        c = _STATS.setdefault(_key(path, op), dict.fromkeys(_COUNTERS, 0))
        c["checks"] += 1
        c["violations"] += int(viol)
        c["retries"] += int(retries)
        c["recovered"] += int(recovered)
        c["unrecovered"] += int(unrecovered)
        c["nar_words"] += int(nar)
        c["saturated_words"] += int(sat)
        c["sentinel_words"] += int(words)
        if bool(viol):
            _EVENTS.append({
                "path": path, "op": op,
                "rows": [bool(r) for r in rows.reshape(-1).tolist()],
                "retries": int(retries), "recovered": bool(recovered),
                "unrecovered": bool(unrecovered),
            })


def stats(reset: bool = False) -> dict[str, dict]:
    """Per-dispatch counters: {"<path>|<op>": {checks, violations, retries,
    recovered, unrecovered, nar_words, saturated_words, sentinel_words}}."""
    with _LOCK:
        out = {k: dict(v) for k, v in _STATS.items()}
        if reset:
            _STATS.clear()
    return out


def totals(reset: bool = False) -> dict:
    """Aggregate counters over every dispatch site."""
    agg = dict.fromkeys(_COUNTERS, 0)
    for c in stats(reset=reset).values():
        for k in _COUNTERS:
            agg[k] += c[k]
    return agg


def drain_events() -> list[dict]:
    """Pop the pending violation events: one dict per violated op call, with
    per-leading-row flags for slot attribution."""
    with _LOCK:
        out = _EVENTS[:]
        _EVENTS.clear()
    return out


def reset():
    with _LOCK:
        _STATS.clear()
        _EVENTS.clear()


def snapshot() -> dict:
    """JSON-able guard state (counters only; events are transient)."""
    return {"stats": stats()}


def load(snap: dict | None):
    """Restore :func:`snapshot` state (replaces current counters)."""
    with _LOCK:
        _STATS.clear()
        _EVENTS.clear()
        for k, v in (snap or {}).get("stats", {}).items():
            c = dict.fromkeys(_COUNTERS, 0)
            c.update({kk: int(vv) for kk, vv in v.items() if kk in _COUNTERS})
            _STATS[k] = c


# --------------------------------------------------------------------------
# The guarded op
# --------------------------------------------------------------------------

def _leading_rows(viol):
    """Per-row violation flags reduced to the output's leading axis (the
    batch axis everywhere on the serving path)."""
    if viol.ndim == 0:
        return viol[None]
    return viol.reshape(viol.shape[0], -1).any(dim=1)


def guard_call(base, kind: str, a, b, dimension_numbers, cfg: EulerConfig,
               gcfg: GuardConfig = DEFAULT, *, op: str | None = None,
               path: str | None = None):
    """Run one contraction through ``base`` under the guard stack: ABFT
    check, sentinels, escalation, stats.

    ``kind`` picks the base method ("dot_general" uses the explicit
    ``dimension_numbers``; named ops use the base's own implementation,
    which the dimension numbers describe for the check).  ``op``/``path``
    label the stats; by default they come from the numerics dispatcher."""
    from repro_torch.numerics import api as _api
    from . import faults as _faults
    if op is None or path is None:
        d_op, d_path = _api.last_dispatch()
        op = op if op is not None else d_op
        path = path if path is not None else d_path

    if kind == "dot_general":
        def call(cfg_i):
            return base.dot_general(a, b, dimension_numbers, cfg_i)
    else:
        def call(cfg_i):
            return getattr(base, kind)(a, b, cfg_i)

    out0 = call(cfg)
    if gcfg.record == "off" and gcfg.max_retries <= 0:
        return out0

    if gcfg.quantize_check:
        aq, bq = _quantize_like(a, cfg), _quantize_like(b, cfg)
    else:  # fast profile: raw operands, quant_eps-widened tolerance
        aq = torch.as_tensor(a).to(torch.float32)
        bq = torch.as_tensor(b).to(torch.float32)
    viol = violation(out0, aq, bq, dimension_numbers, cfg, gcfg)
    detected = bool(viol.any())   # the host gate: one sync per guarded op

    out, still, retries = out0, detected, 0
    if detected:
        for i, cfg_i in enumerate(escalation_ladder(cfg, gcfg)):
            retries += 1
            # the retry index gives a FaultPlan a fresh draw, so a
            # transient flip is not replayed on the recompute
            with _faults.retrying(i + 1):
                o2 = call(cfg_i)
            if cfg_i == cfg or not gcfg.quantize_check:
                aq2, bq2 = aq, bq  # check operands are rung-invariant
            else:
                aq2 = _quantize_like(a, cfg_i)
                bq2 = _quantize_like(b, cfg_i)
            out = o2.to(out0.dtype)
            still = bool(violation(o2, aq2, bq2, dimension_numbers, cfg_i,
                                   gcfg).any())
            if not still:
                break

    if gcfg.record == "full" or (gcfg.record == "events" and detected):
        if gcfg.sentinels and cfg.mode in _POSIT_MODES:
            nar, sat = sentinel_counts(out0, cfg)
            words = math.prod(out0.shape)
        else:
            nar = sat = words = 0
        _record(path, op, words, detected, _leading_rows(viol).cpu(),
                retries, detected and not still, still, nar, sat)
    return out
