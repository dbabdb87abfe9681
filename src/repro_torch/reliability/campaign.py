"""Serving-scale fault-injection campaign.

Counterpart of ``repro.reliability.campaign``: live continuous-batching
traffic (``RequestBatcher`` over ``ServeEngine``) decodes under seeded
:class:`FaultPlan`\\ s applied by the ``faulty:<base>`` backend, and
corruption is measured on the tokens users would have seen: per-request
edit distance against the fault-free run of the same traffic.

Orderings it reproduces (the application-level analogue of Eqs. 5-7):

  * **bounded < unbounded**: at equal per-word flip rate, B-Posit serving
    corrupts fewer tokens than standard posit of the same width;
  * **regime > fraction**: flips on regime-run bits corrupt more than
    flips on fraction bits.

Traffic, weights and fault draws are seeded and decoding is greedy, so a
campaign is deterministic for a seed on one device.  The draws come from
``torch.Generator`` streams, not the reference's JAX PRNG, so the numbers
differ from the reference's campaign; the orderings are what carries over.
Not imported by ``repro_torch.reliability`` (it pulls in models and
serving).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import EulerConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.transformer import Model
from repro_torch.numerics import NumericsContext, PrecisionPolicy
from repro_torch.numerics.backends import faulty, guarded
from repro_torch.reliability import faults as _faults
from repro_torch.reliability import guards as _guards
from repro_torch.reliability.faults import FaultPlan
from repro_torch.serving import GenerationConfig, RequestBatcher, ServeEngine

TINY = ModelConfig(name="faultcamp", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                   loss_chunk=32, q_chunk=32, kv_chunk=32)


def edit_distance(a, b) -> int:
    """Levenshtein distance between two token sequences (plain DP)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _traffic(n_requests: int, vocab: int, seed: int):
    """The campaign's deterministic request mix (same for every run)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 20)))
            for _ in range(n_requests)]


def _drain(engine: ServeEngine, prompts, gen: GenerationConfig):
    """One full scheduler drain of the fixed traffic; returns (results,
    rid->slot map from the admission events)."""
    b = RequestBatcher(engine, prompt_buckets=(32,))
    for p in prompts:
        b.submit(p, max_new=gen.max_new_tokens)
    res = b.run(gen)
    slot_of = {rid: s for kind, rid, s, _ in b.events
               if kind in ("admit", "refill")}
    return res, slot_of


def _compare(base: dict, res: dict, slot_of: dict) -> dict:
    """Token-level corruption of ``res`` against the fault-free ``base``."""
    edits, base_toks, corrupted = 0, 0, []
    per_request = {}
    for rid in sorted(base):
        d = edit_distance([int(t) for t in base[rid]],
                          [int(t) for t in res[rid]])
        edits += d
        base_toks += len(base[rid])
        per_request[str(rid)] = d
        if d:
            corrupted.append(rid)
    n = max(len(base), 1)
    return {
        "requests": len(base),
        "corrupted_requests": len(corrupted),
        "request_corruption_rate": round(len(corrupted) / n, 6),
        "token_error_rate": round(edits / max(base_toks, 1), 6),
        "mean_edit_distance": round(edits / n, 6),
        "edit_distance_per_request": per_request,
        "slots_hit": sorted({slot_of[rid] for rid in corrupted}),
    }


def run_campaign(*, widths=(16, 32), roles=("regime_run", "fraction"),
                 rate: float = 5e-4, n_requests: int = 8, max_new: int = 12,
                 batch: int = 2, seed: int = 0, backend: str = "lax_ref",
                 operand: str = "a", model_cfg: ModelConfig | None = None,
                 eos_id: int | None = 7, guard: bool = False,
                 guard_cfg=None, device: str = "cuda") -> dict:
    """Run the (format x role) grid at equal flip rate.

    One model (exact weights from ``seed``, shared by every format: the
    precision is a serve-time numerics switch) decodes the same traffic
    once clean and once per fault plan, per format.  ``operand="a"`` hits
    activations, ``"b"`` weights.

    ``guard=True`` adds the defense arm: each cell reruns through
    ``guarded:faulty:<backend>`` with recording plans, giving the ABFT
    detection rate (violations over ops where a flip landed), op and
    request recovery rates and the residual token damage; a guarded clean
    drain per format counts false positives (must be zero)."""
    cfg = model_cfg if model_cfg is not None else TINY
    model = Model(cfg, EulerConfig(mode="exact"), device=device)
    params = model.init(seed)
    ctx = Ctx(ecfg=model.ecfg)
    prompts = _traffic(n_requests, cfg.vocab, seed)
    gen = GenerationConfig(max_new_tokens=max_new, eos_id=eos_id)
    fb = faulty(backend)
    if guard:
        # lean profile, as the reference's: event-gated recording, no
        # sentinel encode, a 2-rung ladder (same-precision redraw, exact)
        if guard_cfg is None:
            guard_cfg = _guards.GuardConfig(record="events", sentinels=False,
                                            max_retries=2)
        gb = guarded(fb, guard_cfg)

    formats = {}
    for w in widths:
        for bounded in (False, True):
            label = f"{'bposit' if bounded else 'posit'}{w}"
            formats[label] = EulerConfig(mode="posit", width=w,
                                         bounded=bounded)

    out: dict = {
        "config": {"widths": list(widths), "roles": list(roles),
                   "rate": rate, "n_requests": n_requests,
                   "max_new": max_new, "batch": batch, "seed": seed,
                   "backend": backend, "operand": operand,
                   "model": cfg.name, "eos_id": eos_id, "guard": guard,
                   "device": str(model.device)},
        "formats": {},
    }

    def engine(ecfg, backend_name):
        nctx = NumericsContext(policy=PrecisionPolicy.uniform(ecfg),
                               backend=backend_name)
        return ServeEngine(model, params, ctx, max_len=64, batch=batch,
                           cache_dtype="float32", numerics=nctx)

    for label, ecfg in formats.items():
        eng = engine(ecfg, fb.name)
        base, _ = _drain(eng, prompts, gen)
        fmt = {"bounded": ecfg.bounded, "width": ecfg.width,
               "regime_bound": ecfg.posit.regime_max, "roles": {}}
        if guard:
            eng_g = engine(ecfg, gb.name)
            _guards.reset()
            base_g, _ = _drain(eng_g, prompts, gen)
            t = _guards.totals(reset=True)
            fmt["guard_clean"] = {
                "checks": t["checks"],
                "false_positives": t["violations"],
                "tokens_equal_unguarded": bool(all(
                    np.array_equal(base[rid], base_g[rid]) for rid in base)),
            }
        for role in roles:
            eng.fault = FaultPlan(seed=seed + 1, rate=rate, role=role,
                                  operand=operand)
            res, slot_of = _drain(eng, prompts, gen)
            cell = _compare(base, res, slot_of)
            if guard:
                eng_g.fault = FaultPlan(seed=seed + 1, rate=rate, role=role,
                                        operand=operand, record=True)
                _guards.reset()
                _faults.injection_stats(reset=True)
                res_g, slot_of_g = _drain(eng_g, prompts, gen)
                t = _guards.totals(reset=True)
                inj = _faults.injection_stats(reset=True)
                affected = [int(rid) for rid, d in
                            cell["edit_distance_per_request"].items() if d]
                restored = sum(1 for rid in affected
                               if np.array_equal(base[rid], res_g[rid]))
                residual = _compare(base, res_g, slot_of_g)
                cell["guarded"] = {
                    "injected_ops": inj["ops"],
                    "injected_words": inj["words"],
                    "violations": t["violations"],
                    "detection_rate": round(
                        t["violations"] / inj["ops"], 6) if inj["ops"] else None,
                    "retries": t["retries"],
                    "op_recovery_rate": round(
                        t["recovered"] / t["violations"], 6)
                        if t["violations"] else None,
                    "unrecovered": t["unrecovered"],
                    "affected_requests": len(affected),
                    "restored_requests": restored,
                    "request_recovery_rate": round(
                        restored / len(affected), 6) if affected else None,
                    "residual_token_error_rate":
                        residual["token_error_rate"],
                    "residual_corrupted_requests":
                        residual["corrupted_requests"],
                }
            fmt["roles"][role] = cell
        out["formats"][label] = fmt

    # -- summary: the paper's orderings at application level ---------------
    def agg_ter(label):
        r = out["formats"][label]["roles"]
        return sum(v["token_error_rate"] for v in r.values())

    def role_ter(role):
        return sum(f["roles"][role]["token_error_rate"]
                   for f in out["formats"].values())

    summary: dict = {"gamma_app": {}, "ordering": {}}
    ter_u = ter_b = 0.0
    for w in widths:
        u, b = agg_ter(f"posit{w}"), agg_ter(f"bposit{w}")
        ter_u += u
        ter_b += b
        summary["gamma_app"][str(w)] = round(u / b, 4) if b > 0 else None
    summary["ordering"]["bounded_below_unbounded"] = bool(ter_b < ter_u)
    if "regime_run" in roles and "fraction" in roles:
        summary["ordering"]["regime_worse_than_fraction"] = bool(
            role_ter("regime_run") > role_ter("fraction"))
    if guard:
        inj = viol = aff = rest = fp = 0
        inj_regime = viol_regime = 0
        for fmt in out["formats"].values():
            fp += fmt["guard_clean"]["false_positives"]
            for role, cell in fmt["roles"].items():
                g = cell["guarded"]
                inj += g["injected_ops"]
                viol += g["violations"]
                aff += g["affected_requests"]
                rest += g["restored_requests"]
                if role == "regime_run":
                    inj_regime += g["injected_ops"]
                    viol_regime += g["violations"]
        summary["guard"] = {
            "false_positives": fp,
            "detection_rate": round(viol / inj, 6) if inj else None,
            "detection_rate_regime": round(
                viol_regime / inj_regime, 6) if inj_regime else None,
            "request_recovery_rate": round(rest / aff, 6) if aff else None,
        }
    out["summary"] = summary
    return out
