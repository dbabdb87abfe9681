"""Soft-error resilience analysis of (bounded) posit: paper Eqs. (3)-(7).

Counterpart of ``repro.reliability.ece``.  Expected Catastrophic Error

    eta = E[ | log2|x_o| - log2|x_f| | ]

of one uniformly placed bit flip on a uniformly drawn valid pattern,
evaluated exactly for N = 8/16 (every (pattern, bit) pair through the
bit-accurate codec) and by Monte-Carlo for N = 32, decomposed by bit role
(regime run / terminator / exponent / fraction / sign; the G1/G2/G3 split
of Eq. 5).  The Monte-Carlo draw uses numpy, not the reference's JAX PRNG.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import posit as P

from .faults import _body, _run_width

ROLE_NAMES = {0: "sign", 1: "regime_run", 2: "regime_term", 3: "exponent",
              4: "fraction"}


def _log2_magnitude(fields, W):
    """Exact log2|x| from decoded fields (scale + log2 mantissa)."""
    mant = 1.0 + fields["frac"].to(torch.float32) * (2.0 ** -W)
    return fields["scale"].to(torch.float32) + torch.log2(mant)


def word_flags(pats, cfg: P.PositConfig) -> dict:
    """Per-word health flags of encoded posit words, the sentinel
    classification the guards count per op: ``is_nar`` / ``is_zero`` from
    the codec, ``saturated`` when the regime run reaches the format's cap."""
    p = torch.as_tensor(pats).to(torch.int64) & P.mask(cfg.n_bits)
    f = P.decode_fields(p, cfg)
    _, sat, _ = _run_width(_body(p, cfg.n_bits), cfg)
    return {"is_nar": f["is_nar"], "is_zero": f["is_zero"], "saturated": sat}


def _classify_bits(pats, cfg: P.PositConfig):
    """Role of each bit position for each pattern: 0=sign 1=run 2=term
    3=exp 4=frac, as ``[..., N]`` (bit index from the MSB)."""
    N = cfg.n_bits
    p = torch.as_tensor(pats).to(torch.int64) & P.mask(N)
    f = P.decode_fields(p, cfg)
    _, sat, rw = _run_width(_body(p, N), cfg)
    run_w = rw - (~sat).to(torch.int64)
    roles = [torch.zeros_like(rw)]
    for j in range(N - 1):  # position within the body, from its MSB
        role = torch.where(
            j < run_w, 1,
            torch.where((j < rw) & ~sat, 2,
                        torch.where(j < rw + cfg.es, 3, 4)))
        roles.append(role.to(torch.int64))
    return torch.stack(roles, -1), f


def ece(cfg: P.PositConfig, n_samples: int | None = None, seed: int = 0):
    """ECE and its per-bit-role decomposition: overall ``eta``, per-role
    ``eta_<role>`` and the exceptional-fault rate (flips that hit or
    produce zero or NaR)."""
    N = cfg.n_bits
    if N <= 16 and n_samples is None:
        pats = torch.arange(1 << N, dtype=torch.int64)
    else:
        n = n_samples or 1_000_000
        pats = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 1 << N, n, dtype=np.int64))

    f0 = P.decode_fields(pats, cfg)
    valid = ~(f0["is_zero"] | f0["is_nar"])
    W = cfg.frac_window
    lg0 = _log2_magnitude(f0, W)
    roles, _ = _classify_bits(pats, cfg)

    deltas, oks = [], []
    for bit in range(N):
        f1 = P.decode_fields(pats ^ (1 << (N - 1 - bit)), cfg)
        ok = valid & ~(f1["is_zero"] | f1["is_nar"])
        lg1 = _log2_magnitude(f1, W)
        deltas.append(torch.where(ok, (lg0 - lg1).abs(),
                                  torch.zeros((), dtype=torch.float32)))
        oks.append(ok)
    d = torch.stack(deltas, -1)
    ok = torch.stack(oks, -1)
    total_ok = ok.sum()
    eta = d.sum() / torch.clamp(total_ok, min=1)
    out = {"eta": float(eta),
           "exceptional_rate": float(1.0 - total_ok / (valid.sum() * N))}
    for rid, name in ROLE_NAMES.items():
        mask = ok & (roles == rid)
        cnt = torch.clamp(mask.sum(), min=1)
        out[f"eta_{name}"] = float(
            torch.where(mask, d, torch.zeros((), dtype=d.dtype)).sum() / cnt)
    return out


def improvement_factor(width: int, n_samples: int | None = None) -> float:
    """Gamma_B (Eq. 7): eta_std / eta_bounded for the paper's (N, es, R)."""
    std, bnd = P.BY_WIDTH[width]
    return ece(std, n_samples)["eta"] / ece(bnd, n_samples)["eta"]


def ece_vs_regime_bound(width: int, bounds, n_samples: int | None = None):
    """eta_B as a function of R (monotone increasing, Eq. 6)."""
    es = {8: 0, 16: 1, 32: 2}[width]
    return {r: ece(P.PositConfig(width, es, r), n_samples)["eta"]
            for r in bounds}
