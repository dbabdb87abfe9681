"""Reliability subsystem of the port: ECE analysis, live fault injection,
ABFT guards and the serving-scale campaign.

Counterpart of ``repro.reliability``:

* ``ece``: the paper's Eqs. (3)-(7), Expected Catastrophic Error of single
  bit flips decomposed by bit role.
* ``faults``: :class:`FaultPlan` and the seeded flips the ``faulty:<base>``
  backend applies to live posit words.
* ``guards``: ABFT checksums, NaR/saturation sentinels and the
  detect -> escalate ladder of the ``guarded:<base>`` backend.
* ``campaign``: live continuous-batching traffic under fault plans (import
  it explicitly: it pulls in models and serving).
"""
from .guards import (GuardConfig, check_eps, escalation_ladder,
                     guard_call)
from .ece import (ece, ece_vs_regime_bound, improvement_factor,
                  word_flags)
from .faults import (FaultPlan, ROLES, call_salt, corrupt, current,
                     flip_words, inject, retry_index, retrying, role_mask)

__all__ = [
    "ece", "ece_vs_regime_bound", "improvement_factor", "word_flags",
    "FaultPlan", "ROLES", "call_salt", "corrupt", "current", "flip_words",
    "inject", "retry_index", "retrying", "role_mask",
    "GuardConfig", "check_eps", "escalation_ladder", "guard_call",
]
