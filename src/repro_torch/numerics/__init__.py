"""Numerics API of the port: policies, backends (exact | lax_ref | cuda,
and the faulty:/guarded: wrappers) and the context-scoped op set."""
from .policy import (OP_KINDS, PolicyRule, PrecisionPolicy, ecfg_from_dict,
                     ecfg_to_dict, load_policy)
from .backends import (Backend, CudaBackend, ExactBackend, FaultyBackend,
                       GuardedBackend, LaxRefBackend, faulty, get_backend,
                       guarded, register_backend)
from .api import (DEFAULT, NumericsContext, current, current_path,
                  decode_attention, dot_general, drain_guard_events,
                  guard_stats, guard_totals, last_dispatch, reset_guard_stats,
                  resolve, scope, scoped)

__all__ = [
    "OP_KINDS", "PolicyRule", "PrecisionPolicy", "ecfg_from_dict",
    "ecfg_to_dict", "load_policy",
    "Backend", "CudaBackend", "ExactBackend", "FaultyBackend",
    "GuardedBackend", "LaxRefBackend", "faulty", "get_backend", "guarded",
    "register_backend",
    "DEFAULT", "NumericsContext", "current", "current_path",
    "decode_attention", "dot_general", "drain_guard_events", "guard_stats",
    "guard_totals", "last_dispatch", "reset_guard_stats", "resolve",
    "scope", "scoped",
]
