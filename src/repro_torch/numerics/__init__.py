"""Numerics API of the port: policies, backends (exact | lax_ref | cuda,
and the faulty:/guarded: wrappers) and the context-scoped op set, with
explicit (``Ctx``) and ambient (:func:`use`) resolution."""
from .policy import (OP_KINDS, PolicyRule, PrecisionPolicy, ecfg_from_dict,
                     ecfg_to_dict, load_policy)
from .backends import (Backend, CudaBackend, ExactBackend, FaultyBackend,
                       GuardedBackend, LaxRefBackend, available_backends,
                       faulty, get_backend, guarded, register_backend)
from .api import (DEFAULT, NumericsContext, current, current_path,
                  decode_attention, dot_general, drain_guard_events,
                  elementwise, guard_stats, guard_totals, last_dispatch,
                  matmul, pv, qk, reset_guard_stats, resolve, scope, scoped,
                  use)

__all__ = [
    "OP_KINDS", "PolicyRule", "PrecisionPolicy", "ecfg_from_dict",
    "ecfg_to_dict", "load_policy",
    "Backend", "CudaBackend", "ExactBackend", "FaultyBackend",
    "GuardedBackend", "LaxRefBackend", "available_backends", "faulty",
    "get_backend", "guarded", "register_backend",
    "DEFAULT", "NumericsContext", "current", "current_path",
    "decode_attention", "dot_general", "drain_guard_events", "elementwise",
    "guard_stats", "guard_totals", "last_dispatch", "matmul", "pv", "qk",
    "reset_guard_stats", "resolve", "scope", "scoped", "use",
]
