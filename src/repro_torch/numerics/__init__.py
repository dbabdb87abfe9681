"""Numerics API of the port: policies, backends (exact | lax_ref | cuda)
and the context-scoped op set."""
from .policy import (OP_KINDS, PolicyRule, PrecisionPolicy, ecfg_from_dict,
                     ecfg_to_dict, load_policy)
from .backends import (Backend, CudaBackend, ExactBackend, LaxRefBackend,
                       get_backend, register_backend)
from .api import (DEFAULT, NumericsContext, current, current_path,
                  decode_attention, dot_general, resolve, scope, scoped)

__all__ = [
    "OP_KINDS", "PolicyRule", "PrecisionPolicy", "ecfg_from_dict",
    "ecfg_to_dict", "load_policy",
    "Backend", "CudaBackend", "ExactBackend", "LaxRefBackend",
    "get_backend", "register_backend",
    "DEFAULT", "NumericsContext", "current", "current_path",
    "decode_attention", "dot_general", "resolve", "scope", "scoped",
]
