"""Deprecated alias: the ECE analysis lives in ``repro_torch.reliability.ece``
(the reliability package: fault injection, ABFT guards, serving campaign).
Counterpart of ``repro.core.reliability``: attribute access through this
shim emits a :class:`DeprecationWarning`.

Resolution is lazy (module ``__getattr__``): ``repro_torch.core`` imports
this shim while ``repro_torch.reliability.ece`` itself imports
``repro_torch.core``, so an eager re-export would deadlock whichever side
is imported first.
"""
import warnings

_NAMES = ("ece", "ece_vs_regime_bound", "improvement_factor",
          "_classify_bits", "_log2_magnitude")

__all__ = ["ece", "ece_vs_regime_bound", "improvement_factor"]


def __getattr__(name):
    if name in _NAMES:
        import importlib
        warnings.warn(
            f"repro_torch.core.reliability.{name} is deprecated; import it "
            "from repro_torch.reliability instead", DeprecationWarning,
            stacklevel=2)
        # import_module: the package __init__ shadows the submodule
        # attribute with the function
        return getattr(importlib.import_module("repro_torch.reliability.ece"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
