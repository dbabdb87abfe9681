"""A model family's yardstick, one file each (``families/<family>.py``),
found by the ``family`` of a configuration's ``model`` object: the layer's
projection contractions (for the counts), each layer's attention window,
the weight leaves drawn from the seed, and the FLOPs of any mixer beside
attention and the projections.  A configuration of a new family adds its
file here and its reference decoder under ``reference/`` (named by the
configuration's ``reference`` key); no file that is here changes."""
from __future__ import annotations

import importlib
import importlib.util
import pkgutil


def load(family: str):
    """The module of ``family``."""
    name = f"{__name__}.{family}"
    if not family.isidentifier() or importlib.util.find_spec(name) is None:
        known = sorted(m.name for m in pkgutil.iter_modules(__path__))
        raise ValueError(f"family {family!r}: the yardstick knows {known}")
    return importlib.import_module(name)
