"""Architecture configs ported so far (copies of the reference's files).

``get_config(arch_id)`` returns the module; each module defines ``FULL``
(the assigned configuration), ``SMOKE`` (a reduced same-family config for
CPU tests) and ``EXPECTED`` (the raw assigned numbers).
"""
from __future__ import annotations

import importlib

ARCHS = ("gemma2_2b", "mamba2_1p3b", "hymba_1p5b")

ALIASES = {"gemma2-2b": "gemma2_2b", "mamba2-1.3b": "mamba2_1p3b",
           "hymba-1.5b": "hymba_1p5b"}


def get_config(arch: str):
    mod = ALIASES.get(arch, arch)
    if mod not in ARCHS:
        raise KeyError(f"unknown or unported arch {arch!r}; ported: "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")
