"""Architecture configs (copies of the reference's files; public-literature
sources in each file's docstring).

``get_config(arch_id)`` returns the module; each module defines ``FULL``
(the assigned configuration), ``SMOKE`` (a reduced same-family config for
CPU tests) and ``EXPECTED`` (the raw assigned numbers).  ``SHAPES`` maps
the per-arch input-shape set; ``shape_applicable`` encodes the long_500k
sub-quadratic rule.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "nemotron_4_15b",
    "gemma2_27b",
    "yi_6b",
    "gemma2_2b",
    "arctic_480b",
    "llama4_scout_17b_a16e",
    "musicgen_large",
    "mamba2_1p3b",
    "chameleon_34b",
    "hymba_1p5b",
)

# canonical ids as assigned (hyphenated) -> module names
ALIASES = {
    "nemotron-4-15b": "nemotron_4_15b",
    "gemma2-27b": "gemma2_27b",
    "yi-6b": "yi_6b",
    "gemma2-2b": "gemma2_2b",
    "arctic-480b": "arctic_480b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "musicgen-large": "musicgen_large",
    "mamba2-1.3b": "mamba2_1p3b",
    "chameleon-34b": "chameleon_34b",
    "hymba-1.5b": "hymba_1p5b",
}

SHAPES = {
    "train_4k":    {"seq_len": 4_096,   "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32_768,  "global_batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq_len": 32_768,  "global_batch": 128, "kind": "decode"},
    "long_500k":   {"seq_len": 524_288, "global_batch": 1,   "kind": "decode"},
}


def get_config(arch: str):
    mod = ALIASES.get(arch, arch)
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def shape_applicable(arch: str, shape: str) -> bool:
    """long_500k needs sub-quadratic decode: SSM/hybrid only."""
    if shape != "long_500k":
        return True
    return get_config(arch).FULL.sub_quadratic


def all_cells():
    """The 40 assigned (arch, shape) cells; long_500k skips marked inline."""
    for arch in ALIASES:
        for shape in SHAPES:
            yield arch, shape, shape_applicable(arch, shape)
