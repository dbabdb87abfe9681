"""The paper's own configuration space: EULER-ADAS NCE operating points.

Variant names follow Tables I/II:  L-1, L-2, L-21, L-22 (+``b`` = bounded
regime).  ``DEFAULT`` is b3_LP-6_T8 (L-21b) at Posit-16 — the configuration
the paper headlines (best EDP / lowest power at near-baseline accuracy).
"""
import torch

from repro_torch.core.engine import EulerConfig, from_variant, VARIANT_NAMES

WIDTHS = (8, 16, 32)

# every (width, variant) operating point from the paper
POINTS = {
    (w, v): from_variant(w, v) for w in WIDTHS for v in VARIANT_NAMES
}

# SIMD modes (Table I/II SIMD rows): shared 8-bit sub-lane datapath
SIMD_POINTS = {
    (16, v): from_variant(16, v, simd="8_16") for v in VARIANT_NAMES
}
SIMD_POINTS.update({
    (32, v): from_variant(32, v, simd="8_16_32") for v in VARIANT_NAMES
})

DEFAULT = from_variant(16, "L-21b")
EXACT_POSIT = EulerConfig(width=16, bounded=False, stages=0, trunc=None,
                          mode="posit")   # the R4BM exact-posit baseline
FP32 = EulerConfig(mode="exact")


def for_arch(dtype: str = "bfloat16") -> EulerConfig:
    """Default engine config for large-model runs (bf16 planes)."""
    return DEFAULT.replace(dtype=torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
