"""Bit-accurate posit codec, ILM planes, quire, engine, error metrics and
the paper's hardware model, on torch tensors."""
from .posit import (PositConfig, POSIT8, POSIT16, POSIT32, BPOSIT8, BPOSIT16,
                    BPOSIT32, BY_WIDTH, decode_fields, decode_to_float,
                    encode_from_float, quantize)
from .engine import (EulerConfig, EXACT, from_variant, euler_dot_general,
                     euler_matmul, euler_einsum_qk, euler_einsum_pv,
                     operand_planes, VARIANT_NAMES)
from .metrics import error_metrics
from . import logmult, quire, reliability, hwmodel

__all__ = [
    "PositConfig", "POSIT8", "POSIT16", "POSIT32", "BPOSIT8", "BPOSIT16",
    "BPOSIT32", "BY_WIDTH", "decode_fields", "decode_to_float",
    "encode_from_float", "quantize", "EulerConfig", "EXACT", "from_variant",
    "euler_dot_general", "euler_matmul", "euler_einsum_qk", "euler_einsum_pv",
    "operand_planes", "VARIANT_NAMES", "error_metrics", "logmult", "quire",
    "reliability", "hwmodel",
]
