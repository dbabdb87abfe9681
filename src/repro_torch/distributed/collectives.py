"""Numerics of the compressed gradient all-reduce: int8 block quantization
and error feedback.

Counterpart of ``repro.distributed.collectives`` (its value-level half):
``int8_quantize``/``int8_dequantize``, ``compression_ratio``, ``ef_init``
and ``ef_compress``, which ``training.train_step`` applies under
``compress_grads``.  Both packages round half to even, so the int8 words
and scales are bit-identical.  The collectives themselves
(``compressed_psum``/``pmean``, ``bucketed``) wait for the multi-device
slice (ROADMAP queue 1, multi-device).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def int8_quantize(x, block: int = 2048):
    """Symmetric per-block int8 quantization.  Returns (q, scales, meta)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which rounds differently
    scale = torch.clamp(amax, min=1e-30) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32), (tuple(x.shape), n)


def int8_dequantize(q, scale, meta):
    shape, n = meta
    out = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return out.reshape(shape)


def compression_ratio(x, block: int = 2048) -> float:
    """Wire bytes of compressed vs f32 transfer (int8 payload + f32 scales)."""
    n = x.numel()
    nb = -(-n // block)
    return (n + 4 * nb) / (4 * n)


def ef_init(grads):
    """Zero residual buffer matching the gradient tree."""
    return T.map(torch.zeros_like, grads)


def ef_compress(grads, ef, block: int = 2048):
    """int8 quantization with error feedback over a gradient tree: returns
    (compressed grads, new residual).  The residual, what int8 could not
    represent, is carried into the next step."""
    comp, new_ef = [], []
    for g, e in zip(T.leaves(grads), T.leaves(ef), strict=True):
        tot = g + e
        deq = int8_dequantize(*int8_quantize(tot, block))
        comp.append(deq)
        new_ef.append(tot - deq)
    return T.unflatten(grads, comp), T.unflatten(grads, new_ef)
