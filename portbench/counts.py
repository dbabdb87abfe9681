"""The work a window needed, counted in closed form from the published
widths and the tokens its calls processed, never from launches: it reads
the same whatever implements it.

* Model FLOPs (``mfu``): 2 x matmul parameters a token (the projections;
  the tied head once a prefill and once a decode token, since serving
  needs the last position's logits only), attention's 4 x ctx x H*hd a
  token and attention layer (ctx capped at the window on windowed
  layers), and the family's other mixers (``families/<family>.py``: the
  hybrid's SSD, its chunked form a prompt token and its recurrence a
  decode token).
* The projections' least time (``roofline_pct.contract``): for each
  projection contraction of M rows, the larger of 2MKN at the bf16 tensor
  rate and ((MK + KN) w/8 + 4MN) bytes at the HBM rate, w the posit word
  width: every operand read once as words, the f32 output written once.
* Paged decode's least time: each active slot's K and V words over its
  context, its q and output, at the HBM rate.

Peaks: NVIDIA's data sheet for one H100 SXM, dense: 989 TFLOP/s bf16 and
3.35 TB/s HBM3."""
from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def _attn_ctx_sum(s, T0: int, T1: int, window) -> int:
    """Sum over positions t in [T0, T1) of the context t + 1, capped at
    ``window``."""
    def upto(n):  # sum_{t < n} min(t + 1, w)
        if window is None or n <= window:
            return n * (n + 1) // 2
        return window * (window + 1) // 2 + (n - window) * window
    return upto(T1) - upto(T0)


def matmul_params(s) -> int:
    """Projection parameters a token passes, all layers (no head)."""
    return s.n_layers * sum(k * n for _, k, n in s.projections())


def head_params(s) -> int:
    return s.d_model * s.vocab_padded


def attention_flops(s, T0: int, T1: int, full_square: bool = False) -> int:
    """Attention's qk and pv FLOPs for the positions [T0, T1) over their
    causal contexts; ``full_square``: every position over all T1 (what a
    prefill's flash chunks compute, for the cost model's count)."""
    HD = s.n_heads * s.head_dim
    total = 0
    for i in range(s.n_layers):
        if full_square:
            ctx = (T1 - T0) * T1
        else:
            ctx = _attn_ctx_sum(s, T0, T1, s.window_of(i))
        total += 4 * ctx * HD
    return total


def prefill_flops(s, T: int) -> int:
    """Model FLOPs of a prefill of T prompt tokens (its head on the last
    position)."""
    return (2 * matmul_params(s) * T + 2 * head_params(s)
            + attention_flops(s, 0, T) + s.fam.mixer_prompt_flops(s) * T)


def decode_flops(s, positions) -> int:
    """Model FLOPs of one decode step over the active slots at their cache
    ``positions`` (the row written this step)."""
    n = len(positions)
    att = sum(attention_flops(s, int(p), int(p) + 1) for p in positions)
    return (2 * (matmul_params(s) + head_params(s)) * n + att
            + s.fam.mixer_decode_flops(s) * n)


def contract_least_s(s, M: int, word_bits: int, head_rows: int) -> float:
    """The least time of one pass's projection contractions over M rows,
    plus the head over ``head_rows`` rows (0: none)."""
    def one(m, k, n):
        ops = 2 * m * k * n
        byts = (m * k + k * n) * word_bits / 8 + 4 * m * n
        return max(ops / PEAK_FLOPS, byts / PEAK_BYTES)
    total = s.n_layers * sum(one(M, k, n) for _, k, n in s.projections())
    if head_rows:
        total += one(head_rows, s.d_model, s.vocab_padded)
    return total


def paged_decode_least_s(s, contexts, word_bits: int) -> float:
    """Paged decode's least time for one step: K and V words of each
    active slot's context, q in and the output out (float32), all
    layers."""
    kv = 2 * s.n_kv_heads * s.head_dim * word_bits / 8
    qo = 2 * s.n_heads * s.head_dim * 4
    byts = s.n_layers * sum(int(c) * kv + qo for c in contexts)
    return byts / PEAK_BYTES
