"""The hybrid decoder (Hymba): attention and Mamba-2 SSD heads in
parallel on a layer's input, then the gated MLP; global attention in the
first, middle and last layers, a sliding window elsewhere."""
from __future__ import annotations

from . import dense


def projections(s) -> list[tuple[str, int, int]]:
    return dense.projections(s) + [("in_proj", s.d_model, s.d_proj),
                                   ("out_proj", s.d_inner, s.d_model)]


def window_of(s, i: int) -> int | None:
    if not s.window:
        return None
    if s.n_global_layers and i in {0, s.n_layers // 2, s.n_layers - 1}:
        return None
    return s.window


def layer_leaves(s, i: int):
    d = s.d_model
    Hs, K, cd = s.n_ssm_heads, s.conv_kernel, s.conv_dim
    L = ("layers", i)
    S = L + ("ssm",)
    return dense.layer_leaves(s, i) + [
        (S + ("in_proj", "w"), (d, s.d_proj), ("normal", d ** -0.5)),
        (S + ("conv_w",), (K, cd), ("normal", (K * cd) ** -0.5)),
        (S + ("conv_b",), (cd,), ("zeros",)),
        (S + ("A_log",), (Hs,), ("a_log",)),
        (S + ("D",), (Hs,), ("ones",)),
        (S + ("dt_bias",), (Hs,), ("dt_bias",)),
        (S + ("norm_g",), (s.d_inner,), ("ones",)),
        (S + ("out_proj", "w"), (s.d_inner, d),
         ("normal", s.d_inner ** -0.5)),
        (L + ("bn_a", "g"), (d,), ("ones",)),
        (L + ("bn_s", "g"), (d,), ("ones",)),
    ]


def mixer_prompt_flops(s) -> int:
    """The SSD's chunked form (Mamba-2): 2QN + 2QHP + 4NHP a token."""
    Q, N, HP = s.ssm_chunk, s.ssm_state, s.d_inner
    return s.n_layers * (2 * Q * N + 2 * Q * HP + 4 * N * HP)


def mixer_decode_flops(s) -> int:
    """The SSD's recurrence: 4NHP a token."""
    return s.n_layers * 4 * s.ssm_state * s.d_inner
