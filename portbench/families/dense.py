"""The dense GQA decoder: attention and a gated MLP a layer."""
from __future__ import annotations


def projections(s) -> list[tuple[str, int, int]]:
    """(name, K, N) of one layer's projection contractions."""
    d, H, KV, hd, f = (s.d_model, s.n_heads, s.n_kv_heads, s.head_dim,
                       s.d_ff)
    return [("wq", d, H * hd), ("wk", d, KV * hd), ("wv", d, KV * hd),
            ("wo", H * hd, d), ("wi", d, f), ("wg", d, f), ("w_down", f, d)]


def window_of(s, i: int) -> int | None:
    """Layer i's attention window (None: global)."""
    return None


def layer_leaves(s, i: int):
    """(path, shape, init) of layer i's leaves, init ("normal", scale),
    ("ones",), ("zeros",), ("a_log",) or ("dt_bias",)."""
    d = s.d_model
    L = ("layers", i)
    H, KV, hd, f = s.n_heads, s.n_kv_heads, s.head_dim, s.d_ff
    out = [(L + ("ln1", "g"), (d,), ("ones",))]
    for name, k, n in (("wq", d, H * hd), ("wk", d, KV * hd),
                       ("wv", d, KV * hd), ("wo", H * hd, d)):
        out.append((L + ("attn", name, "w"), (k, n), ("normal", k ** -0.5)))
    out.append((L + ("ln2", "g"), (d,), ("ones",)))
    for name, k, n in (("wi", d, f), ("wg", d, f), ("wo", f, d)):
        out.append((L + ("mlp", name, "w"), (k, n), ("normal", k ** -0.5)))
    return out


def mixer_prompt_flops(s) -> int:
    """FLOPs a prompt token of the mixers beside attention and the
    projections, all layers."""
    return 0


def mixer_decode_flops(s) -> int:
    """The same for a decode token."""
    return 0
