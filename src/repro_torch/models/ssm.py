"""Mamba-2 SSD (state-space duality) mixer with EULER-ADAS numerics.

Counterpart of ``repro.models.ssm``: the chunked SSD algorithm of Dao & Gu
(arXiv:2405.21060) for prefill, and the classic recurrence
``S' = dA * S + dt * (B ⊗ x)``, ``y = C·S'`` with a rolling conv buffer for
the O(1) decode step.

The reference's ``lax.scan`` over chunks is a Python loop here.  Its
chunks are not rematerialized one by one: in training the whole block is
(``Model`` remat), and gradients reach the chunk scan through autograd as
through ``jax.grad`` in the reference (the log-decay masked before
``exp``).  A chunk's four contractions go through
``repro_torch.numerics`` with the reference's dimension numbers; they have
batch dimensions, so the ``cuda`` backend runs them on the reference
engine, as the reference's Pallas backend does.  ``in_proj`` and
``out_proj`` are plain projections and reach the fused encode and logmac on
``cuda``.  Under the production placement (``Ctx.placement``) ``in_proj``
is column-parallel with its packed [z, x, B, C, dt] columns gathered,
the rank runs its block of the heads where ``A_log`` is split over
``model`` (the gated norm's mean summed over ``model``), and ``out_proj``
is row-parallel.  The cross-chunk state accumulation and the decode recurrence
stay exact f32.

Caches are updated in place: ``ssm_apply`` writes the new state and conv
tail into the cache views it is given (the reference returns new arrays);
training passes no cache, so no write is ever differentiated.  A
posit-word cache stores the conv tail as unsigned words, saturated as XLA
converts them (:func:`conv_to_cache`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import numerics as NU  # 'N' is the SSM state dim locally
from repro_torch.core import posit as _P
from repro_torch.core import xla_f32 as _X

from repro_torch.distributed import collectives as C

from .layers import (Ctx, cache_reset, column_gathered, dense_init, randn,
                     row_apply)


def ssm_init(gen, cfg, device):
    """Mamba-2 mixer params.  Group count G=1 (shared B/C across heads)."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.n_ssm_heads
    K = cfg.conv_kernel
    conv_dim = di + 2 * N  # conv over [x, B, C] as in the reference impl
    d_proj = 2 * di + 2 * N + H  # in_proj emits [z, x, B, C, dt]
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = randn((K, conv_dim), gen, device)
    return {
        "in_proj": dense_init(gen, d, d_proj, device),
        "conv_w": conv_w.mul_((K * conv_dim) ** -0.5),
        "conv_b": torch.zeros((conv_dim,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, H,
                                                        **f32))),
        "norm_g": torch.ones((di,), **f32),
        "out_proj": dense_init(gen, di, d, device),
    }


def _gated_rmsnorm(y, z, g, eps=1e-6, group=None):
    """The gated RMS norm over the last dim; ``group``: the dim is split
    over it (the model axis), so the mean is the group's sum over the
    whole width."""
    y = y * _X.silu(z.to(torch.float32))
    if group is None:
        var = _X.mean_last(y * y)
    else:   # every rank's features take part in the mean's gradient
        var = C.copy_sum_grad(C.reduce_sum((y * y).sum(-1, keepdim=True),
                                           group), group) / (
            y.shape[-1] * C.group_size(group))
    return y * _X.rsqrt(var + eps) * g


def _causal_conv(u, w, b):
    """Depthwise causal conv along T.  u: [B, T, C], w: [K, C]."""
    K = w.shape[0]
    T = u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for i in range(K):  # K is tiny (4)
        out = out + pad[:, i:i + T, :] * w[i]
    return out + b


def conv_to_cache(x, dtype):
    """The conv tail as a cache of ``dtype`` stores it.  A posit-word cache
    holds unsigned words (uint16/uint32 in int16/int32 storage); XLA
    converts a float to an unsigned word by truncating toward zero and
    saturating to [0, 2^N - 1] (NaN to 0), and so does this."""
    pc = _P.storage_pc(dtype)
    if pc is None:
        return x.to(dtype)
    w = torch.nan_to_num(x.to(torch.float64).trunc(), nan=0.0)
    w = w.clamp(0, _P.mask(pc.n_bits)).to(torch.int64)
    return _P.to_storage(w, pc)


def conv_from_cache(c):
    """A cached conv tail as float32 (integer words read as unsigned)."""
    pc = _P.storage_pc(c.dtype)
    if pc is None:
        return c.to(torch.float32)
    return _P.from_storage(c, pc).to(torch.float32)


def _split_proj(zxbcdt, cfg):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, xBC, dt


def cumsum(x, dim: int):
    """The SSD's inclusive prefix sum: on CPU tensors ``jnp.cumsum``'s order
    on XLA:CPU (``core/xla_f32.py``), which the hybrid's whole-model L-21b
    gradients need to follow ``jax.grad``'s (ROADMAP queue 3); on the card
    :func:`log_step_scan`."""
    if x.device.type == "cpu":
        return _X.prefix_sum(x, dim)
    return log_step_scan(x, dim)


def log_step_scan(x, dim: int):
    """Inclusive prefix sum along ``dim`` in ceil(log2 n) shifted adds, in
    an order fixed by the shape alone: deterministic on a card, where
    torch refuses a float ``cumsum`` under deterministic algorithms."""
    n, step = x.shape[dim], 1
    while step < n:
        shifted = F.pad(x.narrow(dim, 0, n - step).movedim(dim, -1),
                        (step, 0)).movedim(-1, dim)
        x = x + shifted
        step *= 2
    return x


def ssd_chunked(x, dt, A, Bm, Cm, ctx: Ctx, chunk: int, initial_state=None,
                heads_split: bool = False):
    """Chunked SSD: a loop over chunks carrying the [B, H, N, P] state,
    which accumulates exactly in f32 (the quire analogue).

    Args:
      x:  [B, T, H, P] inner activations.
      dt: [B, T, H]    softplus'd step sizes.
      A:  [H]          negative decay rates.
      Bm/Cm: [B, T, N] input/output projections (G=1 group, shared by heads).
      heads_split: x, dt and A hold the rank's block of the heads (the
        production placement): operands over heads take their statistics
        over data and model, B and C (shared by the heads) over data.
    Returns:
      y: [B, T, H, P], final_state [B, H, N, P].
    """
    gh = ctx.joint_group if heads_split else ctx.data_group
    gd = ctx.data_group
    g_bc, g_hh, g_bh = ((gd, gd), (gh, gh), (gd, gh)) if heads_split else (
        None, None, None)
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"SSD chunk {Q}")
    dev = x.device
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    neg = torch.tensor(-1e30, device=dev)
    S = (initial_state if initial_state is not None
         else torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=dev))
    ys = []
    for c in range(T // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = dtq * A                                           # [B, Q, H]
        cum = cumsum(dA, 1)
        # intra-chunk dual form: scores[i,j] = C_i · B_j (EULER-quantized)
        dn = (((2,), (2,)), ((0,), (0,)))
        scores = NU.dot_general(Cq, Bq, dn, ctx.numerics, op="qk",
                                groups=g_bc)
        # mask the log-decay BEFORE exp (the reference's where-grad guard)
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]        # [B,Qi,Qj,H]
        ldiff = torch.where(causal[None, :, :, None], ldiff, neg)
        M = scores[..., None] * _X.exp(ldiff)                  # [B,Qi,Qj,H]
        xdt = xq * dtq[..., None]                              # [B,Q,H,P]
        # y_intra[i,h,p] = sum_j M[i,j,h] xdt[j,h,p]
        dn2 = (((3,), (1,)), ((0, 1), (0, 2)))  # [B,H,Qi,Qj] x [B,Qj,H,P]
        y_intra = NU.dot_general(M.movedim(-1, 1), xdt, dn2, ctx.numerics,
                                 op="pv", groups=g_hh
                                 ).movedim(1, 2)               # [B,Qi,H,P]
        # inter-chunk: y_inter[i] = exp(cum_i) * (C_i · S_in)
        dn3 = (((2,), (1,)), ((0,), (0,)))  # Cq [B,Q,N] x S_in [B,N,H,P]
        y_inter = NU.dot_general(Cq, S.movedim(1, 2), dn3, ctx.numerics,
                                 groups=g_bh)
        y_inter = y_inter * _X.exp(cum)[..., None]
        # state update: S_out = decay * S_in + sum_j B_j ⊗ (w_j x_j)
        decay_out = _X.exp(cum[:, -1:, :] - cum)               # [B,Q,H]
        w = xdt * decay_out[..., None]                         # [B,Q,H,P]
        dn4 = (((1,), (1,)), ((0,), (0,)))  # contract Q
        S_chunk = NU.dot_general(Bq, w, dn4, ctx.numerics,
                                 groups=g_bh).movedim(1, 2)
        chunk_decay = _X.exp(cum[:, -1, :])                    # [B,H]
        S = S * chunk_decay[:, :, None, None] + S_chunk
        ys.append(y_intra + y_inter)
    return torch.cat(ys, 1), S


@NU.scoped("ssm")
def ssm_apply(p, x, ctx: Ctx, cfg, cache=None):
    """Full Mamba-2 mixer.  cache None: chunked forward over [B, T, d];
    cache ``{"state", "conv"}`` and T > 1: prefill (the final state and
    conv tail written into the cache); T == 1: the O(1) decode step.
    Returns (out, cache)."""
    Bsz, T, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    K = cfg.conv_kernel

    # under the production placement in_proj's packed columns are
    # gathered; where A_log, D and dt_bias are split over model the rank
    # runs its block of the heads (and of z, the norm and out_proj's rows)
    zxbcdt = column_gathered(p["in_proj"], x, ctx,
                             2 * di + 2 * N + H)    # [B, T, 2di+2N+H]
    z, xBC, dt_raw = _split_proj(zxbcdt, cfg)
    mg = ctx.model_group if ctx.placed else None
    split = mg is not None and p["A_log"].shape[0] != H
    hg = mg if split else None     # the heads' group, where split
    H = p["A_log"].shape[0]
    z = C.take_block(z, -1, hg)
    dt_raw = C.take_block(dt_raw, -1, hg)
    norm_g = C.take_block(p["norm_g"], -1, hg)
    A = -_X.exp(p["A_log"])  # [H]
    dt = _X.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # [B,T,H]

    if cache is not None and T == 1:
        # ---- O(1) decode ----
        conv_buf = cache["conv"]  # [B, K-1, conv_dim]
        window = torch.cat([conv_buf, conv_to_cache(xBC, conv_buf.dtype)], 1)
        conv_out = torch.einsum("bkc,kc->bc", conv_from_cache(window),
                                p["conv_w"]) + p["conv_b"]
        conv_out = _X.silu(conv_out)[:, None, :]  # [B,1,cd]
        xin = C.take_block(conv_out[..., :di].reshape(Bsz, 1, -1, P), 2, hg)
        Bm = C.copy_sum_grad(conv_out[..., di:di + N], hg)
        Cm = C.copy_sum_grad(conv_out[..., di + N:], hg)
        S = cache["state"]  # [B, H, N, P]
        dA = _X.exp(dt[:, 0, :] * A)  # [B,H]
        dBx = (dt[:, 0, :, None, None] * Bm[:, 0, None, :, None]
               * xin[:, 0, :, None, :])
        S_new = S * dA[:, :, None, None] + dBx
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], S_new)  # contract N
        y = y + p["D"][None, :, None] * xin[:, 0]
        y = _gated_rmsnorm(y.reshape(Bsz, 1, H * P), z, norm_g, group=hg)
        out = row_apply(p["out_proj"], y.to(x.dtype), ctx, split)
        cache["state"].copy_(S_new)
        cache["conv"].copy_(window[:, 1:, :])
        return out, cache

    # ---- chunked forward / prefill ----
    conv_out = _X.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    xin = C.take_block(conv_out[..., :di].reshape(Bsz, T, -1, P), 2, hg)
    # B and C serve every head: their gradient sums the ranks' heads'
    Bm = C.copy_sum_grad(conv_out[..., di:di + N], hg)
    Cm = C.copy_sum_grad(conv_out[..., di + N:], hg)
    y, S_final = ssd_chunked(xin, dt, A, Bm, Cm, ctx, cfg.ssm_chunk,
                             heads_split=split)
    y = y + p["D"][None, None, :, None] * xin
    y = _gated_rmsnorm(y.reshape(Bsz, T, H * P), z, norm_g, group=hg)
    out = row_apply(p["out_proj"], y.to(x.dtype), ctx, split)
    if cache is not None:  # prefill: carry the final state + conv tail
        cache["state"].copy_(S_final)
        cache["conv"].copy_(conv_to_cache(xBC[:, T - (K - 1):, :],
                                          cache["conv"].dtype))
    return out, cache


def ssm_cache_init(cfg, batch: int, dtype, device):
    """``{"state": [B, H, N, P] f32, "conv": [B, K-1, conv_dim] dtype}``."""
    di, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    conv_dim = di + 2 * N
    return {
        "state": torch.zeros((batch, H, N, P), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def ssm_cache_reset(cache, slot=None, batch_axis: int = 0):
    """Zero the recurrent SSM state/conv buffers in place — whole cache or
    one batch slot.  The SSM state is recurrent (no validity mask hides a
    stale one), so a slot must be reset before a new request enters it."""
    return cache_reset(cache, slot, batch_axis)

