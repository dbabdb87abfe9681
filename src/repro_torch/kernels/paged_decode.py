"""Paged flash-decode over posit-word KV pages.

Counterpart of ``repro.kernels.paged_decode``.  The serving tier stores KV
state as posit words in a shared ``[num_pages, page_size, KV, hd]`` pool per
layer, addressed through per-slot page tables.

* :func:`paged_attention_reference` — gather-then-attend, op for op the
  dense decode branch of ``models/layers.py`` (same dot dimension numbers,
  mask, softmax and probs dtype, with the qk/pv contractions routed through
  the caller's ``dot_fn``), so paged decode is bit-identical to dense on the
  reference backends.
* :func:`paged_flash_decode_plain` — the plain version of the fused kernel:
  page by page, the kernel's own math (posit decode to ILM planes,
  two-plane QK, softcap, causal+window mask, online softmax, re-encode of
  the probabilities in the pv format, two-plane PV).  Its scores are the
  kernel's bit for bit (:func:`page_scores`: the same summation order and
  the same ``expf``/``tanhf``, with no fast-math intrinsic), so the two
  encode the same probability words.
* :func:`paged_flash_decode` — the wrapper: the plain version for CPU
  tensors, the ``csrc/paged_decode.cu`` kernel for CUDA tensors (q's
  pre-scale and encode in one launch, then page-parallel passes: each
  page's probabilities are encoded against the running max of the serial
  walk, and the pages are combined with the telescoped weights
  ``exp(m_j - m_last)``; the same function up to f32 reassociation).

Page-table conventions (shared with ``serving/kvcache.py``): page
``NULL_PAGE`` (0) is never written, so unallocated table entries gather
exact zeros; page ``TRASH_PAGE`` (1) is the write sink of masked decode
rows and never appears in a table.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import posit as _P
from repro_torch.core import xla_f32 as _X
from repro_torch.core.engine import EulerConfig, _pow2_scale
from repro_torch.core.engine import dot_general as _dot_general
from repro_torch.core.logmult import effective_trunc
from . import _build
from . import logmac as _logmac
from . import posit_codec as _codec
from .logmac import decode_planes_raw, subtracts_rem
from .posit_codec import encode_body

NULL_PAGE = 0   # read-only all-zeros page; target of unallocated table slots
TRASH_PAGE = 1  # write-only sink page for masked rows; never in a table
RESERVED_PAGES = 2


def gather_pages(pages, table):
    """``[P, ps, ...]`` pool gathered through ``[B, nlp]`` table ids into a
    ``[B, nlp*ps, ...]`` logical cache view."""
    B, nlp = table.shape
    ps = pages.shape[1]
    g = pages[table.to(torch.long)]               # [B, nlp, ps, ...]
    return g.reshape((B, nlp * ps) + tuple(pages.shape[2:]))


def decode_words(x, pc, out_dtype=torch.float32):
    """Posit storage words -> float (identity cast for float caches)."""
    if pc is not None and not torch.is_floating_point(x):
        return _codec.posit_load(x, pc, out_dtype)
    return x.to(out_dtype)


def _default_dot(a, b, dn, op):
    return _dot_general(a, b, dn)


def paged_attention_reference(q, k_pages, v_pages, page_table, pos, *,
                              pc=None, softcap=None, window=None,
                              dot_fn=None):
    """Gather-then-attend decode over paged posit KV state.

    q ``[B, 1, H, hd]``; k_pages/v_pages ``[P, ps, KV, hd]`` posit words
    (or float); page_table ``[B, nlp]`` int32; pos ``[B]`` int32.
    ``dot_fn(a, b, dn, op)`` routes the qk/pv contractions (default exact
    f32).  Returns ``[B, 1, H*hd]``."""
    dot_fn = dot_fn or _default_dot
    B, T, H, hd = q.shape
    KV = k_pages.shape[2]
    group = H // KV
    kd = decode_words(gather_pages(k_pages, page_table), pc, q.dtype)
    vd = decode_words(gather_pages(v_pages, page_table), pc, q.dtype)
    S = kd.shape[1]

    qg = q.reshape(B, T, KV, group, hd)
    dn_qk = (((4,), (3,)), ((0, 2), (0, 2)))     # contract hd; batch B, KV
    s = dot_fn(qg, kd, dn_qk, "qk")              # [B, KV, T, group, S]
    s = s * (hd ** -0.5)
    s = s.to(torch.float32)
    if softcap:
        s = softcap * _X.tanh(s / softcap)

    pos_b = pos.to(torch.int32)
    s_pos = torch.arange(S, device=q.device)
    valid = s_pos[None, :] <= pos_b[:, None]     # [B, S]
    if window is not None:
        w = int(window)
        if w >= 0:
            valid &= s_pos[None, :] > pos_b[:, None] - w
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    probs = _X.softmax(s, dim=-1).to(vd.dtype)
    dn_pv = (((4,), (1,)), ((0, 1), (0, 2)))
    o = dot_fn(probs, vd, dn_pv, "pv")           # [B, KV, T, group, hd]
    return o.movedim(1, 2).reshape(B, T, KV * group * hd)


# --------------------------------------------------------------------------
# Fused flash-decode: shared set-up, plain version, kernel wrapper
# --------------------------------------------------------------------------

def _q_setup(q, k_pages, cfg_qk: EulerConfig):
    """Per-tensor pow2 scale of q over the whole batch (inactive rows
    included, as the reference does outside its kernel) and the post-dot
    scalar ``scl = sq / sqrt(hd)``.  Returns (scaled q [B,KV,G,hd], scl[1])."""
    B, T, H, hd = q.shape
    if T != 1:
        raise ValueError("flash-decode is single-token")
    KV = k_pages.shape[2]
    qf = q[:, 0].reshape(B, KV, H // KV, hd).to(torch.float32)
    if cfg_qk.pre_scale:
        sq = _pow2_scale(qf)
    else:
        sq = torch.ones((), dtype=torch.float32, device=q.device)
    scl = (sq * (hd ** -0.5)).reshape(1).to(torch.float32)
    return _P.flushed_quotient(qf, sq).contiguous(), scl


def lane_dot(a, b):
    """``a [..., G, hd] . b [..., S, hd] -> [..., G, S]`` in the kernel's
    order (``csrc/paged_decode.cu``, ``pd_scores_kernel``): lane ``l`` of
    a warp sums ``d = l, l + 32, ...`` as a chain of ``fmaf`` from 0, then
    the 32 lanes are added by the xor butterfly (lane 0 ends with
    ``x[i] + x[i + h]`` for h = 16, 8, 4, 2, 1).  An ``fmaf`` is taken as
    the float64 ``a * b + c`` rounded to float32 (the product is exact
    in float64)."""
    hd = a.shape[-1]
    pad = -hd % 32
    a = torch.nn.functional.pad(a, (0, pad)).unflatten(-1, (-1, 32))
    b = torch.nn.functional.pad(b, (0, pad)).unflatten(-1, (-1, 32))
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    acc = torch.zeros(a.shape[:-3] + (a.shape[-3], b.shape[-3], 32),
                      dtype=torch.float32, device=a.device)
    for i in range(a.shape[-2]):
        prod = a64[..., :, None, i, :] * b64[..., None, :, i, :]
        acc = (prod + acc).to(torch.float32)
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def page_scores(qv, qr, kv_, kr, scl, sub_rem: bool, softcap):
    """One page's scores ``[..., G, ps]`` as the kernel computes them: the
    two planes' :func:`lane_dot`, their difference, times ``scl``, then
    the softcap with a true division (a CUDA tensor divided by a host
    scalar is multiplied by its reciprocal, which rounds differently)."""
    s = lane_dot(qv, kv_)
    if sub_rem:
        s = s - lane_dot(qr, kr)
    s = s * scl
    if softcap:
        s = softcap * torch.tanh(s / s.new_tensor(softcap))
    return s


def _window_int(window) -> int:
    return -1 if window is None else int(window)


def _flash_plain(qpat, k_pages, v_pages, page_table, pos, window, scl, *,
                 pc, cfg_qk, cfg_pv, softcap):
    B, KV, G, hd = qpat.shape
    ps = k_pages.shape[1]
    nlp = page_table.shape[1]
    w = _window_int(window)
    qv, qr = decode_planes_raw(qpat, cfg_qk.posit, cfg_qk.stages,
                               cfg_qk.trunc, cfg_qk.sublane)
    dev = qpat.device
    m = torch.full((B, KV, G, 1), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=dev)
    pos_b = pos.to(torch.int64).reshape(B, 1, 1, 1)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    for j in range(nlp):
        phys = page_table[:, j].to(torch.long)
        kw = k_pages[phys].permute(0, 2, 1, 3)           # [B, KV, ps, hd]
        kv_, kr = decode_planes_raw(kw, pc, cfg_qk.stages, cfg_qk.trunc,
                                    cfg_qk.sublane)
        s = page_scores(qv, qr, kv_, kr, scl, subtracts_rem(cfg_qk),
                        softcap)                         # [B, KV, G, ps]
        spos = torch.arange(ps, device=dev) + j * ps
        ok = spos <= pos_b
        if w >= 0:
            ok = ok & (spos > pos_b - w)
        s = torch.where(ok, s, neg)

        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new)
        m = m_new
        l = l * alpha + pexp.sum(-1, keepdim=True)

        pv_pc = cfg_pv.posit
        pv_, pr = decode_planes_raw(encode_body(pexp, pv_pc), pv_pc,
                                    cfg_pv.stages, cfg_pv.trunc,
                                    cfg_pv.sublane)
        vw = v_pages[phys].permute(0, 2, 1, 3)
        vv, vr = decode_planes_raw(vw, pc, cfg_pv.stages, cfg_pv.trunc,
                                   cfg_pv.sublane)
        o = pv_ @ vv
        if subtracts_rem(cfg_pv):
            o = o - pr @ vr
        acc = acc * alpha + o
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, 1, KV * G * hd)


def paged_flash_decode_plain(q, k_pages, v_pages, page_table, pos,
                             window=None, *, pc: _P.PositConfig,
                             cfg_qk: EulerConfig, cfg_pv: EulerConfig,
                             softcap=None):
    """The plain version of the paged flash-decode kernel (every page of
    the table visited, as the TPU grid does)."""
    qs, scl = _q_setup(q, k_pages, cfg_qk)
    qpat = encode_body(qs, cfg_qk.posit)
    return _flash_plain(qpat, k_pages, v_pages, page_table, pos, window, scl,
                        pc=pc, cfg_qk=cfg_qk, cfg_pv=cfg_pv, softcap=softcap)


_WORD_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def paged_flash_decode(q, k_pages, v_pages, page_table, pos, window=None, *,
                       pc: _P.PositConfig, cfg_qk: EulerConfig,
                       cfg_pv: EulerConfig, softcap=None):
    """Fused paged decode attention over posit-word pages.

    q ``[B, 1, H, hd]`` float; k_pages/v_pages ``[P, ps, KV, hd]`` integer
    posit storage words in format ``pc``; page_table ``[B, nlp]`` int32;
    pos ``[B]`` int32; window None / int (< 0 = global).  Returns
    ``[B, 1, H*hd]`` f32."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(
            q, k_pages, v_pages, page_table, pos, window, pc=pc,
            cfg_qk=cfg_qk, cfg_pv=cfg_pv, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    for t, n in ((k_pages, "k_pages"), (v_pages, "v_pages"),
                 (page_table, "page_table"), (pos, "pos")):
        if t.device != q.device:
            raise ValueError(f"paged_flash_decode: {n} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_flash_decode: {n} must be contiguous")
    word = _WORD_BYTES.get(k_pages.dtype)
    if word is None or v_pages.dtype != k_pages.dtype:
        raise ValueError("paged_flash_decode: pages must be uint8/int16/int32 "
                         f"posit words (got {k_pages.dtype}, {v_pages.dtype})")
    if word * 8 != pc.n_bits:
        raise ValueError(f"paged_flash_decode: {k_pages.dtype} pages cannot "
                         f"hold {pc.name} words")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_flash_decode: page_table and pos must be int32")
    if cfg_qk.mode != "euler" or cfg_pv.mode != "euler":
        raise ValueError("paged_flash_decode: kernel runs euler qk/pv only")
    B, _, H, hd = q.shape
    P_, ps, KV, hd2 = k_pages.shape
    if hd2 != hd or H % KV or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"paged_flash_decode: shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    nlp = page_table.shape[1]
    if (tuple(page_table.shape) != (B, nlp) or nlp < 1
            or tuple(pos.shape) != (B,)):
        raise ValueError("paged_flash_decode: page_table [B, nlp >= 1], "
                         "pos [B]")

    if q.shape[1] != 1:
        raise ValueError("flash-decode is single-token")
    G = H // KV
    ppb = pages_per_block(nlp)
    nchunk = -(-nlp // ppb)
    qf = q.reshape(B, H * hd).to(torch.float32).contiguous()
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    # per (b, kv, page): scores [G, ps] and page max [G]; per (b, kv, chunk
    # of ppb pages): weighted acc [G, hd] and sum [G]; then q's words and
    # its scale (csrc/paged_decode.cu: Scratch)
    scratch = torch.empty(B * KV * G * (nlp * (ps + 1) + nchunk * (hd + 1)
                                        + hd) + 1,
                          dtype=torch.float32, device=q.device)
    qp, vp = cfg_qk.posit, cfg_pv.posit
    mq = effective_trunc(cfg_qk.trunc, cfg_qk.sublane)
    mv = effective_trunc(cfg_pv.trunc, cfg_pv.sublane)
    # one decode table serves the call when the K and V words (cache
    # format), q and the probabilities all decode as one table format
    key = _logmac.table16_key(pc, cfg_qk)
    if key is not None and all(_logmac.table16_key(f, c) == key for f, c in (
            (qp, cfg_qk), (vp, cfg_pv), (pc, cfg_pv))):
        tab = _logmac._table16(q.device, key)
    else:
        tab = None
    fn = _build.function("paged_decode", "paged_decode_launch",
                         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                         + [ctypes.c_float] * 2 + [ctypes.c_int] * 13
                         + [ctypes.c_void_p])
    err = fn(qf.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), pos.data_ptr(),
             tab.data_ptr() if tab is not None else None,
             out.data_ptr(), scratch.data_ptr(), B, KV, G, hd, ps, nlp, ppb,
             _window_int(window), word, int(cfg_qk.pre_scale),
             float(softcap or 0.0), hd ** -0.5,
             pc.n_bits, pc.es, pc.regime_max or 0,
             qp.n_bits, qp.es, qp.regime_max or 0, cfg_qk.stages,
             -1 if mq is None else mq,
             vp.n_bits, vp.es, vp.regime_max or 0, cfg_pv.stages,
             -1 if mv is None else mv,
             _build.stream_ptr(q))
    _build.check(err, "paged_flash_decode")
    _build.count_launch("paged_flash_decode", pc.n_bits)
    return out.reshape(B, 1, H * hd)


def pages_per_block(nlp: int) -> int:
    """Pages one block of the kernel walks: 1 up to 64-page tables, so a
    short context spreads over blocks; more beyond, so a 256-page table
    runs 64 chunks a (b, kv) row and q's planes and the decode table are
    loaded once per chunk."""
    return max(1, nlp // 64)
