"""Composable layers: attention, MLPs and the mixture of experts.  Every
matmul routes through ``repro_torch.numerics``.

Counterpart of ``repro.models.layers``: functional style,
``*_apply(params, x, ctx)`` on dicts of tensors.  Attention traces under
the ``attn`` scope, MLPs under ``mlp`` and MoE under ``moe``, so a
``PrecisionPolicy`` rule like ``("*attn*", P8)`` hits exactly the
attention ops.  Norms, softmax, RoPE, router logits and elementwise
nonlinearities run in exact f32; the casts between the compute dtype and
f32 mirror the reference.

On a mesh (``Ctx.mesh``, one process per rank) each rank holds its rows
of the global batch, split over the data axes.  The numbers are the
reference's GSPMD run's: the per-tensor statistics of the activations are
taken over the data group (``Ctx.numerics.group``; :func:`dense_apply`
names its weight's group None), and ``moe_apply`` runs the reference's
``shard_map`` expert block (local statistics, per-rank capacity, experts
over ``model``, the ZeRO-3 gather under ``moe_fsdp``).

``Ctx.placement`` says what else a rank holds.  ``None``: the whole
parameter tree, as the reference's launcher places the train state
replicated.  ``"production"``: the blocks of the parameters and caches
that the reference's dry run (``launch/dryrun.py``'s ``in_shardings``)
gives one device, ``distributed.sharding.place`` of ``params_pspecs``
and ``cache_shardings``, and the explicit tensor parallelism that GSPMD
compiles from them: column-parallel projections (:func:`column_apply`:
the rank's output columns, whole heads where they divide, else gathered
over ``model``; each column summed in the whole product's order),
row-parallel ones (:func:`row_apply`: the rank's rows, summed over
``model``), the vocab-parallel embedding
(:func:`embed_apply` with a group), attention on local heads or over a
sequence-sharded KV cache (the softmax's max and sum taken over
``model``).  Every per-tensor statistic is still the whole tensor's: an
operand split over ``model``, or over data and model, takes it over that
group (``numerics.dot_general(groups=...)``).  Gradients follow
Megatron's rule: a tensor every model rank holds alike carries the whole
gradient on each, so only the data axes sum gradients.
The reference's other placement constraints (``Ctx.shard``, the
residual's sequence sharding) tell GSPMD where to put data and leave the
numbers as they are; they have no counterpart here.

KV caches are updated in place (the reference returns new arrays): a
layer's cache is a view into the model's ``[L, ...]`` stack, and
``attention_apply`` writes its new K/V words into it before attending.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import numerics as N
from repro_torch.core import posit as _P
from repro_torch.core import xla_f32 as _X
from repro_torch.core.engine import EulerConfig, no_batch_dot
from repro_torch.distributed import collectives as C
from repro_torch.kernels import posit_codec as _codec
from repro_torch.numerics import NumericsContext

_NEG = -1e30
# the mesh axes (``launch.mesh``) the batch rows split over, and the one
# the experts split over
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"


def cache_encode(x, cache_dtype, pc=None):
    """Write-side KV-cache codec: integer caches store posit words in the
    storage width's format, or ``pc`` (the policy format) when its width
    matches."""
    pc = _P.storage_pc(cache_dtype, pc)
    if pc is not None:
        return _codec.posit_store(x, pc)
    return x.to(cache_dtype)


def cache_decode(x, out_dtype=torch.bfloat16, pc=None):
    """Read-side KV-cache codec: posit words back to ``out_dtype`` (NaR ->
    NaN); float caches as they are."""
    pc = _P.storage_pc(x.dtype, pc)
    if pc is not None:
        return _codec.posit_load(x, pc, out_dtype)
    return x


def cache_policy_pc(ctx, cache_dtype):
    """The posit format a KV cache of ``cache_dtype`` stores under the
    active policy: the qk operand format when its width matches the
    storage width, else the standard posit of that width; ``None`` for
    float caches.  Resolved under the ``attn`` scope."""
    cfg_qk = N.resolve("qk", ctx=ctx.numerics)
    pref = cfg_qk.posit if cfg_qk.mode != "exact" else None
    return _P.storage_pc(cache_dtype, pref)


@dataclasses.dataclass
class Ctx:
    ecfg: EulerConfig | None = None  # uniform config (promoted to a policy)
    numerics: NumericsContext | None = None  # policy + backend (wins if set)
    mesh: Any = None                 # launch.mesh.Mesh or None: each rank
                                     # holds its rows of the global batch
    decode_pos: Any = None           # decode position: int or [B] tensor
    page_table: Any = None           # [B, n_logical] int32 physical page ids
                                     # — presence selects paged decode
    decode_write: Any = None         # [B] bool write mask for paged decode
                                     # (False rows write the trash page)
    moe_fsdp: bool = False           # expert weights' f dim ZeRO-3 over the
                                     # data axes, gathered per layer
    moe_gather_dtype: Any = None     # cast expert weights before the ZeRO-3
                                     # all-gather (bf16 halves wire bytes)
    placement: str | None = None     # None: each rank holds the whole tree;
                                     # "production": the dry run's blocks

    def __post_init__(self):
        if self.numerics is None:
            self.numerics = NumericsContext.from_ecfg(
                self.ecfg if self.ecfg is not None
                else EulerConfig(mode="exact"))
        if self.ecfg is None:
            self.ecfg = self.numerics.policy.default
        # the data group carries the activations' statistics
        group = self.data_group
        if group is not self.numerics.group:
            self.numerics = dataclasses.replace(self.numerics, group=group)

    @property
    def data_group(self):
        """The process group of the data axes, or None (no mesh, or one
        rank along them)."""
        return None if self.mesh is None else self.mesh.group(DATA_AXES)

    @property
    def model_group(self):
        return None if self.mesh is None else self.mesh.group(MODEL_AXIS)

    @property
    def placed(self) -> bool:
        """Whether the rank holds the production placement's blocks."""
        if self.placement not in (None, "production"):
            raise ValueError(f"unknown placement {self.placement!r}")
        return self.placement == "production" and self.mesh is not None

    @property
    def joint_group(self):
        """The group of the data and model axes together: the group of an
        activation split over both (or None)."""
        return (None if self.mesh is None
                else self.mesh.group(DATA_AXES + (MODEL_AXIS,)))


def dot(a, b, ctx: Ctx, dn=None, op: str = "matmul", groups=None,
        column_parts: int = 1):
    """Policy-resolved dot_general; default contracts a's last with b's
    first dim (op kind "matmul").  ``groups``, ``column_parts``: the
    operands' statistics groups and the share of the columns the product
    computes (``numerics.dot_general``)."""
    if dn is None:
        dn = (((a.ndim - 1,), (0,)), ((), ()))
    return N.dot_general(a, b, dn, ctx.numerics, op=op, groups=groups,
                         column_parts=column_parts)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------

def randn(shape, gen, device):
    """A float32 draw from ``gen``; with no generator an empty tensor of
    the shape (``Model.init_shapes``: shapes only, on the meta device)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, device, scale: float | None = None):
    scale = scale if scale is not None else d_in ** -0.5
    w = randn((d_in, d_out), gen, device)
    return {"w": w.mul_(scale)}


def dense_apply(p, x, ctx: Ctx):
    """``x`` times a weight every rank holds whole (its own statistics)."""
    return dot(x, p["w"], ctx, groups=(ctx.data_group, None))


def column_apply(p, x, ctx: Ctx, n_out: int):
    """A column-parallel projection of ``x`` (whole over ``model``) onto
    ``n_out`` global columns: (y, split), ``y`` the rank's block of the
    columns where the weight is split over ``model`` (``split`` True),
    else all of them.  The input's gradient is summed over ``model``."""
    w = p["w"]
    if not ctx.placed or w.shape[1] == n_out:
        return dense_apply(p, x, ctx), False
    mg = ctx.model_group
    y = dot(C.copy_sum_grad(x, mg), w, ctx, groups=(ctx.data_group, mg),
            column_parts=C.group_size(mg))
    return y, True


def column_gathered(p, x, ctx: Ctx, n_out: int):
    """:func:`column_apply` with the columns gathered over ``model``."""
    y, split = column_apply(p, x, ctx, n_out)
    return C.gather_replicated(y, -1, ctx.model_group) if split else y


def row_apply(p, h, ctx: Ctx, h_split: bool = False):
    """A row-parallel projection: ``h`` [..., n_in] whole over ``model``,
    or its rank's block of the features (``h_split``), times the weight;
    where the weight's rows are split over ``model`` the rank multiplies
    its block and the partial products are summed over ``model``.  The
    result is whole on every rank."""
    w = p["w"]
    mg = ctx.model_group if ctx.placed else None
    if mg is None:
        return dense_apply(p, h, ctx)
    m = C.group_size(mg)
    n_in = h.shape[-1] * (m if h_split else 1)
    if w.shape[0] == n_in:          # the weight is whole
        if h_split:
            h = C.gather_replicated(h, -1, mg)
        return dot(h, w, ctx, groups=(ctx.data_group, None))
    if not h_split:
        h = C.take_block(h, -1, mg)
    y = dot(h, w, ctx, groups=(ctx.joint_group, mg))
    return C.reduce_sum(y, mg)


def rmsnorm_init(d: int, device):
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    # the elementwise functions (_X) round as XLA:CPU's on CPU tensors
    var = _X.mean_last(x32 * x32)
    return (x32 * _X.rsqrt(var + eps) * p["g"]).to(x.dtype)


def embed_init(gen, vocab_p: int, d: int, device):
    e = randn((vocab_p, d), gen, device)
    return {"e": e.mul_(0.02)}


def embed_apply(p, ids, group=None):
    """The embedding rows of ``ids``.  ``group``: the table is split by
    vocab rows over this group (the model axis); each rank looks up the
    ids it holds, zeros the rest, and the ranks' rows are summed (one
    nonzero term each, so the sum is the row itself)."""
    e = p["e"]
    shape = tuple(ids.shape) + (e.shape[1],)
    ids = ids.reshape(-1).to(torch.long)
    if group is not None:
        v_l = e.shape[0]
        local = ids - dist.get_rank(group) * v_l
        mine = (local >= 0) & (local < v_l)
        ids = torch.where(mine, local, torch.zeros_like(local))
    # index_select: its backward (index_add) runs a deterministic algorithm
    # on a CUDA card under torch.use_deterministic_algorithms
    rows = torch.index_select(e, 0, ids)
    if group is not None:
        rows = C.reduce_sum(torch.where(mine[:, None], rows,
                                        torch.zeros((), dtype=rows.dtype,
                                                    device=rows.device)),
                            group)
    return rows.reshape(shape)


def rope(x, positions, theta: float):
    """Rotary embedding on the last dim of x: [..., T, H, hd]."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32)
                      / half).to(x.device)
    ang = positions.to(torch.float32)[..., None] * freqs  # [..., T, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _softcap(x, cap):
    return cap * _X.tanh(x / cap) if cap else x


# --------------------------------------------------------------------------
# Attention (GQA, optional sliding window, softcaps, chunked-flash softmax)
# --------------------------------------------------------------------------

def attention_init(gen, cfg, device):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, H * hd, device),
        "wk": dense_init(gen, d, KV * hd, device),
        "wv": dense_init(gen, d, KV * hd, device),
        "wo": dense_init(gen, H * hd, d, device),
    }
    if cfg.qk_norm:
        p["qn"] = rmsnorm_init(cfg.head_dim, device)
        p["kn"] = rmsnorm_init(cfg.head_dim, device)
    return p


def _attn_scores(q, k, ctx: Ctx, softcap, groups=None):
    # q: [B, T, H, hd], k: [B, S, KV, hd] (grouped) -> [B, KV, T, group, S]
    B, T, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    qg = q.reshape(B, T, KV, group, hd)
    dn = (((4,), (3,)), ((0, 2), (0, 2)))  # contract hd; batch B, KV
    s = N.dot_general(qg, k, dn, ctx.numerics, op="qk", groups=groups)
    s = s * (hd ** -0.5)
    return _softcap(s.to(torch.float32), softcap)


def _attn_values(p, v, ctx: Ctx, groups=None):
    # p: [B, KV, T, group, S], v: [B, S, KV, hd] -> [B, T, KV*group*hd]
    dn = (((4,), (1,)), ((0, 1), (0, 2)))
    o = N.dot_general(p, v, dn, ctx.numerics, op="pv",
                      groups=groups)                       # [B,KV,T,group,hd]
    B, KV, T, group, hd = o.shape
    return o.movedim(1, 2).reshape(B, T, KV * group * hd)


def window_ok(t_pos, s_pos, window):
    """Sliding-window part of the mask (``window`` None or < 0: global)."""
    if window is None or window < 0:
        return torch.ones((), dtype=torch.bool, device=s_pos.device)
    return s_pos > (t_pos - window)


def causal_window_mask(t_pos, s_pos, window):
    """Causal + sliding-window mask [T, S]."""
    m = s_pos[None, :] <= t_pos[:, None]
    return m & window_ok(t_pos[:, None], s_pos[None, :], window)


def _maybe_qk_norm(p, q, k, q_grad_group=None, k_grad_group=None):
    """q/k RMS norms where the config has them; a norm weight applied to
    the rank's own heads only has its gradient summed over the group
    given for it."""
    if "qn" in p:
        q = rmsnorm_apply({"g": C.copy_sum_grad(p["qn"]["g"], q_grad_group)},
                          q)
        k = rmsnorm_apply({"g": C.copy_sum_grad(p["kn"]["g"], k_grad_group)},
                          k)
    return q, k


def _decode_positions(ctx: Ctx, B: int, device):
    pos = torch.as_tensor(ctx.decode_pos, dtype=torch.int32, device=device)
    return pos.expand(B).contiguous() if pos.ndim == 0 else pos


@dataclasses.dataclass(frozen=True)
class _Heads:
    """The attention heads one rank computes.  ``q_local``: its own block
    of the q heads (H / model of them), else all; with ``n_kv`` set, its
    q heads are local, the rank holds all the KV heads and attends with
    ``kv0 .. kv0 + n_kv - 1``, those its q heads use (every KV head is
    then taken by as many ranks, so statistics summed over ``model`` are
    the whole tensor's)."""
    q_local: bool = False
    kv0: int = 0
    n_kv: int | None = None


def _attn_qkv(p, x, ctx: Ctx, cfg, positions, gather_q: bool = False):
    """q [B, T, Hh, hd] of the heads the rank computes, k/v [B, T, KVh,
    hd] of all KV heads it holds (the cache's write), the KV heads it
    attends with, and the :class:`_Heads` layout.  Without the production
    placement every head, as on one device."""
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mg = ctx.model_group if ctx.placed else None
    m = C.group_size(mg)
    qc, q_split = column_apply(p["wq"], x, ctx, H * hd)
    kc, kv_split = column_apply(p["wk"], x, ctx, KV * hd)
    vc, _ = column_apply(p["wv"], x, ctx, KV * hd)
    g, h_l = H // KV, H // m
    q_local = (q_split and not gather_q and H % m == 0
               and (g % h_l == 0 or h_l % g == 0))
    kv_local = q_local and kv_split and KV % m == 0
    if q_split and not q_local:
        qc = C.gather_replicated(qc, -1, mg)
    if kv_split and not kv_local:
        kc = C.gather_replicated(kc, -1, mg)
        vc = C.gather_replicated(vc, -1, mg)
    q = qc.reshape(B, T, -1, hd)
    k = kc.reshape(B, T, -1, hd)
    v = vc.reshape(B, T, -1, hd)
    q, k = _maybe_qk_norm(p, q, k, mg if q_local else None,
                          mg if kv_local else None)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    heads = _Heads(q_local)
    ka, va = k, v
    if q_local and not kv_local:
        r = dist.get_rank(mg)
        n_kv = max(1, h_l // g)
        heads = _Heads(True, (r * h_l) // g, n_kv)
        # each rank attends with its q heads' KV heads: their gradient is
        # the sum of the ranks' parts
        ka = C.copy_sum_grad(k, mg)[:, :, heads.kv0:heads.kv0 + n_kv]
        va = C.copy_sum_grad(v, mg)[:, :, heads.kv0:heads.kv0 + n_kv]
    return q, k, v, ka, va, heads


def _kv_view(t, heads: _Heads):
    """The KV heads a rank attends with, of a cache holding all of them."""
    if heads.n_kv is None:
        return t
    return t[:, :, heads.kv0:heads.kv0 + heads.n_kv]


def _seq_sharded(ctx: Ctx, cfg) -> bool:
    """Whether the rank's dense KV cache holds its block of positions:
    under the production placement where the KV heads do not divide
    ``model`` (``sharding.cache_spec``; ``Model.init_cache(mesh=...)``
    refuses such a cache whose positions do not divide either)."""
    if not ctx.placed:
        return False
    m = C.group_size(ctx.model_group)
    return m > 1 and cfg.n_kv_heads % m != 0


def _decode_seq_sharded(q, k, v, ck, cv, ctx: Ctx, cfg, window, pos_b):
    """Single-token decode over a KV cache whose positions are split over
    ``model``: the rank holding the new token's position writes its K/V,
    each rank scores its positions, the softmax's max and sum are taken
    over ``model``, and the ranks' partial P.V are summed: the whole
    cache's attention, each operand's statistics over data and model."""
    mg, jg = ctx.model_group, ctx.joint_group
    B = q.shape[0]
    S = ck.shape[1]
    lo = dist.get_rank(mg) * S
    pc = cache_policy_pc(ctx, ck.dtype)
    rows = torch.arange(B, device=q.device)
    off = (pos_b - lo).to(torch.long)
    mine = (off >= 0) & (off < S)
    at = torch.clamp(off, 0, S - 1)
    for c, new in ((ck, k), (cv, v)):
        w = cache_encode(new[:, 0], c.dtype, pc)
        c[rows, at] = torch.where(mine[:, None, None], w, c[rows, at])
    s_pos = lo + torch.arange(S, device=q.device)
    kd = cache_decode(ck, q.dtype, pc)
    vd = cache_decode(cv, q.dtype, pc)
    scores = _attn_scores(q, kd, ctx, cfg.attn_softcap,
                          groups=(ctx.data_group, jg))     # [B,KV,1,g,S]
    valid = s_pos[None, :] <= pos_b[:, None]
    valid = valid & window_ok(pos_b[:, None], s_pos[None, :], window)
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.tensor(_NEG, device=q.device))
    return seq_sharded_attend(scores, vd, ctx)


def seq_sharded_attend(scores, vd, ctx: Ctx):
    """softmax(scores) . v for scores [B, KV, T, g, S_l] and values [B,
    S_l, KV, hd] of the rank's block of positions: the max and the sum
    over ``model`` (the log-sum-exp combine), then the rank's partial
    P.V summed over ``model``."""
    mg, jg = ctx.model_group, ctx.joint_group
    mx = C.all_reduce(scores.amax(-1, keepdim=True), mg, dist.ReduceOp.MAX)
    e = _X.exp(scores - mx)
    probs = (e / C.all_reduce(e.sum(-1, keepdim=True), mg)).to(vd.dtype)
    out = _attn_values(probs, vd, ctx, groups=(jg, jg))
    return C.reduce_sum(out, mg)


@N.scoped("attn")
def attention_apply(p, x, ctx: Ctx, cfg, window, positions,
                    cache=None, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Full attention layer.

    Modes (from shapes): cache None — forward over x[B, T, d]; cache given
    and T > 1 — prefill (flash attention + KV slab write); cache given and
    T == 1 — single-token decode at ``ctx.decode_pos`` (paged when
    ``ctx.page_table`` is set).  ``window``: int (< 0 = global) or None.
    Under the production placement (``Ctx.placement``) the rank computes
    the heads of :func:`_attn_qkv` and holds its block of a dense cache:
    its KV heads, or its positions (a decode over them is
    :func:`_decode_seq_sharded`).
    """
    B, T, d = x.shape
    seq_split = cache is not None and _seq_sharded(ctx, cfg)
    q, k, v, ka, va, heads = _attn_qkv(p, x, ctx, cfg, positions,
                                       gather_q=seq_split and T == 1)
    hd = q.shape[-1]
    mg = ctx.model_group if ctx.placed else None
    # the statistics groups of the qk and pv operands where the placement
    # splits them over model; else the context's (the data group)
    grp = (ctx.joint_group, ctx.joint_group) if heads.q_local else None

    def out_proj(out):
        return row_apply(p["wo"], out.to(x.dtype), ctx, heads.q_local)

    if cache is not None and T == 1 and ctx.page_table is not None:
        if ctx.placed:
            raise NotImplementedError(
                "the production placement runs dense caches only (the "
                "dry run's build_cell uses init_cache)")
        # ---- paged decode ----
        # The cache is the shared page pool [P, page_size, KV, hd]; this
        # slot's token goes to the physical page its table names for the
        # current logical page.  Masked rows and rows whose entry is
        # unallocated write the TRASH_PAGE sink instead.
        from repro_torch.kernels.paged_decode import NULL_PAGE, TRASH_PAGE
        kp, vp = cache["k"], cache["v"]
        pc = cache_policy_pc(ctx, kp.dtype)
        pos_b = _decode_positions(ctx, B, x.device)
        ps_ = kp.shape[1]
        table = ctx.page_table
        nlp = table.shape[1]
        lp = torch.clamp(torch.div(pos_b, ps_, rounding_mode="floor"),
                         0, nlp - 1).to(torch.long)
        off = torch.remainder(pos_b, ps_).to(torch.long)
        phys = table.gather(1, lp[:, None])[:, 0].to(torch.long)
        phys = torch.where(phys == NULL_PAGE, TRASH_PAGE, phys)
        if ctx.decode_write is not None:
            phys = torch.where(ctx.decode_write, phys, TRASH_PAGE)
        kp[phys, off] = cache_encode(k[:, 0], kp.dtype, pc)
        vp[phys, off] = cache_encode(v[:, 0], vp.dtype, pc)
        out = N.decode_attention(q, kp, vp, table, pos_b, ctx.numerics,
                                 pc=pc, softcap=cfg.attn_softcap,
                                 window=window)
        return out_proj(out), cache

    if cache is not None and T == 1 and seq_split:
        pos_b = _decode_positions(ctx, B, x.device)
        out = _decode_seq_sharded(q, k, v, cache["k"], cache["v"], ctx, cfg,
                                  window, pos_b)
        return out_proj(out), cache

    if cache is not None and T == 1:
        # ---- dense decode: every slot at its own position ----
        ck, cv = cache["k"], cache["v"]
        pc = cache_policy_pc(ctx, ck.dtype)
        pos_b = _decode_positions(ctx, B, x.device)
        rows = torch.arange(B, device=x.device)
        prow = pos_b.to(torch.long)
        ck[rows, prow] = cache_encode(k[:, 0], ck.dtype, pc)
        cv[rows, prow] = cache_encode(v[:, 0], cv.dtype, pc)
        S = ck.shape[1]
        s_pos = torch.arange(S, device=x.device)
        kd = _kv_view(cache_decode(ck, x.dtype, pc), heads)
        vd = _kv_view(cache_decode(cv, x.dtype, pc), heads)
        scores = _attn_scores(q, kd, ctx, cfg.attn_softcap,
                              groups=grp)                  # [B,KV,1,g,S]
        valid = s_pos[None, :] <= pos_b[:, None]             # [B, S]
        valid = valid & window_ok(pos_b[:, None], s_pos[None, :], window)
        scores = torch.where(valid[:, None, None, None, :], scores,
                             torch.tensor(_NEG, device=x.device))
        probs = _X.softmax(scores, dim=-1).to(vd.dtype)
        out = _attn_values(probs, vd, ctx, groups=grp)
        return out_proj(out), cache

    # ---- forward / prefill: chunked (flash-style) causal attention ----
    # chunk sizes must divide T: fall back to the largest divisor <= chunk
    qc = min(q_chunk, T)
    while T % qc:
        qc -= 1
    kc = min(kv_chunk, T)
    while T % kc:
        kc -= 1
    n_q, n_k = T // qc, T // kc
    Hh, KVh = q.shape[2], ka.shape[2]
    group = Hh // KVh
    dev = x.device
    neg = torch.tensor(_NEG, device=dev)
    outs = []
    for qi in range(n_q):
        q_i = q[:, qi * qc:(qi + 1) * qc]
        t_idx = torch.arange(qc, device=dev) + qi * qc
        m_run = torch.full((B, KVh, qc, group), _NEG, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, KVh, qc, group), dtype=torch.float32,
                            device=dev)
        acc = torch.zeros((B, KVh, qc, group, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(n_k):
            k_i = ka[:, ki * kc:(ki + 1) * kc]
            v_i = va[:, ki * kc:(ki + 1) * kc]
            s = _attn_scores(q_i, k_i, ctx, cfg.attn_softcap, groups=grp)
            s_idx = torch.arange(kc, device=dev) + ki * kc
            mask = causal_window_mask(t_idx, s_idx, window)
            s = torch.where(mask[None, None, :, None, :], s, neg)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = _X.exp(m_run - m_new)
            pexp = _X.exp(s - m_new[..., None])
            l_run = l_run * alpha + pexp.sum(-1)
            dn = (((4,), (1,)), ((0, 1), (0, 2)))
            o = N.dot_general(pexp.to(v_i.dtype), v_i, dn, ctx.numerics,
                              op="pv", groups=grp)
            acc = acc * alpha[..., None] + o
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.movedim(2, 1).reshape(B, qc, Hh * hd))
    out = torch.cat(outs, 1) if len(outs) > 1 else outs[0]
    y = out_proj(out)

    if cache is not None:  # prefill: write the K/V slab at offset 0
        pc = cache_policy_pc(ctx, cache["k"].dtype)
        if seq_split:      # the rank's block of positions
            S = cache["k"].shape[1]
            lo = dist.get_rank(mg) * S
            n = max(0, min(T - lo, S))
            cache["k"][:, :n] = cache_encode(k[:, lo:lo + n],
                                             cache["k"].dtype, pc)
            cache["v"][:, :n] = cache_encode(v[:, lo:lo + n],
                                             cache["v"].dtype, pc)
        else:
            cache["k"][:, :T] = cache_encode(k, cache["k"].dtype, pc)
            cache["v"][:, :T] = cache_encode(v, cache["v"].dtype, pc)
    return y, cache


def attention_cache_init(cfg, batch: int, max_len: int, dtype, device):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_reset(cache, slot=None, batch_axis: int = 0):
    """Zero a cache dict in place: all of it (``slot=None``) or one batch
    row.  ``batch_axis`` is 0 for per-layer caches and 1 for the
    model-level [L, B, ...] stacks.  Zero words are the posit zero."""
    for a in cache.values():
        if slot is None:
            a.zero_()
        else:
            a.select(batch_axis, int(slot)).zero_()
    return cache


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

def mlp_init(gen, cfg, device, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("silu_gated", "gelu_gated"):
        return {"wi": dense_init(gen, d, f, device),
                "wg": dense_init(gen, d, f, device),
                "wo": dense_init(gen, f, d, device)}
    return {"wi": dense_init(gen, d, f, device),
            "wo": dense_init(gen, f, d, device)}


@N.scoped("mlp")
def mlp_apply(p, x, ctx: Ctx, kind: str, d_ff: int | None = None):
    """The MLP; under the production placement ``wi``/``wg`` are
    column-parallel and ``wo`` row-parallel onto ``d_ff`` (the global
    hidden width), the hidden activation the rank's block of features
    between them."""
    f = p["wi"]["w"].shape[1] if d_ff is None else d_ff
    h, split = column_apply(p["wi"], x, ctx, f)
    if kind in ("silu_gated", "gelu_gated"):
        gate, split_g = column_apply(p["wg"], x, ctx, f)
        if split_g != split:
            raise ValueError("wi and wg are split differently")
        act = _X.silu if kind == "silu_gated" else _X.gelu_tanh
        h = act(gate) * h
    elif kind == "relu2":  # squared ReLU (nemotron)
        r = F.relu(h)
        h = r * r
    elif kind == "gelu":
        h = _X.gelu_tanh(h)
    else:
        raise ValueError(kind)
    return row_apply(p["wo"], h, ctx, split)


# --------------------------------------------------------------------------
# Mixture of Experts (top-k router, sort-free capacity dispatch)
# --------------------------------------------------------------------------

def moe_init(gen, cfg, device):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(d_in, d_out):
        w = randn((E, d_in, d_out), gen, device)
        return {"w": w.mul_(d_in ** -0.5)}

    p = {"router": dense_init(gen, d, E, device, scale=0.02),
         "wi": experts(d, f), "wg": experts(d, f), "wo": experts(f, d)}
    if cfg.moe_dense_residual:
        p["dense"] = mlp_init(gen, cfg, device)
    return p


def moe_route(xt, router_w, k: int):
    """The router on tokens ``xt`` [n, d]: exact f32 logits ``xt @ w``,
    the softmax, its top ``k`` (ties to the lower expert id, as
    ``lax.top_k``) and the gates renormalised.  Returns (probabilities
    [n, E] f32, gates [n, k] at ``xt``'s dtype, ids [n, k] int64)."""
    with no_batch_dot():   # a dot with no batch dims, as in the reference
        logits = xt.to(torch.float32) @ router_w
    probs = _X.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in id order
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :k]
    gates = torch.gather(probs, 1, ids)
    gates = (gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
             ).to(xt.dtype)
    return probs, gates, ids


def moe_capacity(n_tok: int, k: int, E: int, capacity_factor: float,
                 dp: int = 1) -> int:
    """Tokens each expert takes on one rank: ``n_tok`` global tokens over
    ``dp`` data ranks, ``round`` half to even, as the reference's Python
    ``round`` (32 tokens, k = 1, E = 16, factor 1.25 gives 2)."""
    return int(max(1, round(n_tok / dp * k / E * capacity_factor)))


def moe_dispatch(ids, E: int, cap: int, e0: int = 0):
    """Sort-free capacity dispatch of the router's choices ``ids`` [n, k]
    to the ``E`` experts ``e0 .. e0 + E - 1`` of one block: each (token,
    choice) in token-major order takes the next free rank of its expert;
    choices of other experts go to a junk bucket.  Returns (block-local
    expert ids [n*k], ranks [n*k], keep mask [n*k]: this block's and
    rank < cap)."""
    flat_e = ids.reshape(-1) - e0
    mine = (flat_e >= 0) & (flat_e < E)
    safe = torch.where(mine, flat_e, E)
    onehot = F.one_hot(safe, E + 1).to(torch.int32)
    # an integer prefix sum over the tokens (torch's deterministic mode
    # refuses only float cumsum on a card)
    rank = (torch.cumsum(onehot, 0, dtype=torch.int32) - 1).gather(
        1, safe[:, None])[:, 0]
    return flat_e, rank, mine & (rank < cap)


def _moe_expert_block(xt, ids, gates, wi, wg, wo, cap: int, nctx,
                      e0: int = 0):
    """Dispatch the tokens ``xt`` [n, d] to the capacity buffers [E, cap,
    d] of the block's experts (``wi``/``wg`` [E, d, f], ``wo`` [E, f, d]:
    global experts ``e0 .. e0 + E - 1``), run the expert FFNs (three
    batched contractions through the numerics layer, batch dimension 0)
    and combine back to token order weighted by the gates.  The single
    device path is the block of all experts; a model rank's is its
    share, whose output is partial (summed over ``model``)."""
    n, k = ids.shape
    d = xt.shape[-1]
    E = wi.shape[0]
    flat_e, rank, keep = moe_dispatch(ids, E, cap, e0)
    tok = torch.arange(n, device=xt.device).repeat_interleave(k)
    # kept (expert, rank) slots are unique: a plain indexed write; the
    # dropped choices write a junk expert row E, cut off after (no mask
    # selects a data-dependent number of rows)
    buf = torch.zeros((E + 1, cap, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((torch.where(keep, flat_e, E),
                         torch.where(keep, rank, 0).to(torch.long)),
                        xt[tok])[:E]
    dnb = (((2,), (1,)), ((0,), (0,)))
    h = N.dot_general(buf, wi, dnb, nctx, op="matmul")
    g = N.dot_general(buf, wg, dnb, nctx, op="matmul")
    h = _X.silu(g) * h
    out = N.dot_general(h, wo, dnb, nctx, op="matmul")      # [E, cap, d]
    got = out[torch.where(keep, flat_e, 0),
              torch.where(keep, rank, 0).to(torch.long)]
    got = torch.where(keep[:, None], got, torch.zeros((), dtype=got.dtype,
                                                      device=got.device))
    # each token's k contributions, added in choice order onto zero
    parts = (got * gates.reshape(-1)[:, None]).reshape(n, k, d)
    y = torch.zeros((n, d), dtype=parts.dtype, device=parts.device)
    for j in range(k):
        y = y + parts[:, j]
    return y


def _moe_expert_parallel(p, xt, ids, gates, ctx: Ctx, cap: int):
    """The reference's ``shard_map`` body on this rank: its ``E / model``
    experts from ``e0 = model index * E_local`` on its own tokens, every
    statistic local (the block's numerics carry no group), the partial
    outputs summed over ``model``.  Under ``moe_fsdp`` (and more than one
    data rank) the experts' f dim is this rank's ZeRO-3 block, cast to
    ``moe_gather_dtype`` and all-gathered over the data axes here, per
    layer.  The expert stacks may be kept in host memory; only this
    rank's block is copied to the tokens' device."""
    mesh, dg, mg = ctx.mesh, ctx.data_group, ctx.model_group
    msz = C.group_size(mg)
    fsdp = ctx.moe_fsdp and dg is not None
    if ctx.placed:       # the rank holds its experts' (ZeRO-3) block
        wi, wg, wo = (p[n]["w"] for n in ("wi", "wg", "wo"))
        E_l = wi.shape[0]
        e0 = mesh.coord[MODEL_AXIS] * E_l if msz > 1 else 0
    else:
        E_l = p["wi"]["w"].shape[0] // msz
        e0 = mesh.coord[MODEL_AXIS] * E_l if msz > 1 else 0
        wi, wg, wo = (p[n]["w"][e0:e0 + E_l] for n in ("wi", "wg", "wo"))
    if fsdp and not ctx.placed:
        dp, r = C.group_size(dg), mesh.index(DATA_AXES)
        f_l = wi.shape[2] // dp
        wi, wg = (w[:, :, r * f_l:(r + 1) * f_l] for w in (wi, wg))
        wo = wo[:, r * f_l:(r + 1) * f_l]
    # the stacks may stay in host memory: the rank's block goes to the
    # tokens' device (a no-op where it is there)
    wi, wg, wo = (w.to(xt.device) for w in (wi, wg, wo))
    if fsdp:
        if ctx.moe_gather_dtype is not None:   # the wire carries this dtype
            wi, wg, wo = (w.to(ctx.moe_gather_dtype) for w in (wi, wg, wo))
        wi, wg = (C.gather_dim(w, 2, dg) for w in (wi, wg))
        wo = C.gather_dim(wo, 1, dg)
    local = dataclasses.replace(ctx.numerics, group=None)
    with C.on_every_rank(math.prod(mesh.shape.values())):
        y = _moe_expert_block(C.copy_sum_grad(xt, mg), ids,
                              C.copy_sum_grad(gates, mg), wi, wg, wo, cap,
                              local, e0)
    return C.reduce_sum(y, mg)


@N.scoped("moe")
def moe_apply(p, x, ctx: Ctx, cfg):
    """Top-k MoE: the router, the capacity dispatch, the expert FFNs, the
    optional dense residual MLP and the Switch-style load-balancing aux
    loss.  Returns (y [B, T, d], aux).

    On a mesh with more than one rank along the data or model axes, the
    experts run as the reference's expert-parallel block
    (:func:`_moe_expert_parallel`), with the capacity of one data rank's
    tokens; the router, the dense residual and the aux loss stay outside
    it, with the global semantics: ``me`` and ``ce`` are means over the
    global tokens, summed over the data group before ``E * sum(me *
    ce)``."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(B * T, d)
    probs, gates, ids = moe_route(xt, p["router"]["w"], k)
    dg, mg = ctx.data_group, ctx.model_group
    dp, msz = C.group_size(dg), C.group_size(mg)
    n_tok = B * T * dp                       # global tokens
    cap = moe_capacity(n_tok, k, E, cfg.capacity_factor, dp)
    if dp > 1 or msz > 1:
        if E % msz:
            raise NotImplementedError(
                f"{E} experts do not split over {msz} model ranks")
        y = _moe_expert_parallel(p, xt, ids, gates, ctx, cap)
    else:
        y = _moe_expert_block(xt, ids, gates, p["wi"]["w"], p["wg"]["w"],
                              p["wo"]["w"], cap, ctx.numerics)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(p["dense"], xt, ctx, "silu_gated", cfg.d_ff)
    onehot = F.one_hot(ids[:, 0], E).to(torch.float32)
    if dg is None:
        me, ce = torch.mean(probs, 0), torch.mean(onehot, 0)
    else:
        me = C.reduce_sum(torch.sum(probs, 0), dg) / n_tok
        ce = C.reduce_sum(torch.sum(onehot, 0), dg) / n_tok
    aux = E * torch.sum(me * ce)
    return y.to(x.dtype).reshape(B, T, d), aux
