"""Decoder-only backbone with EULER-ADAS numerics, six families:

  dense / audio / vlm  attention + MLP blocks (per-layer local/global
          windows, gemma2's post-block norms); audio and vlm differ only in
          the stubbed modality frontend (``embedding_inputs``: ``forward``
          also takes float frame/patch embeddings)
  moe     attention + mixture-of-experts blocks (optional dense residual);
          each block's router aux loss is summed over the stack
  ssm     Mamba-2 SSD blocks (attention-free; ``models.ssm``)
  hybrid  parallel attention + SSD heads per block, each branch normalized,
          then averaged, then an MLP (hymba)

Counterpart of ``repro.models.transformer``: init,
forward, head, the T-chunked cross-entropy ``loss``, prefill,
decode_step, dense caches (KV slabs, SSM state and conv tail) and the
paged KV pool (attention-only: ``ssm``/``hybrid`` hold
recurrent state and are refused).  Parameters are plain dicts of tensors:
``{"embed": {"e"}, "layers": [per-layer dicts], "ln_f": {"g"}}``; the
reference's ``lax.scan`` over stacked layers is a host loop over the list.
:func:`params_from_jax` converts the reference's ``Model.init`` pytree (as
numpy, layers stacked ``[L, ...]``), and the optimizer moments that mirror
it.

Remat: under autograd, with no cache, each block and each loss chunk runs
inside ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint``: its activations are recomputed in the
backward pass instead of kept.  Under ``remat_policy="dots"`` a block keeps
the outputs of its contractions with no batch dimensions (JAX's
``dots_with_no_batch_dims_saveable``) through a selective-checkpoint
policy, and recomputes everything else (the planes, the straight-through
sums, the attention's batched contractions).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import numerics as N
from repro_torch.core import posit as _P
from repro_torch.core import xla_f32 as _X
from repro_torch.core.engine import EulerConfig, in_no_batch_dot
from repro_torch.distributed import collectives as C
from repro_torch.numerics import NumericsContext

from . import layers as L
from . import ssm as S
from .config import ModelConfig
from .layers import Ctx

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
_ATTN_MLP = ("dense", "audio", "vlm")

# the reference's remat policies: "none" and "nothing" recompute every
# activation (``jax.checkpoint``'s default policy saves nothing),
# "everything" saves them all, which is no remat, and "dots" saves the
# outputs of the contractions with no batch dimensions
_REMAT_POLICIES = ("none", "nothing", "everything", "dots")

_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def save_no_batch_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: every contraction the engine marked as a dot
    with no batch dims is saved (the engine runs each dot as ``bmm``, so
    the mark, not the op, says which); all else is recomputed."""
    if op in _DOT_OPS and in_no_batch_dot():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE

_FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name; posit word names
    ("uint8", "uint16", "uint32") give their storage dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if name in _P.STORAGE_DTYPES:
        return _P.STORAGE_DTYPES[name]
    return _FLOAT_DTYPES[name]


class Model:
    """init / forward / head / loss / prefill / decode_step for one
    ModelConfig."""

    def __init__(self, cfg: ModelConfig, ecfg: EulerConfig | None = None,
                 remat: bool = True, remat_policy: str = "nothing",
                 numerics: NumericsContext | None = None,
                 device: "str | torch.device" = "cuda"):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ported: "
                f"{', '.join(FAMILIES)})")
        if remat_policy not in _REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat_policy!r}")
        self.cfg = cfg
        self.remat = remat and remat_policy != "everything"
        self.remat_policy = remat_policy
        if numerics is None:
            numerics = NumericsContext.from_ecfg(
                ecfg or EulerConfig(mode="exact"))
        self.numerics = numerics
        self.ecfg = ecfg or numerics.policy.default
        self.compute_dtype = torch_dtype(cfg.dtype)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' requested but no CUDA device "
                                   "is available; pass device='cpu' to run on "
                                   "the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())

    def make_ctx(self, **kw) -> Ctx:
        return Ctx(ecfg=self.ecfg, numerics=self.numerics, **kw)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _block_init(self, gen, dev):
        cfg = self.cfg
        fam = cfg.family
        p = {"ln1": L.rmsnorm_init(cfg.d_model, dev)}
        if fam != "ssm":
            p["attn"] = L.attention_init(gen, cfg, dev)
            if cfg.post_norm:
                p["pn1"] = L.rmsnorm_init(cfg.d_model, dev)
        if fam in _ATTN_MLP + ("hybrid",):
            p["ln2"] = L.rmsnorm_init(cfg.d_model, dev)
            p["mlp"] = L.mlp_init(gen, cfg, dev)
            if cfg.post_norm:
                p["pn2"] = L.rmsnorm_init(cfg.d_model, dev)
        if fam == "moe":
            p["ln2"] = L.rmsnorm_init(cfg.d_model, dev)
            p["moe"] = L.moe_init(gen, cfg, dev)
        if fam in ("ssm", "hybrid"):
            p["ssm"] = S.ssm_init(gen, cfg, dev)
        if fam == "hybrid":
            p["bn_a"] = L.rmsnorm_init(cfg.d_model, dev)
            p["bn_s"] = L.rmsnorm_init(cfg.d_model, dev)
        return p

    def init(self, seed: int = 0):
        """Random parameters with the reference's shapes and init scales,
        drawn from a ``torch.Generator`` seeded with ``seed`` on the model's
        device (the numbers differ from the reference's PRNG)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self._init_tree(gen, self.device)

    def init_shapes(self):
        """The parameter tree's shapes and dtypes, drawing nothing: the
        tree of :meth:`init` on the ``meta`` device (the counterpart of
        ``jax.eval_shape(model.init, key)``)."""
        return self._init_tree(None, torch.device("meta"))

    def _init_tree(self, gen, dev):
        cfg = self.cfg
        return {
            "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dev),
            "layers": [self._block_init(gen, dev)
                       for _ in range(cfg.n_layers)],
            "ln_f": L.rmsnorm_init(cfg.d_model, dev),
        }

    @staticmethod
    def param_count(params) -> int:
        def count(t):
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            if isinstance(t, list):
                return sum(count(v) for v in t)
            return t.numel()
        return count(params)

    def layer_windows(self) -> list[int]:
        """Per-layer attention window (-1 = global)."""
        cfg = self.cfg
        return [cfg.window if (cfg.layer_kind(i) == "local" and cfg.window)
                else -1 for i in range(cfg.n_layers)]

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def _block(self, p, x, ctx: Ctx, window, positions, cache):
        """One block: (x, cache, aux); aux is the MoE router's loss (a
        float32 0 in the other families)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "ssm":
            h, _ = S.ssm_apply(p["ssm"], L.rmsnorm_apply(p["ln1"], x), ctx,
                               cfg, cache)
            return x + h.to(x.dtype), cache, aux
        if cfg.family == "hybrid":
            xin = L.rmsnorm_apply(p["ln1"], x)
            a_cache = s_cache = None
            if cache is not None:
                a_cache = {"k": cache["k"], "v": cache["v"]}
                s_cache = {"state": cache["state"], "conv": cache["conv"]}
            ha, _ = L.attention_apply(p["attn"], xin, ctx, cfg, window,
                                      positions, a_cache,
                                      q_chunk=cfg.q_chunk,
                                      kv_chunk=cfg.kv_chunk)
            hs, _ = S.ssm_apply(p["ssm"], xin, ctx, cfg, s_cache)
            # hymba-style fusion: per-branch normalization, then the mean
            h = 0.5 * (L.rmsnorm_apply(p["bn_a"], ha)
                       + L.rmsnorm_apply(p["bn_s"], hs))
            x = x + h.to(x.dtype)
            x = x + L.mlp_apply(p["mlp"], L.rmsnorm_apply(p["ln2"], x), ctx,
                                cfg.mlp, cfg.d_ff).to(x.dtype)
            return x, cache, aux
        # attention families: dense / audio / vlm / moe
        h, cache = L.attention_apply(p["attn"], L.rmsnorm_apply(p["ln1"], x),
                                     ctx, cfg, window, positions, cache,
                                     q_chunk=cfg.q_chunk,
                                     kv_chunk=cfg.kv_chunk)
        if cfg.post_norm:
            h = L.rmsnorm_apply(p["pn1"], h)
        x = x + h.to(x.dtype)
        xin = L.rmsnorm_apply(p["ln2"], x)
        if cfg.family == "moe":
            h, aux = L.moe_apply(p["moe"], xin, ctx, cfg)
        else:
            h = L.mlp_apply(p["mlp"], xin, ctx, cfg.mlp, cfg.d_ff)
        if cfg.post_norm:
            h = L.rmsnorm_apply(p["pn2"], h)
        x = x + h.to(x.dtype)
        return x, cache, aux

    def _checkpointed(self, cache) -> bool:
        """Whether to rematerialize: remat on, autograd recording, and no
        cache (a cache is written in place, never under autograd)."""
        return self.remat and cache is None and torch.is_grad_enabled()

    def forward(self, params, inputs, ctx: Ctx, cache=None, positions=None):
        """inputs: token ids [B, T] or float embeddings [B, T, d].
        Returns (hidden [B, T, d], cache) — the cache updated in place."""
        x, cache, _ = self.forward_aux(params, inputs, ctx, cache, positions)
        return x, cache

    def forward_aux(self, params, inputs, ctx: Ctx, cache=None,
                    positions=None):
        """:meth:`forward` that also returns the blocks' aux loss summed
        over the stack, layer by layer from 0 (the reference's scan
        carry): (hidden, cache, aux)."""
        if torch.is_floating_point(inputs):
            x = inputs.to(self.compute_dtype)
        else:
            x = L.embed_apply(params["embed"], inputs,
                              self._vocab_group(params, ctx)
                              ).to(self.compute_dtype)
        T = x.shape[1]
        if positions is None:
            if ctx.decode_pos is None:
                positions = torch.arange(T, dtype=torch.int32,
                                         device=x.device)
            else:
                dp = torch.as_tensor(ctx.decode_pos, dtype=torch.int32,
                                     device=x.device)
                positions = dp.reshape(1) if dp.ndim == 0 else dp[:, None]
        remat = self._checkpointed(cache)
        remat_kw = ({"context_fn": functools.partial(
            create_selective_checkpoint_contexts, save_no_batch_dots)}
            if self.remat_policy == "dots" else {})
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (p_l, win) in enumerate(zip(params["layers"],
                                           self.layer_windows())):
            c_l = (None if cache is None else
                   {name: a[i] for name, a in cache.items()})
            if remat:   # the block's (x, aux); no cache under remat
                x, a = checkpoint(
                    lambda p, h, w: self._block(p, h, ctx, w, positions,
                                                None)[::2],
                    p_l, x, win, use_reentrant=False, **remat_kw)
            else:
                x, _, a = self._block(p_l, x, ctx, win, positions, c_l)
            aux = aux + a
        x = L.rmsnorm_apply(params["ln_f"], x)
        return x, cache, aux

    def _vocab_group(self, params, ctx: Ctx):
        """The model group where the rank holds its block of the
        embedding's vocab rows (the production placement), else None."""
        if not ctx.placed or params["embed"]["e"].shape[0] == \
                self.cfg.vocab_padded:
            return None
        return ctx.model_group

    def head(self, params, h, ctx: Ctx, gather: bool = True):
        """hidden [..., d] -> logits [..., vocab_padded] (tied embeddings).
        Under the production placement each rank computes its block of
        the vocab, gathered over ``model`` unless ``gather`` is False."""
        cfg = self.cfg
        emb = params["embed"]["e"].to(h.dtype)
        vg = self._vocab_group(params, ctx)
        dn = (((h.ndim - 1,), (1,)), ((), ()))
        with N.scope("head"):
            if vg is None:
                logits = N.dot_general(h, emb, dn, ctx.numerics, op="matmul",
                                       groups=(ctx.data_group, None))
            else:
                logits = N.dot_general(C.copy_sum_grad(h, vg), emb, dn,
                                       ctx.numerics, op="matmul",
                                       groups=(ctx.data_group, vg),
                                       column_parts=C.group_size(vg))
            logits = logits.to(torch.float32)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * _X.tanh(logits / cfg.logit_softcap)
        if cfg.vocab_padded > cfg.vocab:  # mask padded vocab slots
            vocab = torch.arange(emb.shape[0], device=h.device)
            if vg is not None:
                vocab = vocab + dist.get_rank(vg) * emb.shape[0]
            logits = torch.where(vocab >= cfg.vocab,
                                 torch.tensor(-1e30, device=h.device), logits)
        if vg is not None and gather:
            logits = C.gather_replicated(logits, -1, vg)
        return logits

    def _chunk_loss(self, params, h_c, y_c, ctx: Ctx):
        logits = self.head(params, h_c, ctx, gather=False)      # [B,tc,Vp]
        vg = self._vocab_group(params, ctx)
        if vg is None:
            logz = _X.logsumexp(logits, -1)
            ll = torch.gather(logits, -1,
                              y_c[..., None].to(torch.long))[..., 0]
            return torch.sum(logz - ll)
        return torch.sum(vocab_parallel_xent(logits, y_c, vg))

    def loss(self, params, batch, ctx: Ctx):
        """Mean next-token cross-entropy with T-chunked logits: the head
        runs on one [B, loss_chunk, V] slab at a time, each rematerialized
        in the backward pass under remat.

        batch: {"inputs": ids [B, T] or embeds [B, T, d], "labels": ids
        [B, T]}.  Returns (loss, {"xent", "aux"}): the moe family adds
        ``0.01 * aux``, the router loss summed over the blocks.  On a mesh
        (``ctx.mesh``) the batch is this rank's rows; the loss is the
        global batch's, and its gradient on each rank that rank's share,
        so the ranks' gradients sum to the global one."""
        hidden, _, aux = self.forward_aux(params, batch["inputs"], ctx)
        labels = batch["labels"]
        B, T = labels.shape
        tc = min(self.cfg.loss_chunk, T)
        if T % tc:
            raise ValueError(f"sequence length {T} is not a multiple of the "
                             f"loss chunk {tc}")
        remat = self._checkpointed(None)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(T // tc):
            h_c = hidden[:, c * tc:(c + 1) * tc]
            y_c = labels[:, c * tc:(c + 1) * tc]
            if remat:
                part = checkpoint(
                    lambda h, y: self._chunk_loss(params, h, y, ctx),
                    h_c, y_c, use_reentrant=False)
            else:
                part = self._chunk_loss(params, h_c, y_c, ctx)
            total = total + part
        # on a mesh: the sum over the data group, normalised by the global
        # B * T; each rank's gradient is its own rows' share
        dg = ctx.data_group
        xent = C.reduce_sum(total, dg) / (B * C.group_size(dg) * T)
        loss = xent + 0.01 * aux if self.cfg.family == "moe" else xent
        return loss, {"xent": xent, "aux": aux}

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   mesh=None):
        """Dense per-slot cache, every leaf stacked ``[L, B, ...]``: KV slabs
        ``{"k","v"}`` of ``[L, B, max_len, KV, hd]`` (dense, hybrid) and the
        SSM ``{"state","conv"}`` (ssm, hybrid).  The SSM conv tail takes
        ``dtype`` too, bfloat16 for a uint8 cache, as in the reference.
        ``device``: the model's unless given (``"meta"``: shapes only).
        ``mesh``: the rank's blocks under ``sharding.cache_shardings``, the
        production placement's cache; a KV cache whose heads and positions
        both leave ``model`` whole is refused (the placed decode splits
        positions wherever the KV heads do not divide ``model``)."""
        from repro_torch.distributed import sharding as SH
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        dtype = torch_dtype(dtype or cfg.cache_dtype)
        fdt = torch.bfloat16 if dtype == torch.uint8 else dtype
        c = {}  # one layer's leaves, on the meta device for their shapes
        if cfg.family != "ssm":
            c.update(L.attention_cache_init(cfg, batch, max_len, dtype,
                                            "meta"))
        if cfg.family in ("ssm", "hybrid"):
            c.update(S.ssm_cache_init(cfg, batch, fdt, "meta"))
        shapes = {k: (cfg.n_layers,) + tuple(a.shape) for k, a in c.items()}
        if mesh is not None:
            specs = SH.cache_shardings(mesh, {
                k: torch.empty(v, device="meta") for k, v in shapes.items()})
            m = SH.axis_size(mesh, "model")
            for k in ("k", "v"):
                if (k in specs and m > 1 and cfg.n_kv_heads % m
                        and "model" not in specs[k][1]):
                    raise ValueError(
                        f"a placed KV cache of {max_len} positions: "
                        f"{cfg.n_kv_heads} KV heads and the positions leave "
                        f"model = {m} whole")
            shapes = {k: SH.local_shape(v, specs[k][1], mesh)
                      for k, v in shapes.items()}
        return {k: torch.zeros(v, dtype=c[k].dtype, device=dev)
                for k, v in shapes.items()}

    def init_paged_cache(self, num_pages: int, page_size: int, dtype=None):
        """Shared page pool ``{"k","v"}`` of ``[L, P, page_size, KV, hd]``;
        pages 0/1 are reserved (null read page / trash write sink).
        Attention-only: SSM/hybrid recurrent state has no sequence axis to
        page."""
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                f"paged KV cache requires attention caches; family "
                f"{cfg.family!r} holds recurrent state")
        dtype = torch_dtype(dtype or cfg.cache_dtype)
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def reset_cache(self, cache, slot=None):
        """Zero the whole cache or one slot's rows, in place."""
        return L.cache_reset(cache, slot, batch_axis=1)

    def prefill(self, params, inputs, ctx: Ctx, cache):
        """Run the prompt through the stack, filling the cache.
        Returns (last-position logits [B, Vp], cache)."""
        hidden, cache = self.forward(params, inputs, ctx, cache=cache)
        logits = self.head(params, hidden[:, -1:, :], ctx)[:, 0, :]
        return logits, cache

    def decode_step(self, params, tok, pos, cache, ctx: Ctx, *,
                    page_table=None, write_mask=None):
        """One decode step.  tok [B] int; pos int or [B] int32.  With
        ``page_table`` ([B, n_logical] int32) ``cache`` is the page pool
        and ``write_mask`` ([B] bool) sends masked rows' writes to the
        trash page.  Returns (logits [B, Vp], cache)."""
        ctx = dataclasses.replace(ctx, decode_pos=pos, page_table=page_table,
                                  decode_write=write_mask)
        hidden, cache = self.forward(params, tok[:, None], ctx, cache=cache)
        logits = self.head(params, hidden[:, 0, :], ctx)
        return logits, cache


def vocab_parallel_xent(logits, labels, group):
    """Cross-entropy ``logsumexp(logits) - logits[label]`` per position of
    logits split by vocab over ``group``: ``logits`` [..., V / n] the
    rank's block, ``labels`` [...] global ids.  The max, the sum of exp and
    the label's logit are each summed over the group (the max outside the
    gradient, 0 where it is not finite, as ``_X.logsumexp``); each rank's
    gradient is its block's."""
    v_l = logits.shape[-1]
    amax = C.all_reduce(logits.detach().amax(-1, keepdim=True), group,
                        dist.ReduceOp.MAX)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = C.reduce_sum(_X.exp(logits - amax).sum(-1), group)
    logz = _X.log(s.abs()) + amax.squeeze(-1)
    local = labels.to(torch.long) - dist.get_rank(group) * v_l
    mine = (local >= 0) & (local < v_l)
    ll = torch.gather(logits, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    ll = C.reduce_sum(torch.where(mine, ll, torch.zeros_like(ll)), group)
    return logz - ll


def params_from_jax(np_params, cfg: ModelConfig, device="cuda",
                    dtype=torch.float32):
    """The reference's ``Model.init`` pytree, as numpy arrays with layers
    stacked ``[L, ...]``, converted to this package's parameter dicts.  Any
    tree that mirrors the parameters converts the same way: the AdamW
    moments ``opt["m"]``/``opt["v"]`` of a training state, at their
    ``state_dtype`` (``dtype``)."""
    import numpy as np

    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return conv(np.asarray(tree)[i])

    return {"embed": {"e": conv(np_params["embed"]["e"])},
            "layers": [layer(np_params["layers"], i)
                       for i in range(cfg.n_layers)],
            "ln_f": {"g": conv(np_params["ln_f"]["g"])}}
