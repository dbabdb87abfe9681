"""Slot-based continuous-batching serving.

Counterpart of ``repro.serving.engine``: greedy and sampled (temperature,
top-k) serving with per-request deadlines, the SLO-driven precision
ladder, guard-triggered retries and live fault plans.  Durable snapshots
and supervised restart build on it in ``serving.failover``.

* ``ServeEngine`` owns the model's KV cache and exposes the slot
  primitives: ``prefill_slot`` (batch-1 prefill fully overwriting a slot),
  ``step_slots`` (one masked decode step over every slot, each at its own
  position) and the cache lifecycle (``reset_all``/``reset_slot``/
  ``release_slot``).  ``generate`` keeps the reference's whole-batch,
  lockstep API on the dense cache: an EOS-aware decode that pads finished
  rows and exits early, checked every ``decode_chunk`` steps.  The
  reference's on-device ``lax.scan`` over decode steps is a host loop
  here.
* ``RequestBatcher`` is the host-side scheduler: queued -> prefill (slot
  admission, per-request bucket) -> decoding -> done (EOS | budget) ->
  slot refilled from the queue mid-stream.  Prompts longer than
  ``max_len`` are rejected at admission.

**Paged mode** (``paged=PagedKVConfig(...)``) replaces the per-slot cache
rows with a shared page pool (``serving.kvcache``): prefill allocates
``ceil(len/page_size)`` pages, decode grows one page at a time, and pool
exhaustion surfaces as ``PagePoolOOM``.  The batcher then reclaims retired
slots' deferred pages, then preempts the youngest-admitted slot (its
request re-enqueues at the queue front and recomputes), and finally holds
admission (queue backpressure).

**Fault-tolerant serving.**  ``ServeEngine(levels=[...])`` holds one
numerics context per precision-ladder level; ``RequestBatcher(slo=...)``
admits new requests down the ladder under load (``DegradeController``),
``deadline_ms`` retires late requests with status "timeout", and
``guard_retry`` re-enqueues a request hit by an unrecovered ``guarded:``
violation one level higher, or fails it when its retries run out.
``ServeEngine(fault=...)`` runs every decode step under
``reliability.faults.inject``; prefill is never corrupted.

**Keys.**  JAX's PRNG keys become counter-based pairs of integers
``(seed, counter)`` (:func:`make_key`).  :func:`split_key` advances the
counter and hands out a sub-key, an integer folded from the pair, that
seeds one device ``torch.Generator`` for one sample.  The batcher threads
the key through every admission and decode step as the reference does, so
a snapshot of the pair (``serving.failover``) resumes the exact stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.models.layers import Ctx
from repro_torch.numerics import NumericsContext
from repro_torch.reliability import faults as _faults
from repro_torch.reliability.faults import FaultPlan
from repro_torch.serving.kvcache import PagePoolOOM, PagedKVCache, PagedKVConfig

log = logging.getLogger("repro_torch.serving")


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => no top-k filter
    eos_id: int | None = None         # stop a row once it emits this token
    pad_id: int = 0                   # what finished rows emit afterwards


def make_key(seed: int = 0) -> tuple[int, int]:
    """A sampling key: the pair (seed, counter) at counter 0."""
    return (int(seed), 0)


def split_key(key) -> tuple[tuple[int, int], int]:
    """(the next key, a sub-key): the counter advances by one and the
    sub-key is an integer seed folded from the pair."""
    seed, ctr = (int(k) for k in key)
    return (seed, ctr + 1), _faults.fold_in(seed, ctr)


def _sample(logits, gen: GenerationConfig, sub: int):
    """Greedy / temperature / top-k sampling of one [B, V] logits slab on
    its device.  Sampling is the Gumbel-max draw ``jax.random.categorical``
    makes, from a generator seeded with the sub-key."""
    if gen.temperature == 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    logits = logits.to(torch.float32) / gen.temperature
    if gen.top_k:
        kth = torch.topk(logits, gen.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.tensor(-1e30, device=logits.device), logits)
    g = torch.Generator(device=logits.device)
    g.manual_seed(sub)
    u = torch.rand(logits.shape, generator=g, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), -1).to(torch.int32)


class ServeEngine:
    def __init__(self, model, params, ctx: Ctx | None = None, *,
                 max_len: int = 2048, batch: int = 8, cache_dtype=None,
                 decode_chunk: int = 8,
                 numerics: NumericsContext | None = None,
                 fault: FaultPlan | None = None,
                 levels: "Sequence[NumericsContext] | None" = None,
                 paged: PagedKVConfig | None = None):
        """``numerics`` (policy + backend) overrides whatever the ctx
        carries.  ``paged`` switches the KV cache to the page-pool layout;
        decode then runs through the ``decode_attention`` numerics op (the
        fused flash-decode kernel on the ``cuda`` backend for integer
        pages) and ``generate`` is refused.

        ``decode_chunk``: how many decode steps ``generate`` runs between
        its all-done checks (the early-exit granularity).

        ``fault``: a live fault plan.  Each decode step runs under
        ``faults.inject`` with a key folded from the plan's seed and the
        engine's decode-step counter ``fault_step`` (effective under a
        ``faulty:<base>`` backend); prefill is never corrupted.

        ``levels``: the precision ladder, ``levels[0]`` first (it overrides
        ``numerics``), then the cheaper contexts the scheduler demotes to.
        Slots at different levels decode side by side, each only ever
        under its own level's numerics; with one level the decode path is
        the single-context path."""
        if levels:
            numerics = levels[0]
        if ctx is None:
            ctx = model.make_ctx()
        if numerics is not None:
            ctx = dataclasses.replace(ctx, numerics=numerics,
                                      ecfg=numerics.policy.default)
        self.model = model
        self.params = params
        self.ctx = ctx
        self.max_len = max_len
        self.batch = batch
        self.decode_chunk = max(1, decode_chunk)
        self.paged = paged
        self.device = model.device
        self._cache_dtype = cache_dtype
        if paged is not None:
            if max_len % paged.page_size:
                raise ValueError(
                    f"max_len={max_len} not a multiple of "
                    f"page_size={paged.page_size}")
            num_pages = paged.resolve_pages(batch, max_len)
            self.kv = PagedKVCache(batch, max_len, paged.page_size, num_pages)
            self.cache = model.init_paged_cache(num_pages, paged.page_size,
                                                cache_dtype)
            self._ptmpl: dict[int, Any] = {}  # batch-1 prefill templates
            self._cache1 = None
        else:
            self.kv = None
            self.cache = model.init_cache(batch, max_len, cache_dtype)
            self._cache1 = model.init_cache(1, max_len, cache_dtype)
        # the precision ladder: every level reuses the primary ctx with
        # only the numerics (and its default ecfg) swapped
        self._ctxs = [ctx] + [
            dataclasses.replace(ctx, numerics=nc, ecfg=nc.policy.default)
            for nc in (levels or [])[1:]]
        self.n_levels = len(self._ctxs)
        self.fault = fault
        self.fault_step = 0  # decode-step counter for fault keys
        self.last_decode_steps = 0  # decode steps run by the last generate

    # -- cache lifecycle ------------------------------------------------

    def reset_all(self):
        """Invalidate every slot (used at the top of every drain)."""
        if self.kv is not None:
            self.kv.reset()
        self.model.reset_cache(self.cache)

    def reset_slot(self, slot: int):
        """Invalidate one slot: zero its cache rows (dense) or return its
        pages to the pool (paged; pool rows are overwritten on reuse)."""
        if self.kv is not None:
            self.kv.free_slot(slot)
            return
        self.model.reset_cache(self.cache, slot)

    def release_slot(self, slot: int):
        """Return a slot's pages to the pool (dense engines: no-op).  Plain
        retires keep the pages mapped until the refilling prefill frees
        them, so a retired slot's masked decode writes keep landing at its
        frozen position, byte-identical to the dense engine."""
        if self.kv is not None and self.kv.n_pages(slot):
            self.kv.free_slot(slot)

    def ensure_slot_pages(self, slot: int, pos) -> list:
        """Grow ``slot`` until its pages cover a cache write at ``pos``;
        every grown page is zeroed first (a reused page holds the previous
        tenant's words).  Raises :class:`PagePoolOOM` with the pages grown
        so far mapped and zeroed."""
        need = min(int(pos), self.max_len - 1) // self.kv.page_size + 1
        grown = []
        while self.kv.n_pages(slot) < need:
            p = self.kv.grow_slot(slot)
            for pool in self.cache.values():
                pool[:, p].zero_()
            grown.append(p)
        return grown

    def _step(self, gen, tok, pos, done, key, level: int = 0, cache=None,
              page_table=None, write_mask=None, fstep=None):
        """One masked decode step at ladder ``level`` over ``cache`` (the
        engine's own by default): the reference's scan body.  ``fstep``
        is the fault step (default: the engine's ``fault_step``).
        Returns (tokens, positions, done, the next key)."""
        cache = self.cache if cache is None else cache
        fstep = self.fault_step if fstep is None else fstep
        if self.fault is None:
            faults_on = contextlib.nullcontext()
        else:
            fkey = _faults.fold_in(self.fault.seed, fstep)
            faults_on = _faults.inject(self.fault, fkey, fstep)
        with faults_on:
            logits, _ = self.model.decode_step(
                self.params, tok, pos, cache, self._ctxs[level],
                page_table=page_table, write_mask=write_mask)
        key, sub = split_key(key)
        nxt = _sample(logits, gen, sub)
        pad = torch.tensor(gen.pad_id, dtype=torch.int32, device=self.device)
        nxt = torch.where(done, pad, nxt)
        pos = torch.where(done, pos,
                          torch.clamp(pos + 1, max=self.max_len - 1))
        if gen.eos_id is not None:
            done = done | (nxt == gen.eos_id)
        return nxt, pos, done, key

    # -- whole-batch generation -----------------------------------------

    def _decode_scan(self, gen: GenerationConfig, n: int, tok, pos, done,
                     key, fstep: int):
        """``n`` masked lockstep decode steps on the dense cache, the
        reference's scanned program as a host loop.  Carry: (tok [B], pos
        [B], done [B], key, fstep); finished rows emit ``pad_id`` and keep
        their position, active rows clamp it to ``max_len - 1``; ``fstep``
        drives the fault plan's keys and advances every step.  Returns
        (the carry, tokens [n, B])."""
        toks = []
        for _ in range(n):
            tok, pos, done, key = self._step(gen, tok, pos, done, key,
                                             fstep=fstep)
            fstep += 1
            toks.append(tok)
        return (tok, pos, done, key, fstep), torch.stack(toks)

    def generate(self, prompts, gen: GenerationConfig, key=None):
        """prompts: [B, Tp] int token ids (right-aligned in one bucket),
        B the engine's batch.  Returns tokens [B, max_new_tokens] (a
        tensor on the engine's device).

        The whole cache is reset, the batch prefilled in lockstep and then
        decoded ``decode_chunk`` steps at a time.  With ``gen.eos_id`` a
        row stops at (and including) its first EOS and emits ``pad_id``
        afterwards; decoding stops once every row is done, and the output
        is padded to the full width.  Dense cache only: a paged engine
        serves through ``RequestBatcher``."""
        if self.kv is not None:
            raise RuntimeError(
                "generate() is whole-batch/bucketed; a paged engine serves "
                "through RequestBatcher (prefill_slot/step_slots)")
        dev = self.device
        prompts = torch.as_tensor(prompts, device=dev).to(torch.int32)
        B, Tp = prompts.shape
        if B != self.batch:
            raise ValueError(f"generate needs a batch of {self.batch} "
                             f"prompts, got {B}")
        if gen.max_new_tokens <= 0:
            return torch.zeros((B, 0), dtype=torch.int32, device=dev)
        key = key if key is not None else make_key(0)
        self.reset_all()  # no state from a previous generate can leak in
        logits, _ = self.model.prefill(self.params, prompts, self.ctx,
                                       self.cache)
        key, sub = split_key(key)
        tok = _sample(logits, gen, sub)
        done = (tok == gen.eos_id if gen.eos_id is not None
                else torch.zeros((B,), dtype=torch.bool, device=dev))
        pos = torch.full((B,), Tp, dtype=torch.int32, device=dev)
        outs = [tok[:, None]]  # the first token comes from the prefill
        remaining = gen.max_new_tokens - 1
        steps, fstep = 0, 0
        while remaining > 0 and not bool(done.all()):
            n = min(self.decode_chunk, remaining)
            (tok, pos, done, key, fstep), toks = self._decode_scan(
                gen, n, tok, pos, done, key, fstep)
            outs.append(toks.T)
            remaining -= n
            steps += n
        self.last_decode_steps = steps
        out = torch.cat(outs, dim=1)
        if out.shape[1] < gen.max_new_tokens:  # early exit: pad the rest
            out = torch.nn.functional.pad(
                out, (0, gen.max_new_tokens - out.shape[1]),
                value=gen.pad_id)
        return out

    # -- slot-level primitives (used by the scheduler) -------------------

    def prefill_slot(self, slot: int, prompt_tokens, gen: GenerationConfig,
                     key: int, level: int = 0) -> int:
        """Prefill one request into ``slot`` and return its first token,
        sampled under ``gen`` with the sub-key ``key`` (``split_key``'s).

        Runs a batch-1 prefill on a zero cache, under ladder ``level``'s
        numerics, and writes it over every cache leaf's slot row (dense:
        KV slabs, SSM state, conv tail) or scatters it into freshly
        allocated pool pages (paged; the length must be a page multiple).
        Raises :class:`PagePoolOOM` (slot unmapped, pool clean) when the
        pool cannot hold the request plus one growth page."""
        ctx = self._ctxs[level]
        toks = torch.as_tensor(np.asarray(prompt_tokens, np.int32),
                               device=self.device)[None, :]
        if self.kv is not None:
            ps = self.kv.page_size
            Tpad = toks.shape[1]
            if Tpad % ps or Tpad > self.max_len:
                raise ValueError(
                    f"paged prefill length {Tpad} must be a multiple of "
                    f"page_size={ps} and <= max_len={self.max_len}")
            if self.kv.n_pages(slot):
                self.kv.free_slot(slot)
            pages = self.kv.alloc_slot(slot, Tpad // ps)
            tmpl = self._ptmpl.get(Tpad)
            if tmpl is None:
                tmpl = self.model.init_cache(1, Tpad, self._cache_dtype)
                self._ptmpl[Tpad] = tmpl
            else:
                self.model.reset_cache(tmpl)
            logits, c1 = self.model.prefill(self.params, toks, ctx, tmpl)
            idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
            for name, pool in self.cache.items():
                slab = c1[name][:, 0]                 # [L, Tpad, KV, hd]
                pool[:, idx] = slab.reshape(
                    (slab.shape[0], len(pages), ps) + tuple(slab.shape[2:])
                ).to(pool.dtype)
            return int(_sample(logits, gen, key)[0])
        self.model.reset_cache(self._cache1)
        logits, c1 = self.model.prefill(self.params, toks, ctx,
                                        self._cache1)
        for name, a in self.cache.items():
            a[:, slot] = c1[name][:, 0].to(a.dtype)
        return int(_sample(logits, gen, key)[0])

    def _table_cap(self) -> int:
        """Logical-page window for this step's table: the max mapped page
        count over all slots, rounded up to a power of two, capped at
        ``n_logical``."""
        n = max(max((self.kv.n_pages(s) for s in range(self.batch)),
                    default=1), 1)
        cap = 1
        while cap < n:
            cap *= 2
        return min(cap, self.kv.n_logical)

    def step_slots(self, gen: GenerationConfig, tok, pos, active, key,
                   level=None):
        """One masked decode step over all slots.  ``tok``/``pos``/``active``
        are [B] host arrays; inactive slots are fed as done (emit pad,
        frozen position).  Returns the emitted [B] tokens (numpy) and the
        threaded key (every level's step splits it once); the cache and
        ``fault_step`` advance on the engine.

        ``level``: optional [B] ladder indices.  When every active slot
        shares one level this is one step, identical to the level-free
        call; mixed levels run one step per occupied level with the other
        levels' slots masked done, so no slot's tokens or cache words are
        produced by another level's numerics."""
        dev = self.device
        act = np.asarray(active, bool)
        lvls = (np.zeros(act.shape, np.int32) if level is None
                else np.asarray(level, np.int32))
        used = sorted({int(l) for l, a in zip(lvls, act) if a}) or [0]
        tok_t = torch.as_tensor(np.asarray(tok, np.int32), device=dev)
        pos_t = torch.as_tensor(np.asarray(pos, np.int32), device=dev)
        kw = {}
        if self.kv is not None:
            table = self.kv.table_device(dev)[:, :self._table_cap()]
            kw["page_table"] = table.contiguous()
        if len(used) == 1:
            if self.kv is not None:
                # every row writes (mask all-True): done rows land their
                # pad-token k/v at their frozen position, like dense does
                kw["write_mask"] = torch.ones(act.shape, dtype=torch.bool,
                                              device=dev)
            nxt, _, _, key = self._step(gen, tok_t, pos_t,
                                        torch.as_tensor(~act, device=dev),
                                        key, level=used[0], **kw)
            self.fault_step += 1
            return nxt.cpu().numpy(), key
        out = None
        if self.kv is not None:
            # the pool has no slot axis to merge over, so the levels run
            # SEQUENTIALLY through it: each level's step writes only its
            # own slots' pages (the write mask sends the other rows to the
            # trash page)
            for lvl in used:
                sel = torch.as_tensor(act & (lvls == lvl), device=dev)
                t, _, _, key = self._step(gen, tok_t, pos_t, ~sel, key,
                                          level=lvl, write_mask=sel, **kw)
                out = t if out is None else torch.where(sel, t, out)
        else:
            # dense: every level steps from the SAME pre-step cache (a
            # copy), and each slot's row is taken from its own level's copy
            stepped = []
            for lvl in used:
                sel = torch.as_tensor(act & (lvls == lvl), device=dev)
                c = {k: v.clone() for k, v in self.cache.items()}
                t, _, _, key = self._step(gen, tok_t, pos_t, ~sel, key,
                                          level=lvl, cache=c)
                out = t if out is None else torch.where(sel, t, out)
                stepped.append((sel, c))
            for sel, c in stepped:
                rows = torch.nonzero(sel).reshape(-1)
                for k, a in self.cache.items():
                    a[:, rows] = c[k][:, rows]
        self.fault_step += 1
        return out.cpu().numpy(), key


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    deadline_ms: float | None = None  # wall-clock SLO from submit time
    submit_t: float = 0.0             # batcher-clock timestamp of submit()
    level: int = 0                    # precision-ladder index (0 = highest)
    attempts: int = 0                 # guard-triggered re-enqueues so far
    status: str = "ok"                # ok | timeout | failed | rejected


class QueueFullError(RuntimeError):
    """submit() on a batcher whose queue is at max_queue capacity."""


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Degradation thresholds for SLO-aware precision throttling.

    Every ``queue_hi`` queued requests push newly-admitted slots one level
    down the engine's precision ladder; a recent-window p99 step latency
    above ``p99_ms`` adds one more.  Levels clamp to the ladder length, so a
    1-level engine never degrades (the config is then inert)."""

    queue_hi: int = 8
    p99_ms: float | None = None
    window: int = 64              # step-latency samples kept for the p99

    def __post_init__(self):
        if self.queue_hi <= 0:
            raise ValueError(f"queue_hi must be > 0, got {self.queue_hi}")
        if self.window <= 0:
            raise ValueError(f"window must be > 0, got {self.window}")


class DegradeController:
    """Maps instantaneous load to an admission precision level.

    Pure policy over observations the batcher feeds it (queue depth at
    admission, per-step wall latency) — it never touches the engine, so the
    demote-on-admission point stays the single place levels are assigned.
    """

    def __init__(self, slo: SLOConfig, n_levels: int):
        self.slo = slo
        self.n_levels = n_levels
        self._lat: list[float] = []

    def record_step(self, dt_ms: float):
        self._lat.append(float(dt_ms))
        if len(self._lat) > self.slo.window:
            del self._lat[:len(self._lat) - self.slo.window]

    def p99_ms(self) -> float:
        if not self._lat:
            return 0.0
        return float(np.percentile(np.asarray(self._lat), 99))

    def admission_level(self, queue_depth: int) -> int:
        lvl = queue_depth // self.slo.queue_hi
        if self.slo.p99_ms is not None and self.p99_ms() > self.slo.p99_ms:
            lvl += 1
        return min(lvl, self.n_levels - 1)


@dataclasses.dataclass
class _Slot:
    req: Request
    budget: int          # tokens still allowed (per-request max_new cap)
    seq: int = 0         # admission order — preemption evicts the youngest


@dataclasses.dataclass
class _RunState:
    """The scheduler loop's complete host-side state between two decode
    steps (the engine holds the cache): what ``serving.failover``'s
    ``DurableBatcher`` snapshots, and re-enters ``_drive`` from."""
    gen: GenerationConfig
    cap_budget: bool          # True: gen.max_new_tokens caps request budgets
    key: tuple                # threaded (seed, counter) sampling key
    slots: list               # [B] of _Slot | None
    tok: np.ndarray           # [B] last emitted token per slot
    pos: np.ndarray           # [B] next cache write position per slot
    active: np.ndarray        # [B] bool
    level: np.ndarray         # [B] per-slot precision-ladder index
    step: int = 0
    results: dict = dataclasses.field(default_factory=dict)


# ``mixed_steps``: decode steps that ran more than one ladder level
_FRESH_STATS = {"steps": 0, "refills": 0, "truncated": 0, "timeouts": 0,
                "guard_retries": 0, "demotions": 0, "mixed_steps": 0,
                "rejected": 0, "kv_oom": 0, "preempts": 0}


class RequestBatcher:
    """Host-side continuous-batching scheduler over ``ServeEngine`` slots.

    ``submit`` enqueues; ``run`` drains the queue: free slots are admitted
    (batch-1 prefill), then the batch decodes one masked step at a time and
    any slot that finishes is retired and refilled mid-stream.  Each
    request keeps its own bucket and position, so its tokens equal a
    single-request run's."""

    def __init__(self, engine: ServeEngine, prompt_buckets=(128, 512, 2048),
                 max_queue: int | None = None, *,
                 slo: SLOConfig | None = None, guard_retry: int = 0,
                 clock: Callable[[], float] | None = None):
        """``max_queue``: admission cap (``submit`` raises
        :class:`QueueFullError` beyond it).  ``slo``: admit requests at
        ``DegradeController.admission_level`` of the engine's ladder.
        ``guard_retry``: re-enqueues per request after an unrecovered
        ``guarded:`` violation on its row, one level higher each time;
        past it the request retires "failed".  ``clock``: monotonic
        seconds for deadlines and step latency (tests pin it)."""
        self.engine = engine
        if engine.kv is not None:
            self.buckets = None  # paged: each prompt padded to its own pages
        else:
            buckets = sorted(b for b in prompt_buckets if b < engine.max_len)
            if not buckets:
                raise ValueError(
                    f"no prompt bucket fits engine max_len={engine.max_len} "
                    f"(got {tuple(prompt_buckets)})")
            self.buckets = buckets
        self.max_queue = max_queue
        self.clock = clock if clock is not None else time.monotonic
        self.slo = slo
        self.guard_retry = guard_retry
        self.controller = (DegradeController(slo, engine.n_levels)
                           if slo is not None else None)
        self.queue: list[Request] = []
        self._next_rid = 0
        self._admit_seq = 0
        # ("admit"|"refill"|"done"|"timeout"|"failed"|"rejected"|"preempt"|
        #  "kv_oom"|"guard_retry", rid, slot, step)
        self.events: list[tuple] = []
        self.stats = dict(_FRESH_STATS)
        self.statuses: dict[int, str] = {}

    def submit(self, prompt, max_new: int = 32,
               deadline_ms: float | None = None) -> int:
        """Enqueue a prompt; ``deadline_ms`` is a wall-clock SLO from now: a
        request not finished by then retires with status "timeout" (with
        its partial tokens if it was decoding)."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFullError(
                f"queue full ({len(self.queue)} >= max_queue={self.max_queue})")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32), max_new,
                                  deadline_ms=deadline_ms,
                                  submit_t=self.clock()))
        return rid

    def _expired(self, r: Request, now: float) -> bool:
        return (r.deadline_ms is not None
                and (now - r.submit_t) * 1000.0 > r.deadline_ms)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _pack(self, r: Request) -> np.ndarray:
        """Right-align the prompt in its own bucket (paged: its own page
        multiple); over-long prompts keep their LAST ``bucket`` tokens."""
        if self.buckets is None:
            ps = self.engine.kv.page_size
            bucket = max(ps, -(-len(r.prompt) // ps) * ps)
        else:
            bucket = self._bucket(len(r.prompt))
        prompt = r.prompt
        if len(prompt) > bucket:
            log.warning("rid=%d prompt len %d exceeds largest bucket %d; "
                        "keeping the last %d tokens", r.rid, len(prompt),
                        bucket, bucket)
            prompt = prompt[-bucket:]
            self.stats["truncated"] += 1
        toks = np.zeros(bucket, np.int32)
        toks[bucket - len(prompt):] = prompt
        return toks

    # -- the scheduler loop ---------------------------------------------

    def run(self, gen: GenerationConfig | None = None,
            on_complete: Callable[[int, np.ndarray], None] | None = None,
            key=None, max_steps: int | None = None):
        """Drain the queue; returns {rid: tokens}.  Per-request budgets are
        ``min(request.max_new, gen.max_new_tokens)``.  ``key``: the
        sampling key (``make_key(0)`` when None).  ``max_steps`` bounds the
        decode steps of this call: the loop then returns the results so far
        with its state kept on ``self._state`` (the simulated kill of the
        failover tests)."""
        if not self.queue:
            return {}
        eng = self.engine
        B = eng.batch
        self.events = []
        self.stats = dict(_FRESH_STATS)
        self.statuses = {}
        eng.reset_all()
        eng.fault_step = 0
        st = _RunState(gen=gen if gen is not None else GenerationConfig(),
                       cap_budget=gen is not None,
                       key=tuple(key) if key is not None else make_key(),
                       slots=[None] * B, tok=np.zeros(B, np.int32),
                       pos=np.zeros(B, np.int64), active=np.zeros(B, bool),
                       level=np.zeros(B, np.int32))
        self._state = st
        return self._drive(st, on_complete, max_steps)

    def _budget(self, st: _RunState, r: Request) -> int:
        return (min(r.max_new, st.gen.max_new_tokens) if st.cap_budget
                else r.max_new)

    def _finish(self, st: _RunState, r: Request, s: int, on_complete,
                status: str = "ok"):
        """Complete ``r`` with its tokens so far; also the path of requests
        that never (re)entered a slot (zero budget, expired in the queue,
        rejected)."""
        r.done = True
        r.status = status
        st.results[r.rid] = np.asarray(r.out, np.int32)
        self.statuses[r.rid] = status
        self.events.append(("done" if status == "ok" else status, r.rid, s,
                            st.step))
        if status == "timeout":
            self.stats["timeouts"] += 1
        if on_complete is not None:
            on_complete(r.rid, st.results[r.rid])

    def _retire(self, st: _RunState, s: int, on_complete,
                status: str = "ok"):
        self._finish(st, st.slots[s].req, s, on_complete, status)
        st.slots[s] = None
        st.active[s] = False

    def _expire_slots(self, st: _RunState, on_complete):
        """Retire every active slot whose deadline has passed, with its
        partial tokens and status "timeout".  Neighbours are untouched:
        retire only flips this slot's host-side flag, and the next
        admission overwrites the slot's cache."""
        now = self.clock()
        for s in range(self.engine.batch):
            if st.slots[s] is not None and self._expired(st.slots[s].req, now):
                self._retire(st, s, on_complete, status="timeout")

    def _drain_guard_events(self, st: _RunState, on_complete,
                            prefill_slot: int | None = None):
        """Re-enqueue every slot an UNRECOVERED guard violation landed on
        (the op-level ladder already absorbed recovered ones): the request
        restarts from scratch one precision level higher, at the queue
        front; after ``guard_retry`` attempts it retires "failed".
        ``prefill_slot`` attributes batch-1 prefill events to that slot."""
        from repro_torch.numerics import api as _napi
        hit: set[int] = set()
        for ev in _napi.drain_guard_events():
            if not ev.get("unrecovered"):
                continue
            if prefill_slot is not None:
                hit.add(prefill_slot)
            else:
                rows = ev.get("rows") or []
                hit.update(s for s, f in enumerate(rows[:self.engine.batch])
                           if f)
        for s in sorted(hit):
            if st.slots[s] is None:
                continue
            r = st.slots[s].req
            if r.attempts >= self.guard_retry:
                self._retire(st, s, on_complete, status="failed")
                continue
            r.attempts += 1
            r.level = max(0, r.level - 1)
            r.out = []
            self.events.append(("guard_retry", r.rid, s, st.step))
            self.stats["guard_retries"] += 1
            st.slots[s] = None
            st.active[s] = False
            self.queue.insert(0, r)

    # -- paged-pool pressure handling -----------------------------------

    def _reclaim_retired(self, st: _RunState) -> bool:
        """Free the deferred pages of retired (empty) slots."""
        eng = self.engine
        freed = False
        for s in range(eng.batch):
            if st.slots[s] is None and eng.kv.n_pages(s):
                eng.kv.free_slot(s)
                freed = True
        return freed

    def _preempt_for(self, st: _RunState, grower: int) -> bool:
        """Evict the youngest-admitted active slot (≠ ``grower``); its
        request restarts from scratch at the queue front."""
        eng = self.engine
        victim, vseq = None, -1
        for s in range(eng.batch):
            if s != grower and st.slots[s] is not None \
                    and st.slots[s].seq > vseq:
                victim, vseq = s, st.slots[s].seq
        if victim is None:
            return False
        r = st.slots[victim].req
        r.out = []
        self.queue.insert(0, r)
        self.events.append(("preempt", r.rid, victim, st.step))
        self.stats["preempts"] += 1
        st.slots[victim] = None
        st.active[victim] = False
        eng.release_slot(victim)
        return True

    def _grow_pages(self, st: _RunState):
        """Grow every mapped slot to cover its next cache write: retired
        slots are released under pressure; active ones escalate reclaim ->
        preempt."""
        eng = self.engine
        for s in range(eng.batch):
            if not eng.kv.n_pages(s):
                continue
            if st.slots[s] is None:
                try:
                    eng.ensure_slot_pages(s, int(st.pos[s]))
                except PagePoolOOM:
                    eng.release_slot(s)
                continue
            while True:
                try:
                    eng.ensure_slot_pages(s, int(st.pos[s]))
                    break
                except PagePoolOOM:
                    if self._reclaim_retired(st):
                        continue
                    if not self._preempt_for(st, s):
                        raise

    def _admit(self, st: _RunState, s: int, on_complete) -> bool:
        """Pull the next request into slot ``s``; True if it ended active."""
        eng = self.engine
        while self.queue:
            r = self.queue.pop(0)
            if self._expired(r, self.clock()):  # dead on arrival at a slot
                self._finish(st, r, s, on_complete, "timeout")
                continue
            if self._budget(st, r) <= 0:  # zero-token request: complete empty
                self._finish(st, r, s, on_complete)
                continue
            if len(r.prompt) > eng.max_len:
                log.warning("rid=%d prompt len %d exceeds max_len %d; "
                            "rejected", r.rid, len(r.prompt), eng.max_len)
                self.stats["rejected"] += 1
                self._finish(st, r, s, on_complete, "rejected")
                continue
            if self.controller is not None and r.attempts == 0:
                # the SLO controller assigns the admission level; a
                # guard-retried request keeps its promoted level
                lvl = self.controller.admission_level(len(self.queue))
                if lvl > 0:
                    self.stats["demotions"] += 1
                r.level = lvl
            r.level = min(r.level, eng.n_levels - 1)
            packed = self._pack(r)
            st.key, sub = split_key(st.key)
            try:
                first = eng.prefill_slot(s, packed, st.gen, sub,
                                         level=r.level)
            except PagePoolOOM:
                self._reclaim_retired(st)
                try:
                    first = eng.prefill_slot(s, packed, st.gen, sub,
                                             level=r.level)
                except PagePoolOOM:
                    # backpressure: requeue and stop admitting until decode
                    # retires slots
                    self.queue.insert(0, r)
                    self.stats["kv_oom"] += 1
                    self.events.append(("kv_oom", r.rid, s, st.step))
                    return False
            kind = "refill" if st.step > 0 else "admit"
            self.events.append((kind, r.rid, s, st.step))
            if kind == "refill":
                self.stats["refills"] += 1
            st.slots[s] = _Slot(req=r, budget=self._budget(st, r),
                                seq=self._admit_seq)
            self._admit_seq += 1
            st.level[s] = r.level
            r.out.append(first)
            st.slots[s].budget -= 1
            st.tok[s] = first
            st.pos[s] = len(packed)
            st.active[s] = True
            if self.guard_retry:
                # a violation during THIS batch-1 prefill belongs to slot s
                self._drain_guard_events(st, on_complete, prefill_slot=s)
                if st.slots[s] is None:  # re-enqueued (or failed) already
                    continue
            hit_eos = st.gen.eos_id is not None and first == st.gen.eos_id
            if st.slots[s].budget <= 0 or hit_eos:
                self._retire(st, s, on_complete)  # done on the prefill token
                continue
            return True
        return False

    def _drive(self, st: _RunState, on_complete=None,
               max_steps: int | None = None):
        """Advance the loop from ``st`` until the queue drains (or
        ``max_steps`` decode steps); ``_on_step_boundary`` fires after each
        completed step, after retire and before the next admission wave."""
        eng = self.engine
        B = eng.batch
        maxpos = eng.max_len - 1
        steps_this_call = 0
        while True:
            for s in range(B):
                if st.slots[s] is None:
                    self._admit(st, s, on_complete)
            if not st.active.any():
                break
            if max_steps is not None and steps_this_call >= max_steps:
                break  # yield with resumable state (the simulated kill)
            if eng.kv is not None:
                self._grow_pages(st)
            if len(set(st.level[st.active].tolist())) > 1:
                self.stats["mixed_steps"] += 1
            t0 = self.clock()
            emitted, st.key = eng.step_slots(st.gen, st.tok, st.pos,
                                             st.active, st.key,
                                             level=st.level)
            if self.controller is not None:
                self.controller.record_step((self.clock() - t0) * 1000.0)
            st.step += 1
            steps_this_call += 1
            self.stats["steps"] += 1
            if self.guard_retry:
                # unrecovered violations tear the slot down BEFORE its
                # (corrupted) token reaches the request stream
                self._drain_guard_events(st, on_complete)
            for s in range(B):
                if st.slots[s] is None:
                    continue
                t = int(emitted[s])
                st.slots[s].req.out.append(t)
                st.slots[s].budget -= 1
                st.tok[s] = t
                st.pos[s] = min(st.pos[s] + 1, maxpos)
                hit_eos = st.gen.eos_id is not None and t == st.gen.eos_id
                if st.slots[s].budget <= 0 or hit_eos:
                    self._retire(st, s, on_complete)
            self._expire_slots(st, on_complete)
            self._on_step_boundary(st)
        return st.results

    def _on_step_boundary(self, st: _RunState):
        """Hook after every completed decode step (post-retire); the
        ``DurableBatcher`` snapshots here, the base scheduler does nothing."""
