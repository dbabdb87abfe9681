"""Slot-based continuous-batching serving.

Counterpart of ``repro.serving.engine`` for greedy serving without
deadlines, precision ladders, guard retries or fault plans.

* ``ServeEngine`` owns the model's KV cache and exposes the slot
  primitives: ``prefill_slot`` (batch-1 prefill fully overwriting a slot),
  ``step_slots`` (one masked decode step over every slot, each at its own
  position) and the cache lifecycle (``reset_all``/``release_slot``).  The
  reference's on-device ``lax.scan`` over decode steps is a host loop here.
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
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.layers import Ctx
from repro_torch.numerics import NumericsContext
from repro_torch.serving.kvcache import PagePoolOOM, PagedKVCache, PagedKVConfig

log = logging.getLogger("repro_torch.serving")


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    eos_id: int | None = None         # stop a row once it emits this token
    pad_id: int = 0                   # what finished rows emit afterwards


class ServeEngine:
    def __init__(self, model, params, ctx: Ctx | None = None, *,
                 max_len: int = 2048, batch: int = 8, cache_dtype=None,
                 numerics: NumericsContext | None = None,
                 paged: PagedKVConfig | None = None):
        """``numerics`` (policy + backend) overrides whatever the ctx
        carries.  ``paged`` switches the KV cache to the page-pool layout;
        decode then runs through the ``decode_attention`` numerics op (the
        fused flash-decode kernel on the ``cuda`` backend for integer
        pages)."""
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

    # -- cache lifecycle ------------------------------------------------

    def reset_all(self):
        """Invalidate every slot (used at the top of every drain)."""
        if self.kv is not None:
            self.kv.reset()
        self.model.reset_cache(self.cache)

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

    def _step(self, gen, tok, pos, done, page_table=None, write_mask=None):
        """One masked decode step (the reference's scan body)."""
        logits, _ = self.model.decode_step(
            self.params, tok, pos, self.cache, self.ctx,
            page_table=page_table, write_mask=write_mask)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        pad = torch.tensor(gen.pad_id, dtype=torch.int32, device=self.device)
        nxt = torch.where(done, pad, nxt)
        pos = torch.where(done, pos,
                          torch.clamp(pos + 1, max=self.max_len - 1))
        if gen.eos_id is not None:
            done = done | (nxt == gen.eos_id)
        return nxt, pos, done

    # -- slot-level primitives (used by the scheduler) -------------------

    def prefill_slot(self, slot: int, prompt_tokens) -> int:
        """Prefill one request into ``slot`` and return its first token.

        Runs a batch-1 prefill on a zero cache and writes it over the
        slot's whole row (dense) or scatters it into freshly allocated
        pool pages (paged; the length must be a page multiple).  Raises
        :class:`PagePoolOOM` (slot unmapped, pool clean) when the pool
        cannot hold the request plus one growth page."""
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
            logits, c1 = self.model.prefill(self.params, toks, self.ctx, tmpl)
            idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
            for name, pool in self.cache.items():
                slab = c1[name][:, 0]                 # [L, Tpad, KV, hd]
                pool[:, idx] = slab.reshape(
                    (slab.shape[0], len(pages), ps) + tuple(slab.shape[2:])
                ).to(pool.dtype)
            return int(torch.argmax(logits[0]))
        self.model.reset_cache(self._cache1)
        logits, c1 = self.model.prefill(self.params, toks, self.ctx,
                                        self._cache1)
        for name, a in self.cache.items():
            a[:, slot] = c1[name][:, 0].to(a.dtype)
        return int(torch.argmax(logits[0]))

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

    def step_slots(self, gen: GenerationConfig, tok, pos, active):
        """One masked decode step over all slots.  ``tok``/``pos``/``active``
        are [B] host arrays; inactive slots are fed as done (emit pad,
        frozen position).  Returns the emitted [B] tokens (numpy)."""
        dev = self.device
        act = np.asarray(active, bool)
        tok_t = torch.as_tensor(np.asarray(tok, np.int32), device=dev)
        pos_t = torch.as_tensor(np.asarray(pos, np.int32), device=dev)
        done = torch.as_tensor(~act, device=dev)
        kw = {}
        if self.kv is not None:
            # every row writes (mask all-True): done rows land their
            # pad-token k/v at their frozen position, like dense does
            table = self.kv.table_device(dev)[:, :self._table_cap()]
            kw = {"page_table": table.contiguous(),
                  "write_mask": torch.ones(act.shape, dtype=torch.bool,
                                           device=dev)}
        nxt, _, _ = self._step(gen, tok_t, pos_t, done, **kw)
        return nxt.cpu().numpy()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "ok"                # ok | rejected


@dataclasses.dataclass
class _Slot:
    req: Request
    budget: int          # tokens still allowed (per-request max_new cap)
    seq: int = 0         # admission order — preemption evicts the youngest


@dataclasses.dataclass
class _RunState:
    gen: GenerationConfig
    cap_budget: bool          # True: gen.max_new_tokens caps request budgets
    slots: list               # [B] of _Slot | None
    tok: np.ndarray           # [B] last emitted token per slot
    pos: np.ndarray           # [B] next cache write position per slot
    active: np.ndarray        # [B] bool
    step: int = 0
    results: dict = dataclasses.field(default_factory=dict)


_FRESH_STATS = {"steps": 0, "refills": 0, "truncated": 0, "rejected": 0,
                "kv_oom": 0, "preempts": 0}


class RequestBatcher:
    """Host-side continuous-batching scheduler over ``ServeEngine`` slots.

    ``submit`` enqueues; ``run`` drains the queue: free slots are admitted
    (batch-1 prefill), then the batch decodes one masked step at a time and
    any slot that finishes is retired and refilled mid-stream.  Each
    request keeps its own bucket and position, so its tokens equal a
    single-request run's."""

    def __init__(self, engine: ServeEngine, prompt_buckets=(128, 512, 2048)):
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
        self.queue: list[Request] = []
        self._next_rid = 0
        self._admit_seq = 0
        # ("admit"|"refill"|"done"|"rejected"|"preempt"|"kv_oom", rid, slot, step)
        self.events: list[tuple] = []
        self.stats = dict(_FRESH_STATS)
        self.statuses: dict[int, str] = {}

    def submit(self, prompt, max_new: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32), max_new))
        return rid

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
            on_complete: Callable[[int, np.ndarray], None] | None = None):
        """Drain the queue; returns {rid: tokens}.  Per-request budgets are
        ``min(request.max_new, gen.max_new_tokens)``."""
        if not self.queue:
            return {}
        eng = self.engine
        B = eng.batch
        self.events = []
        self.stats = dict(_FRESH_STATS)
        self.statuses = {}
        eng.reset_all()
        st = _RunState(gen=gen if gen is not None else GenerationConfig(),
                       cap_budget=gen is not None, slots=[None] * B,
                       tok=np.zeros(B, np.int32), pos=np.zeros(B, np.int64),
                       active=np.zeros(B, bool))
        return self._drive(st, on_complete)

    def _budget(self, st: _RunState, r: Request) -> int:
        return (min(r.max_new, st.gen.max_new_tokens) if st.cap_budget
                else r.max_new)

    def _finish(self, st: _RunState, r: Request, s: int, on_complete,
                status: str = "ok"):
        r.done = True
        r.status = status
        st.results[r.rid] = np.asarray(r.out, np.int32)
        self.statuses[r.rid] = status
        self.events.append(("done" if status == "ok" else status, r.rid, s,
                            st.step))
        if on_complete is not None:
            on_complete(r.rid, st.results[r.rid])

    def _retire(self, st: _RunState, s: int, on_complete):
        self._finish(st, st.slots[s].req, s, on_complete)
        st.slots[s] = None
        st.active[s] = False

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
            if self._budget(st, r) <= 0:  # zero-token request: complete empty
                self._finish(st, r, s, on_complete)
                continue
            if len(r.prompt) > eng.max_len:
                log.warning("rid=%d prompt len %d exceeds max_len %d; "
                            "rejected", r.rid, len(r.prompt), eng.max_len)
                self.stats["rejected"] += 1
                self._finish(st, r, s, on_complete, "rejected")
                continue
            packed = self._pack(r)
            try:
                first = eng.prefill_slot(s, packed)
            except PagePoolOOM:
                self._reclaim_retired(st)
                try:
                    first = eng.prefill_slot(s, packed)
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
            r.out.append(first)
            st.slots[s].budget -= 1
            st.tok[s] = first
            st.pos[s] = len(packed)
            st.active[s] = True
            hit_eos = st.gen.eos_id is not None and first == st.gen.eos_id
            if st.slots[s].budget <= 0 or hit_eos:
                self._retire(st, s, on_complete)  # done on the prefill token
                continue
            return True
        return False

    def _drive(self, st: _RunState, on_complete=None):
        eng = self.engine
        B = eng.batch
        maxpos = eng.max_len - 1
        while True:
            for s in range(B):
                if st.slots[s] is None:
                    self._admit(st, s, on_complete)
            if not st.active.any():
                break
            if eng.kv is not None:
                self._grow_pages(st)
            emitted = eng.step_slots(st.gen, st.tok, st.pos, st.active)
            st.step += 1
            self.stats["steps"] += 1
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
        return st.results
