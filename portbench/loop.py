"""The closed-loop driver and the benchmark's own spans.

``ClosedLoop`` drives the port's scheduler (``RequestBatcher.run``) with
C clients: each submits its next request from the ``on_complete`` of its
last.  The warm loop runs during set-up until every client has completed
one request; the window then opens and lasts ``seconds``; after it no
client submits, and what is in flight drains.

The benchmark reads token times where the program hands tokens to the
host: wrappers around the engine's ``prefill_slot`` (a request's first
token) and ``step_slots`` (one token for each active slot), one clock
read a call.  The scheduler's ``events`` name the request each prefill
admitted and each retired, so every token is a request's.  Spans of both
calls are kept in memory with the rows they processed."""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Req:
    rid: int
    client: int
    spec: object
    submit_t: float
    tokens: list = dataclasses.field(default_factory=list)   # host times
    served: np.ndarray | None = None
    status: str | None = None
    slot: int | None = None          # the slot that served it


@dataclasses.dataclass
class Span:
    kind: str           # "prefill" | "step"
    t0: float
    t1: float
    rows: int           # prompt tokens | active slots
    contexts: tuple = ()  # step: each active slot's cache position
    others: int = 0     # prefill: other slots active meanwhile
    real: int = 0       # prefill: the request's own prompt tokens


class ClosedLoop:
    def __init__(self, batcher, specs, clients: int, seconds: float,
                 hooks=None):
        """``specs``: the traffic's request iterator.  ``hooks``: an
        object with ``before(kind)`` and ``after(kind)`` called around
        every prefill and step (the traced run's profiler)."""
        self.b = batcher
        self.eng = batcher.engine
        self.specs = specs
        self.clients = clients
        self.seconds = seconds
        self.clock = time.perf_counter
        self.hooks = hooks
        self.reqs: dict[int, Req] = {}
        self.spans: list[Span] = []
        self.w0 = self.w1 = None
        self.first_done = set()
        self._ev = 0
        self._pending = []             # prefill return times, in order
        self.slot_rid: dict[int, int] = {}
        self._wrap()

    # -- the window ----------------------------------------------------

    def _submit(self, client: int):
        spec = next(self.specs)
        rid = self.b.submit(spec.prompt, max_new=spec.max_new)
        self.reqs[rid] = Req(rid, client, spec, self.clock())

    def _on_complete(self, rid, toks):
        self._sync()
        r = self.reqs[rid]
        r.served = np.asarray(toks, np.int32)
        r.status = self.b.statuses.get(rid, "ok")
        if self.w0 is None:
            self.first_done.add(r.client)
            if len(self.first_done) == self.clients:
                self.w0 = self.clock()
                self.w1 = self.w0 + self.seconds
                if self.hooks is not None:
                    self.hooks.window_open(self)
        if self.w0 is None or self.clock() < self.w1:
            self._submit(r.client)

    def run(self, gen):
        for c in range(self.clients):
            self._submit(c)
        self.b.run(gen, on_complete=self._on_complete)

    # -- spans and token times ------------------------------------------

    def _sync(self):
        """Read the scheduler's new events: admissions pair with the
        prefills that returned, in order; retirements free their slot."""
        ev = self.b.events
        for kind, rid, slot, _ in ev[self._ev:]:
            if kind in ("admit", "refill"):
                t1, i = self._pending.pop(0)
                self.reqs[rid].tokens = [t1]
                self.reqs[rid].slot = int(slot)
                self.spans[i].real = len(self.reqs[rid].spec.prompt)
                self.slot_rid[slot] = rid
            elif kind == "preempt":
                self.reqs[rid].tokens = []
                self.slot_rid.pop(slot, None)
            elif self.slot_rid.get(slot) == rid:
                self.slot_rid.pop(slot)
        self._ev = len(ev)

    def _wrap(self):
        prefill, step = self.eng.prefill_slot, self.eng.step_slots

        def prefill_slot(slot, prompt_tokens, gen, key, level=0):
            self._sync()
            others = sum(1 for s in self.slot_rid if s != slot)
            if self.hooks is not None:
                self.hooks.before("prefill")
            t0 = self.clock()
            tok = prefill(slot, prompt_tokens, gen, key, level=level)
            t1 = self.clock()
            if self.hooks is not None:
                self.hooks.after("prefill")
            self._pending.append((t1, len(self.spans)))
            self.spans.append(Span("prefill", t0, t1, len(prompt_tokens),
                                   others=others))
            return tok

        def step_slots(gen, tok, pos, active, key, level=None):
            self._sync()
            act = np.asarray(active, bool)
            ctx = tuple(int(p) for p, a in zip(pos, act) if a)
            if self.hooks is not None:
                self.hooks.before("step")
            t0 = self.clock()
            out = step(gen, tok, pos, active, key, level=level)
            t1 = self.clock()
            if self.hooks is not None:
                self.hooks.after("step")
            for s in np.flatnonzero(act):
                self.reqs[self.slot_rid[int(s)]].tokens.append(t1)
            self.spans.append(Span("step", t0, t1, int(act.sum()), ctx))
            return out

        self.eng.prefill_slot = prefill_slot
        self.eng.step_slots = step_slots



def endtoend(reqs, w0: float, seconds: float) -> dict:
    """The window's user-facing numbers from the requests' host times:
    tokens that reached the host in [w0, w0 + seconds] over the window's
    seconds; the median time from submit to first token over requests
    whose first token fell in the window; the 95th percentile of the gaps
    between consecutive tokens of one request that start and end in it."""
    w1 = w0 + seconds
    toks = [t for r in reqs for t in r.tokens if w0 <= t <= w1]
    ttft = [1e3 * (r.tokens[0] - r.submit_t) for r in reqs
            if r.tokens and w0 <= r.tokens[0] <= w1]
    itl = [1e3 * (b - a) for r in reqs
           for a, b in zip(r.tokens[:-1], r.tokens[1:])
           if w0 <= a and b <= w1]
    return {
        "output_tok_s": len(toks) / seconds,
        "ttft_p50_ms": float(np.percentile(ttft, 50)) if ttft else None,
        "itl_p95_ms": float(np.percentile(itl, 95)) if itl else None,
    }


def samples(reqs, w0: float, seconds: float) -> dict:
    """How many samples the window's tails stand on, and the gaps' upper
    quantiles (ms): the spread of ``itl_p95_ms`` is read from them."""
    w1 = w0 + seconds
    ttft = [r for r in reqs if r.tokens and w0 <= r.tokens[0] <= w1]
    itl = sorted(1e3 * (b - a) for r in reqs
                 for a, b in zip(r.tokens[:-1], r.tokens[1:])
                 if w0 <= a and b <= w1)
    q = {f"p{p}": round(float(np.percentile(itl, p)), 1)
         for p in (50, 90, 93, 95, 97, 99)} if itl else {}
    return {"ttft_n": len(ttft), "itl_n": len(itl), **q}

