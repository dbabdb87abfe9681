"""Serve-side checkpoint-restart: durable continuous batching.

Counterpart of ``repro.serving.failover``.

* :class:`DurableBatcher` — a ``RequestBatcher`` that snapshots the complete
  scheduler state through ``distributed.checkpoint`` at step boundaries:
  the engine cache, the (seed, counter) sampling key and the per-slot
  tok/pos/active/level as the array tree, and the request/queue/slot/budget
  bookkeeping, the live fault plan, the fault-step counter and the guard
  counters as the JSON ``extra``.  The step boundary (after retire, before
  the next admission wave) is the loop's consistency point: ``_drive``
  re-entered from a restored ``_RunState`` replays the admission order, key
  splits and fault keys of the uninterrupted run, so every request's tokens
  come out bit-identical.  The per-slot arrays cover inactive slots too:
  the ``cuda`` route's power-of-2 pre-scale takes one scale over every row
  of a decode batch, pad rows included, so a resumed step fed other pad
  rows would round differently.

* :class:`ServeSupervisor` — wires ``HeartbeatMonitor`` + ``FailoverPolicy``
  around the drive loop.  The batcher heartbeats every decode step; a crash
  (any exception escaping the loop — tests raise :class:`SimulatedCrash`
  from the step hook) silences the heartbeat, the policy rules the host
  ELASTIC_DOWN, and the supervisor builds a fresh batcher over a fresh
  engine that ``resume()``s from the last complete snapshot.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable

import numpy as np

from repro_torch.distributed import checkpoint
from repro_torch.distributed.failover import (Action, FailoverPolicy,
                                              HeartbeatMonitor,
                                              StragglerDetector)
from repro_torch.reliability import guards
from repro_torch.reliability.faults import FaultPlan
from repro_torch.serving.engine import (GenerationConfig, Request,
                                        RequestBatcher, ServeEngine,
                                        _RunState, _Slot)

log = logging.getLogger("repro_torch.serving")


class SimulatedCrash(RuntimeError):
    """Raised from a step hook to model a process kill mid-drain (tests)."""


class DurableBatcher(RequestBatcher):
    """A ``RequestBatcher`` whose scheduler loop survives process death.

    ``snapshot_every``: snapshot cadence in decode steps.  ``on_step(step)``
    runs at every step boundary *before* the snapshot — the supervisor
    heartbeats there, and tests inject crashes there (so a crash step is
    never persisted, like a real kill).  ``snapshot_s``/``snapshot_bytes``
    record each snapshot's wall seconds and bytes written."""

    def __init__(self, engine: ServeEngine, prompt_buckets=(128, 512, 2048),
                 max_queue: int | None = None, *, ckpt_dir: str,
                 snapshot_every: int = 4, keep: int = 3,
                 on_step: Callable[[int], None] | None = None, **kw):
        super().__init__(engine, prompt_buckets, max_queue, **kw)
        self.ckpt_dir = ckpt_dir
        self.snapshot_every = max(1, snapshot_every)
        self.keep = keep
        self.on_step = on_step
        self.snapshot_s: list[float] = []
        self.snapshot_bytes: list[int] = []

    # -- snapshot ---------------------------------------------------------

    def _on_step_boundary(self, st: _RunState):
        if self.on_step is not None:
            self.on_step(st.step)
        if st.step % self.snapshot_every == 0:
            self.snapshot(st)

    def _array_tree(self, st: _RunState) -> dict:
        return {"cache": self.engine.cache,
                "key": np.asarray(st.key, np.int64),
                "tok": st.tok, "pos": st.pos, "active": st.active,
                "level": st.level}

    def snapshot(self, st: _RunState) -> str:
        """Persist the complete drain state; returns the checkpoint dir."""
        t0 = time.perf_counter()
        eng = self.engine
        seen: dict[int, Request] = {}
        for slot in st.slots:
            if slot is not None:
                seen[slot.req.rid] = slot.req
        for r in self.queue:
            seen[r.rid] = r
        extra = {
            "step": st.step,
            "gen": {"max_new_tokens": st.gen.max_new_tokens,
                    "temperature": st.gen.temperature,
                    "top_k": st.gen.top_k, "eos_id": st.gen.eos_id,
                    "pad_id": st.gen.pad_id},
            "cap_budget": st.cap_budget,
            "slots": [None if s is None else
                      {"rid": s.req.rid, "budget": s.budget, "seq": s.seq}
                      for s in st.slots],
            "admit_seq": self._admit_seq,
            # paged engines: the pool bytes ride in the array tree (they ARE
            # eng.cache); this records the page tables that address them
            "paged": None if eng.kv is None else eng.kv.snapshot(),
            "requests": [{"rid": r.rid, "prompt": [int(t) for t in r.prompt],
                          "max_new": r.max_new, "out": [int(t) for t in r.out],
                          "done": r.done, "deadline_ms": r.deadline_ms,
                          "submit_t": r.submit_t, "level": r.level,
                          "attempts": r.attempts, "status": r.status}
                         for r in seen.values()],
            "queue": [r.rid for r in self.queue],
            "next_rid": self._next_rid,
            "results": {str(k): [int(t) for t in v]
                        for k, v in st.results.items()},
            "events": [list(e) for e in self.events],
            "stats": dict(self.stats),
            "statuses": {str(k): v for k, v in self.statuses.items()},
            "fault": None if eng.fault is None else eng.fault.to_dict(),
            "fault_step": eng.fault_step,
            "guards": guards.snapshot(),
        }
        path = checkpoint.save(self.ckpt_dir, st.step, self._array_tree(st),
                               keep=self.keep, extra=extra)
        self.snapshot_s.append(time.perf_counter() - t0)
        self.snapshot_bytes.append(_dir_bytes(path))
        return path

    # -- restore ----------------------------------------------------------

    def resume(self, *, step: int | None = None, on_complete=None,
               max_steps: int | None = None):
        """Restore the last (or given) snapshot and drain to completion.

        Call on a freshly built batcher over a fresh engine (the restarted
        process); its queue and engine state are overwritten by the
        snapshot.  Returns the full {rid: tokens} results, including
        requests that completed before the snapshot."""
        eng = self.engine
        B = eng.batch
        # layout check BEFORE the array restore: a dense/paged mismatch must
        # surface as this error, not as a leaf mismatch deep in restore
        extra_peek, step = checkpoint.read_extra(self.ckpt_dir, step)
        snap_paged = extra_peek.get("paged")
        if (snap_paged is None) != (eng.kv is None):
            raise RuntimeError(
                "snapshot/engine cache layout mismatch: "
                f"snapshot is {'paged' if snap_paged else 'dense'}, engine "
                f"is {'paged' if eng.kv is not None else 'dense'}")
        target = {"cache": eng.cache, "key": np.zeros(2, np.int64),
                  "tok": np.zeros(B, np.int32), "pos": np.zeros(B, np.int64),
                  "active": np.zeros(B, bool),
                  "level": np.zeros(B, np.int32)}
        tree, ck_step, extra = checkpoint.restore(self.ckpt_dir, target,
                                                  step=step)
        eng.cache = tree["cache"]
        if eng.kv is not None:
            eng.kv.load(snap_paged)
        self._admit_seq = extra.get("admit_seq", 0)
        eng.fault = (None if extra["fault"] is None
                     else FaultPlan.from_dict(extra["fault"]))
        eng.fault_step = extra["fault_step"]
        guards.load(extra.get("guards"))
        reqs = {rec["rid"]: Request(rec["rid"],
                                    np.asarray(rec["prompt"], np.int32),
                                    rec["max_new"], out=list(rec["out"]),
                                    done=rec["done"],
                                    deadline_ms=rec.get("deadline_ms"),
                                    submit_t=rec.get("submit_t", 0.0),
                                    level=rec.get("level", 0),
                                    attempts=rec.get("attempts", 0),
                                    status=rec.get("status", "ok"))
                for rec in extra["requests"]}
        self.queue = [reqs[rid] for rid in extra["queue"]]
        self._next_rid = extra["next_rid"]
        self.events = [tuple(e) for e in extra["events"]]
        self.stats = dict(extra["stats"])
        self.statuses = {int(k): v
                         for k, v in extra.get("statuses", {}).items()}
        st = _RunState(
            gen=GenerationConfig(**extra["gen"]),
            cap_budget=extra["cap_budget"],
            key=tuple(int(k) for k in tree["key"]),
            slots=[None if rec is None
                   else _Slot(req=reqs[rec["rid"]], budget=rec["budget"],
                              seq=rec.get("seq", 0))
                   for rec in extra["slots"]],
            tok=np.array(tree["tok"], np.int32),
            pos=np.array(tree["pos"], np.int64),
            active=np.array(tree["active"], bool),
            level=np.array(tree["level"], np.int32),
            step=extra["step"],
            results={int(k): np.asarray(v, np.int32)
                     for k, v in extra["results"].items()})
        self._state = st
        log.info("resumed serve drain from step %d (%d in flight, %d queued)",
                 ck_step, sum(s is not None for s in st.slots),
                 len(self.queue))
        return self._drive(st, on_complete=on_complete, max_steps=max_steps)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


class ServeSupervisor:
    """Checkpoint-restore supervision of a serve drain, one host.

    ``make_batcher()`` builds a fresh :class:`DurableBatcher` over a fresh
    engine — the "restarted process".  The supervisor heartbeats the monitor
    from the batcher's step hook; when the drive loop dies, the crashed
    process goes silent (its ``last_beat`` is rolled past ``dead_after_s``:
    a dead process cannot beat, the rollback skips the wall-clock wait),
    ``FailoverPolicy`` rules ELASTIC_DOWN for the dead host, and the
    supervisor restarts: fresh batcher, ``resume()`` from the last snapshot.
    ``min_hosts=0`` because serving keeps zero quorum — a lone host restarts
    rather than aborting the job."""

    def __init__(self, make_batcher: Callable[[], DurableBatcher], *,
                 host: str = "serve/0", dead_after_s: float = 60.0,
                 max_restarts: int = 3, clock=None):
        self.make_batcher = make_batcher
        self.host = host
        self.max_restarts = max_restarts
        self.monitor = HeartbeatMonitor(
            [host], dead_after_s=dead_after_s,
            clock=clock if clock is not None else time.monotonic)
        self.policy = FailoverPolicy(min_hosts=0)
        self.detector = StragglerDetector()
        self.restarts = 0
        self.decisions: list = []

    def _attach(self, batcher: DurableBatcher):
        prev = batcher.on_step

        def hook(step: int):
            self.monitor.beat(self.host, step)
            if prev is not None:
                prev(step)
        batcher.on_step = hook
        return batcher

    def run(self, submit: Callable[[DurableBatcher], Any],
            gen: GenerationConfig | None = None, *, key=None,
            on_complete=None) -> dict:
        """Drive a workload to completion across crashes.

        ``submit(batcher)`` enqueues the requests on the initial process;
        restarted processes inherit the queue from the snapshot instead."""
        batcher = self._attach(self.make_batcher())
        submit(batcher)
        last_step = 0
        first = True
        while True:
            try:
                if first:
                    return batcher.run(gen, on_complete=on_complete, key=key)
                return batcher.resume(on_complete=on_complete)
            except Exception as e:
                st = self.monitor.hosts[self.host]
                last_step = max(last_step, st.last_step)
                st.last_beat = (self.monitor.clock()
                                - self.monitor.dead_after_s - 1.0)
                decision = self.policy.decide(self.monitor, self.detector,
                                              last_step)
                self.decisions.append(decision)
                if (decision.action not in (Action.ELASTIC_DOWN,
                                            Action.RESTART)
                        or self.restarts >= self.max_restarts):
                    raise
                self.restarts += 1
                log.warning("serve drain died at step ~%d (%s); restart "
                            "%d/%d from last snapshot", last_step, e,
                            self.restarts, self.max_restarts)
                batcher = self._attach(self.make_batcher())
                self.monitor.beat(self.host, 0)  # new process is alive
                first = False
