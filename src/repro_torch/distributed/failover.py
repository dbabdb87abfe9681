"""Failure handling: heartbeats, stragglers, restart policy, elastic
rescale.

A copy of ``repro.distributed.failover`` (plain Python, no JAX), so the
port's serving supervisor (``serving.failover.ServeSupervisor``) rules on
the same policy as the reference's.

An in-step device failure cannot be survived (the collective hangs), so
fault tolerance is *checkpoint-restart* shaped: a lightweight monitor
detects dead/slow hosts and orchestrates a restart from the last complete
checkpoint, possibly on fewer hosts (elastic).  This module is the policy
brain, fully unit-testable with a fake clock.

Components:
  * HeartbeatMonitor — per-host ``beat(host, step)`` bookkeeping; a host is
    DEAD after ``dead_after_s`` of silence.
  * StragglerDetector — EWMA of per-step wall time; a host is a STRAGGLER
    when its step time exceeds ``k_mad`` median-absolute-deviations over the
    fleet median for ``patience`` consecutive steps.
  * FailoverPolicy — turns monitor state into actions:
      CONTINUE | CHECKPOINT_NOW | RESTART (same fleet, from ckpt)
      | ELASTIC_DOWN (drop hosts, reshard from ckpt) | ABORT
  * plan_elastic_mesh — valid (data, model) mesh for a reduced chip count.
"""
from __future__ import annotations

import dataclasses
import enum
import statistics
import time
from typing import Callable


class Action(enum.Enum):
    CONTINUE = "continue"
    CHECKPOINT_NOW = "checkpoint_now"
    RESTART = "restart"
    ELASTIC_DOWN = "elastic_down"
    ABORT = "abort"


@dataclasses.dataclass
class HostState:
    last_beat: float
    last_step: int = 0
    step_ewma: float | None = None
    step_start: float = 0.0   # clock at the last step advance (EWMA anchor)
    slow_streak: int = 0
    dead: bool = False


class HeartbeatMonitor:
    def __init__(self, hosts: list[str], dead_after_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.dead_after_s = dead_after_s
        now = clock()
        self.hosts = {h: HostState(last_beat=now, step_start=now)
                      for h in hosts}

    def beat(self, host: str, step: int):
        """Record liveness; update the per-step EWMA only on step advance.

        Step time is measured from ``step_start`` (the previous advance), not
        from the previous heartbeat — liveness-only beats (same step) must
        neither reset the timer (which would under-count the eventual step
        and could starve the EWMA seed forever) nor feed inter-heartbeat
        gaps into the EWMA.  A step regression (restarted host) restarts the
        timer without polluting the history."""
        st = self.hosts[host]
        now = self.clock()
        if step > st.last_step:
            dt = (now - st.step_start) / (step - st.last_step)
            st.step_ewma = dt if st.step_ewma is None else (
                0.8 * st.step_ewma + 0.2 * dt)
            st.step_start = now
            st.last_step = step
        elif step < st.last_step:
            st.step_start = now
            st.last_step = step
        st.last_beat = now
        st.dead = False

    def dead_hosts(self) -> list[str]:
        now = self.clock()
        out = []
        for h, st in self.hosts.items():
            if now - st.last_beat > self.dead_after_s:
                st.dead = True
                out.append(h)
        return out

    def alive(self) -> list[str]:
        dead = set(self.dead_hosts())
        return [h for h in self.hosts if h not in dead]


class StragglerDetector:
    """Flag hosts whose step time is an outlier vs. the fleet."""

    def __init__(self, k_mad: float = 4.0, patience: int = 3,
                 min_hosts: int = 3):
        self.k_mad = k_mad
        self.patience = patience
        self.min_hosts = min_hosts

    def update(self, monitor: HeartbeatMonitor) -> list[str]:
        ewmas = {h: st.step_ewma for h, st in monitor.hosts.items()
                 if st.step_ewma is not None and not st.dead}
        if len(ewmas) < self.min_hosts:
            return []
        med = statistics.median(ewmas.values())
        mad = statistics.median(abs(v - med) for v in ewmas.values()) or 1e-9
        out = []
        for h, v in ewmas.items():
            st = monitor.hosts[h]
            if v > med + self.k_mad * mad and v > 1.2 * med:
                st.slow_streak += 1
                if st.slow_streak >= self.patience:
                    out.append(h)
            else:
                st.slow_streak = 0
        return out


@dataclasses.dataclass
class Decision:
    action: Action
    reason: str = ""
    drop_hosts: tuple = ()


class FailoverPolicy:
    """Decide what the supervising loop should do given monitor state.

    Rules (evaluated in order):
      1. any DEAD host and alive >= min_hosts  -> ELASTIC_DOWN (reshard)
      2. any DEAD host and alive <  min_hosts  -> ABORT
      3. straggler persisting                  -> CHECKPOINT_NOW first time,
                                                  ELASTIC_DOWN if it persists
                                                  past ``straggler_grace`` more
                                                  steps (slow host == failing
                                                  host eventually)
      4. otherwise                             -> CONTINUE
    """

    def __init__(self, min_hosts: int = 1, straggler_grace: int = 10):
        self.min_hosts = min_hosts
        self.straggler_grace = straggler_grace
        self._straggler_since: dict[str, int] = {}

    def decide(self, monitor: HeartbeatMonitor, detector: StragglerDetector,
               step: int) -> Decision:
        dead = monitor.dead_hosts()
        alive = monitor.alive()
        if dead:
            if len(alive) >= self.min_hosts:
                return Decision(Action.ELASTIC_DOWN,
                                f"dead hosts {dead}", tuple(dead))
            return Decision(Action.ABORT, f"only {len(alive)} hosts alive")
        stragglers = detector.update(monitor)
        for h in stragglers:
            since = self._straggler_since.setdefault(h, step)
            if step - since >= self.straggler_grace:
                return Decision(Action.ELASTIC_DOWN,
                                f"persistent straggler {h}", (h,))
        for h in list(self._straggler_since):
            if h not in stragglers:
                del self._straggler_since[h]
        if stragglers:
            return Decision(Action.CHECKPOINT_NOW,
                            f"stragglers {stragglers} — protecting progress")
        return Decision(Action.CONTINUE)


def plan_elastic_mesh(n_chips: int, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) mesh using <= n_chips with fixed TP degree.

    TP degree is architecture-determined (weights are sharded model-ways in
    the checkpoint-independent sense), so elasticity drops data-parallel
    replicas: data = floor(n_chips / model)."""
    if n_chips < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with only {n_chips} chips")
    return (n_chips // model_parallel, model_parallel)


def replay_plan(ckpt_step: int, failed_step: int, grad_accum: int = 1):
    """Deterministic data replay after restart: the seeded pipeline re-issues
    batches for steps (ckpt_step, failed_step]; nothing is lost because the
    pipeline is stateless given (seed, step)."""
    return {"resume_step": ckpt_step,
            "replay_steps": list(range(ckpt_step + 1, failed_step + 1)),
            "microbatches_per_step": grad_accum}
