"""The traced run's profiler and its reduction.

``Tracer`` starts ``torch.profiler`` (CUDA activity: the device's kernels,
copies and sets) at the first call boundary ``lead_s`` into the window and
stops it at the first call boundary ``slice_s`` later, after that call has
synchronised: the profiled slice holds whole prefills and steps, whose
spans and rows the loop kept.

The reduction is a copy of chip_smoke's ``profile_drain`` arithmetic
(kernel time by name, the port's kernels split out from torch's), with the
device's busy time taken as the union of the kernels' intervals, and idle
gaps labelled by the host call they fell in."""
from __future__ import annotations

import json
import os
import re
import time

_BASE = re.compile(r"^(?:void\s+)?([^<(]*)")


def base_name(kernel: str) -> str:
    """A kernel's name without ``void``, template arguments, parameters
    and namespaces."""
    k = kernel.strip().replace("(anonymous namespace)::", "")
    return _BASE.match(k).group(1).split("::")[-1].strip()


def load_groups(root) -> dict[str, set]:
    """Every ``kernels/*.json`` file's groups of base names, merged."""
    groups: dict[str, set] = {}
    d = os.path.join(root, "kernels")
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                for k, v in json.load(f).items():
                    if isinstance(v, list):
                        groups.setdefault(k, set()).update(v)
    return groups


class Tracer:
    def __init__(self, lead_s: float, slice_s: float, device: str = "cuda"):
        """``device``: "cuda", or "cpu" for the CPU rehearsal (host ops
        only: no device numbers)."""
        self.lead_s, self.slice_s = lead_s, slice_s
        self.clock = time.perf_counter
        self.cuda = device == "cuda"
        self.loop = None
        self.prof = None
        self.state = "wait"
        self.p0 = self.p1 = None
        self.i0 = self.i1 = None

    def window_open(self, loop):
        self.loop = loop

    def before(self, kind):
        if (self.state == "wait" and self.loop is not None
                and self.clock() >= self.loop.w0 + self.lead_s):
            from torch.profiler import ProfilerActivity, profile
            self._sync()
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
            self.prof.start()
            self.state = "on"
            self.i0 = len(self.loop.spans)
            self.p0 = self.clock()

    def after(self, kind):
        if self.state == "on" and self.clock() >= self.p0 + self.slice_s:
            self._sync()
            self.p1 = self.clock()
            self.prof.stop()
            self.state = "done"
            self.i1 = len(self.loop.spans) + 1   # this call's span included

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def spans(self):
        return self.loop.spans[self.i0:self.i1]


def _kernel_events(prof):
    """(name, start_s, dur_s) of every device event, by start."""
    from torch.autograd import DeviceType
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                out.append((e.name(), e.start_ns() * 1e-9,
                            e.duration_ns() * 1e-9))
            else:
                out.append((e.name(), e.start_us() * 1e-6,
                            e.duration_us() * 1e-6))
    except AttributeError:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                tr = e.time_range
                out.append((e.name, tr.start * 1e-6,
                            (tr.end - tr.start) * 1e-6))
    out.sort(key=lambda r: r[1])
    return out


def reduce(tracer: Tracer, groups: dict[str, set]) -> dict:
    """The profiled slice's numbers (``reduce_events``)."""
    return reduce_events(_kernel_events(tracer.prof), tracer.spans(),
                         tracer.p0, tracer.p1, groups)


def reduce_events(evs, spans, p0: float, p1: float,
                  groups: dict[str, set]) -> dict:
    """The slice's device numbers from its device events ``evs`` ((name,
    start_s, dur_s), by start) and the host spans of its calls: busy and
    window seconds, kernel time by group (and ``fallback``: names in no
    group), the ten longest device ops and the idle time by the host call
    it fell in."""
    window_s = p1 - p0
    by_name: dict[str, float] = {}
    for name, _, dur in evs:
        by_name[name] = by_name.get(name, 0.0) + dur
    kernel_s = sum(by_name.values())
    by_group = {g: 0.0 for g in groups}
    by_group["fallback"] = 0.0
    for name, dur in by_name.items():
        b = base_name(name)
        hit = [g for g, names in groups.items() if b in names]
        by_group[hit[0] if hit else "fallback"] += dur
    # busy: the union of the events' intervals
    merged = []
    for _, st, dur in evs:
        en = st + dur
        if merged and st <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], en)
        else:
            merged.append([st, en])
    busy_s = sum(en - st for st, en in merged)
    # the device clock against the host's: the first kernel starts just
    # after the first profiled call began (the device was idle then)
    idle = {}
    if merged and spans:
        off = merged[0][0] - spans[0].t0
        edges = ([(p0 + off, p0 + off)] + merged
                 + [(p1 + off, p1 + off)])
        j = 0
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2 - off
            while j < len(spans) and spans[j].t1 < mid:
                j += 1
            label = "scheduler"
            if j < len(spans) and spans[j].t0 <= mid:
                label = ("prefill_slot" if spans[j].kind == "prefill"
                         else "step_slots")
            idle[label] = idle.get(label, 0.0) + (b - a)
    by_base: dict[str, float] = {}
    for name, dur in by_name.items():
        by_base[base_name(name)] = by_base.get(base_name(name), 0.0) + dur
    top = sorted(by_base.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s, "kernel_s": kernel_s,
            "by_group": by_group, "n_events": len(evs),
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])}
