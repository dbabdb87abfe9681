"""The benchmark of the PyTorch/CUDA port: one cell, one run.

  python3 portbench/run.py --workload yi6b-doc --seed 7 --seconds 45 --trace 0

Reads ``BENCHMARK.json`` at the checkout's root, finds the cell by name and
its configuration, traffic and workload files under ``portbench/`` by
theirs, serves the cell's traffic through the port's scheduler
(``repro_torch.serving``) on one card, and prints one JSON line last on
standard output: the end-to-end metrics (``--trace 0``) or the per-layer
metrics read by ``portbench/metrics/<name>.py`` (``--trace 1``), whether
the served tokens agree with the plain reference, and the device.  Each
number compared is printed beside its limit, last on standard error too.

Set-up (``setup_s``): the kernels' build or load from
``build/repro_torch_kernels/`` inside the checkout, the weights drawn from
the seed on the card, and the warm loop (every client completes one
request).  Exits non-zero, printing no result, without a CUDA card, or
when the process holds JAX or the JAX package after the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the package, not the script's folder: its module names are not
# top-level ones
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's manifest entries and files, found by name under the
    checkout ``root``."""
    path = os.path.join(root, "BENCHMARK.json")
    here = os.path.join(root, "portbench")
    if not os.path.exists(path):
        fail(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no cell {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    wpath = os.path.join(here, "workloads", f"{name}.json")
    workload = {}
    if os.path.exists(wpath):
        with open(wpath) as f:
            workload = json.load(f)
    return {"bench": bench, "cell": cell, "config": config,
            "workload": workload, "dir": here,
            "traffic": os.path.join(here, "traffic",
                                    f"{cell['traffic']}.json")}


def metric_readers(c: dict, kind: str) -> dict:
    """name -> the manifest entry (end-to-end) or (entry, read) of each
    metric of this kind that the cell reports; a per-layer metric's
    reader is ``metrics/<name>.py``."""
    out = {}
    for m in c["bench"][kind]:
        if "workloads" in m and c["cell"]["name"] not in m["workloads"]:
            continue
        path = os.path.join(c["dir"], "metrics", f"{m['name']}.py")
        if kind == "end_to_end":
            out[m["name"]] = m
            continue
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = (m, mod.read)
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def pack(prompt, serve: dict):
    """The prompt as the scheduler prefills it: right-aligned in its page
    multiple (paged) or its bucket (dense), zeros before it."""
    import numpy as np
    q = serve["page_size"] if serve.get("paged") else serve["bucket"]
    n = max(q, -(-len(prompt) // q) * q)
    out = np.zeros(n, np.int32)
    out[n - len(prompt):] = prompt
    return out


class Hooks:
    """Around every prefill and step: the launch counters at the window's
    two ends, and the traced run's profiler."""

    def __init__(self, launches, tracer):
        self.launches, self.tracer = launches, tracer
        self.clock = time.perf_counter
        self.loop = None
        self.l0 = self.l1 = None
        self.t_close = None

    def window_open(self, loop):
        self.loop = loop
        self.l0 = dict(self.launches)
        if self.tracer is not None:
            self.tracer.window_open(loop)

    def before(self, kind):
        if (self.loop is not None and self.t_close is None
                and self.clock() >= self.loop.w1):
            self.l1 = dict(self.launches)
            self.t_close = self.clock()
        if self.tracer is not None:
            self.tracer.before(kind)

    def after(self, kind):
        if self.tracer is not None:
            self.tracer.after(kind)


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", program=None,
             width: int | None = None) -> dict:
    """Serve the cell once and judge it.  ``program``: the port's modules
    (tests pass their own); ``device``: "cuda" (a CPU run serves the
    kernels' plain versions: the tests' rehearsal); ``width``: serve at
    this posit width instead of the configuration's (the control), judged
    against the configuration's reference all the same."""
    import numpy as np
    import torch

    from portbench import check, trace as TR
    from portbench.loop import ClosedLoop, endtoend, samples
    from portbench.shapes import Shapes
    from portbench.traffic import Traffic
    from portbench.weights import make_params

    P = program or import_program()
    config, workload = c["config"], c["workload"]
    serve = dict(config["serve"], **workload.get("serve", {}))
    shapes = Shapes.of(config["model"])
    traffic = Traffic.load(c["traffic"])
    if device == "cuda":
        built = P.build_all()
        log(f"kernels built {built or 'none: loaded'} at "
            f"{time.perf_counter() - T_START:.2f} s")
        P.pin_exact_f32()
    cfg = P.ModelConfig(**config["model"])
    nctx = P.numerics(serve if width is None else dict(serve, width=width))
    params = make_params(shapes, seed, device)
    log(f"weights drawn at {time.perf_counter() - T_START:.2f} s")
    model = P.Model(cfg, remat=False, numerics=nctx, device=device)
    paged = (P.PagedKVConfig(page_size=serve["page_size"])
             if serve.get("paged") else None)
    eng = P.ServeEngine(model, params, P.Ctx(numerics=nctx),
                        max_len=serve["max_len"], batch=traffic.clients,
                        cache_dtype=serve.get("cache_dtype"), paged=paged)
    buckets = (() if paged else
               tuple(range(serve["bucket"], serve["max_len"],
                           serve["bucket"])))
    batcher = P.RequestBatcher(eng, prompt_buckets=buckets)
    tcfg = workload.get("trace", {})
    tracer = (TR.Tracer(tcfg.get("lead_s", 4.0), tcfg.get("slice_s", 8.0),
                        device) if trace else None)
    hooks = Hooks(P.launches(), tracer)
    loop = ClosedLoop(batcher, traffic.requests(seed, shapes.vocab),
                      traffic.clients, seconds, hooks=hooks)
    with torch.no_grad():
        loop.run(P.GenerationConfig(max_new_tokens=traffic.max_output))
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    if loop.w0 is None:
        fail("the warm loop never completed a request from every client", 5)
    t_close = hooks.t_close or loop.w1
    pre = [s for s in loop.spans if s.kind == "prefill" and s.t0 >= loop.w0
           and s.t1 <= loop.w1]
    stp = [s for s in loop.spans if s.kind == "step" and s.t0 >= loop.w0
           and s.t1 <= loop.w1]
    log(f"window {loop.w0 - T_START:.2f}-{loop.w1 - T_START:.2f} s: "
        f"{len(pre)} prefills (mean "
        f"{sum(s.t1 - s.t0 for s in pre) / max(len(pre), 1):.3f} s, "
        f"{sum(s.real for s in pre)} tokens), {len(stp)} steps (mean "
        f"{sum(s.t1 - s.t0 for s in stp) / max(len(stp), 1):.3f} s); "
        f"drained at {time.perf_counter() - T_START:.2f} s; peak "
        f"{peak / 2 ** 30:.3f} GiB")
    # ---- end-to-end metrics, over the window --------------------------
    w0, w1 = loop.w0, loop.w1
    reqs = list(loop.reqs.values())
    e2e = dict(endtoend(reqs, w0, seconds), peak_mem_gib=peak / 2 ** 30,
               setup_s=w0 - T_START)
    log("window samples: " + json.dumps(samples(reqs, w0, seconds)))
    seen = [r for r in reqs if r.tokens and r.tokens[-1] >= w0
            and r.submit_t <= w1]
    attempted = len(seen)
    bad = [r for r in seen
           if r.status not in (None, "ok")
           or (r.served is not None and len(r.served) != r.spec.max_new)]
    unfinished = [r for r in seen if r.served is None]

    # ---- per-layer readings --------------------------------------------
    rec = None
    if trace:
        spans = [s for s in loop.spans if s.t0 >= w0 and s.t1 <= t_close]
        l0, l1 = hooks.l0, hooks.l1 or dict(P.launches())
        rec = {"seconds": seconds, "spans": spans, "shapes": shapes,
               "serve": serve,
               "launches": {k: l1[k] - l0[k] for k in l0},
               "trace": (TR.reduce(tracer, TR.load_groups(c["dir"]))
                         if tracer.p1 is not None else None),
               "traced_spans": (tracer.spans() if tracer.p1 is not None
                                else [])}

    # ---- the comparison, with the program's state freed ---------------
    done = [r for r in seen if r.served is not None and not (
        r.status not in (None, "ok") or len(r.served) != r.spec.max_new)]
    for r in done:
        r.packed = pack(r.spec.prompt, serve)
    ck = workload.get("check", {})
    picked = check.sample(done, seed, ck.get("min_tokens", 200),
                          ck.get("max_requests", 12))
    # the program's state goes before the reference runs (the hooks and
    # the profiler hold the loop, and through it the engine)
    del loop, batcher, eng, model, params, hooks, tracer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    g = (check.gaps(shapes, serve, seed, picked, device,
                    config["reference"]) if picked
         else {"mean": float("inf"), "widest": float("inf"),
               "first": float("inf"), "off_best": 1.0})
    ref_s = time.perf_counter() - t_ref
    log(f"reference over {len(picked)} requests of slots "
        f"{sorted({r.slot for r in picked})} "
        f"({sum(len(r.served) for r in picked)} tokens): {ref_s:.2f} s; "
        f"gaps: mean {g['mean']}, widest {g['widest']}, widest of first "
        f"tokens {g['first']}, share off the best {g['off_best']}")
    # the gap numbers the cell's limits name are the ones compared
    limits = ck.get("limits", {})
    checks = {name: {"value": g[key], "limit": limits[name]}
              for name, key in (("widest_gap", "widest"),
                                ("mean_gap", "mean")) if name in limits}
    if not checks:
        fail("the cell's workload file names no gap limit")
    held = all(v["value"] <= v["limit"] for v in checks.values())
    checks["short_or_failed"] = {"value": len(bad) + len(unfinished),
                                 "limit": 0}
    checks["compared_tokens"] = {
        "value": sum(len(r.served) for r in picked), "limit": 1}
    correct = (held and not bad and not unfinished
               and checks["compared_tokens"]["value"] >= 1)
    return {"e2e": e2e, "rec": rec, "correct": correct,
            "attempted": attempted, "failed": len(bad) + len(unfinished),
            "peak": peak, "checks": checks, "ref_s": ref_s,
            "n_compared": len(picked), "gaps": g}


def import_program():
    """The port's entry points the harness drives (from ``src/``)."""
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port is not here: no {src}/repro_torch")
    sys.path.insert(0, src)
    from repro_torch.core.engine import from_variant
    from repro_torch.kernels import _build
    from repro_torch.launch import pin_exact_f32
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model
    from repro_torch.numerics import NumericsContext, PrecisionPolicy
    from repro_torch.serving import (GenerationConfig, PagedKVConfig,
                                     RequestBatcher, ServeEngine)

    class Program:
        pass

    P = Program()
    P.build_all = _build.build_all
    P.pin_exact_f32 = pin_exact_f32
    P.ModelConfig, P.Ctx, P.Model = ModelConfig, Ctx, Model
    P.GenerationConfig, P.PagedKVConfig = GenerationConfig, PagedKVConfig
    P.RequestBatcher, P.ServeEngine = RequestBatcher, ServeEngine
    P.launches = lambda: _build.LAUNCHES
    P.numerics = lambda serve: NumericsContext(
        policy=PrecisionPolicy.uniform(from_variant(serve["width"],
                                                    serve["variant"])),
        backend=serve["backend"])
    return P


def per_layer(readers, rec) -> dict:
    out = {}
    for name, (m, read) in readers.items():
        v = read(rec)
        if v is not None:
            out[name] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = load_cell(args.workload)
    import torch
    chips = c["cell"].get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
             3)
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    out = run_cell(c, args.seed, args.seconds, bool(args.trace))
    held = sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
    if held:
        fail(f"the process holds {held} after the window", 4)
    card = card_line()
    metrics = {}
    if args.trace:
        readers = metric_readers(c, "per_layer")
        metrics = per_layer(readers, out["rec"])
    else:
        for name, m in metric_readers(c, "end_to_end").items():
            v = out["e2e"].get(name)
            if v is not None:
                metrics[name] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(out["correct"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device, "card": card,
              "reference_s": out["ref_s"],
              "compared_requests": out["n_compared"]}
    tr = (out["rec"] or {}).get("trace")
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"][:10]}
    result["checks"] = out["checks"]
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
