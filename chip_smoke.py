"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py            # everything, on one CUDA card

Phases (each asserts; a failed phase exits non-zero and prints no result):

1. the card's name and power limit; build of the three CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path: posit encode (bit-exact, six formats with
   zero/NaR/clamp/subnormal inputs), logmac (M in {4, 32, 128} against the
   five gemma2-2b K x N shapes, per-element bound
   ``1e-5*(|va||vb| + |ra||rb|) + 1e-4``), paged flash-decode (max-abs
   <= 1e-3 against the plain version, < 0.05 against the gather
   reference);
3. serving gemma2-2b FULL (26 layers, d_model 2304, seeded random
   weights) through ``repro_torch.launch.serve`` with a paged uint16
   posit KV cache on the ``cuda`` backend: 8 requests, batch 4, max_len
   256, max_new 16; launch counts of all three kernels must be > 0; then
   the SMOKE model's logits on the kernels against the reference engine;
4. each kernel timed with CUDA events (L2 flushed before every launch)
   beside its plain version, with the least time the card could take.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): device memory 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

GEMMA_KN = [(2304, 2304), (2304, 1152), (2304, 9216), (9216, 2304),
            (2304, 256000)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events around
    each launch; ``flush`` runs before each, outside the timed window)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def profile_drain(eng, card: str) -> None:
    """Trace a short drain on the served engine: device time by kernel and
    the share of the wall window the device was busy."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import GenerationConfig, RequestBatcher

    rng = np.random.default_rng(1)
    b = RequestBatcher(eng)
    for _ in range(2):
        b.submit(rng.integers(0, eng.model.cfg.vocab, 12), max_new=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        b.run(GenerationConfig(max_new_tokens=4))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: the CPU-side aten rows repeat their
        # kernels' time
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {card}: drain of 2 requests x 4 tokens ({b.stats['steps']} "
        f"decode steps, 2 prefills): wall {wall_ms:.1f} ms (profiled), "
        f"kernel time {busy:.1f} ms ({100 * busy / wall_ms:.1f}% of the wall "
        f"window)")
    for ms, n, key in rows[:20]:
        log(f"[profile]   {ms:10.3f} ms  {n:6d}x  {key[:90]}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, trace one short drain (2 requests, "
                    "4 new tokens) with torch.profiler and print the device "
                    "time by kernel and the device's busy share")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    from repro_torch.core import posit as P
    from repro_torch.core.engine import _pow2_scale, from_variant
    from repro_torch.kernels import logmac as LM
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import posit_codec as PC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f}s "
        f"(per source: { {k: round(v, 1) for k, v in took.items()} }) "
        f"into {_build.build_dir()}")
    for name in _build.SOURCES:
        _build.load(name)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ecfg = from_variant(16, "L-21b")
    errs = {"posit_encode": 0.0, "logmac": 0.0, "paged_flash_decode": 0.0}

    # ---- phase 2: kernels against their plain versions ------------------
    specials = torch.tensor(
        [0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1e-40, -1e-40,
         3e38, -3e38, 1e-30, -1e-30, 1e30, 1.0, -1.0, 0.5, 2.0 ** -126],
        device=dev)
    x = torch.randn(2304 * 9216, generator=gen, device=dev)
    x = x * torch.exp2(torch.randint(-30, 30, x.shape, generator=gen,
                                     device=dev).to(torch.float32))
    x = torch.cat([x, specials]).contiguous()
    for pc in (P.POSIT8, P.BPOSIT8, P.POSIT16, P.BPOSIT16, P.POSIT32,
               P.BPOSIT32):
        got = PC.posit_encode(x, pc)
        want = PC.encode_plain(x, pc)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        assert bad == 0, f"encode {pc.name}: {bad} words differ"
        # largest difference of the words read as unsigned patterns
        diff = ((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)).abs()
        errs["posit_encode"] = max(errs["posit_encode"], float(diff.max()))
    log(f"[encode] bit-exact on 6 formats, {x.numel()} inputs incl. "
        f"zero/NaR/clamp/subnormal")

    def bits(shape, scale_pow=3):
        v = torch.randn(shape, generator=gen, device=dev)
        v = v * torch.exp2(torch.randint(-scale_pow, scale_pow, shape,
                                         generator=gen,
                                         device=dev).to(torch.float32))
        return PC.posit_encode((v / _pow2_scale(v)).contiguous(), ecfg.posit)

    worst = 0.0
    for M in (4, 32, 128):
        for K, N in GEMMA_KN:
            a, b = bits((M, K)), bits((K, N))
            got = LM.logmac(a, b, ecfg)
            want = LM.logmac_plain(a, b, ecfg)
            va, ra = LM.decode_planes(a, ecfg)
            ok_all = True
            for c0 in range(0, N, 16384):
                vb, rb = LM.decode_planes(b[:, c0:c0 + 16384], ecfg)
                bound = 1e-5 * (va.abs() @ vb.abs() + ra.abs() @ rb.abs()) + 1e-4
                diff = (got[:, c0:c0 + 16384] - want[:, c0:c0 + 16384]).abs()
                ok_all &= bool((diff <= bound).all())
                worst = max(worst, float(diff.max()))
            assert ok_all, f"logmac M={M} K={K} N={N} outside its bound"
            assert bool(torch.isfinite(got).all())
            del a, b, got, want
    errs["logmac"] = worst
    log(f"[logmac] M in (4, 32, 128) x {GEMMA_KN} within the per-element bound "
        f"(max abs diff {worst:.3g})")

    # paged flash-decode at the serving geometry
    B, KV, G, hd, ps, max_len = 4, 4, 2, 288, 16, 256
    nlp = max_len // ps
    pos = torch.tensor([37, 100, 250, 5], dtype=torch.int32, device=dev)
    num_pages = PD.RESERVED_PAGES + B * nlp

    def page_table(pos):
        # real pages for positions 0..pos of each row, NULL_PAGE past them
        tab = torch.full((B, nlp), PD.NULL_PAGE, dtype=torch.int32)
        nxt = PD.RESERVED_PAGES
        for r in range(B):
            for j in range(int(pos[r]) // ps + 1):
                tab[r, j] = nxt
                nxt += 1
        assert (tab == PD.NULL_PAGE).any()
        return tab.to(dev)

    table = page_table(pos)
    pc16 = P.BPOSIT16
    kf = torch.randn((num_pages, ps, KV, hd), generator=gen, device=dev)
    vf = torch.randn((num_pages, ps, KV, hd), generator=gen, device=dev)
    kf[:PD.RESERVED_PAGES] = 0
    vf[:PD.RESERVED_PAGES] = 0
    kp = P.to_storage(P.encode_from_float(kf, pc16), pc16).contiguous()
    vp = P.to_storage(P.encode_from_float(vf, pc16), pc16).contiguous()
    q = torch.randn((B, 1, KV * G, hd), generator=gen, device=dev)
    kw = dict(pc=pc16, cfg_qk=ecfg, cfg_pv=ecfg, softcap=50.0)
    for window in (None, 4096, 24):
        got = PD.paged_flash_decode(q, kp, vp, table, pos, window, **kw)
        want = PD.paged_flash_decode_plain(q, kp, vp, table, pos, window,
                                           **kw)
        ref = PD.paged_attention_reference(q, kp, vp, table, pos, pc=pc16,
                                           softcap=50.0, window=window)
        d_plain = float((got - want).abs().max())
        d_ref = float((got - ref).abs().max())
        assert d_plain <= 1e-3, f"paged decode window={window}: {d_plain}"
        assert d_ref < 0.05, f"paged decode vs reference window={window}: {d_ref}"
        errs["paged_flash_decode"] = max(errs["paged_flash_decode"], d_plain)
        log(f"[paged_decode] window={window}: max|kernel-plain|={d_plain:.3g}, "
            f"max|kernel-reference|={d_ref:.3g}")

    # ---- phase 3: serve gemma2-2b FULL through the launcher -------------
    from repro_torch.launch import serve
    _build.reset_launches()
    rep = serve.main(["--arch", "gemma2-2b", "--full", "--paged",
                      "--page-size", "16", "--cache-dtype", "uint16",
                      "--backend", "cuda", "--euler", "L-21b", "--width",
                      "16", "--device", "cuda", "--batch", "4", "--max-len",
                      "256", "--requests", "8", "--max-new", "16",
                      "--seed", "0"])
    launches = dict(_build.LAUNCHES)
    log(f"[serve] launches on the main path: {launches}")
    assert rep["n_layers"] == 26 and rep["d_model"] == 2304, rep["arch"]
    assert rep["tokens"] == 128, rep["tokens"]
    assert rep["refills"] >= 1, rep["refills"]
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    eng = rep["engine"]
    first = next(iter(rep["results"].values()))
    logits, _ = eng.model.prefill(
        eng.params, torch.as_tensor(first[:16], device=dev)[None, :],
        eng.ctx, eng.model.init_cache(1, 16, "uint16"))
    assert logits.shape == (1, eng.model.cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all()), "non-finite FULL logits"
    log(f"[serve] {card}: {rep['tok_per_s']:.2f} tok/s, request latency "
        f"p50 {rep['latency_p50_s']:.3f}s p99 {rep['latency_p99_s']:.3f}s, "
        f"{rep['steps']} steps, {rep['refills']} refills, "
        f"max_memory_allocated {rep['max_memory_allocated'] / 2**30:.2f} GiB")
    serve_line = {k: rep[k] for k in (
        "tokens", "seconds", "tok_per_s", "latency_p50_s", "latency_p99_s",
        "steps", "refills", "max_memory_allocated")}
    serve_line["card"] = card
    log("[serve] " + json.dumps(serve_line))
    if args.profile:
        profile_drain(eng, card)
    del rep, eng, logits
    torch.cuda.empty_cache()

    # SMOKE logits: the kernels against the reference engine on the card
    from repro_torch.configs import gemma2_2b
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model
    from repro_torch.numerics import NumericsContext
    ids = torch.randint(0, gemma2_2b.SMOKE.vocab, (2, 16), generator=gen,
                        device=dev)
    outs = {}
    params = None
    for backend in ("cuda", "lax_ref"):
        nctx = NumericsContext.from_ecfg(ecfg, backend=backend)
        m = Model(gemma2_2b.SMOKE, numerics=nctx, device=dev)
        params = params if params is not None else m.init(1)
        outs[backend], _ = m.prefill(params, ids, Ctx(numerics=nctx),
                                     m.init_cache(2, 16, "uint16"))
    torch.testing.assert_close(outs["cuda"], outs["lax_ref"], rtol=1e-4,
                               atol=2e-3)
    log(f"[smoke-model] cuda vs lax_ref prefill logits max diff "
        f"{float((outs['cuda'] - outs['lax_ref']).abs().max()):.3g}")

    # ---- phase 4: timings ----------------------------------------------
    flush_buf = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    rows = []
    # encode at the MLP weight shape the main path encodes every step
    xw = torch.randn((2304, 9216), generator=gen, device=dev)
    n = xw.numel()
    enc_ms = time_ms(lambda: PC.posit_encode(xw, ecfg.posit), flush=flush)
    enc_plain = time_ms(lambda: PC.encode_plain(xw, ecfg.posit), reps=3,
                        flush=flush)
    enc_bytes = n * 4 + n * 4
    rows.append({"name": "posit_encode", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/posit_encode.cu",
                 "replaces": "src/repro/kernels/posit_codec.py:73",
                 "shape": "f32 [2304, 9216] -> uint32",
                 "bytes": enc_bytes, "flops": 0,
                 "ms": enc_ms, "plain_ms": enc_plain})
    # logmac at decode (M=4) and prefill-bucket (M=32, 128) widths of the MLP
    for M in (4, 32, 128):
        K, N = 2304, 9216
        a, b = bits((M, K)), bits((K, N))
        ms = time_ms(lambda: LM.logmac(a, b, ecfg), flush=flush)
        pms = time_ms(lambda: LM.logmac_plain(a, b, ecfg), reps=3,
                      flush=flush)
        rows.append({"name": "logmac", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/logmac.cu",
                     "replaces": "src/repro/kernels/logmac.py:136",
                     "shape": f"M={M} K={K} N={N}",
                     "bytes": (M * K + K * N + M * N) * 4,
                     "flops": 4 * M * N * K, "ms": ms, "plain_ms": pms})
    # the head at decode width
    a, b = bits((4, 2304)), bits((2304, 256000))
    ms = time_ms(lambda: LM.logmac(a, b, ecfg), reps=5, flush=flush)
    pms = time_ms(lambda: LM.logmac_plain(a, b, ecfg), reps=2, flush=flush)
    rows.append({"name": "logmac", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/logmac.cu",
                 "replaces": "src/repro/kernels/logmac.py:136",
                 "shape": "M=4 K=2304 N=256000",
                 "bytes": (4 * 2304 + 2304 * 256000 + 4 * 256000) * 4,
                 "flops": 4 * 4 * 256000 * 2304, "ms": ms, "plain_ms": pms})
    del a, b
    # paged decode at the serving geometry, window 4096 (local layers)
    pos_serve = torch.tensor([40, 33, 27, 21], dtype=torch.int32, device=dev)
    table = page_table(pos_serve)
    ms = time_ms(lambda: PD.paged_flash_decode(q, kp, vp, table, pos_serve,
                                               4096, **kw), flush=flush)
    pms = time_ms(lambda: PD.paged_flash_decode_plain(
        q, kp, vp, table, pos_serve, 4096, **kw), reps=3, flush=flush)
    npos = int((pos_serve + 1).sum())            # valid positions this run
    pages = int(sum(int(p) // ps + 1 for p in pos_serve.tolist()))
    pd_bytes = (q.numel() * 4 + pages * ps * KV * hd * 2 * 2
                + B * nlp * 4 + B * 4 + B * KV * G * hd * 4)
    pd_flops = npos * KV * G * hd * 8
    rows.append({"name": "paged_flash_decode", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
                 "replaces": "src/repro/kernels/paged_decode.py:127",
                 "shape": f"B=4 KV=4 G=2 hd=288 ps=16 uint16, pos {pos_serve.tolist()}",
                 "bytes": pd_bytes, "flops": pd_flops,
                 "ms": ms, "plain_ms": pms})
    for r in rows:
        bb = r["bytes"] / HBM_BYTES_PER_S * 1e3
        bo = r["flops"] / FP32_FLOPS * 1e3
        r["bound_ms"] = max(bb, bo)
        r["bound_by"] = "bytes" if bb >= bo else "operations"
        log(f"[time] {card}: {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")

    kernels = []
    for name in ("posit_encode", "logmac", "paged_flash_decode"):
        r = next(r for r in rows if r["name"] == name)
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
