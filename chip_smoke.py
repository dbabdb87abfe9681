"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py            # everything, on one CUDA card

Phases (each asserts; a failed phase exits non-zero and prints no result):

1. the card's name and power limit; build of the four CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path: posit encode (bit-exact, six formats with
   zero/NaR/clamp/subnormal inputs), posit decode (bit-identical f32 on
   six formats: every 8- and 16-bit pattern plus 2^24 random 32-bit
   words), logmac (P16: M in {4, 32, 128}; P8 and P32: M in {4, 32};
   against the five gemma2-2b K x N shapes, per-element bound
   ``1e-5*(|va||vb| + |ra||rb|) + 1e-4``), paged flash-decode (max-abs
   <= 1e-3 against the plain version, < 0.05 against the gather
   reference);
3. serving gemma2-2b FULL (26 layers, d_model 2304, seeded random
   weights) through ``repro_torch.launch.serve`` with a paged uint16
   posit KV cache on the ``cuda`` backend: 8 requests, batch 4, max_len
   256, max_new 16; encode, logmac and paged flash-decode must launch;
   then the SMOKE model's logits on the kernels against the reference
   engine;
3b. guarded, laddered serving of gemma2-2b FULL through the same launcher
   (``--guard --degrade-ladder 8``, P16 -> P8): every request ``ok``,
   demotions and mixed-level steps, encode and logmac launched at widths 8
   and 16, paged flash-decode not launched (the guarded path attends
   through the gather reference, as the JAX package does), guard checks
   with zero violations;
3c. the fault-injection campaign ``repro_torch.launch.faultcamp --smoke
   --guard`` (the TINY model in posit mode: no kernel) with its asserts;
3d. the ``ops.encode`` -> ``ops.decode`` codec path on an MLP weight;
4. each kernel timed with CUDA events (L2 flushed before every launch)
   beside its plain version, with the least time the card could take.

Launch counts are reset just before each path (3, 3b, 3c, 3d) and read
just after; each path asserts the kernels it launches, and the
``launches`` of the kernels line sum the four paths.  The line before the
last is ``{"kernels": [...]}``; the last line is
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
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import posit_codec as PC
    from repro_torch.launch import pin_exact_f32

    pin_exact_f32()
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
    errs = {"posit_encode": 0.0, "posit_decode": 0.0, "logmac": 0.0,
            "paged_flash_decode": 0.0}
    total_launches = dict.fromkeys(errs, 0)

    def path_launches(what: str) -> dict:
        """The counts since the last reset, added to the run's total."""
        got = dict(_build.LAUNCHES)
        for k, n in got.items():
            total_launches[k] += n
        log(f"[{what}] launches: {got}, by width: "
            f"{ {k: v for k, v in _build.WIDTH_LAUNCHES.items() if v} }")
        return got

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
    del x

    # posit decode: every 8- and 16-bit pattern, 2^24 random 32-bit words
    # (with 0 and NaR); the kernel masks each word to its format's N bits
    words = torch.cat([
        torch.arange(1 << 8, dtype=torch.int32, device=dev),
        torch.arange(1 << 16, dtype=torch.int32, device=dev),
        torch.tensor([0, -(1 << 31)], dtype=torch.int32, device=dev),
        torch.randint(-(1 << 31), (1 << 31) - 1, (1 << 24,), generator=gen,
                      dtype=torch.int32, device=dev)]).contiguous()
    for pc in (P.POSIT8, P.BPOSIT8, P.POSIT16, P.BPOSIT16, P.POSIT32,
               P.BPOSIT32):
        got = PC.posit_decode(words, pc)
        want = PC.decode_plain(words, pc)
        torch.cuda.synchronize()
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        assert bad == 0, f"decode {pc.name}: {bad} f32 results differ"
        nar = 1 << (pc.n_bits - 1) if pc.n_bits < 32 else -(1 << 31)
        specials = torch.tensor([0, nar], dtype=torch.int32, device=dev)
        assert PC.posit_decode(specials, pc).tolist() == [0.0, 0.0], pc.name
        errs["posit_decode"] = max(errs["posit_decode"],
                                   float((got - want).abs().max()))
    log(f"[decode] bit-identical f32 on 6 formats, {words.numel()} words "
        f"incl. every 8/16-bit pattern, 0 and NaR (-> 0.0)")
    del words, got, want

    def bits(shape, pc, scale_pow=3):
        v = torch.randn(shape, generator=gen, device=dev)
        v = v * torch.exp2(torch.randint(-scale_pow, scale_pow, shape,
                                         generator=gen,
                                         device=dev).to(torch.float32))
        return PC.posit_encode((v / _pow2_scale(v)).contiguous(), pc)

    # P16 is the served width; P8 is the ladder's width and P32 the guard's
    # escalation width, each encoded by the encode kernel at that width
    worst = 0.0
    for width, Ms in ((16, (4, 32, 128)), (8, (4, 32)), (32, (4, 32))):
        wcfg = from_variant(width, "L-21b")
        for M in Ms:
            for K, N in GEMMA_KN:
                a, b = bits((M, K), wcfg.posit), bits((K, N), wcfg.posit)
                got = LM.logmac(a, b, wcfg)
                want = LM.logmac_plain(a, b, wcfg)
                va, ra = LM.decode_planes(a, wcfg)
                ok_all = True
                for c0 in range(0, N, 16384):
                    vb, rb = LM.decode_planes(b[:, c0:c0 + 16384], wcfg)
                    bound = (1e-5 * (va.abs() @ vb.abs() + ra.abs() @ rb.abs())
                             + 1e-4)
                    diff = (got[:, c0:c0 + 16384]
                            - want[:, c0:c0 + 16384]).abs()
                    ok_all &= bool((diff <= bound).all())
                    worst = max(worst, float(diff.max()))
                assert ok_all, (f"logmac P{width} M={M} K={K} N={N} outside "
                                "its bound")
                assert bool(torch.isfinite(got).all())
                del a, b, got, want
        log(f"[logmac] P{width} L-21b, M in {Ms} x {GEMMA_KN} within the "
            f"per-element bound (max abs diff so far {worst:.3g})")
    errs["logmac"] = worst

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
    from repro_torch.launch import faultcamp, serve
    _build.reset_launches()
    rep = serve.main(["--arch", "gemma2-2b", "--full", "--paged",
                      "--page-size", "16", "--cache-dtype", "uint16",
                      "--backend", "cuda", "--euler", "L-21b", "--width",
                      "16", "--device", "cuda", "--batch", "4", "--max-len",
                      "256", "--requests", "8", "--max-new", "16",
                      "--seed", "0"])
    launches = path_launches("serve")
    assert rep["n_layers"] == 26 and rep["d_model"] == 2304, rep["arch"]
    assert rep["tokens"] == 128, rep["tokens"]
    assert rep["refills"] >= 1, rep["refills"]
    for name in ("posit_encode", "logmac", "paged_flash_decode"):
        assert launches[name] > 0, f"kernel {name} was not launched in serving"
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
    del outs, params, m

    # ---- phase 3b: guarded, laddered serving of gemma2-2b FULL ----------
    # --slo-queue-hi 3: of the first four admissions three see >= 3 queued
    # requests (-> P8) and the fourth sees 2 (-> P16), so the first decode
    # steps run both levels
    _build.reset_launches()
    rep = serve.main(["--arch", "gemma2-2b", "--full", "--paged",
                      "--cache-dtype", "uint16", "--backend", "cuda",
                      "--guard", "--width", "16", "--euler", "L-21b",
                      "--degrade-ladder", "8", "--slo-queue-hi", "3",
                      "--device", "cuda", "--batch", "4", "--max-len", "256",
                      "--requests", "6", "--max-new", "4", "--seed", "0"])
    launches = path_launches("guarded serve")
    by_width = rep["launches_by_width"]
    g = rep["guard"]
    assert rep["n_layers"] == 26 and rep["d_model"] == 2304, rep["arch"]
    assert rep["requests"] == 6 and set(rep["statuses"].values()) == {"ok"}, \
        rep["statuses"]
    assert rep["tokens"] == 24, rep["tokens"]
    assert rep["demotions"] > 0, rep["demotions"]
    assert rep["mixed_steps"] > 0, "no decode step ran both ladder levels"
    for name in ("posit_encode", "logmac"):
        for w in (8, 16):
            assert by_width[name].get(w, 0) > 0, (
                f"{name} not launched at width {w}: {by_width[name]}")
    assert launches["paged_flash_decode"] == 0, launches
    assert g["checks"] > 0 and g["violations"] == 0, g
    log(f"[guarded-serve] {card}: {rep['tok_per_s']:.3f} tok/s, request "
        f"latency p50 {rep['latency_p50_s']:.3f}s p99 "
        f"{rep['latency_p99_s']:.3f}s, {rep['steps']} steps "
        f"({rep['mixed_steps']} mixed-level), {rep['demotions']} demotions, "
        f"guard {g['checks']} checks / {g['violations']} violations, "
        f"max_memory_allocated {rep['max_memory_allocated'] / 2**30:.2f} GiB")
    guarded_line = {k: rep[k] for k in (
        "tokens", "seconds", "tok_per_s", "latency_p50_s", "latency_p99_s",
        "steps", "mixed_steps", "demotions", "max_memory_allocated")}
    guarded_line.update(guard=g, launches_by_width=by_width, card=card)
    log("[guarded-serve] " + json.dumps(guarded_line))

    # the guard's share of a FULL forward pass: one 16-token prefill through
    # cuda and guarded:cuda on the served weights, in turns (plain, guarded,
    # guarded, plain); a clean guard returns the base op's output unchanged
    eng = rep["engine"]
    if args.profile:
        profile_drain(eng, card)
    ids16 = torch.as_tensor(rep["results"][0][:1].tolist() * 16,
                            device=dev)[None, :]
    pass_s = {"cuda": [], "guarded:cuda": []}
    logits = {}
    for backend in ("cuda", "guarded:cuda", "guarded:cuda", "cuda"):
        nctx = NumericsContext.from_ecfg(ecfg, backend=backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[backend], _ = eng.model.prefill(
            eng.params, ids16, Ctx(numerics=nctx),
            eng.model.init_cache(1, 16, "uint16"))
        torch.cuda.synchronize()
        pass_s[backend].append(time.perf_counter() - t0)
    torch.testing.assert_close(logits["guarded:cuda"], logits["cuda"],
                               rtol=1e-4, atol=2e-3)
    t_plain = sum(pass_s["cuda"]) / 2
    t_guard = sum(pass_s["guarded:cuda"]) / 2
    log(f"[guard-share] {card}: FULL 16-token prefill pass {t_plain:.4f} s "
        f"on cuda, {t_guard:.4f} s on guarded:cuda (guard share "
        f"{100 * (1 - t_plain / t_guard):.1f} % of a guarded pass; each "
        f"pass: {pass_s}); logits max diff "
        f"{float((logits['guarded:cuda'] - logits['cuda']).abs().max()):.3g}")
    del rep, eng, logits
    torch.cuda.empty_cache()

    # ---- phase 3c: the fault-injection campaign entry point --------------
    _build.reset_launches()
    t0 = time.perf_counter()
    camp = faultcamp.main(["--smoke", "--guard", "--device", "cuda"])
    path_launches("faultcamp")
    assert camp["config"]["device"].startswith("cuda"), camp["config"]
    log(f"[faultcamp] {card}: smoke grid with the guard arm passed its "
        f"asserts in {time.perf_counter() - t0:.1f}s: "
        f"{json.dumps(camp['summary'], sort_keys=True)}")

    # ---- phase 3d: the codec path, ops.encode -> ops.decode -------------
    xw = torch.randn((2304, 9216), generator=gen, device=dev)
    xs = (xw / _pow2_scale(xw)).contiguous()
    _build.reset_launches()
    pats = OPS.encode(xs, ecfg.posit)
    vals = OPS.decode(pats, ecfg.posit)
    torch.cuda.synchronize()
    launches = path_launches("codec")
    assert launches["posit_encode"] == 1 and launches["posit_decode"] == 1
    assert vals.shape == xs.shape and bool(torch.isfinite(vals).all())
    assert bool((vals.view(torch.int32)
                 == PC.decode_plain(pats, ecfg.posit).view(torch.int32)).all())
    log(f"[codec] decode(encode(w)) of a pre-scaled [2304, 9216] weight: "
        f"max |round trip - w| {float((vals - xs).abs().max()):.3g}")
    del pats, vals, xs

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
    # decode of the same weight's P16 words: 4 B in and 4 B out per word
    pw = PC.posit_encode(xw, ecfg.posit)
    dec_ms = time_ms(lambda: PC.posit_decode(pw, ecfg.posit), flush=flush)
    dec_plain = time_ms(lambda: PC.decode_plain(pw, ecfg.posit), reps=3,
                        flush=flush)
    rows.append({"name": "posit_decode", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/posit_decode.cu",
                 "replaces": "src/repro/kernels/posit_codec.py:77",
                 "shape": "uint32 [2304, 9216] -> f32",
                 "bytes": n * 4 + n * 4, "flops": 0,
                 "ms": dec_ms, "plain_ms": dec_plain})
    del pw
    # logmac at decode (M=4) and prefill-bucket (M=32, 128) widths of the
    # MLP at P16, and at decode width at the ladder's P8 and the guard's P32
    # (4 B per weight word at every width, so one bound formula)
    for width, M in ((16, 4), (16, 32), (16, 128), (8, 4), (32, 4)):
        K, N = 2304, 9216
        wcfg = from_variant(width, "L-21b")
        a, b = bits((M, K), wcfg.posit), bits((K, N), wcfg.posit)
        ms = time_ms(lambda: LM.logmac(a, b, wcfg), flush=flush)
        pms = time_ms(lambda: LM.logmac_plain(a, b, wcfg), reps=3,
                      flush=flush)
        rows.append({"name": "logmac", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/logmac.cu",
                     "replaces": "src/repro/kernels/logmac.py:136",
                     "shape": f"P{width} M={M} K={K} N={N}",
                     "bytes": (M * K + K * N + M * N) * 4,
                     "flops": 4 * M * N * K, "ms": ms, "plain_ms": pms})
    # the head at decode width
    a, b = bits((4, 2304), ecfg.posit), bits((2304, 256000), ecfg.posit)
    ms = time_ms(lambda: LM.logmac(a, b, ecfg), reps=5, flush=flush)
    pms = time_ms(lambda: LM.logmac_plain(a, b, ecfg), reps=2, flush=flush)
    rows.append({"name": "logmac", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/logmac.cu",
                 "replaces": "src/repro/kernels/logmac.py:136",
                 "shape": "P16 M=4 K=2304 N=256000",
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
    for name in ("posit_encode", "posit_decode", "logmac",
                 "paged_flash_decode"):
        r = next(r for r in rows if r["name"] == name)
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": total_launches[name],
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
