"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py            # everything, on one CUDA card

Phases (each asserts; a failed phase exits non-zero and prints no result):

1. the card's name and power limit; build of the six CUDA sources from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path: posit encode (bit-exact, six formats with
   zero/NaR/clamp/subnormal inputs; the table form the encode kernels
   run equal to ``encode_f32`` on all 2^32 f32 patterns of seven
   formats), the fused pow2 pre-scale + encode
   (its scale bit-equal to torch's ``_pow2_scale``, its words bit-identical
   to the plain version, at P8, P16 and P32 with and without pre-scale, on
   the five gemma2-2b weight shapes at the model init's scale, activations
   at M in {1, 4, 16, 32}, every weight shape of the mamba2-1.3b and
   hymba-1.5b paths with activations at each of their K for M in {1, 4,
   128, 256}, a ragged size, a misaligned base, edge values and 1 %
   subnormals (not counted in the scale, XLA's flush); the heads at
   the served format only; two launches bit-identical), posit decode
   (bit-identical f32 on
   six formats: every 8- and 16-bit pattern plus 2^24 random 32-bit
   words), the core codec's five entries (``posit_store``,
   ``posit_load``, ``posit_quantize`` and the guard's
   ``posit_quantize_prescaled`` and ``posit_sentinels``;
   ``check_core_codec``) bit for bit against their plain versions, NaN
   as NaN, on six formats: every 8- and 16-bit word and 2^24 random
   32-bit words loaded to f32 and bf16, f32 and bf16 stores and quantizes
   of edge values (subnormals -> 0, XLA's flush), the five gemma2-2b
   weight shapes (the head at the served P16 and P8), a ragged size, a
   misaligned base, a transposed weight, a strided slice, head logits and
   1 % subnormals; the guard's entries given the kernel's s, that s
   bit-equal to the fused encode's on the same memory (also next to a .5
   tie of the mean log2), the sentinels with and without the scale, each
   input's margin to a tie printed; the served P16 format's decode table bit for bit against the
   plain decode, logmac over every 8- and 16-bit pattern (and 2^20
   32-bit words) as B with K = 1 and M in {1, 4, 33, 64}, equal to the
   plain version (the bf16-piece kernel, P32 above 32 rows, within
   ``4 * 2^-24 * (|va||vb| + |ra||rb|)``), and logmac at P8, P16 and P32 L-21b for M in {1,
   4, 5, 16, 17, 31, 32, 33} (the small-M kernel up to the crossover
   M = 32; above it the fp16 tensor-core kernel at P8 and P16, the
   bf16-piece tensor-core kernel at P32), at P8 and P16 also for M in
   {64, 65, 128, 200, 256} and at P32 for M = 128, against the five
   gemma2-2b K x N shapes and a ragged one
   (N % 4 != 0, K not a multiple of the split), at P16 for M in {1, 4,
   16, 128} against the ten K x N shapes of the mamba2-1.3b and
   hymba-1.5b paths and at P16 and P8 for M in {33, 64, 65, 128, 200,
   256} (256: the eval step of 3g) against hymba's, plus a misaligned B
   base, per-element bound ``1e-5*(|va||vb| + |ra||rb|) + 1e-4``; the
   bf16-piece kernel at every format routed to it (P32 L-21b and L-22b,
   the seven P16 variants but L-21b) for M in {33, 128, 256} and the tile
   kernel at P32 L-21 and L-1b (unbounded; untruncated) for M in {33,
   128}, K x N (300, 70), (2304, 9216), (9216, 2304) and the ragged one,
   and at K = 300 on unit-scale words against rtol 1e-5 / atol 1e-4;
   above 32 rows the first 33 rows of calls at M
   in {33, 128, 129, 256, 512} bit-equal (fp16 kernel at P16 and P8 L-21b,
   bf16-piece kernel at P32 L-21b, on [2304, 9216] and [2304, 2304]);
   paged flash-decode at the serving geometry and at a long context
   (max_len 4096, positions near 4000; windows None and 4096), max-abs
   <= 1e-3 against the plain version, < 0.05 against the gather
   reference.  Logmac and paged decode must give the same bits on two
   launches (no float atomics).  At the shapes of phases 3h-3j
   (``ZOO_KN``): the fused encode at P16 with and without pre-scale on
   the llama4-scout, musicgen-large and yi-6b weights and activations at
   their K (M in {1, 4, 32}), logmac at P16 for M in {1, 4, 32, 128} (the
   heads 4 and 32, llama4's [5120, 202048] among them), and paged decode
   at (KV, G, hd) = (8, 5, 128), (32, 1, 64) and (8, 8, 128), then at
   those on eight more draws, each held to the plain version at 1e-3
   (the plain version's scores are the kernel's bit for bit);
3. the fused kernel's scale against torch's ``_pow2_scale`` for every
   weight of the seeded FULL model (26 x 7 projections and the head's
   operand), then serving gemma2-2b FULL (26 layers, d_model 2304, seeded
   random weights) through ``repro_torch.launch.serve`` with a paged
   uint16 posit KV cache on the ``cuda`` backend: 8 requests, batch 4,
   max_len 256, max_new 16; the fused encode (at width 16), logmac,
   paged flash-decode and ``posit_store`` (the KV writes) must launch; then the SMOKE model's logits on the
   kernels against the reference engine;
3b. guarded, laddered serving of gemma2-2b FULL through the same launcher
   (``--guard --degrade-ladder 8``, P16 -> P8): every request ``ok``,
   demotions and mixed-level steps, the fused encode and logmac launched
   at widths 8 and 16, paged flash-decode not launched (the guarded path
   attends through the gather reference, as the JAX package does),
   ``posit_store``, ``posit_load`` (the gather reference's reads),
   ``posit_quantize_prescaled`` and ``posit_sentinels`` (the guard's
   check and sentinels) launched and their counts printed, guard checks
   with zero violations; then a 16-token prefill on ``cuda`` and
   ``guarded:cuda`` in turns (the guard's share, each pass's launches,
   both guard entries launched, logits equal to ``cuda``'s within the
   model bar);
3c. the fault-injection campaign ``repro_torch.launch.faultcamp --smoke
   --guard`` (the TINY model in posit mode: no kernel) with its asserts;
3d. the ``ops.encode`` -> ``ops.decode`` codec path on an MLP weight;
3e. durable serving of gemma2-2b FULL (paged uint16 cache, ``cuda``,
   batch 4, max_len 256, 8 requests x 16 tokens sampled at temperature
   0.8 from one fixed key): an uninterrupted ``RequestBatcher`` drain,
   then a ``ServeSupervisor`` over a ``DurableBatcher`` (a snapshot every
   2 decode steps) killed at step 5 and restarted on a fresh engine;
   every request's tokens equal the uninterrupted run's, one restart
   ruled ELASTIC_DOWN, the fused encode, logmac, paged flash-decode and
   ``posit_store`` launched before and after the restart, every slot's pages equal to
   the uninterrupted engine's; each snapshot's seconds and bytes; then
   the same 8 prompts with staggered budgets, killed two steps before
   the end (a snapshot every step), so the resumed steps carry retired
   slots' pad rows: tokens, stats and every slot's pages equal to an
   uninterrupted drain's;
3f. mamba2-1.3b FULL (48 layers, d_model 2048) and hymba-1.5b FULL (32
   layers, d_model 1600) served through the launcher on ``cuda`` with a
   dense cache (8 requests x 16 tokens, batch 4, max_len 256): the fused
   encode and logmac's small-M kernel launched, its tile kernel and paged
   flash-decode not; then a 128-token prefill on the served engine
   (logmac's tensor-core kernel launched, the tile kernel not), finite
   logits, the share of subnormal values in the operands the SSD
   pre-scales printed; then each SMOKE model's logits on the kernels
   against the reference engine;
3g. training: gemma2-2b SMOKE (L-21b P16, ``lax_ref``, batch 4, seq 64)
   takes two train steps on the card and on the CPU from one initial
   state (losses within rtol 1e-4, atol 2e-3); one step replayed from the
   same state on the card gives a bit-identical loss and state (under
   ``launch.train.deterministic``); hymba-1.5b FULL (32 layers, d_model
   1600) trains 3 steps through ``repro_torch.launch.train`` (batch 2,
   seq 128, seed 0): finite losses and grad norms, every parameter leaf
   moved, s/step and the peak memory beside what was held before; then
   one eval step with the trained parameters on ``cuda`` (the fused
   encode and logmac's tensor-core kernel, M = 256; the tile kernel not)
   against ``lax_ref``, within
   2 (2e-3 + 1e-4 max|logit|); then one L-21b loss + gradient of
   hymba-1.5b FULL from the launcher's initial state and first batch under
   remat policy "nothing" and under "dots": loss and every gradient leaf
   bit-equal, each one's seconds and peak memory; last, the plain codec's
   peak device bytes per weight value over a forward and backward of a
   [2304, 25600] weight;
3h. llama4-scout-17b-a16e (moe) at full width (d_model 5120, 16 experts
   of d_ff 8192, top-1, vocab 202048) cut to ``LLAMA4_LAYERS`` layers,
   served through the launcher (``--layers``) with a paged uint16 cache
   on ``cuda``: 4 requests x 4 tokens; the fused encode, logmac's small-M
   kernel and paged decode (G = 5) launched; the experts' batched
   contractions on the reference engine; the depth, the weights a layer,
   the peak and the phase's seconds printed; then the SMOKE logits;
3i. musicgen-large FULL (audio: 48 layers, d_model 2048, MHA 32 heads of
   64) served from EnCodec ids with a paged uint16 cache (8 x 16 tokens;
   paged decode at G = 1), then one prefill from the stub frontend's
   [1, 32, 2048] frame embeddings on ``cuda``, each kernel contraction in
   it held at the logits bar against the reference engine on the same
   operands, its logits' distance from ``lax_ref`` reported; then the
   SMOKE logits;
3j. ``ServeEngine.generate`` on yi-6b FULL (32 layers, d_model 4096):
   batch 4 x 8-token prompts, 8 greedy tokens on a dense uint16 cache,
   equal to the model's prefill + decode_step loop; a ``RequestBatcher``
   drain of the same prompts beside it, the tokens it shares reported;
3k. the public numerics API and the paper's arithmetic: (a) Table I, the
   45 points (five width/SIMD groups x the eight ILM variants and R4BM)
   of ``ilm_pair`` + ``error_metrics`` at n = 200,000 on the card, each
   metric within rtol 1e-5 of the port's CPU path, printed beside the
   paper's spot values; (b) ``with numerics.use(cfg, backend="cuda"):
   numerics.matmul(x, w)`` at gemma2-2b width, x [4 | 128, 2304], w [2304,
   9216], for the eight variants at P16, L-21b at P8 and P32, L-1b and
   L-21 at P32, L-21b at P16 8_16 and P32 8_16_32: each call one pair of
   fused encodes and one logmac (the kernel its plan picks: at M = 128
   the fp16, bf16-piece or tile kernel), within the per-element bound of
   ``lax_ref``, its error metrics against the f64 product printed, then
   P16 L-21b with ``out_quant`` (``posit_quantize`` without a scale)
   bit-equal to the plain quantize of the unquantized output; (c) the
   quire at K = 9216: bposit16 words from the fused encode decoded by the
   decode kernel bit-equal to ``ref_decode`` on the CPU, and for 32
   outputs ``ref_exact_posit_mac`` (the decode kernel, f32 matmul),
   ``kahan_sum`` and ``chunked_sum`` against the exact ``np_quire_dot``
   within ``tests/test_quire.py``'s bars; (d) gemma2-2b FULL's dot FLOPs
   and bytes of a 128-token prefill, counted by ``analysis.costmodel`` on
   ``exact``, over the median time of the same prefill on ``cuda``, as
   shares of the card's peaks (a report); then the ``quickstart`` and
   ``mixed_precision`` examples on the card, each with its assertions;
3l. the multi-device path on the one card: gloo ranks (NCCL refuses two
   ranks on one GPU), each computing on cuda:0 under ``pin_exact_f32``
   and ``deterministic()``, spawned after phase 1 built the kernels.
   (a) ``compressed_psum``/``compressed_pmean`` over 4 ranks on CUDA
   tensors, bit-equal to the same calls on CPU tensors and within 0.02 of
   the exact sum; (b) gemma2-2b FULL's forward + head on ``cuda``, a
   ``DP_BATCH`` batch split 2 + 2 over a 2-rank data mesh (rank 0's
   parameters broadcast): every pre-scale (the fused encode's split
   entry, the reference engine's) bit-equal to the parent's one-process
   forward's, every logmac launch within its per-element bound of the
   plain version and replayed with both ranks' rows stacked (the
   one-process call's shape), the rank's rows of it bit-equal to the
   rank's own result, the logits' max |diff| and argmax agreement
   reported;
   (c) one data-parallel train step of hymba-1.5b at full width, cut to
   ``HYMBA_DP_LAYERS`` layers, on ``lax_ref``, global batch 2 x 128 over 2
   ranks, the two rows taking different local pre-scales: every pre-scale
   of the step bit-equal to rank 0's one-process step on the whole batch;
   the loss within 1e-6 and every gradient leaf within relative L2 1e-3
   of rank 0's one-process step as two 128-row micro-batches (the ranks'
   product shapes) with those pre-scales; the distance from the
   whole-batch step, s/step and the peak a rank printed; (d) one llama4-scout MoE block at full width on [4, 128]
   tokens: expert parallel on (1, 2) bit-identical to the one-process
   block without pre-scale (its max |diff| under P16 L-21b reported), on
   (2, 2) ``moe_fsdp``'s f32 ZeRO-3 gather bit-identical to the run
   without it, the bfloat16 gather's diff and bytes reported; (e)
   gemma2-2b FULL under the production placement
   (``Ctx(placement="production")``) on (data, model) = (1, 2) on
   ``cuda`` at P16 L-21b: each rank holds its blocks of the seeded
   parameters and of a dense cache (placed bytes equal to the sharding
   arithmetic), layer 0's pre-scales (and the head's on it) bit-equal to
   one process's on both ranks and its output within rtol 1e-4 / atol
   2e-3 (its logits' distance printed), split encodes over the model
   group bit-equal to their plain version, logmac within its bound on the
   column and row blocks and each column block's call replayed with the
   whole weight gathered, the rank's columns of it bit-equal to its own,
   then a 4 x 16-token prefill and 8 greedy decode steps with the fused
   encode and logmac launched; the final logits' distance, argmax
   agreement and tokens against one process's, seconds and the peak
   printed; the card's memory against ``mesh.H100_80GB_HBM3_BYTES``;
4. each kernel timed with CUDA events (L2 flushed before every launch)
   beside its plain version, with the least time the card could take:
   ``ms`` with the host's issue of the call inside the window, as every
   earlier slice timed it, and ``device_ms`` with the host run ahead of
   the device, so the window holds the device's work alone;
   the fused encode on the five gemma2-2b weight shapes and a decode
   activation beside the parent route (torch's ``_pow2_scale``, ``/``,
   the plain encode launch) timed in the same run; logmac on the five
   gemma2-2b shapes at M=4 and at M=16, 32 and 128 (P8 and P32 at M=4
   and 128; P32 L-21b at M=128 on all five shapes, P16 L-1b and P32 L-21
   at M=128 on the MLP shape), each row under the name of the kernel that
   ran it (``logmac_small``, ``logmac_mma``, ``logmac_pieces``,
   ``logmac_tile``), the tensor-core kernels' bounds at the tensor cores'
   rate for their products and the f32 tile kernel timed beside them on
   the same inputs, with the floor the decode instructions of an L-21b
   format set at the issue rate (SASS of a probe built from the kernels'
   ``logmac_decode.cuh``),
   paged decode
   (the whole call: q's pre-scale and encode, then the three passes) at
   the serving positions, near the end of max_len 256 and at a 4096
   context; the fused encode and logmac (M=4) also at every weight shape
   of the mamba2-1.3b and hymba-1.5b paths, and logmac's tensor-core
   kernel and the activations' fused encode at hymba's eval shapes
   (M = 256); the fused encode and logmac (M = 4 and 32) at the shapes of
   3h-3j, and paged decode at their geometries; the core codec's entries:
   ``posit_quantize_prescaled`` (the guard's check) at the five gemma2-2b
   weight shapes (the head transposed, read in place) and a decode
   activation, ``posit_sentinels`` of a 16-token prefill's MLP output and
   logits and of a decode step's output, ``posit_quantize`` (out_quant)
   of the API call's [128, 9216] output, ``posit_store`` of a decode
   step's K/V row (and of [2304, 9216], and of a strided slice, copied
   first), ``posit_load`` of one layer's gathered K or V to bf16 (and
   [2304, 9216] to f32); then the aten ops a call of ``cache_encode``,
   ``cache_decode`` and the guard's two entries dispatch on the card,
   kernel route against plain.

Launch counts are reset just before each path (3, 3b, 3c, 3d, the four
drains of 3e, each model of 3f, the eval step of 3g, the drains of 3h and
3i, 3i's frame prefill, 3j's generate and drain, each ``numerics.matmul``,
the quire and the two examples of 3k, 3l's forward in each data rank,
3l(e)'s prefill and decode in each placed rank) and read just after;
each path asserts
the kernels it launches, and the ``launches`` of the kernels line sum
the paths.  ``--profile`` also
groups torch's own kernels by name and sums the kinds the pow2 pre-scale
runs.  The line before the last is ``{"kernels": [...]}``; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): device memory 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s, fp16 and bf16 on the tensor
# cores 989 TFLOP/s (logmac's two tensor-core kernels).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP16_FLOPS = 989e12

GEMMA_KN = [(2304, 2304), (2304, 1152), (2304, 9216), (9216, 2304),
            (2304, 256000)]
# (K, N, projection) of every weight shape on the ssm and hybrid paths
NEW_FAMILY_KN = {
    "mamba2-1.3b": [(2048, 8512, "in_proj"), (4096, 2048, "out_proj"),
                    (2048, 50288, "head")],
    "hymba-1.5b": [(1600, 6482, "in_proj"), (3200, 1600, "out_proj"),
                   (1600, 1600, "q, o"), (1600, 320, "k, v"),
                   (1600, 5504, "gate, up"), (5504, 1600, "down"),
                   (1600, 32016, "head")]}
NEW_FAMILY_KN_SET = sorted({(K, N) for kns in NEW_FAMILY_KN.values()
                            for K, N, _ in kns})
NEW_FAMILY_K = sorted({K for K, _ in NEW_FAMILY_KN_SET})
# (K, N, projection) of the weight shapes the kernels take in phases 3h-3j:
# llama4-scout at full width (its experts' batched contractions run the
# reference engine, as in JAX), musicgen-large and yi-6b FULL
ZOO_KN = {
    "llama4-scout-17b-a16e": [(5120, 5120, "q, o"), (5120, 1024, "k, v"),
                              (5120, 202048, "head")],
    "musicgen-large": [(2048, 2048, "q, k, v, o, head"), (2048, 8192, "up"),
                       (8192, 2048, "down")],
    "yi-6b": [(4096, 4096, "q, o"), (4096, 512, "k, v"),
              (4096, 11008, "gate, up"), (11008, 4096, "down"),
              (4096, 64000, "head")]}
ZOO_K = sorted({K for kns in ZOO_KN.values() for K, _, _ in kns})
# (KV heads, group G, head_dim) of paged decode beyond gemma2's (4, 2, 288):
# llama4-scout (phase 3h), musicgen-large's multi-head attention (3i) and
# chameleon-34b (CPU parity only)
PAGED_GEOMS = [(8, 5, 128), (32, 1, 64), (8, 8, 128)]
# phase 3h's depth: llama4-scout at full width holds 7.73 GiB of f32
# weights a layer and 3.86 GiB of embedding; 4 layers peaked at 48.77 GiB
# of the card's 79.18 and 6 at 64.26 (PERF.md section 4), but 6 took
# about 115 s of the run's 1200; 2 make room for 3l(e) in the run's time
LLAMA4_LAYERS = 2

# torch kernels of the kinds ``_pow2_scale`` and its divide run: abs, the
# compare, clamp, log2, where, the sums, exp2, round, the divide, the fill
PRE_SCALE_KINDS = re.compile(r"abs|log2|where|reduce_kernel|div|clamp|exp2|"
                             r"round|CompareGT|compare|fill", re.IGNORECASE)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, flush=None, device_only: bool = False
            ) -> float:
    """Mean time of ``fn`` over ``reps`` calls, from CUDA events recorded
    around each call (``flush`` runs before each, outside the window).

    By default the window holds the host's issue of the call as well as the
    device's work (the kernels line's ``ms``, the port's first yardstick).
    With ``device_only`` a ~1 ms device sleep precedes the start
    event, so the host has queued the whole call before the device reaches
    it and the window holds the device's work alone."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        if device_only:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def random_words(shape, pc, gen, scale_pow: int = 3):
    """Posit words (int32, on ``gen``'s device) of pre-scaled randn values
    spread over 2^[-scale_pow, scale_pow), encoded by the encode kernel."""
    import torch
    from repro_torch.core.engine import _pow2_scale
    from repro_torch.kernels import posit_codec as PC
    v = torch.randn(shape, generator=gen, device=gen.device)
    v = v * torch.exp2(torch.randint(-scale_pow, scale_pow, shape,
                                     generator=gen,
                                     device=gen.device).to(torch.float32))
    return PC.posit_encode((v / _pow2_scale(v)).contiguous(), pc)


DECODE_PROBE = r"""
#include "logmac_decode.cuh"
template <int FMT>
__global__ void probe(const uint32_t* in, float2* out, euler::Posit pc,
                      euler::Planes pl) {
  __shared__ float2 tab[TABLE16];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v, r;
  decode_word<FMT>(in[i], pc, pl, tab, v, r);
  out[i] = make_float2(v, r);
}
__global__ void null_probe(const uint32_t* in, float2* out, euler::Posit pc,
                           euler::Planes pl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = make_float2(__uint_as_float(in[i]), 0.0f);
}
template __global__ void probe<FMT_TABLE8>(const uint32_t*, float2*,
                                           euler::Posit, euler::Planes);
template __global__ void probe<FMT_TABLE16>(const uint32_t*, float2*,
                                            euler::Posit, euler::Planes);
template __global__ void probe<FMT_P32>(const uint32_t*, float2*,
                                        euler::Posit, euler::Planes);
"""


def decode_instructions(build_dir, csrc) -> dict:
    """SASS instructions the small logmac kernel spends decoding one word
    of each L-21b format (``logmac_decode.cuh``: P8 and P16 through their
    tables, P32 arithmetically with its knobs as constants): a probe kernel
    that decodes one word per thread, less a probe that only loads and
    stores it.  Keys are the word widths."""
    src = os.path.join(build_dir, "decode_probe.cu")
    cubin = os.path.join(build_dir, "decode_probe.cubin")
    with open(src, "w") as f:
        f.write(DECODE_PROBE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(csrc), "-o", cubin, src],
                   check=True, capture_output=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and re.search(r"/\*[0-9a-f]{4}\*/\s+\S", line):
            counts[cur] += 1
    base = next(n for k, n in counts.items() if "null_probe" in k)
    fmt_of = {8: 1, 16: 2, 32: 3}      # FMT_TABLE8, FMT_TABLE16, FMT_P32
    return {w: next(n for k, n in counts.items()
                    if k.startswith(f"_Z5probeILi{f}E")) - base
            for w, f in fmt_of.items()}


ENCODE_PROBE = r"""
#include <cuda_runtime.h>
#include "posit_common.cuh"
__global__ void encode_probe(euler::Posit pc, unsigned long long* bad) {
  __shared__ euler::EncodeEntry tab[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    tab[i] = euler::encode_entry(i, pc);
  __syncthreads();
  unsigned long long nbad = 0;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const uint32_t b = (uint32_t)i;
    nbad += euler::encode_by_entry(b, tab[(b >> 23) & 0xFFu], pc)
            != euler::encode_f32(__uint_as_float(b), pc);
  }
  atomicAdd(bad, nbad);
}
extern "C" int encode_probe_launch(int N, int es, int R,
                                   unsigned long long* bad) {
  encode_probe<<<132 * 8, 256>>>(euler::Posit{N, es, R}, bad);
  return (int)cudaGetLastError();
}
"""


def encode_table_mismatches(build_dir, csrc, formats) -> dict:
    """Every one of the 2^32 f32 bit patterns through the encode kernels'
    table form (``encode_entry`` + ``encode_by_entry``) and through
    ``encode_f32`` on the card: the number of patterns that differ, per
    format name."""
    import ctypes
    import torch
    src = os.path.join(build_dir, "encode_probe.cu")
    lib = os.path.join(build_dir, "libencode_probe.so")
    with open(src, "w") as f:
        f.write(ENCODE_PROBE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-shared", "-Xcompiler", "-fPIC", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", str(csrc), "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).encode_probe_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for pc in formats:
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        assert fn(pc.n_bits, pc.es, pc.regime_max or 0, bad.data_ptr()) == 0
        out[pc.name] = int(bad)
    return out


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
    # the plain and fused encodes launch the same encode kernel (the
    # parent tree's plain one was posit_encode_kernel)
    ours = {"posit_encode(_prescaled)": ("posit_encode_kernel",
                                         "pe_reduce_kernel",
                                         "pe_encode_kernel"),
            "posit_decode": ("posit_decode_kernel",),
            "logmac": ("logmac_",),
            "paged_flash_decode": ("pd_q_prep_kernel", "pd_scores_kernel",
                                   "pd_values_kernel", "pd_combine_kernel")}
    shares = {}
    mine = set()
    for name, prefixes in ours.items():
        hit = [r for r in rows if r[2].split("<")[0].split("(")[0]
               .replace("void ", "").startswith(prefixes)]
        mine.update(r[2] for r in hit)
        ms = sum(r[0] for r in hit)
        shares[name] = f"{ms:.1f} ms ({100 * ms / busy:.1f}% of kernel time)"
    log(f"[profile] the port's kernels: {shares}")
    # torch's own kernels, and among them the kinds the pow2 pre-scale
    # runs (other callers of the same kinds are counted with them)
    torch_rows = [r for r in rows if r[2] not in mine]
    pre = [r for r in torch_rows if PRE_SCALE_KINDS.search(r[2])]
    t_ms = sum(r[0] for r in torch_rows)
    p_ms, p_n = sum(r[0] for r in pre), sum(r[1] for r in pre)
    log(f"[profile] torch's kernels: {t_ms:.1f} ms over "
        f"{sum(r[1] for r in torch_rows)} launches ({100 * t_ms / busy:.1f}% "
        f"of kernel time); pre-scale kinds ({PRE_SCALE_KINDS.pattern}): "
        f"{p_ms:.1f} ms over {p_n} launches ({100 * p_ms / busy:.1f}%)")
    for ms, n, key in rows[:20]:
        tag = "pre" if PRE_SCALE_KINDS.search(key) and key not in mine else ""
        log(f"[profile]   {ms:10.3f} ms  {n:6d}x {tag:3s} {key[:90]}")
    log("[profile] " + json.dumps({
        "wall_ms": wall_ms, "kernel_ms": busy, "ours": shares,
        "torch_ms": t_ms, "pre_scale_ms": p_ms, "pre_scale_launches": p_n,
        "card": card}))


# ---- phase 3k: the public numerics API and the paper's arithmetic --------

# the paper's Table I spot values (MSE, MAE, NMED, MRED) that
# benchmarks/table1_error.py:21-26 quotes
TABLE1_PAPER = {
    (8, "scalar", "L-1"): (0.103, 0.257, 20.4e-3, 10.5e-3),
    (8, "scalar", "L-2"): (0.089, 0.238, 19.6e-3, 9.2e-3),
    (16, "scalar", "L-2"): (0.024, 0.124, 9.9e-3, 4.3e-3),
    (32, "scalar", "L-2"): (0.026, 0.129, 8.9e-3, 3.9e-3),
}
TABLE1_GROUPS = ((8, "scalar"), (16, "scalar"), (16, "8_16"), (32, "scalar"),
                 (32, "8_16_32"))
TABLE1_N = 200_000
# gemma2-2b's gate/up weight (K, N) for the public API, and its down
# projection's (K, N) for the quire
API_KN = (2304, 9216)
QUIRE_KN = (9216, 2304)


def table1_point(width: int, variant: str, simd: str, device,
                 n: int = TABLE1_N, seed: int = 0) -> tuple[dict, dict]:
    """One Table I point as ``benchmarks/table1_error.py:33-50`` builds it:
    n operand pairs of magnitude 2^U(-4, 4) with random signs, the ILM
    product (``ilm_pair``; for R4BM the exact-posit product, f32) against
    the f64 product of the quantized operands.  Returns the four metrics
    and the benchmark's normalized ones (MSE / scale^2, MAE / scale)."""
    import numpy as np
    import torch
    from repro_torch.core import posit as P
    from repro_torch.core.engine import from_variant
    from repro_torch.core.logmult import ilm_pair
    from repro_torch.core.metrics import error_metrics
    cfg = from_variant(width, "L-2" if variant == "R4BM" else variant,
                       simd=simd)
    pc = cfg.posit
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(-4, 4, size=n)).astype(np.float32)
    a = torch.from_numpy((mag * rng.choice([-1, 1], n)).astype(np.float32))
    b = torch.from_numpy((np.exp2(rng.uniform(-4, 4, n))
                          * rng.choice([-1, 1], n)).astype(np.float32))
    a, b = a.to(device), b.to(device)
    qa, qb = P.quantize(a, pc), P.quantize(b, pc)
    exact = (qa.double() * qb.double()).float()
    approx = (qa * qb if variant == "R4BM" else
              ilm_pair(a, b, pc, cfg.stages, cfg.trunc, cfg.sublane))
    m = {k: float(v) for k, v in error_metrics(approx, exact).items()}
    scale = float(exact.abs().mean())
    norm = {"mse": m["mse"] / scale ** 2, "mae": m["mae"] / scale,
            "nmed": m["nmed"], "mred": m["mred"]}
    return m, norm


def phase_numerics(dev, gen, card: str, path_launches, logmac_kernel,
                   flops_cfg=None) -> dict:
    """Phase 3k on the card: (a) Table I, (b) ``numerics.use(...,
    backend="cuda")`` at gemma2-2b width, (c) the quire at K = 9216 through
    the decode kernel, (d) the model FLOPs of ``flops_cfg`` (gemma2-2b
    FULL).  Returns the launches of (b) and (c)."""
    import numpy as np
    import torch
    from repro_torch import numerics as NU
    from repro_torch.analysis import costmodel as CM
    from repro_torch.configs import gemma2_2b
    from repro_torch.core import posit as P
    from repro_torch.core import quire as Q
    from repro_torch.core.engine import (VARIANT_NAMES, EulerConfig,
                                         from_variant, operand_planes)
    from repro_torch.core.metrics import error_metrics
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import posit_codec as PC
    from repro_torch.kernels import ref as KR
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model

    # (a) Table I: the card against the port's CPU path
    log(f"[table1] {card}: n = {TABLE1_N} pairs, numpy seed 0; raw MSE MAE NMED "
        f"MRED, then the benchmark's normalized MSE MAE NMED MRED, the "
        f"paper's where Table I quotes them")
    for width, simd in TABLE1_GROUPS:
        for v in VARIANT_NAMES + ("R4BM",):
            got, norm = table1_point(width, v, simd, dev)
            want, _ = table1_point(width, v, simd, "cpu")
            for k in got:
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (
                    width, simd, v, k, got[k], want[k])
            paper = TABLE1_PAPER.get((width, simd, v))
            log(f"[table1] P{width} {simd:8s} {v:6s} raw "
                f"{got['mse']:.6g} {got['mae']:.6g} {got['nmed']:.6g} "
                f"{got['mred']:.6g} | normalized {norm['mse']:.5f} "
                f"{norm['mae']:.5f} {norm['nmed']:.5f} {norm['mred']:.5f}"
                + (f" | paper {paper}" if paper else ""))
    log("[table1] 45 points: the card's metrics within rtol 1e-5 of the "
        "CPU path's")

    # (b) the public API through the kernels at gemma2-2b's gate/up shape
    K, N = API_KN
    w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    cfgs = ([from_variant(16, v) for v in VARIANT_NAMES]
            + [from_variant(8, "L-21b"), from_variant(32, "L-21b"),
               from_variant(32, "L-1b"), from_variant(32, "L-21"),
               from_variant(16, "L-21b", simd="8_16"),
               from_variant(32, "L-21b", simd="8_16_32")])
    api_launches = dict.fromkeys(_build.LAUNCHES, 0)
    for M in (4, 128):
        x = torch.randn((M, K), generator=gen, device=dev)
        exact = x.double() @ w.double()
        for cfg in cfgs:
            what = f"P{cfg.width} {cfg.variant} {cfg.simd} M={M}"
            _build.reset_launches()
            with NU.use(cfg, backend="cuda"):
                y = NU.matmul(x, w)
            torch.cuda.synchronize()
            got = path_launches(f"api {what}")
            for k, n in got.items():
                api_launches[k] += n
            kern = logmac_kernel(M, N, K, cfg)
            assert (got["posit_encode_prescaled"], got["logmac"],
                    got[kern]) == (2, 1, 1), (what, got)
            with NU.use(cfg, backend="lax_ref"):
                ref = NU.matmul(x, w)
            va, ra = operand_planes(x, cfg)
            vb, rb = operand_planes(w, cfg)
            bound = 1e-5 * (va.abs() @ vb.abs() + ra.abs() @ rb.abs()) + 1e-4
            diff = (y - ref).abs()
            assert bool((diff <= bound).all()), f"api {what}: outside bound"
            m = {k: float(v) for k, v in error_metrics(y, exact).items()}
            log(f"[api] {card}: numerics.matmul {what} [{M}, {K}] x [{K}, "
                f"{N}] on cuda ({kern}): vs the f64 product MSE "
                f"{m['mse']:.4g} MAE {m['mae']:.4g} NMED {m['nmed']:.4g} "
                f"MRED {m['mred']:.4g}; vs lax_ref max |diff| "
                f"{float(diff.max()):.3g} (bound min "
                f"{float(bound.min()):.3g})")
            del y, ref, va, ra, vb, rb, bound, diff
    # out_quant (the output rounded to the posit format, ``posit_quantize``
    # without a scale): bit for bit the plain quantize of the same call's
    # unquantized output
    cfg = from_variant(16, "L-21b")
    with NU.use(cfg, backend="cuda"):
        y = NU.matmul(x, w)
    _build.reset_launches()
    with NU.use(cfg.replace(out_quant=True), backend="cuda"):
        yq = NU.matmul(x, w)
    torch.cuda.synchronize()
    got = path_launches("api out_quant")
    for k, n in got.items():
        api_launches[k] += n
    assert got["posit_quantize"] == 1, got
    want = PC.quantize_plain(y.float(), cfg.posit).to(yq.dtype)
    same = (yq.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(yq) & torch.isnan(want))
    assert bool(same.all()), "api out_quant: not the plain quantize's bits"
    log(f"[api] {card}: numerics.matmul P16 L-21b out_quant [{x.shape[0]}, "
        f"{K}] x [{K}, {N}] on cuda: bit-equal to the plain quantize of the "
        f"unquantized output; launches {got}")
    del w, x, exact, y, yq, want

    # (c) the quire at K = 9216 (the down projection), bposit16
    pc = from_variant(16, "L-21b").posit
    K, N = QUIRE_KN
    x = torch.randn((4, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    _build.reset_launches()
    wa, _ = OPS.encode_prescaled(x, pc)
    wb, _ = OPS.encode_prescaled(w, pc)
    va, vb = OPS.decode(wa, pc), OPS.decode(wb, pc)
    f32 = KR.ref_exact_posit_mac(wa, wb, pc)
    torch.cuda.synchronize()
    quire_launches = path_launches("quire")
    assert quire_launches["posit_decode"] == 4, quire_launches
    for v, words in ((va, wa), (vb, wb)):
        want = KR.ref_decode(words.cpu(), pc)
        assert torch.equal(v.cpu().view(torch.int32), want.view(torch.int32))
    rows = torch.randint(0, 4, (32,), generator=gen, device=dev)
    cols = torch.randint(0, N, (32,), generator=gen, device=dev)
    prods = va[rows] * vb[:, cols].T                          # [32, K] f32
    kah = Q.kahan_sum(prods, -1).cpu()
    chk = Q.chunked_sum(prods, -1, chunk=256).cpu()
    f32s = f32[rows, cols].cpu()
    wa_c, wb_c = wa.cpu().numpy(), wb.cpu().numpy()
    dev_f32, dev_kah, dev_chk, same_word = [], [], [], 0
    for s, (i, j) in enumerate(zip(rows.tolist(), cols.tolist())):
        exact = Q.np_quire_dot(wa_c[i], wb_c[:, j], pc)
        scale = float(abs(exact)) + 1e-3
        for dl, got in ((dev_f32, f32s), (dev_kah, kah), (dev_chk, chk)):
            dl.append(abs(float(got[s]) - float(exact)) / scale)
        same_word += (P.np_encode(float(f32s[s]), pc)
                      == Q.np_quire_round(exact, pc))
    rk = np.sqrt(K)
    for name, dl, tol in (("ref_exact_posit_mac f32", dev_f32, 1e-4),
                          ("kahan_sum", dev_kah, 1e-5),
                          ("chunked_sum", dev_chk, 1e-4)):
        assert max(dl) < tol * rk, (name, max(dl), tol * rk)
        log(f"[quire] {card}: bposit16 K = {K}, 32 outputs: {name} relative "
            f"deviation from the exact quire max {max(dl):.3g} median "
            f"{float(np.median(dl)):.3g} (bar {tol * rk:.3g})")
    log(f"[quire] decode kernel bit-equal to ref_decode on [4, {K}] and "
        f"[{K}, {N}]; {same_word} of 32 f32 results round to the exact "
        f"quire's posit word; launches {quire_launches}")
    del x, w, wa, wb, va, vb, f32, prods
    torch.cuda.empty_cache()

    # (d) model FLOPs of gemma2-2b FULL: one 128-token prefill at batch 1
    full = flops_cfg or gemma2_2b.FULL
    exact_ctx = NU.NumericsContext.from_ecfg(EulerConfig(mode="exact"),
                                             backend="exact")
    m = Model(full, numerics=exact_ctx, device=dev)
    params = m.init(0)
    ids = torch.randint(0, full.vocab, (1, 128), generator=gen, device=dev)

    def prefill(model, ctx):
        h, _ = model.forward(params, ids, ctx)
        return model.head(params, h, ctx)

    with torch.no_grad():
        cost = CM.analyze(prefill, m, Ctx(numerics=exact_ctx))
        cuda_ctx = NU.NumericsContext.from_ecfg(from_variant(16, "L-21b"),
                                                backend="cuda")
        mc = Model(full, numerics=cuda_ctx, device=dev)
        secs = []
        for _ in range(4):      # the first call is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(mc, Ctx(numerics=cuda_ctx))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    s = float(np.median(secs[1:]))
    fl, tr = cost["dot_flops"], cost["dot_traffic"]
    log(f"[flops] {card}: {full.name} prefill of 128 tokens (forward + "
        f"head), counted on exact: dot_flops {fl:.6g}, dot_traffic {tr:.6g} "
        f"B, ew_flops {cost['ew_flops']:.6g}, {cost['dots']} dots; on cuda "
        f"L-21b median {s * 1e3:.2f} ms of {[round(t * 1e3, 2) for t in secs[1:]]}"
        f": {fl / s / 1e12:.4g} TFLOP/s = {fl / s / FP16_FLOPS:.4%} of "
        f"989 TFLOP/s (fp16) and {fl / s / FP32_FLOPS:.4%} of 67 TFLOP/s "
        f"(f32); {tr / s / 1e12:.4g} TB/s = {tr / s / HBM_BYTES_PER_S:.4%} "
        f"of 3.35 TB/s")
    log("[flops] " + json.dumps({"card": card, "arch": full.name,
                                 "tokens": 128, **cost, "cuda_s": secs}))
    del m, mc, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: api_launches[k] + quire_launches[k] for k in api_launches}


def dots_remat_step(dev, card: str, ecfg) -> None:
    """Phase 3g's remat check on hymba-1.5b FULL: one L-21b gradient step
    (batch 2 x seq 128, the launcher's first batch and initial state) under
    remat policy "nothing", then under "dots"; the loss and every gradient
    leaf bit-equal, each step's seconds and peak memory printed."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import hymba_1p5b
    from repro_torch.data import SyntheticLM, batch_for_step
    from repro_torch.launch.train import deterministic
    from repro_torch.models.transformer import Model
    from repro_torch.numerics import NumericsContext
    cfg = hymba_1p5b.FULL
    nctx = NumericsContext.from_ecfg(ecfg, backend="lax_ref")
    params = Model(cfg, numerics=nctx, device=dev).init(0)
    batch = batch_for_step(SyntheticLM(vocab=cfg.vocab, seed=0), 0, 2, 128,
                           device=dev)
    out = {}
    with deterministic():
        for policy in ("nothing", "dots"):
            m = Model(cfg, numerics=nctx, remat_policy=policy, device=dev)
            p = T.map(lambda t: t.detach().requires_grad_(True), params)
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss, _ = m.loss(p, batch, m.make_ctx())
            grads = torch.autograd.grad(loss, T.leaves(p), allow_unused=True)
            torch.cuda.synchronize(dev)
            out[policy] = (loss.detach(), grads, time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated(dev) - held)
            del p, m
    (l0, g0, s0, m0), (l1, g1, s1, m1) = out["nothing"], out["dots"]
    assert torch.equal(l0, l1), (float(l0), float(l1))
    for i, (a, b) in enumerate(zip(g0, g1)):
        assert (a is None) == (b is None), i
        assert a is None or torch.equal(a, b), f"gradient leaf {i} differs"
    log(f"[remat dots] {card}: hymba-1.5b FULL L-21b lax_ref, batch 2 x 128, "
        f"one loss + gradient: loss {float(l0)!r} and all {len(g0)} "
        f"gradient leaves bit-equal under 'dots' and 'nothing'; 'nothing' "
        f"{s0:.2f} s, peak {m0 / 2**30:.2f} GiB above the params; 'dots' "
        f"{s1:.2f} s, peak {m1 / 2**30:.2f} GiB")
    del out, g0, g1, params
    gc.collect()
    torch.cuda.empty_cache()


# ---- phase 3l: the multi-device path on one card --------------------------
# NCCL refuses two ranks on one GPU, so the ranks are gloo processes, each
# computing on cuda:0 (gloo of the card's PyTorch takes CUDA tensors for
# every collective the port issues, so the port stages nothing itself;
# gloo copies them through host memory inside each collective).  The parent builds the kernels (phase 1) before any rank
# starts.  (a) the compressed all-reduce over 4 ranks; (b) gemma2-2b FULL
# forward on `cuda`, DP_BATCH split over 2 data ranks, against the
# parent's one-process forward; (c) a data-parallel train step of
# hymba-1.5b at full width, cut to HYMBA_DP_LAYERS, on `lax_ref`, against
# the one-process step; (d) one llama4-scout MoE block at full width,
# expert parallel on (data, model) = (1, 2) and (2, 2), the ZeRO-3 gather.
DP_BATCH = (4, 128)
# (c)'s depth: hymba-1.5b holds about 48 M parameters a layer, 20 bytes
# each in a step (parameters, gradients, AdamW's two moments, the new
# parameters).  At 16 layers a rank peaked at 27.92 GiB, rank 0's
# one-process references included (PERF.md, 3l): about 1.6 GiB a layer,
# so two ranks of 20 layers take about 69 of the card's 79 GiB and 24
# would not fit; 20 took about 240 s with the rest of 3l; 6 keep the
# whole run, 3l(e) included, within the last slice's time
HYMBA_DP_LAYERS = 6
EP_TOKENS = (4, 128)
RANKS_DIR = os.path.join(HERE, "build", "chip_smoke_ranks")


def _rank_entry(rank, world, store, fn, args, out_dir):
    """One gloo rank on cuda:0: exact f32, deterministic, ``fn``'s result
    saved for the parent."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import pin_exact_f32
    from repro_torch.launch.train import deterministic
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    pin_exact_f32()
    try:
        with deterministic():
            out = fn(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks on the card; the
    ranks' results in rank order.  The processes end with the call."""
    import torch
    import torch.multiprocessing as mp
    shutil.rmtree(RANKS_DIR, ignore_errors=True)
    os.makedirs(RANKS_DIR)
    try:
        mp.spawn(_rank_entry, args=(world, os.path.join(RANKS_DIR, "store"),
                                    fn, args, RANKS_DIR),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(RANKS_DIR, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(RANKS_DIR, ignore_errors=True)


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _l21b(backend: str, **kw):
    from repro_torch.core.engine import from_variant
    from repro_torch.numerics import NumericsContext
    return NumericsContext.from_ecfg(from_variant(16, "L-21b", **kw),
                                     backend=backend)


class _Checks(list):
    """Each logmac launch's max |diff| from its plain version; ``split``
    counts the split encodes held against theirs; ``stacked`` (a list in a
    data rank) the logmac calls replayed with every rank's rows stacked;
    ``columns`` (a list where ``column_group`` is a model group) the
    column-parallel calls replayed with the whole weight."""

    def __init__(self, stacked: bool = False, column_group=None):
        super().__init__()
        self.split = []
        self.stacked = [] if stacked else None
        self.column_group = column_group
        self.columns = []


def recording(bound_checks: _Checks | None = None, moved: list | None = None):
    """A context that records every pow2 pre-scale, [(kind, scale)] in
    call order (the fused encode's ``s`` and the reference engine's), and
    with ``bound_checks`` holds each logmac launch against its plain
    version within the per-element bound, appending the max |diff|, and
    each split encode (an operand whose rows are split over a group)
    against its plain version bit for bit.  With ``bound_checks.stacked``,
    replays each logmac call with every rank's rows stacked in rank order
    (the one-process call's shape) and holds this rank's rows of it to the
    rank's own result bit for bit.  With ``bound_checks.column_group``,
    replays each call that computes a block of a product's columns
    (``logmac.column_block``) with the whole weight gathered over that
    group and holds this rank's columns of it to the rank's own result bit
    for bit.  The replays' launches are not counted.
    With ``moved``, appends for each engine pre-scale taken over a group
    whether the rank's own rows alone would give another."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core import posit as P
    from repro_torch.kernels import logmac as LM
    from repro_torch.kernels import posit_codec as PC

    split_checked = [] if bound_checks is None else bound_checks.split

    @contextlib.contextmanager
    def ctx():
        rec = []
        enc, p2, lm = PC.posit_encode_prescaled, E._pow2_scale, LM.logmac

        def enc_spy(x, pc, pre_scale=True, group=None):
            w, s = enc(x, pc, pre_scale, group)
            rec.append(("encode", float(s)))
            if bound_checks is not None and group is not None:
                # the split entry against its plain version, same group
                s2 = p2(x, group)
                assert float(s2) == float(s), "split encode's scale"
                assert torch.equal(PC.encode_plain(
                    P.flushed_quotient(x, s2), pc), w), \
                    "split encode's words"
                split_checked.append(1)
            return w, s

        def p2_spy(x, group=None):
            s = p2(x, group)
            rec.append(("engine", float(s)))
            if moved is not None and group is not None:
                moved.append(float(p2(x)) != float(s))
            return s

        def lm_spy(a, b, ecfg):
            out = lm(a, b, ecfg)
            worst = 0.0
            va, ra = LM.decode_planes(a, ecfg)
            for c0 in range(0, b.shape[1], 16384):
                bc = b[:, c0:c0 + 16384]
                vb, rb = LM.decode_planes(bc, ecfg)
                want = LM.logmac_plain(a, bc, ecfg)
                bound = (1e-5 * (va.abs() @ vb.abs() + ra.abs() @ rb.abs())
                         + 1e-4)
                diff = (out[:, c0:c0 + 16384] - want).abs()
                assert bool((diff <= bound).all()), "logmac outside bound"
                worst = max(worst, float(diff.max()))
            bound_checks.append(worst)
            parts = getattr(LM._COLUMNS, "parts", 1)
            if bound_checks.stacked is not None:
                import torch.distributed as dist
                M, world = a.shape[0], dist.get_world_size()
                rows = torch.empty((world * M, a.shape[1]), dtype=a.dtype,
                                   device=a.device)
                dist.all_gather_into_tensor(rows, a.contiguous())
                with _uncounted():
                    whole = lm(rows, b, ecfg)
                r0 = dist.get_rank() * M
                assert torch.equal(whole[r0:r0 + M].view(torch.int32),
                                   out.view(torch.int32)), (
                    f"logmac [{M}, {a.shape[1]}] x {list(b.shape)}: this "
                    f"rank's rows differ in the {world * M}-row call")
                bound_checks.stacked.append(world * M)
            if bound_checks.column_group is not None and parts > 1:
                import torch.distributed as dist
                g = bound_checks.column_group
                blocks = [torch.empty_like(b) for _ in range(parts)]
                dist.all_gather(blocks, b.contiguous(), group=g)
                with _uncounted(), LM.column_block(1):
                    whole = lm(a, torch.cat(blocks, 1).contiguous(), ecfg)
                c0 = dist.get_rank(g) * b.shape[1]
                assert torch.equal(
                    whole[:, c0:c0 + b.shape[1]].view(torch.int32),
                    out.view(torch.int32)), (
                    f"logmac [{a.shape[0]}, {a.shape[1]}] x {list(b.shape)}"
                    f": this rank's columns differ in the whole product")
                bound_checks.columns.append(tuple(b.shape))
            return out

        PC.posit_encode_prescaled, E._pow2_scale = enc_spy, p2_spy
        if bound_checks is not None:
            LM.logmac = lm_spy
        try:
            yield rec
        finally:
            PC.posit_encode_prescaled, E._pow2_scale, LM.logmac = enc, p2, lm
    return ctx()


@contextlib.contextmanager
def _uncounted():
    """Launches made inside are taken off the counts again."""
    from repro_torch.kernels import _build
    counts = ({k: dict(v) for k, v in _build.WIDTH_LAUNCHES.items()},
              dict(_build.LAUNCHES))
    try:
        yield
    finally:
        for k, v in counts[0].items():
            _build.WIDTH_LAUNCHES[k].clear()
            _build.WIDTH_LAUNCHES[k].update(v)
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(counts[1])


@contextlib.contextmanager
def replaying(rec):
    """The reference engine's pow2 pre-scales taken from ``rec`` (a
    :func:`recording` of the same code path, in call order), each once,
    in place of the operands' own."""
    import torch
    from repro_torch.core import engine as E
    p2, used = E._pow2_scale, [0]

    def replay(x, group=None):
        assert group is None and used[0] < len(rec), "more pre-scales"
        kind, s = rec[used[0]]
        assert kind == "engine"
        used[0] += 1
        return torch.tensor(s, dtype=torch.float32, device=x.device)
    E._pow2_scale = replay
    try:
        yield
    finally:
        E._pow2_scale = p2
    assert used[0] == len(rec), "fewer pre-scales than recorded"


def gemma_forward(model, params, ids, ctx, bound_checks=None):
    """(logits, pre-scales, launches) of one no-grad forward + head."""
    import torch
    from repro_torch.kernels import _build
    _build.reset_launches()
    with torch.no_grad(), recording(bound_checks) as rec:
        hidden, _ = model.forward(params, ids, ctx)
        logits = model.head(params, hidden, ctx)
    torch.cuda.synchronize()
    return logits, rec, dict(_build.LAUNCHES)


def compressed_rank(rank, world):
    """(a): this rank's row through compressed_psum/pmean on the card and
    on the CPU (same group), and the exact sum."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    x = np.random.default_rng(0).normal(size=(world, 4100)).astype(
        np.float32)
    g = dist.group.WORLD
    out = {}
    for name, fn in (("psum", C.compressed_psum),
                     ("pmean", C.compressed_pmean)):
        xl = torch.from_numpy(x[rank:rank + 1])
        got = fn(xl.cuda(), g)
        cpu = fn(xl, g)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), cpu), f"{name}: card != CPU"
        exact = x.sum(0, keepdims=True) / (world if name == "pmean" else 1)
        rel = float(np.abs(got.cpu().numpy() - exact).max()
                    / (np.abs(exact).max() + 1e-9))
        assert rel < 0.02, (name, rel)
        out[name] = rel
    return out


def ranks_of_two(rank, world, ids_np, ep_x_seed):
    """(b), (c), (d) and (e) on (1, 2) in one pair of ranks, one after
    the other, each freeing the card before the next."""
    out = {"b": dp_forward_rank(rank, ids_np)}
    _free()
    out["c"] = dp_train_rank(rank)
    _free()
    out["d"] = ep_rank(rank, (1, 2), {"pre": ({}, {}),
                                      "nopre": ({"pre_scale": False}, {})},
                       ep_x_seed)
    _free()
    out["e"] = placed_rank(rank, ids_np)
    return out


# 3l(e): the prompt [batch, tokens] and the greedy decode steps after it
PLACED_PROMPT = (4, 16)
PLACED_STEPS = 8


def layer0_model(cfg, numerics):
    """3l(e)'s layer 0 of ``cfg`` with float32 activations, under
    ``numerics``."""
    from repro_torch.models.transformer import Model
    c1 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    return Model(c1, numerics=numerics, device="cuda")


def placed_serve(model, params, ids, ctx, layer0, checks=None):
    """Layer 0's forward and the head on it (``layer0``: the 1-layer
    model of :func:`layer0_model`) with its pre-scales recorded, then a
    prefill of ``ids`` and ``PLACED_STEPS`` greedy decode steps on a
    dense cache: (layer 0's output and its logits, its pre-scales, the
    logmac weight shapes it ran, the final logits, the tokens, the
    launches of the serve, seconds)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels import _build
    from repro_torch.kernels import logmac as LM
    cfg = model.cfg
    B, Tn = ids.shape
    shapes, lm = [], LM.logmac

    def spy(a, b, ecfg):
        shapes.append(tuple(b.shape))
        return lm(a, b, ecfg)
    p0 = {"embed": params["embed"], "layers": params["layers"][:1],
          "ln_f": params["ln_f"]}
    LM.logmac = spy
    try:
        with torch.no_grad():
            with recording(checks) as rec:
                hidden, _ = layer0.forward(p0, ids, ctx)
            # the head's scales, not its checks: the plain encode of a
            # [2304, 128000] block takes ~20 GiB of int64 temporaries
            with recording() as rec_head:
                h0 = layer0.head(p0, hidden, ctx)
    finally:
        LM.logmac = lm
    cache = model.init_cache(B, Tn + PLACED_STEPS,
                             mesh=ctx.mesh if ctx.placed else None)
    _build.reset_launches()
    t0 = time.perf_counter()
    toks = []
    with torch.no_grad():
        logits, cache = model.prefill(params, ids, ctx, cache)
        for i in range(PLACED_STEPS):
            tok = logits[:, :cfg.vocab].argmax(-1)
            toks.append(tok.cpu())
            logits, cache = model.decode_step(
                params, tok, torch.tensor(Tn + i, dtype=torch.int32,
                                          device=ids.device), cache, ctx)
    torch.cuda.synchronize()
    return {"out0": hidden.float().cpu(), "h0": h0.float().cpu(),
            "scales": rec + rec_head,
            "shapes": sorted(set(shapes)),
            "logits": logits.cpu(), "tokens": torch.stack(toks, 1),
            "launches": dict(_build.LAUNCHES),
            "s": time.perf_counter() - t0,
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in T.leaves(cache))}


def placed_rank(rank, ids_np):
    """(e): gemma2-2b FULL under the production placement on a (1, 2)
    mesh on ``cuda``: the rank's blocks of the seeded parameters and of
    the dense cache, layer 0's forward and a prefill + greedy decode."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import gemma2_2b
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model
    cfg = gemma2_2b.FULL
    mesh = make_mesh((1, 2), ("data", "model"))
    model = Model(cfg, numerics=_l21b("cuda"), device="cuda")
    layer0 = layer0_model(cfg, model.numerics)
    whole = model.init(0)
    specs = SH.params_pspecs(whole, mesh)
    want_bytes = sum(
        math.prod(SH.local_shape(x.shape, sp, mesh)) * x.element_size()
        for x, sp in zip(T.leaves(whole), SH.shardings_in_order(whole,
                                                                specs)))
    params = T.map(lambda t: t.clone(), SH.place(whole, specs, mesh))
    del whole
    _free()
    ids = torch.from_numpy(ids_np[:PLACED_PROMPT[0],
                                  :PLACED_PROMPT[1]]).cuda()
    ctx = Ctx(numerics=model.numerics, mesh=mesh, placement="production")
    torch.cuda.reset_peak_memory_stats()
    checks = _Checks(column_group=ctx.model_group)
    out = placed_serve(model, params, ids, ctx, layer0, checks)
    cache = model.init_cache(*PLACED_PROMPT[:1],
                             PLACED_PROMPT[1] + PLACED_STEPS, device="meta")
    out.update({
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in T.leaves(params)),
        "want_param_bytes": want_bytes,
        "want_cache_bytes": sum(
            math.prod(SH.local_shape(x.shape, sp, mesh)) * x.element_size()
            for x, (_, sp) in zip(T.leaves(cache), SH.shardings_in_order(
                cache, SH.cache_shardings(mesh, cache)))),
        "bound_checks": len(checks), "worst": max(checks),
        "split_checked": len(checks.split),
        "columns": sorted(set(checks.columns)),
        "column_checks": len(checks.columns),
        "peak": torch.cuda.max_memory_allocated(),
        "total_memory": torch.cuda.get_device_properties(0).total_memory})
    return out


def ranks_of_four(rank, world, ep_x_seed):
    import torch
    out = {"a": compressed_rank(rank, world)}
    out["d"] = ep_rank(rank, (2, 2), {
        "ep": ({}, {}), "fsdp": ({}, {"moe_fsdp": True}),
        "fsdp_bf16": ({}, {"moe_fsdp": True,
                           "moe_gather_dtype": torch.bfloat16})}, ep_x_seed)
    return out


def dp_forward_rank(rank, ids_np):
    """(b): gemma2-2b FULL on `cuda` over a 2-rank data mesh, rank 0's
    parameters broadcast (rank 1 draws others first)."""
    import torch
    from repro_torch.configs import gemma2_2b
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model
    from repro_torch.training import rank_rows
    model = Model(gemma2_2b.FULL, numerics=_l21b("cuda"), device="cuda")
    params = model.init(rank)
    mesh = make_mesh((2,), ("data",))
    ctx = Ctx(numerics=model.numerics, mesh=mesh)
    C.reset_bytes()
    t0 = time.perf_counter()
    C.broadcast_tree(params)
    torch.cuda.synchronize()
    bcast_s = time.perf_counter() - t0
    ids = rank_rows({"ids": torch.from_numpy(ids_np).cuda()}, ctx)["ids"]
    C.reset_bytes()
    checks = _Checks(stacked=True)
    t0 = time.perf_counter()
    logits, rec, launches = gemma_forward(model, params, ids, ctx, checks)
    return {"logits": logits.cpu(), "scales": rec, "launches": launches,
            "bound_checks": len(checks), "worst": max(checks),
            "stacked": sorted(set(checks.stacked)),
            "stacked_checks": len(checks.stacked),
            "split_checked": len(checks.split),
        "columns": sorted(set(checks.columns)),
        "column_checks": len(checks.columns),
            "bytes": dict(C.BYTES), "bcast_s": bcast_s,
            "forward_s": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated()}


def spiky_rows(params, batch, vocab: int) -> dict:
    """``batch`` with row 0 on the lower half of the vocabulary and row 1
    on the upper half, whose embedding rows (changed in place) keep 4 of
    d values and shrink the rest by 2^-12: after the norms the two rows'
    activations take different local pre-scales, as in
    ``tests/test_torch_dp_train.py``."""
    import torch
    half = vocab // 2
    with torch.no_grad():
        params["embed"]["e"][half:, 4:] *= 2.0 ** -12
    out = {}
    for k, v in batch.items():
        v = v % half
        v[1:] += half
        out[k] = v
    return out


def dp_train_rank(rank):
    """(c): hymba-1.5b at full width, HYMBA_DP_LAYERS deep, one data-
    parallel step on `lax_ref` over 2 ranks, each holding one row of a
    :func:`spiky_rows` batch; rank 0 then takes the one-process loss and
    gradients of the global batch, whole and as two micro-batches of the
    ranks' rows."""
    import dataclasses
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import hymba_1p5b
    from repro_torch.data import SyntheticLM, batch_for_step
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW
    from repro_torch.training import (broadcast_state, init_state,
                                      make_train_step, rank_rows, sync_grads)
    cfg = dataclasses.replace(hymba_1p5b.FULL, n_layers=HYMBA_DP_LAYERS)
    model = Model(cfg, numerics=_l21b("lax_ref"), device="cuda")
    opt = AdamW(lr=1e-4, weight_decay=0.01)
    mesh = make_mesh((2,), ("data",))
    ctx = Ctx(numerics=model.numerics, mesh=mesh)
    state = broadcast_state(init_state(model, opt, rank))
    batch = spiky_rows(state.params, batch_for_step(
        SyntheticLM(vocab=cfg.vocab, seed=0), 0, 2, 128, device="cuda"),
        cfg.vocab)
    local = rank_rows(batch, ctx)
    torch.cuda.reset_peak_memory_stats()
    C.reset_bytes()
    leaves = T.leaves(state.params)
    moved = []
    # the forward's pre-scales and those of remat's recomputation
    with recording(moved=moved) as scales:
        loss, _ = model.loss(state.params, local, ctx)
        grads = torch.autograd.grad(loss, leaves)
    grads = T.leaves(sync_grads(T.unflatten(state.params, list(grads)),
                                ctx))
    grad_bytes = dict(C.BYTES)
    step_fn = make_train_step(model, opt, ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, metrics = step_fn(state, local)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    out = {"loss": float(loss.detach()),
           "step_loss": float(metrics["loss"]), "scales": scales,
           "moved": sum(moved), "step_s": step_s,
           "peak": torch.cuda.max_memory_allocated(),
           "grad_bytes": grad_bytes, "leaves": len(leaves)}
    del new, metrics
    if rank != 0:
        return out
    one = Ctx(numerics=model.numerics)

    def rel(g, w):
        return float((g.double() - w.double()).norm()
                     / max(float(w.double().norm()), 1e-30))
    # the one-process step on the whole batch: products of 256 rows
    with recording() as whole_scales:
        whole_loss, _ = model.loss(state.params, batch, one)
        whole = torch.autograd.grad(whole_loss, leaves)
    out["whole_scales"] = whole_scales
    out["whole_loss"] = float(whole_loss.detach())
    out["whole_rels"] = [rel(g, w) for g, w in zip(grads, whole)]
    del whole
    # the one-process step as two micro-batches of 128 rows (the ranks'
    # product shapes), grad_accum's sum and mean, each micro-batch with
    # the whole batch's pre-scales, which the ranks take over the group
    acc = [torch.zeros_like(p) for p in leaves]
    acc_loss = torch.zeros((), device="cuda")
    for i in range(2):
        with replaying(scales):
            mb_loss, _ = model.loss(state.params,
                                    {k: v[i:i + 1] for k, v in batch.items()},
                                    one)
            mb = torch.autograd.grad(mb_loss, leaves)
        acc = [a + g for a, g in zip(acc, mb)]
        acc_loss = acc_loss + mb_loss.detach()
        del mb
    out["ref_loss"] = float(acc_loss / 2)
    out["rels"] = [rel(g, a / 2) for g, a in zip(grads, acc)]
    out["paths"] = [T.keystr(pth) for pth, _ in
                    T.leaves_with_path(state.params)]
    out["ref_peak"] = torch.cuda.max_memory_allocated()
    # cuBLAS's f32 product of 128 rows against the first 128 of 256
    a = torch.randn((1, 256, cfg.d_model), device="cuda")
    w = torch.randn((1, cfg.d_model, cfg.d_ff), device="cuda")
    out["rows_equal"] = bool(torch.equal(torch.bmm(a[:, :128], w),
                                         torch.bmm(a, w)[:, :128]))
    return out


def ep_block(seed: int):
    """One llama4-scout MoE block's parameters and tokens at full width,
    drawn on the card from ``seed``."""
    import torch
    from repro_torch.configs import llama4_scout_17b_a16e as L4
    from repro_torch.models.layers import moe_init
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    p = moe_init(gen, L4.FULL, "cuda")
    x = torch.randn(EP_TOKENS + (L4.FULL.d_model,), generator=gen,
                    device="cuda")
    return p, x


def ep_rank(rank, shape, runs, seed):
    """(d): the block expert parallel on a (data, model) mesh of
    ``shape``, per run (numerics knobs, Ctx knobs): this rank's output
    rows, aux, the collectives' bytes and seconds."""
    import torch
    from repro_torch.configs import llama4_scout_17b_a16e as L4
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx, moe_apply
    from repro_torch.training import rank_rows
    p, x = ep_block(seed)
    # every rank holds the whole tree, as the launcher places it; the
    # expert stacks (8.05 GB) in host memory, so four ranks fit the card:
    # the block copies its own experts over
    for n in ("wi", "wg", "wo"):
        p[n]["w"] = p[n]["w"].cpu()
    _free()
    mesh = make_mesh(shape, ("data", "model"))
    out = {}
    for name, (nkw, ckw) in runs.items():
        ctx = Ctx(numerics=_l21b("cuda", **nkw), mesh=mesh, **ckw)
        xl = rank_rows({"x": x}, ctx)["x"]
        C.reset_bytes()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            y, aux = moe_apply(p, xl, ctx, L4.FULL)
        torch.cuda.synchronize()
        out[name] = {"y": y.cpu(), "aux": float(aux),
                     "bytes": dict(C.BYTES),
                     "s": time.perf_counter() - t0,
                     "peak": torch.cuda.max_memory_allocated()}
        del y
        _free()
    return out


def phase_multi_device(card: str, path_launches) -> dict:
    """Phase 3l; returns the launches the ranks' driven paths made."""
    import numpy as np
    import torch
    from repro_torch.configs import gemma2_2b, llama4_scout_17b_a16e as L4
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import _build
    from repro_torch.models.layers import Ctx, moe_apply
    from repro_torch.models.transformer import Model
    from repro_torch.launch.mesh import HW
    log(f"[multi-device] {card}: HW {dict(HW, hbm_bytes=HW['hbm_bytes'])}")
    seed = 7
    ids = np.random.default_rng(0).integers(
        0, gemma2_2b.FULL.vocab, size=DP_BATCH).astype(np.int64)
    # the one-process references, before any rank holds the card
    model = Model(gemma2_2b.FULL, numerics=_l21b("cuda"), device="cuda")
    params = model.init(0)
    ref_logits, ref_scales, ref_launch = gemma_forward(
        model, params, torch.from_numpy(ids).cuda(), Ctx(
            numerics=model.numerics))
    ref_logits = ref_logits.cpu()
    # (e)'s one-process run: layer 0 and the prefill + decode
    layer0 = layer0_model(gemma2_2b.FULL, model.numerics)
    ref_e = placed_serve(model, params, torch.from_numpy(
        ids[:PLACED_PROMPT[0], :PLACED_PROMPT[1]]).cuda(),
        Ctx(numerics=model.numerics), layer0)
    del model, params, layer0
    _free()
    p, x = ep_block(seed)
    ep_ref = {}
    for name, kw in (("pre", {}), ("nopre", {"pre_scale": False})):
        with torch.no_grad():
            y, aux = moe_apply(p, x, Ctx(numerics=_l21b("cuda", **kw)),
                               L4.FULL)
        ep_ref[name] = (y.cpu(), float(aux))
    del p, x, y
    _free()

    t0 = time.perf_counter()
    two = run_ranks(ranks_of_two, 2, ids, seed)
    t_two = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = run_ranks(ranks_of_four, 4, seed)
    t_four = time.perf_counter() - t0

    # (a)
    log(f"[multi-device a] {card}: compressed_psum / pmean over 4 gloo "
        f"ranks on CUDA tensors bit-equal to the same calls on CPU tensors;"
        f" relative error against the exact sum (bar 0.02): "
        f"{[round(r['a']['psum'], 6) for r in four]} / "
        f"{[round(r['a']['pmean'], 6) for r in four]}")
    # (b)
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    b = [r["b"] for r in two]
    vocab = gemma2_2b.FULL.vocab
    got = torch.cat([r["logits"] for r in b])
    for r in b:
        assert r["scales"] == ref_scales, "a data rank's pre-scale differs"
        for k, v in r["launches"].items():
            launches[k] += v
        assert r["launches"]["posit_encode_prescaled"] > 0
        assert r["launches"]["logmac"] > 0
        assert r["split_checked"] > 0
        assert r["stacked_checks"] == r["bound_checks"] > 0
    diff = float((got - ref_logits).abs().max())
    agree = float((got[..., :vocab].argmax(-1)
                   == ref_logits[..., :vocab].argmax(-1)).float().mean())
    kinds = {k: sum(1 for kk, _ in ref_scales if kk == k)
             for k in ("encode", "engine")}
    log(f"[multi-device b] {card}: gemma2-2b FULL forward on cuda, batch "
        f"{DP_BATCH} split 2 + 2 over 2 data ranks: {len(ref_scales)} "
        f"pre-scales ({kinds['encode']} fused encodes, {kinds['engine']} "
        f"on the reference engine) bit-equal to the one-process forward's;"
        f" {b[0]['bound_checks']} logmac contractions a rank within the "
        f"per-element bound (max |diff| {max(r['worst'] for r in b):.3g}),"
        f" {b[0]['split_checked']} split encodes a rank (scale and words) "
        f"bit-equal to their plain version over the group; each rank's "
        f"rows of its {b[0]['stacked_checks']} logmac calls bit-equal to the "
        f"same rows of the call with both ranks' rows stacked (M "
        f"{b[0]['stacked']});"
        f" logits max |diff| {diff:.4g}, argmax agreement {agree:.4f} over "
        f"26 layers (before the row-count-free split: 0.1112 and "
        f"0.9668; attention's batched contractions still run cuBLAS on the "
        f"reference engine); rank 0's launches {b[0]['launches']}, one-process "
        f"{ref_launch}; collective bytes a rank {b[0]['bytes']}; "
        f"broadcast of the parameters {b[0]['bcast_s']:.2f} s; forward "
        f"(with the checks) {[round(r['forward_s'], 2) for r in b]} s; "
        f"peak {[round(r['peak'] / 2**30, 2) for r in b]} GiB")
    # (c)
    c = [r["c"] for r in two]
    c0 = c[0]
    assert c0["loss"] == c[1]["loss"], "the ranks' global losses differ"
    assert c0["scales"] == c[1]["scales"], "the ranks' pre-scales differ"
    assert c0["scales"] == c0["whole_scales"], \
        "a data rank's pre-scale differs from the whole batch's"
    moved = [r["moved"] for r in c]
    assert sum(moved) > 0, "no operand's local pre-scale differs"
    # the bars where the products have the ranks' shapes: cuBLAS's f32
    # order depends on the row count (rows_equal), and hymba's bfloat16
    # activations turn a last-bit difference into a bf16 ulp
    rel_loss = abs(c0["loss"] - c0["ref_loss"]) / abs(c0["ref_loss"])
    worst = max(c0["rels"])
    whole_loss = abs(c0["loss"] - c0["whole_loss"]) / abs(c0["whole_loss"])
    order = sorted(range(len(c0["rels"])), key=lambda i: -c0["whole_rels"][i])
    log(f"[multi-device c] worst gradient leaves against the whole-batch "
        f"step (relative L2): " + "; ".join(
            f"{c0['paths'][i]} {c0['whole_rels'][i]:.3g}" for i in order[:6])
        + f"; median {sorted(c0['whole_rels'])[len(order) // 2]:.3g}")
    log(f"[multi-device c] {card}: hymba-1.5b at full width, "
        f"{HYMBA_DP_LAYERS} of 32 layers, lax_ref, global batch 2 x 128 "
        f"over 2 data ranks, the rows on spiky embeddings: "
        f"{len(c0['scales'])} pre-scales a rank (forward and remat) "
        f"bit-equal to the one-process whole batch's, {moved} a rank "
        f"where the rank's rows alone give another; against the "
        f"one-process step as two 128-row micro-batches: loss "
        f"{c0['loss']!r} against {c0['ref_loss']!r} (relative "
        f"{rel_loss:.3g}, bar 1e-06), {c0['leaves']} gradient leaves, max "
        f"relative L2 {worst:.3g} (bar 0.001); against the whole-batch "
        f"step (256-row products; cuBLAS's product of 128 rows equal to "
        f"the first 128 of 256: {c0['rows_equal']}): loss relative "
        f"{whole_loss:.3g}, max leaf {max(c0['whole_rels']):.3g}; step "
        f"{[round(r['step_s'], 2) for r in c]} s/step, peak "
        f"{[round(r['peak'] / 2**30, 2) for r in c]} GiB a rank (rank 0 "
        f"with the references {c0['ref_peak'] / 2**30:.2f}); gradient "
        f"all-reduce bytes a rank {c0['grad_bytes']}")
    checks_c = [(rel_loss <= 1e-6, ("loss", rel_loss, 1e-6)),
                (worst <= 1e-3, ("largest leaf", worst, 1e-3))]
    # (d)
    d12 = [r["d"] for r in two]
    rows12 = d12[0]
    for name in ("pre", "nopre"):
        assert torch.equal(d12[0][name]["y"], d12[1][name]["y"])
        assert rows12[name]["aux"] == d12[1][name]["aux"]
    assert torch.equal(rows12["nopre"]["y"].reshape(ep_ref["nopre"][0].shape),
                       ep_ref["nopre"][0]), \
        "model = 2 without pre-scale is not the one-process block"
    pre_diff = float((rows12["pre"]["y"] - ep_ref["pre"][0]).abs().max())
    d22 = [r["d"] for r in four]
    for r in d22:
        assert torch.equal(r["fsdp"]["y"], r["ep"]["y"]), \
            "the f32 ZeRO-3 gather changed the block"
    bf16_diff = max(float((r["fsdp_bf16"]["y"] - r["ep"]["y"]).abs().max())
                    for r in d22)
    log(f"[multi-device d] {card}: llama4-scout MoE block (d 5120, 16 "
        f"experts of d_ff 8192, top-1) on tokens {EP_TOKENS}: model = 2 "
        f"without pre-scale bit-identical to the one-process block; with "
        f"P16 L-21b's pre-scale max |diff| {pre_diff:.4g} (aux "
        f"{rows12['pre']['aux']:.6f} against {ep_ref['pre'][1]:.6f}); "
        f"(2, 2) with moe_fsdp and no gather dtype bit-identical to (2, 2) "
        f"without; bfloat16 gather max |diff| {bf16_diff:.4g}, gathered "
        f"bytes a rank {d22[0]['fsdp_bf16']['bytes']['all_gather']} "
        f"against {d22[0]['fsdp']['bytes']['all_gather']} in f32; "
        f"seconds a run (1, 2) "
        f"{ {k: round(v['s'], 2) for k, v in rows12.items()} }, (2, 2) "
        f"{ {k: round(v['s'], 2) for k, v in d22[0].items()} }; peak a "
        f"rank {max(v['peak'] for r in d22 for v in r.values()) / 2**30:.2f}"
        f" GiB")
    for ok, what in checks_c:
        assert ok, f"3l(c) outside its bar: {what}"
    # (e)
    from repro_torch.launch.mesh import H100_80GB_HBM3_BYTES
    e = [r["e"] for r in two]
    vocab_p = gemma2_2b.FULL.vocab
    out0_diff = max(float((r["out0"] - ref_e["out0"]).abs().max())
                    for r in e)
    h0_diff = max(float((r["h0"] - ref_e["h0"]).abs().max()) for r in e)
    h0_out = max(float((~torch.isclose(r["h0"], ref_e["h0"], rtol=1e-4,
                                       atol=2e-3)).float().mean())
                 for r in e)
    log(f"[multi-device e] {card}: layer 0 at P16 L-21b, placed against one "
        f"process: its output max |diff| {out0_diff:.4g} (bar rtol 1e-4 / "
        f"atol 2e-3); its logits max |diff| {h0_diff:.4g}, {h0_out:.6f} of "
        f"them outside that bar (the row-parallel wo's sum over two ranks; "
        f"printed); every column-parallel logmac call bit-equal to the "
        f"whole product's columns ({e[0]['column_checks']} calls, weight "
        f"blocks {e[0]['columns']})")
    for r in e:
        assert r["scales"] == ref_e["scales"], \
            "a placed rank's layer-0 pre-scale differs from one process's"
        torch.testing.assert_close(r["out0"], ref_e["out0"], rtol=1e-4,
                                   atol=2e-3)
        assert r["column_checks"] > 0, "no column-parallel logmac call"
        assert r["param_bytes"] == r["want_param_bytes"]
        assert r["cache_bytes"] == r["want_cache_bytes"]
        assert r["split_checked"] > 0 and r["bound_checks"] > 0
        assert (2304, 1152) in r["shapes"] and (4608, 2304) in r["shapes"], \
            f"no logmac on the rank's column or row block: {r['shapes']}"
        for k in ("posit_encode_prescaled", "logmac"):
            assert r["launches"][k] > 0, f"3l(e): {k} not launched"
        for k, v in r["launches"].items():
            launches[k] += v
    if "H100 80GB HBM3" in card:
        assert e[0]["total_memory"] == H100_80GB_HBM3_BYTES, \
            e[0]["total_memory"]
    assert torch.equal(e[0]["logits"], e[1]["logits"])
    e_diff = float((e[0]["logits"] - ref_e["logits"]).abs().max())
    e_agree = float((e[0]["logits"][:, :vocab_p].argmax(-1)
                     == ref_e["logits"][:, :vocab_p].argmax(-1)
                     ).float().mean())
    same_tokens = float((e[0]["tokens"] == ref_e["tokens"]).float().mean())
    log(f"[multi-device e] {card}: gemma2-2b FULL under the production "
        f"placement on (data, model) = (1, 2), cuda, P16 L-21b: each rank "
        f"holds {e[0]['param_bytes']} parameter bytes and "
        f"{e[0]['cache_bytes']} cache bytes, equal to the sharding "
        f"arithmetic; layer 0's {len(ref_e['scales'])} pre-scales (with the "
        f"head's) bit-equal to one process's on both ranks; its output "
        f"within rtol 1e-4 / atol 2e-3 (max |diff| {out0_diff:.4g}); "
        f"{e[0]['split_checked']} split "
        f"encodes over the model "
        f"group bit-equal to their plain version, {e[0]['bound_checks']} "
        f"logmac calls within the per-element bound, weight blocks "
        f"{e[0]['shapes']}; prefill {PLACED_PROMPT} + {PLACED_STEPS} greedy"
        f" steps: final logits max |diff| {e_diff:.4g} from one process's, "
        f"argmax agreement {e_agree:.4f}, decoded tokens equal "
        f"{same_tokens:.4f}; launches a rank {e[0]['launches']}, one "
        f"process {ref_e['launches']}; serve "
        f"{[round(r['s'], 2) for r in e]} s (one process "
        f"{ref_e['s']:.2f}); peak {[round(r['peak'] / 2**30, 2) for r in e]}"
        f" GiB a rank; the card's memory {e[0]['total_memory']} bytes "
        f"(mesh.H100_80GB_HBM3_BYTES {H100_80GB_HBM3_BYTES})")
    log(f"[multi-device] {card}: port-staged bytes 0 (the port hands gloo "
        f"the CUDA tensors; gloo copies them through host memory inside "
        f"each collective); ranks {t_two:.1f} s (2 ranks: b, c, d) and "
        f"{t_four:.1f} s (4 ranks: a, d)")
    _build.reset_launches()
    _build.LAUNCHES.update(launches)
    return path_launches("multi-device b (both ranks)")


# ---- the core codec's entries (csrc/posit_core_codec.cu) ----------------
CORE_ENTRIES = ("posit_store", "posit_load", "posit_quantize",
                "posit_quantize_prescaled", "posit_sentinels")
# f32 edge values: zeros, NaN, Inf, subnormals (XLA's flush: 0), the f32
# extremes, and each format's clamp edges (2^+-e, one step out)
CORE_EDGES = ([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1e-40,
               -1e-40, 1.4e-45, -1.4e-45, 1.1754942e-38, 2.0 ** -126,
               -2.0 ** -126, 3e38, -3e38, 3.4028235e38, 1e-30, -1e-30, 1e30,
               1.0, -1.0, 0.5]
              + [v for e in (6, 12, 20, 28, 56, 120)
                 for v in (2.0 ** e, 2.0 ** (e + 1), 2.0 ** -e,
                           2.0 ** -(e + 1), -1.5 * 2.0 ** -(e + 1))])
CORE_CHUNK = 1 << 24   # the plain versions run a chunk at a time
# the JAX function each entry computes (no pallas_call)
CORE_REPLACES = {
    "posit_store": "src/repro/core/posit.py:195 encode_from_float",
    "posit_load": "src/repro/core/posit.py:170 decode_to_float",
    "posit_quantize": "src/repro/core/posit.py:265 quantize",
    "posit_quantize_prescaled":
        "src/repro/reliability/guards.py:153 _quantize_like",
    "posit_sentinels": "src/repro/reliability/guards.py:209 sentinel_counts"}


def core_compare(name: str, got, want, errs: dict, what: str) -> None:
    """Assert ``got`` bit-equal to ``want`` (NaN equal to any NaN); the
    largest |got - want| (words: as unsigned patterns) goes to errs."""
    import torch
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, what, got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype.is_floating_point:
        ib = torch.int16 if got.element_size() == 2 else torch.int32
        same = (got.view(ib) == want.view(ib)) | (
            torch.isnan(got) & torch.isnan(want))
        diff = torch.where(same, 0.0, (got.float() - want.float()).abs())
    else:
        m = (1 << (8 * got.element_size())) - 1
        same = got == want
        diff = ((got.long() & m) - (want.long() & m)).abs().float()
    bad = int((~same).sum())
    if diff.numel():
        errs[name] = max(errs[name], float(diff.max()))
    assert bad == 0, f"{name} {what}: {bad} of {got.numel()} values differ"


def core_check(name, kernel, plain, x, errs, what) -> None:
    """The kernel on the whole of x against the plain version a chunk of
    the flattened x at a time (the plain int64 codec of a head's 590 M
    values does not fit whole)."""
    got = kernel(x).reshape(-1)
    flat = x.reshape(-1)
    for c0 in range(0, flat.numel(), CORE_CHUNK):
        core_compare(name, got[c0:c0 + CORE_CHUNK],
                     plain(flat[c0:c0 + CORE_CHUNK]), errs, what)


def memory_order(x):
    """``x`` as a contiguous tensor in its memory order: the permuted view
    where its elements fill one block (a transpose), else a copy."""
    order = sorted(range(x.ndim), key=lambda d: -x.stride(d))
    v = x.permute(order)
    return v if v.is_contiguous() else x.contiguous()


def tie_margin(x) -> float | None:
    """|mean - (floor(mean) + 0.5)| of the f64 mean log2|x| over the
    values the pre-scale counts (normal and nonzero; None where that mean
    is not finite): how far the scale's rounding is from a tie."""
    import torch
    ax = x.abs().reshape(-1)
    lg = torch.log2(ax[ax >= 2.0 ** -126]).double()
    if not lg.numel() or not bool(torch.isfinite(lg).all()):
        return None
    m = float(lg.mean())
    return abs(m - (m // 1 + 0.5))


def check_core_codec(dev, errs: dict) -> None:
    """Phase 2's checks of the core codec's entries, bit for bit against
    their plain versions (NaN as NaN), on a generator of their own (the
    later checks draw as before): every 8/16-bit pattern and 2^24 random
    32-bit words loaded to f32 and bf16; f32 and bf16 stores and f32
    quantizes of the edge values, the five gemma2-2b weight shapes at the model init's
    scale (the head, the transposed embedding the guard checks, at the
    served P16 and the ladder's P8 only), a ragged size, a misaligned
    base, a transposed weight (read in place), a strided slice (copied
    first), head logits and a tensor whose 1 % subnormals would move its
    scale were they counted.  The guard's entries on the same inputs:
    ``posit_quantize_prescaled``'s s bit-equal to
    ``posit_encode_prescaled``'s on the same memory and its values to the
    plain version given that s; ``posit_sentinels`` with and without the
    scale equal to the plain counts given it (not on the weights: the
    sentinels count outputs, as the logits); each input's margin of its
    mean log2 to a .5 tie."""
    import torch
    from repro_torch.core import posit as P
    from repro_torch.core.engine import _pow2_scale, from_variant
    from repro_torch.kernels import posit_codec as PC
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    formats = (P.POSIT8, P.BPOSIT8, P.POSIT16, P.BPOSIT16, P.POSIT32,
               P.BPOSIT32)
    served = (from_variant(16, "L-21b").posit, from_variant(8, "L-21b").posit)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # loads: every 8/16-bit word, 2^24 random 32-bit ones, 0 and NaR, and
    # a strided view
    r32 = torch.randint(-(1 << 31), (1 << 31) - 1, (1 << 24,), generator=gen,
                        dtype=torch.int32, device=dev)
    n_load = 0
    for pc in formats:
        N = pc.n_bits
        w = (torch.arange(1 << N, device=dev) if N <= 16 else torch.cat([
            r32.long(), torch.tensor([0, 1 << 31], device=dev)]))
        words = P.to_storage(w, pc)
        for dt in (torch.float32, torch.bfloat16):
            for what, wi in (("words", words), ("strided", words[1::3])):
                core_check("posit_load",
                           lambda t: PC.posit_load(t, pc, dt),
                           lambda t: PC.load_plain(t, pc, dt), wi, errs,
                           f"{pc.name} {what} -> {dt}")
                n_load += wi.numel()
    del r32, w, words

    edge = randn(1 << 20) * torch.exp2(torch.randint(
        -40, 40, (1 << 20,), generator=gen, device=dev).float())
    edge[:len(CORE_EDGES)] = torch.tensor(CORE_EDGES, device=dev)
    xs = {"edge values": edge}
    for K, N in GEMMA_KN:
        xs[f"weight [{K}, {N}]"] = (randn(N, K).t() * 0.02 if N > 100000
                                    else randn(K, N) * K ** -0.5)
    ragged = randn(2304 * 1155 - 3)
    xs[f"ragged [{ragged.numel()}]"] = ragged * torch.exp2(torch.randint(
        -20, 20, ragged.shape, generator=gen, device=dev).float())
    base = randn(2304 * 2304 + 1)
    xs["misaligned base"] = base[1:]
    assert base[1:].data_ptr() % 16 != 0
    xs["transposed [9216, 2304]"] = randn(9216, 2304).t()
    xs["strided [4, 16, 4, 288][:, 3]"] = randn(4, 16, 4, 288)[:, 3] * 3.0
    xs["logits [16, 256000]"] = randn(16, 256000) * 8.0
    sub = randn(1 << 20) * 0.25
    pick = torch.rand(sub.shape, generator=gen, device=dev) < 0.01
    sub[pick] = torch.rand(sub.shape, generator=gen, device=dev)[pick] * (
        2.0 ** -126)
    xs["1 % subnormal [2^20]"] = sub
    n_store = n_quant = n_guard = n_sent = 0
    margins = {}
    for pc in formats:
        for what, x in xs.items():
            head = "256000" in what
            if head and pc not in served:
                continue        # the heads at the served formats only
            weight = what.startswith(("weight", "transposed"))
            for xi in ((x,) if head and weight
                       else (x, x.to(torch.bfloat16))):
                core_check("posit_store", lambda t: PC.posit_store(t, pc),
                           lambda t: PC.store_plain(t, pc), xi, errs,
                           f"{pc.name} {what} {xi.dtype}")
                n_store += xi.numel()
            core_check("posit_quantize", lambda t: PC.posit_quantize(t, pc),
                       lambda t: PC.quantize_plain(t, pc), x, errs,
                       f"{pc.name} {what}")
            n_quant += x.numel()
            # the guard's check: the fused encode's scale, bit for bit
            q, s = PC.posit_quantize_prescaled(x, pc)
            _, s_enc = PC.posit_encode_prescaled(memory_order(x), pc)
            assert float(s) == float(s_enc), (
                f"posit_quantize_prescaled {pc.name} {what}: s {float(s)} "
                f"!= the fused encode's {float(s_enc)}")
            core_check("posit_quantize_prescaled", lambda t: q,
                       lambda t: PC.quantize_plain(t, pc, s), x, errs,
                       f"{pc.name} {what}")
            n_guard += x.numel()
            del q
            if what not in margins:
                margins[what] = tie_margin(x)
            if weight:
                continue        # the sentinels count outputs
            for pre in (True, False):
                got = PC.posit_sentinels(x, pc, pre)
                flat = x.reshape(-1)
                want = sum(PC.sentinels_plain(flat[c0:c0 + CORE_CHUNK], pc,
                                              pre, s if pre else None)
                           for c0 in range(0, flat.numel(), CORE_CHUNK))
                diff = float((got - want).abs().max())
                errs["posit_sentinels"] = max(errs["posit_sentinels"], diff)
                assert torch.equal(got, want), (
                    f"posit_sentinels {pc.name} {what} pre_scale={pre}: "
                    f"{got.tolist()} != {want.tolist()}")
                n_sent += x.numel()
    torch.cuda.synchronize()
    log(f"[core codec] bit-equal to the plain versions (NaN as NaN) on 6 "
        f"formats: posit_load {n_load} words to f32 and bf16 (every 8/16-bit "
        f"pattern, 2^24 random 32-bit words, a strided view), posit_store "
        f"{n_store} and posit_quantize {n_quant} values (f32 and bf16; the "
        f"edge values incl. subnormals -> 0, the five gemma2-2b weight "
        f"shapes, ragged, misaligned, transposed, strided, head logits, 1 % "
        f"subnormals); the guard's posit_quantize_prescaled {n_guard} values (s bit-equal to "
        f"posit_encode_prescaled's on every input) and posit_sentinels "
        f"{n_sent} values (with and without the scale); max |diff| "
        f"{ {k: errs[k] for k in CORE_ENTRIES} }; margin of the mean log2 "
        f"to a .5 tie: {margins}")


@contextlib.contextmanager
def ssd_subnormals():
    """Counts, over the operands the SSD's contractions pre-scale (inside
    the ``ssm`` scope, where ``engine._pow2_scale`` takes them: batched
    contractions run on the reference engine), their subnormal values (a
    device tensor), all their values and the operands holding one."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.numerics import api as NA
    tally = {"subnormal": 0, "values": 0, "operands": 0, "with": 0}
    orig = E._pow2_scale

    def spy(x, group=None):
        if "ssm" in NA.current_path().split("/"):
            ax = x.detach().abs()
            n = ((ax > 0) & (ax < 2.0 ** -126)).sum()   # no host read here
            tally["subnormal"] = tally["subnormal"] + n
            tally["with"] = tally["with"] + (n > 0).long()
            tally["values"] += x.numel()
            tally["operands"] += 1
        return orig(x, group)

    E._pow2_scale = spy
    try:
        yield tally
    finally:
        E._pow2_scale = orig


def aten_ops(fn) -> int:
    """The aten ops one call of ``fn`` dispatches (each a host dispatch;
    a ctypes launch is none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, trace one short drain (2 requests, "
                    "4 new tokens) with torch.profiler and print the device "
                    "time by kernel and the device's busy share")
    args = ap.parse_args(argv)
    # phase 3g replays a train step bit for bit: cuBLAS needs a fixed
    # workspace, set before the process's first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.core.engine import (VARIANT_NAMES, _pow2_scale,
                                         euler_dot_general, from_variant)
    from repro_torch.kernels import logmac as LM
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import posit_codec as PC
    from repro_torch.launch import pin_exact_f32

    pin_exact_f32()
    phase_s: dict[str, float] = {}

    def phase_start(name: str) -> None:
        """Seconds from here to the next phase's start count to ``name``."""
        now = time.perf_counter()
        if phase_s:
            last = next(reversed(phase_s))
            phase_s[last] = now - phase_s[last]
            log(f"[phase {last}] {phase_s[last]:.1f} s")
        phase_s[name] = now

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    phase_start("1")
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
    # logmac's four kernels are held and listed one by one: the small-M
    # kernel (M <= 32), the fp16 tensor-core kernel (M > 32, P8/P16
    # L-21b), the bf16-piece tensor-core kernel (M > 32, P32 L-21b and
    # L-22b, the other P16 variants) and the f32 tile kernel (M > 32, what
    # both refuse: unbounded P32, P32 without truncation)
    errs = {"posit_encode": 0.0, "posit_encode_prescaled": 0.0,
            "posit_decode": 0.0, "posit_store": 0.0, "posit_load": 0.0,
            "posit_quantize": 0.0, "posit_quantize_prescaled": 0.0,
            "posit_sentinels": 0.0, "logmac_small": 0.0, "logmac_mma": 0.0,
            "logmac_pieces": 0.0, "logmac_tile": 0.0,
            "paged_flash_decode": 0.0}
    total_launches = dict.fromkeys(_build.LAUNCHES, 0)

    def logmac_kernel(M, N, K, wcfg) -> str:
        """The launch counter of the logmac kernel that runs this product."""
        return LM.KERNEL_OF[LM.plan_of(M, N, K, wcfg).kind]

    def path_launches(what: str) -> dict:
        """The counts since the last reset, added to the run's total."""
        got = dict(_build.LAUNCHES)
        for k, n in got.items():
            total_launches[k] += n
        log(f"[{what}] launches: {got}, by width: "
            f"{ {k: v for k, v in _build.WIDTH_LAUNCHES.items() if v} }")
        return got

    phase_start("2")
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
    del x, got, want
    # the kernels' table form against encode_f32 on every f32 pattern
    formats = (P.POSIT8, P.BPOSIT8, P.POSIT16, P.BPOSIT16, P.POSIT32,
               P.BPOSIT32, P.PositConfig(16, 2, None))
    bad = encode_table_mismatches(_build.build_dir(), _build.CSRC, formats)
    assert not any(bad.values()), f"encode table form differs: {bad}"
    log(f"[encode] table form equal to encode_f32 on all 2^32 f32 patterns "
        f"of {len(formats)} formats")

    # the fused pow2 pre-scale + encode: s bit-equal to torch's
    # _pow2_scale, words bit-identical to the plain version, two launches
    # the same bits
    def check_prescaled(x, pc, pre_scale, what, chunk=1 << 25):
        w, s = PC.posit_encode_prescaled(x, pc, pre_scale)
        w2, s2 = PC.posit_encode_prescaled(x, pc, pre_scale)
        want_s = (_pow2_scale(x) if pre_scale
                  else torch.ones((), device=dev))
        assert float(s) == float(want_s) == float(s2), (
            f"fused encode {what} {pc.name}: scale {float(s)} != "
            f"{float(want_s)}")
        assert bool((w == w2).all()), f"fused encode {what}: launches differ"
        flat, wf = x.reshape(-1), w.reshape(-1)
        for c0 in range(0, flat.numel(), chunk):   # the plain int64 codec
            xs = flat[c0:c0 + chunk]               # in chunks (the head)
            want = PC.encode_plain(P.flushed_quotient(xs, want_s)
                                   if pre_scale else xs, pc)
            got = wf[c0:c0 + chunk]
            bad = int((got != want).sum())
            assert bad == 0, f"fused encode {what} {pc.name}: {bad} words"
            if got.numel():
                # largest difference of the words read as unsigned patterns
                diff = ((got.long() & 0xFFFFFFFF)
                        - (want.long() & 0xFFFFFFFF)).abs()
                errs["posit_encode_prescaled"] = max(
                    errs["posit_encode_prescaled"], float(diff.max()))
        s_err = (0.0 if float(s) == float(want_s)    # also s = want_s = inf
                 else abs(float(s) - float(want_s)))
        errs["posit_encode_prescaled"] = max(errs["posit_encode_prescaled"],
                                             s_err)
        return float(s)

    # the weights at the model init's scale: d_in^-0.5, the embedding 0.02
    fused_in = {f"weight [{K}, {N}]": torch.randn(
        (K, N), generator=gen, device=dev)
        * (0.02 if N > 100000 else K ** -0.5) for K, N in GEMMA_KN}
    for M in (1, 4, 16, 32):
        for K in (2304, 9216):
            fused_in[f"activation [{M}, {K}]"] = torch.randn(
                (M, K), generator=gen, device=dev) * 3.0
    # every weight of the mamba2-1.3b and hymba-1.5b paths (phase 3f), and
    # activations at each of their K: decode batches and the 128-token
    # prefill bucket
    for arch, kns in NEW_FAMILY_KN.items():
        for K, N, proj in kns:
            fused_in[f"{arch} {proj} weight [{K}, {N}]"] = torch.randn(
                (K, N), generator=gen, device=dev) * (
                    0.02 if proj == "head" else K ** -0.5)
    for K in NEW_FAMILY_K:
        for M in (1, 4, 128, 256):
            fused_in[f"activation [{M}, {K}]"] = torch.randn(
                (M, K), generator=gen, device=dev) * 3.0
    ragged = torch.randn(2304 * 1155 - 3, generator=gen, device=dev)
    fused_in[f"ragged [{ragged.numel()}]"] = ragged * torch.exp2(torch.randint(
        -20, 20, ragged.shape, generator=gen, device=dev).float())
    base = torch.randn(2304 * 2304 + 1, generator=gen, device=dev)
    fused_in["misaligned base [2304*2304]"] = base[1:]
    assert base[1:].data_ptr() % 16 != 0
    edge = torch.randn(100000, generator=gen, device=dev) * 1024.0
    edge[:12] = torch.tensor([0.0, -0.0, float("nan"), 1e-40, -1e-40,
                              2.0 ** -126, 2.0 ** -120, 3e38, -3e38, 1e-30,
                              float("nan"), 0.0])
    fused_in["edge values"] = edge
    # 1 % subnormals, which would move the scale were they counted (a
    # generator of its own: the later checks draw from gen as before)
    gsub = torch.Generator(device=dev)
    gsub.manual_seed(24)
    sub = torch.randn(1 << 20, generator=gsub, device=dev) * 0.25
    pick = torch.rand(sub.shape, generator=gsub, device=dev) < 0.01
    sub[pick] = torch.rand(sub.shape, generator=gsub, device=dev)[pick] * (
        2.0 ** -126)
    fused_in["1 % subnormal [2^20]"] = sub
    fused_in["all zero"] = torch.zeros(1000, device=dev)
    fused_in["with Inf"] = torch.tensor([1.0, float("inf"), -2.0, 0.5],
                                        device=dev)
    scales = {}
    for pc in (P.POSIT8, P.BPOSIT8, P.POSIT16, P.BPOSIT16, P.POSIT32,
               P.BPOSIT32):
        for pre_scale in (True, False):
            for what, xin in fused_in.items():
                if ("256000" in what or "head" in what) and (
                        pc is not P.BPOSIT16):
                    continue        # the heads at the served format only
                s = check_prescaled(xin, pc, pre_scale, what)
                if pre_scale:
                    scales[what] = s
    assert scales["all zero"] == 1.0 and scales["with Inf"] == float("inf")
    log(f"[encode_prescaled] scale bit-equal to torch's _pow2_scale and "
        f"words bit-identical on 6 formats with and without pre-scale, two "
        f"launches the same bits: {len(fused_in)} inputs (the heads at "
        f"bposit16 only; gemma2-2b, mamba2-1.3b and hymba-1.5b weight "
        f"shapes); scales {scales}")
    del fused_in, ragged, base, edge, sub
    # the weight shapes of phases 3h-3j (the model init's scale; the heads
    # are the tied embeddings at 0.02) and activations at each of their K
    # for M in {1, 4, 32}, at the served format with and without pre-scale
    zoo_in = {}
    for arch, kns in ZOO_KN.items():
        for K, N, proj in kns:
            zoo_in[f"{arch} {proj} weight [{K}, {N}]"] = torch.randn(
                (K, N), generator=gen, device=dev) * (
                    0.02 if proj == "head" else K ** -0.5)
    for K in ZOO_K:
        for M in (1, 4, 32):
            zoo_in[f"activation [{M}, {K}]"] = torch.randn(
                (M, K), generator=gen, device=dev) * 3.0
    zoo_scales = {}
    for pre_scale in (True, False):
        for what in list(zoo_in):
            s = check_prescaled(zoo_in[what], ecfg.posit, pre_scale, what)
            if pre_scale:
                zoo_scales[what] = s
    log(f"[encode_prescaled] {ecfg.posit.name} with and without pre-scale: "
        f"scale bit-equal to torch's _pow2_scale, words bit-identical, two "
        f"launches the same bits, on the llama4-scout, musicgen-large and "
        f"yi-6b weight shapes and activations at K in {ZOO_K}: scales "
        f"{zoo_scales}")
    del zoo_in
    # next to a .5 tie of the mean log2 (the seeded weights' own lies about
    # 0.0013 from one): the kernel sums in f64, torch's _pow2_scale in f32,
    # so within the f32 sum's error of a tie the two may round apart.  The
    # kernel's scale must be the one of the f64 mean of the f32 log2 terms;
    # torch's is reported beside it.
    def mean_lg(x):
        ax = x.abs()
        return float(torch.log2(ax[ax > 0]).double().mean())

    w0 = torch.randn((2304, 2304), generator=gen, device=dev) * 2304 ** -0.5
    m0 = mean_lg(w0)
    tie = int(m0 // 1) + 0.5
    near = []
    for d in (1e-3, 1e-4, 1e-5, -1e-5, -1e-4, -1e-3):
        xt = (w0 * 2.0 ** (tie - m0 + d)).contiguous()
        m = mean_lg(xt)
        _, s = PC.posit_encode_prescaled(xt, ecfg.posit)
        want = 2.0 ** round(m)          # round half even, as rintf
        torch_s = float(_pow2_scale(xt))
        assert float(s) == want, (f"fused encode next to a tie: mean "
                                  f"{m} -> {float(s)}, want {want}")
        # the guard's check takes the same scale
        _, s_guard = PC.posit_quantize_prescaled(xt, ecfg.posit)
        assert float(s_guard) == float(s), (m, float(s_guard), float(s))
        near.append({"mean_minus_tie": m - tie, "s": float(s),
                     "torch_s": torch_s})
    log(f"[encode_prescaled] next to the tie {tie} of the mean log2: the "
        f"scale follows the f64 mean on {len(near)} inputs (the guard's "
        f"posit_quantize_prescaled takes the same s on each), torch's f32 "
        f"_pow2_scale agrees on "
        f"{sum(r['s'] == r['torch_s'] for r in near)}: {near}")
    del w0, xt

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
    check_core_codec(dev, errs)

    def bits(shape, pc):
        return random_words(shape, pc, gen)

    # the served format's decode table (built on the card by the kernels'
    # decoder) bit for bit against the plain decode of its 4096 bodies
    key16 = LM.table16_key(ecfg.posit, ecfg)
    assert key16 is not None
    tab = LM._table16(dev, key16).view(4096, 2)
    bodies = (torch.arange(4096, dtype=torch.int32, device=dev) << 3) | 1
    tv, tr = LM.decode_planes(bodies, ecfg)
    for got, want, plane in ((tab[:, 0], tv, "val"), (tab[:, 1], tr, "rem")):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        assert bad == 0, f"P16 decode table: {bad} {plane} entries differ"
    log(f"[logmac] P16 L-21b decode table {key16}: 4096 entries bit-identical "
        f"to the plain decode")
    # every 8- and 16-bit pattern, and 2^20 random 32-bit words (0 and NaR
    # among them), as a one-row B with K = 1: each output is one product
    # per plane, so the kernels (small-M, vector and scalar loads; above
    # M = 32 the fp16 tensor-core kernel at P8/P16) must equal the plain
    # version exactly; the bf16-piece kernel (P32 above M = 32) adds five
    # exact piece products where the plain version rounds two, so both lie
    # a few roundings from the exact value: it is held to
    # |got - want| <= 4 * 2^-24 * (|va||vb| + |ra||rb|), with no absolute
    # term
    k1_pieces = 0.0
    for width in (8, 16, 32):
        wcfg = from_variant(width, "L-21b")
        if width < 32:
            row = torch.arange(1 << width, dtype=torch.int32, device=dev)
        else:
            row = torch.cat([torch.tensor([0, -(1 << 31)], dtype=torch.int32,
                                          device=dev),
                             torch.randint(-(1 << 31), (1 << 31) - 1,
                                           (1 << 20,), generator=gen,
                                           dtype=torch.int32, device=dev)])
        for b in (row[None, :], row[None, :-1]):
            for M in (1, 4, 33, 64):
                a = bits((M, 1), wcfg.posit)
                got = LM.logmac(a, b, wcfg)
                want = LM.logmac_plain(a, b, wcfg)
                if logmac_kernel(M, b.shape[1], 1, wcfg) == "logmac_pieces":
                    va, ra = LM.decode_planes(a, wcfg)
                    vb, rb = LM.decode_planes(b, wcfg)
                    mag = va.abs() @ vb.abs() + ra.abs() @ rb.abs()
                    diff = (got - want).abs()
                    assert bool((diff <= 4 * 2.0 ** -24 * mag).all()), (
                        f"logmac P{width} M={M} over 2^20 words: more than "
                        f"4 * 2^-24 of the products' magnitudes")
                    k1_pieces = max(k1_pieces, float(
                        (diff / mag.clamp(min=2.0 ** -126)).max()))
                    continue
                bad = int((got != want).sum())
                assert bad == 0, (f"logmac P{width} M={M} over every "
                                  f"pattern: {bad} outputs differ")
    log(f"[logmac] every 8/16-bit pattern and 2^20 32-bit words through B "
        f"(M in (1, 4, 33, 64), N % 4 == 0 and != 0): equal to the plain "
        f"version; P32 at M = 33, 64 (the bf16-piece kernel) within 4 * "
        f"2^-24 of |va||vb| + |ra||rb| (largest {k1_pieces * 2**24:.3g} "
        f"* 2^-24)")

    # P16 is the served width; P8 is the ladder's width and P32 the guard's
    # escalation width, each encoded by the encode kernel at that width.
    # M: decode batches (1, 4, 5), prefill buckets (16, 32) and their
    # neighbours, the crossover (32 | 33), and above it the tensor-core
    # kernel's row tiles (64 | 65) and prefill, eval and ragged M at P8 and
    # P16 (P32 L-21b, on the bf16-piece kernel above 32 rows: 33 and the
    # 128-token bucket)
    assert LM.SMALL_M_MAX == 32, LM.SMALL_M_MAX
    logmac_ms = (1, 4, 5, 16, 17, 31, 32, 33)
    mma_ms = (64, 65, 128, 200, 256)
    ragged = (2301, 1155)          # N % 4 != 0, K not a multiple of a split
    assert ragged[1] % 4 and any(
        ragged[0] % LM._plan(M, ragged[1], ragged[0]).ks for M in logmac_ms)
    worst = 0.0

    def abs_planes(b, wcfg, chunk=16384):
        """|vb|, |rb| of a (K, N) operand, decoded a column chunk at a time
        (the plain decode's int64 temporaries of the head stay small)."""
        vb = torch.empty(b.shape, dtype=torch.float32, device=dev)
        rb = torch.empty(b.shape, dtype=torch.float32, device=dev)
        for c0 in range(0, b.shape[1], chunk):
            v, r = LM.decode_planes(b[:, c0:c0 + chunk], wcfg)
            vb[:, c0:c0 + chunk] = v.abs()
            rb[:, c0:c0 + chunk] = r.abs()
        return vb, rb

    def check_logmac(a, b, wcfg, planes_b, what):
        kern = logmac_kernel(a.shape[0], b.shape[1], a.shape[1], wcfg)
        got = LM.logmac(a, b, wcfg)
        again = LM.logmac(a, b, wcfg)
        assert bool((got.view(torch.int32) == again.view(torch.int32)).all()), \
            f"logmac {what}: two launches differ"
        want = LM.logmac_plain(a, b, wcfg)
        va, ra = LM.decode_planes(a, wcfg)
        bound = 1e-5 * (va.abs() @ planes_b[0] + ra.abs() @ planes_b[1]) + 1e-4
        diff = (got - want).abs()
        assert bool((diff <= bound).all()), f"logmac {what} outside its bound"
        assert bool(torch.isfinite(got).all()), f"logmac {what} not finite"
        errs[kern] = max(errs[kern], float(diff.max()))
        return float(diff.max())

    for width in (16, 8, 32):
        wcfg = from_variant(width, "L-21b")
        ms_w = logmac_ms + (mma_ms if width < 32 else (128,))
        for K, N in GEMMA_KN + [ragged]:
            b = bits((K, N), wcfg.posit)
            planes_b = abs_planes(b, wcfg)
            for M in ms_w:
                a = bits((M, K), wcfg.posit)
                worst = max(worst, check_logmac(
                    a, b, wcfg, planes_b, f"P{width} M={M} K={K} N={N}"))
            del b, planes_b
        log(f"[logmac] P{width} L-21b, M in {ms_w} x "
            f"{GEMMA_KN + [ragged]}: within the per-element bound, two "
            f"launches bit-identical (max abs diff so far {worst:.3g}; by "
            f"kernel {errs['logmac_small']:.3g} / {errs['logmac_mma']:.3g} / "
            f"{errs['logmac_tile']:.3g})")
    # the mamba2-1.3b and hymba-1.5b shapes (phase 3f) at the served P16:
    # decode M = 1 and 4, a prefill M = 16 and the 128-token bucket (the
    # tensor-core kernel); the plan's split and K step follow (N, K).  hymba's
    # shapes also at M = 256, the eval step of phase 3g (batch 2 x seq 128)
    # hymba's shapes also at the tensor-core kernel's M, at P16 and P8
    new_ms = (1, 4, 16, 128)
    hymba_ms = (33,) + mma_ms
    hymba_kn = {(K, N) for K, N, _ in NEW_FAMILY_KN["hymba-1.5b"]}
    for K, N in NEW_FAMILY_KN_SET:
        for wcfg in (ecfg, from_variant(8, "L-21b")):
            if wcfg is not ecfg and (K, N) not in hymba_kn:
                continue
            b = bits((K, N), wcfg.posit)
            planes_b = abs_planes(b, wcfg)
            ms_kn = ((new_ms if wcfg is ecfg else ())
                     + (hymba_ms if (K, N) in hymba_kn else ()))
            for M in sorted(set(ms_kn)):
                worst = max(worst, check_logmac(
                    bits((M, K), wcfg.posit), b, wcfg, planes_b,
                    f"P{wcfg.width} M={M} K={K} N={N}"))
            del b, planes_b
    log(f"[logmac] P16 L-21b, M in {new_ms} x the mamba2-1.3b and "
        f"hymba-1.5b shapes {NEW_FAMILY_KN_SET}; P16 and P8, M in "
        f"{hymba_ms} x hymba's {sorted(hymba_kn)}: within the per-element "
        f"bound, two launches bit-identical (max abs diff so far "
        f"{worst:.3g})")
    # a B operand whose base is not 16-byte aligned takes the scalar loads
    K, N = 2304, 2304
    flat = bits((K * N + 1,), ecfg.posit)
    b = flat[1:].view(K, N)
    assert b.data_ptr() % 16 != 0
    planes_b = abs_planes(b, ecfg)
    for M in (4, 16, 32, 64, 128):
        worst = max(worst, check_logmac(bits((M, K), ecfg.posit), b, ecfg,
                                        planes_b, f"P16 M={M} misaligned B"))
    del flat, b, planes_b
    log(f"[logmac] misaligned B base (P16, M in (4, 16, 32, 64, 128)): "
        f"within the bound (max abs diff {worst:.3g}; small / mma / tile "
        f"{errs['logmac_small']:.3g} / {errs['logmac_mma']:.3g} / "
        f"{errs['logmac_tile']:.3g})")
    # the weight shapes of phases 3h-3j at the served P16: decode M = 1 and
    # 4, the 32-token prefill bucket and M = 128 (the tensor-core kernel);
    # the heads at decode width and the prefill bucket
    for arch, kns in ZOO_KN.items():
        for K, N, proj in kns:
            b = bits((K, N), ecfg.posit)
            planes_b = abs_planes(b, ecfg)
            for M in ((4, 32) if proj == "head" else (1, 4, 32, 128)):
                worst = max(worst, check_logmac(
                    bits((M, K), ecfg.posit), b, ecfg, planes_b,
                    f"{arch} {proj} P16 M={M} K={K} N={N}"))
            del b, planes_b
    log(f"[logmac] P16 L-21b at the llama4-scout, musicgen-large and yi-6b "
        f"shapes {[(K, N) for kns in ZOO_KN.values() for K, N, _ in kns]}, "
        f"M in (1, 4, 32, 128) (the heads 4, 32): within the per-element "
        f"bound, two launches bit-identical (max abs diff so far "
        f"{worst:.3g}; small / mma {errs['logmac_small']:.3g} / "
        f"{errs['logmac_mma']:.3g})")

    # the bf16-piece kernel on every format routed to it (P32 L-21b and
    # L-22b, the P16 variants but L-21b), at M in {33, 128, 256}: K = 300,
    # gemma2-2b's MLP shapes and the ragged one against the per-element
    # bound, and at K = 300 words of unit-scale values (the JAX suite's
    # data for this bar) against the flat bar rtol 1e-5 / atol 1e-4: on
    # the spread words the sums reach ~10^3, where one ulp passes atol and
    # no other summation order meets the flat bar; the tile kernel on the
    # formats it keeps (unbounded P32, P32 without truncation), at M in
    # {33, 128}
    # their own generator, so the phases after them draw the inputs they
    # drew before these checks were added
    gen21 = torch.Generator(device=dev)
    gen21.manual_seed(21)
    pieces_cfgs = [c for c in ([from_variant(16, v) for v in VARIANT_NAMES]
                               + [from_variant(32, v) for v in VARIANT_NAMES])
                   if logmac_kernel(128, 9216, 2304, c) == "logmac_pieces"]
    assert len(pieces_cfgs) == 9, [c.variant for c in pieces_cfgs]
    tile_cfgs = [from_variant(32, "L-21"), from_variant(32, "L-1b")]
    for wcfg in pieces_cfgs + tile_cfgs:
        tile = wcfg in tile_cfgs
        ms_p = (33, 128) if tile else (33, 128, 256)
        want_kind = "logmac_tile" if tile else "logmac_pieces"
        what = f"P{wcfg.width} {wcfg.variant}"
        for K, N in [(300, 70), (2304, 9216), (9216, 2304), ragged]:
            b = random_words((K, N), wcfg.posit, gen21)
            planes_b = abs_planes(b, wcfg)
            for M in ms_p:
                assert logmac_kernel(M, N, K, wcfg) == want_kind, what
                a = random_words((M, K), wcfg.posit, gen21)
                worst = max(worst, check_logmac(
                    a, b, wcfg, planes_b, f"{what} M={M} K={K} N={N}"))
                if K == 300:
                    au, bu = (PC.posit_encode(torch.randn(
                        s, generator=gen21, device=dev), wcfg.posit)
                        for s in ((M, K), (K, N)))
                    torch.testing.assert_close(
                        LM.logmac(au, bu, wcfg),
                        LM.logmac_plain(au, bu, wcfg), rtol=1e-5, atol=1e-4)
            del b, planes_b
    log(f"[logmac] the bf16-piece kernel at "
        f"{[f'P{c.width} {c.variant}' for c in pieces_cfgs]}, M in (33, 128, "
        f"256), and the tile kernel at P32 L-21 and L-1b, M in (33, 128), "
        f"on K x N (300, 70), (2304, 9216), (9216, 2304), {ragged}: within "
        f"the per-element bound, two launches bit-identical (pieces "
        f"{errs['logmac_pieces']:.3g}, tile {errs['logmac_tile']:.3g}); at "
        f"K = 300 on unit-scale words within rtol 1e-5, atol 1e-4")
    # above 32 rows a row's result does not depend on the rows beside it:
    # the first 33 rows of calls at every M bit-equal, for the fp16 kernel
    # at P16 and P8 L-21b and the bf16-piece kernel at P32 L-21b
    for width, kernel in ((16, "logmac_mma"), (8, "logmac_mma"),
                          (32, "logmac_pieces")):
        wcfg = from_variant(width, "L-21b")
        for K, N in ((2304, 9216), (2304, 2304)):
            b = random_words((K, N), wcfg.posit, gen21)
            a = random_words((512, K), wcfg.posit, gen21)
            first = None
            for M in (33, 128, 129, 256, 512):
                assert logmac_kernel(M, N, K, wcfg) == kernel
                out = LM.logmac(a[:M], b, wcfg)
                rows = out[:33].view(torch.int32)
                first = rows if first is None else first
                assert torch.equal(rows, first), (
                    f"logmac P{width} [{K}, {N}]: the first 33 rows at "
                    f"M={M} differ from M=33")
            del a, b
    log("[logmac] rows independent of the row count: the first 33 rows of "
        "M in (33, 128, 129, 256, 512) bit-equal at P16 and P8 L-21b (fp16 "
        "kernel) and P32 L-21b "
        "(bf16-piece kernel) on [2304, 9216] and [2304, 2304]")

    # paged flash-decode at the serving geometry, then at a long context
    B, KV, G, hd, ps, max_len = 4, 4, 2, 288, 16, 256
    pc16 = P.BPOSIT16

    def page_table(pos, nlp):
        # real pages for positions 0..pos of each row, NULL_PAGE past them
        tab = torch.full((B, nlp), PD.NULL_PAGE, dtype=torch.int32)
        nxt = PD.RESERVED_PAGES
        for r in range(B):
            for j in range(int(pos[r]) // ps + 1):
                tab[r, j] = nxt
                nxt += 1
        return tab.to(dev)

    def kv_pool(num_pages, KV=KV, hd=hd, g=None):
        g = gen if g is None else g
        kf = torch.randn((num_pages, ps, KV, hd), generator=g, device=dev)
        vf = torch.randn((num_pages, ps, KV, hd), generator=g, device=dev)
        kf[:PD.RESERVED_PAGES] = 0
        vf[:PD.RESERVED_PAGES] = 0
        return (P.to_storage(P.encode_from_float(kf, pc16), pc16).contiguous(),
                P.to_storage(P.encode_from_float(vf, pc16), pc16).contiguous())

    kw = dict(pc=pc16, cfg_qk=ecfg, cfg_pv=ecfg, softcap=50.0)

    def check_paged(q, kp, vp, table, pos, window, what, softcap=50.0,
                    ref_bar=0.05):
        """The kernel against its plain version (1e-3) and the gather
        reference: within ``ref_bar``, or with ``ref_bar`` None within
        1e-3 of the plain version's own distance from it."""
        kw_c = dict(kw, softcap=softcap)
        got = PD.paged_flash_decode(q, kp, vp, table, pos, window, **kw_c)
        again = PD.paged_flash_decode(q, kp, vp, table, pos, window, **kw_c)
        assert bool((got.view(torch.int32) == again.view(torch.int32)).all()), \
            f"paged decode {what}: two launches differ"
        want = PD.paged_flash_decode_plain(q, kp, vp, table, pos, window,
                                           **kw_c)
        ref = PD.paged_attention_reference(q, kp, vp, table, pos, pc=pc16,
                                           softcap=softcap, window=window)
        d_plain = float((got - want).abs().max())
        d_ref = float((got - ref).abs().max())
        # the plain version's own distance from the gather reference: the
        # flash algorithm's posit-quantized page-wise softmax (JAX's Pallas
        # kernel shows the same distance on the same inputs)
        d_alg = float((want - ref).abs().max())
        assert d_plain <= 1e-3, f"paged decode {what}: {d_plain}"
        if ref_bar is not None:
            assert d_ref < ref_bar, (f"paged decode vs reference {what}: "
                                     f"{d_ref}")
        else:
            assert d_ref <= d_alg + 1e-3, (
                f"paged decode vs reference {what}: {d_ref}, the plain "
                f"version's {d_alg}")
        errs["paged_flash_decode"] = max(errs["paged_flash_decode"], d_plain)
        log(f"[paged_decode] {what}: max|kernel-plain|={d_plain:.3g}, "
            f"max|kernel-reference|={d_ref:.3g} (plain-reference "
            f"{d_alg:.3g}), two launches bit-identical")

    nlp = max_len // ps
    pos = torch.tensor([37, 100, 250, 5], dtype=torch.int32, device=dev)
    table = page_table(pos, nlp)
    assert bool((table == PD.NULL_PAGE).any())   # unallocated slots too
    kp, vp = kv_pool(PD.RESERVED_PAGES + B * nlp)
    q = torch.randn((B, 1, KV * G, hd), generator=gen, device=dev)
    for window in (None, 4096, 24):
        check_paged(q, kp, vp, table, pos, window, f"window={window}")
    long_len = 4096
    pos_long = torch.tensor([4000, 3990, 4095, 3971], dtype=torch.int32,
                            device=dev)
    table_long = page_table(pos_long, long_len // ps)
    kp_long, vp_long = kv_pool(PD.RESERVED_PAGES + B * long_len // ps)
    for window in (None, 4096):
        check_paged(q, kp_long, vp_long, table_long, pos_long, window,
                    f"max_len {long_len}, pos {pos_long.tolist()}, "
                    f"window={window}")
    # the geometries of phases 3h and 3i and chameleon-34b's, at the
    # serving positions (no softcap: none of the three has one).  There
    # the flash algorithm itself may lie more than 0.05 from the gather
    # reference (JAX's Pallas kernel as far as the plain version:
    # tests/test_torch_paged_geometry.py), so the kernel is held to the
    # plain version's own distance
    for KVg, Gg, hdg in PAGED_GEOMS:
        kp_g, vp_g = kv_pool(PD.RESERVED_PAGES + B * nlp, KVg, hdg)
        q_g = torch.randn((B, 1, KVg * Gg, hdg), generator=gen, device=dev)
        for window in (None, 24):
            check_paged(q_g, kp_g, vp_g, table, pos, window,
                        f"KV={KVg} G={Gg} hd={hdg}, window={window}",
                        softcap=None, ref_bar=None)
        del kp_g, vp_g
    # the same geometries on eight more draws, each kernel output held to
    # its plain version at 1e-3 as above: the plain version's scores are
    # the kernel's bit for bit (``paged_decode.page_scores``), so both
    # encode the same probability words on every draw; two launches
    # bit-identical and finite outputs are gated too
    gen_pd = torch.Generator(device=dev)
    spread = {}
    for seed in range(1, 9):
        gen_pd.manual_seed(seed)
        for KVg, Gg, hdg in PAGED_GEOMS:
            kp_g, vp_g = kv_pool(PD.RESERVED_PAGES + B * nlp, KVg, hdg, gen_pd)
            q_g = torch.randn((B, 1, KVg * Gg, hdg), generator=gen_pd,
                              device=dev)
            for window in (None, 24):
                kw_c = dict(kw, softcap=None)
                got = PD.paged_flash_decode(q_g, kp_g, vp_g, table, pos,
                                            window, **kw_c)
                again = PD.paged_flash_decode(q_g, kp_g, vp_g, table, pos,
                                              window, **kw_c)
                assert torch.equal(got.view(torch.int32),
                                   again.view(torch.int32)), (
                    f"paged decode seed {seed}: two launches differ")
                assert bool(torch.isfinite(got).all())
                want = PD.paged_flash_decode_plain(q_g, kp_g, vp_g, table,
                                                   pos, window, **kw_c)
                d_seed = float((got - want).abs().max())
                assert d_seed <= 1e-3, (
                    f"paged decode seed {seed} (KV, G, hd) "
                    f"{(KVg, Gg, hdg)} window={window}: {d_seed}")
                spread.setdefault((KVg, Gg, hdg, window), []).append(d_seed)
                errs["paged_flash_decode"] = max(errs["paged_flash_decode"],
                                                 d_seed)
            del kp_g, vp_g
    log("[paged_decode] eight more draws (seeds 1-8) at the phase 3h, 3i and "
        "chameleon-34b geometries, max|kernel-plain| a draw, each gated at "
        "1e-3: " + "; ".join(
            f"(KV, G, hd) {k[:3]} window={k[3]}: max {max(v):.3g}, "
            f"{sum(d > 1e-3 for d in v)} of {len(v)} over 1e-3"
            for k, v in spread.items()))

    phase_start("3")
    # ---- phase 3: serve gemma2-2b FULL through the launcher -------------
    # first the fused kernel's scale of every weight the served model (the
    # same config and seed) contracts: 26 x 7 projections and the head's
    # operand, the tied embedding transposed as the cuda route lays it out
    from repro_torch.configs import gemma2_2b
    from repro_torch.launch import faultcamp, serve
    from repro_torch.models.transformer import Model
    full = Model(gemma2_2b.FULL, device=dev)
    fparams = full.init(0)
    weights = [p["w"] for layer in fparams["layers"]
               for blk in (layer["attn"], layer["mlp"]) for p in blk.values()
               if "w" in p]
    weights.append(fparams["embed"]["e"].t().contiguous())
    assert len(weights) == 26 * 7 + 1, len(weights)
    for w in weights:
        _, s = PC.posit_encode_prescaled(w, ecfg.posit)
        assert float(s) == float(_pow2_scale(w)), (tuple(w.shape), float(s))
    log(f"[weights] fused scale bit-equal to torch's _pow2_scale on all "
        f"{len(weights)} weights of the seeded FULL model")
    del full, fparams, weights, w
    torch.cuda.empty_cache()
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
    for name in ("posit_encode_prescaled", "logmac_small",
                 "paged_flash_decode", "posit_store"):
        assert launches[name] > 0, f"kernel {name} was not launched in serving"
    assert rep["launches_by_width"]["posit_encode_prescaled"].get(16, 0) > 0
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
    from repro_torch.models.layers import Ctx
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

    phase_start("3b")
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
    for name in ("posit_encode_prescaled", "logmac"):
        for w in (8, 16):
            assert by_width[name].get(w, 0) > 0, (
                f"{name} not launched at width {w}: {by_width[name]}")
    assert launches["paged_flash_decode"] == 0, launches
    # the core codec's entries: the KV writes, the gather reference's reads,
    # the guard's quantize check and sentinels (the fused guard entries)
    for name in ("posit_store", "posit_load", "posit_quantize_prescaled",
                 "posit_sentinels"):
        assert launches[name] > 0, f"{name} not launched in guarded serving"
    log(f"[guarded-serve] core codec launches: "
        f"{ {k: launches[k] for k in CORE_ENTRIES} }")
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
    pass_launches = {}
    logits = {}
    for backend in ("cuda", "guarded:cuda", "guarded:cuda", "cuda"):
        nctx = NumericsContext.from_ecfg(ecfg, backend=backend)
        torch.cuda.synchronize()
        with _uncounted():
            _build.reset_launches()
            t0 = time.perf_counter()
            logits[backend], _ = eng.model.prefill(
                eng.params, ids16, Ctx(numerics=nctx),
                eng.model.init_cache(1, 16, "uint16"))
            torch.cuda.synchronize()
            pass_s[backend].append(time.perf_counter() - t0)
            pass_launches[backend] = {k: v for k, v in _build.LAUNCHES.items()
                                      if v}
    torch.testing.assert_close(logits["guarded:cuda"], logits["cuda"],
                               rtol=1e-4, atol=2e-3)
    for name in ("posit_quantize_prescaled", "posit_sentinels"):
        assert pass_launches["guarded:cuda"].get(name, 0) > 0, (
            name, pass_launches)
    t_plain = sum(pass_s["cuda"]) / 2
    t_guard = sum(pass_s["guarded:cuda"]) / 2
    log(f"[guard-share] {card}: FULL 16-token prefill pass {t_plain:.4f} s "
        f"on cuda, {t_guard:.4f} s on guarded:cuda (guard share "
        f"{100 * (1 - t_plain / t_guard):.1f} % of a guarded pass; each "
        f"pass: {pass_s}); logits max diff "
        f"{float((logits['guarded:cuda'] - logits['cuda']).abs().max()):.3g}; "
        f"launches a pass: {pass_launches}")
    del rep, eng, logits
    torch.cuda.empty_cache()

    phase_start("3c")
    # ---- phase 3c: the fault-injection campaign entry point --------------
    _build.reset_launches()
    t0 = time.perf_counter()
    camp = faultcamp.main(["--smoke", "--guard", "--device", "cuda"])
    path_launches("faultcamp")
    assert camp["config"]["device"].startswith("cuda"), camp["config"]
    log(f"[faultcamp] {card}: smoke grid with the guard arm passed its "
        f"asserts in {time.perf_counter() - t0:.1f}s: "
        f"{json.dumps(camp['summary'], sort_keys=True)}")

    phase_start("3d")
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

    phase_start("3e")
    # ---- phase 3e: durable serving of gemma2-2b FULL, one restart -------
    # an uninterrupted sampled drain, then the same workload under a
    # ServeSupervisor whose DurableBatcher snapshots every 2 decode steps
    # and is killed at step 5; the restart builds a fresh engine over the
    # same params and resumes from the step-4 snapshot
    import numpy as np
    from repro_torch.distributed.failover import Action
    from repro_torch.serving import (DurableBatcher, GenerationConfig,
                                     PagedKVConfig, RequestBatcher,
                                     ServeEngine, ServeSupervisor,
                                     SimulatedCrash, make_key)
    nctx = NumericsContext.from_ecfg(ecfg, backend="cuda")
    full = Model(gemma2_2b.FULL, numerics=nctx, device=dev)
    fparams = full.init(0)

    def engine():
        return ServeEngine(full, fparams, Ctx(numerics=nctx), max_len=256,
                           batch=4, cache_dtype="uint16",
                           paged=PagedKVConfig(page_size=16))

    prng = np.random.default_rng(0)
    prompts = [prng.integers(0, gemma2_2b.FULL.vocab, int(prng.integers(4, 24)))
               for _ in range(8)]
    sgen = GenerationConfig(max_new_tokens=16, temperature=0.8)

    def submit(b):
        for p in prompts:
            b.submit(p, max_new=16)

    _build.reset_launches()
    base_b = RequestBatcher(engine(), prompt_buckets=(32, 128))
    submit(base_b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = base_b.run(sgen, key=make_key(7))
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    launches = path_launches("durable: uninterrupted")
    for name in ("posit_encode_prescaled", "logmac", "paged_flash_decode",
                 "posit_store"):
        assert launches[name] > 0, f"{name} not launched in the drain"
    snap_dir = os.path.join(HERE, "build", "chip_smoke_snapshots")
    shutil.rmtree(snap_dir, ignore_errors=True)
    at_crash: dict = {}

    def kill_at_5(step):
        if step == 5 and not at_crash:
            at_crash.update(_build.LAUNCHES)
            raise SimulatedCrash("killed at decode step 5")

    made: list = []  # every DurableBatcher, for its snapshots' costs

    def make_batcher():
        made.append(DurableBatcher(engine(), prompt_buckets=(32, 128),
                                   ckpt_dir=snap_dir, snapshot_every=2,
                                   on_step=kill_at_5))
        return made[-1]

    sup = ServeSupervisor(make_batcher)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sup.run(submit, sgen, key=make_key(7))
    torch.cuda.synchronize()
    sup_s = time.perf_counter() - t0
    launches = path_launches("durable: supervised")
    assert sup.restarts == 1, sup.restarts
    assert [d.action for d in sup.decisions] == [Action.ELASTIC_DOWN], \
        sup.decisions
    assert set(res) == set(base) and len(base) == 8, (sorted(res), sorted(base))
    for rid in base:
        assert np.array_equal(res[rid], base[rid]), (
            f"request {rid}: {res[rid].tolist()} after the restart, "
            f"{base[rid].tolist()} uninterrupted")
    for name in ("posit_encode_prescaled", "logmac", "paged_flash_decode",
                 "posit_store"):
        after = launches[name] - at_crash[name]
        assert at_crash[name] > 0 and after > 0, (
            f"{name}: {at_crash[name]} launches before the restart, "
            f"{after} after")

    def same_pages(want_eng, got_eng, what):
        """Every slot's mapped pages, in logical order, bit for bit."""
        for name, pool in want_eng.cache.items():
            for s in range(want_eng.batch):
                w = pool[:, want_eng.kv.pages_of(s)]
                g = got_eng.cache[name][:, got_eng.kv.pages_of(s)]
                assert torch.equal(w, g), f"{what}: slot {s}'s {name} pages"

    same_pages(base_b.engine, made[-1].engine, "killed at step 5")
    snaps = [(s, n) for b in made
             for s, n in zip(b.snapshot_s, b.snapshot_bytes)]
    log(f"[durable] {card}: 8 requests x 16 sampled tokens (T=0.8) and "
        f"every slot's pages identical after one supervised restart "
        f"(killed at step 5, resumed from step 4); uninterrupted drain "
        f"{base_s:.2f} s, "
        f"supervised drain {sup_s:.2f} s; {len(snaps)} snapshots, seconds "
        f"{[round(s, 4) for s, _ in snaps]}, bytes {sorted({n for _, n in snaps})}")
    log("[durable] " + json.dumps({
        "uninterrupted_s": base_s, "supervised_s": sup_s,
        "snapshot_s": [s for s, _ in snaps],
        "snapshot_bytes": [n for _, n in snaps],
        "launches_before_restart": {k: at_crash[k] for k in launches},
        "launches_after_restart": {k: launches[k] - at_crash[k]
                                   for k in launches}, "card": card}))
    del base_b, sup
    # a late kill: staggered budgets retire the requests at different
    # steps, and the kill two steps before the end resumes from a snapshot
    # taken after the queue drained, with a retired slot's pad row in the
    # batch (the pow2 pre-scale couples it to the live rows)
    late_new = (16, 11, 6, 14, 9, 16, 4, 12)

    def submit_late(b):
        for p, n in zip(prompts, late_new):
            b.submit(p, max_new=n)

    _build.reset_launches()
    late_b = RequestBatcher(engine(), prompt_buckets=(32, 128))
    submit_late(late_b)
    late_base = late_b.run(sgen, key=make_key(8))
    path_launches("durable, late kill: uninterrupted")
    kill_late = late_b.stats["steps"] - 2
    seen: dict = {}
    made_late: list = []

    def kill_late_hook(step):
        b = made_late[-1]
        seen.setdefault(step, (len(b.queue), b._state.active.copy()))
        if step == kill_late and len(made_late) == 1:
            raise SimulatedCrash(f"killed at decode step {step}")

    def make_late():
        made_late.append(DurableBatcher(engine(), prompt_buckets=(32, 128),
                                        ckpt_dir=snap_dir + "_late",
                                        snapshot_every=1,
                                        on_step=kill_late_hook))
        return made_late[-1]

    shutil.rmtree(snap_dir + "_late", ignore_errors=True)
    _build.reset_launches()
    sup = ServeSupervisor(make_late)
    res_late = sup.run(submit_late, sgen, key=make_key(8))
    launches_late = path_launches("durable, late kill: supervised")
    queued, active = seen[kill_late - 1]   # the snapshot resumed from
    assert queued == 0 and not active.all() and active.any(), seen
    assert sup.restarts == 1, sup.restarts
    assert [d.action for d in sup.decisions] == [Action.ELASTIC_DOWN]
    assert set(res_late) == set(late_base), sorted(res_late)
    for rid in late_base:
        assert np.array_equal(res_late[rid], late_base[rid]), (
            f"late kill, request {rid}: {res_late[rid].tolist()} after the "
            f"restart, {late_base[rid].tolist()} uninterrupted")
    assert made_late[-1].stats == late_b.stats
    same_pages(late_b.engine, made_late[-1].engine,
               f"killed at step {kill_late}")
    log(f"[durable] {card}: late kill at step {kill_late} of "
        f"{late_b.stats['steps']} (budgets {late_new}): resumed from step "
        f"{kill_late - 1} with slots {active.astype(int).tolist()} active "
        f"and the queue drained; tokens and every slot's pages identical "
        f"to the uninterrupted drain; launches {launches_late}")
    shutil.rmtree(snap_dir + "_late", ignore_errors=True)
    del late_b, made_late, sup, res_late, late_base
    shutil.rmtree(snap_dir, ignore_errors=True)
    del made, full, fparams, res, base
    gc.collect()  # the engines go before phase 3f measures its peak
    torch.cuda.empty_cache()

    phase_start("3f")

    def smoke_logits_on_card(mod, what, cache_dtype=None):
        """The SMOKE model's prefill logits on the kernels against the
        reference engine, on the card."""
        ids = torch.randint(0, mod.SMOKE.vocab, (2, 16), generator=gen,
                            device=dev)
        outs, params = {}, None
        for backend in ("cuda", "lax_ref"):
            nctx = NumericsContext.from_ecfg(ecfg, backend=backend)
            m = Model(mod.SMOKE, numerics=nctx, device=dev)
            params = params if params is not None else m.init(1)
            outs[backend], _ = m.prefill(params, ids, Ctx(numerics=nctx),
                                         m.init_cache(2, 16, cache_dtype))
        torch.testing.assert_close(outs["cuda"], outs["lax_ref"], rtol=1e-4,
                                   atol=2e-3)
        log(f"[smoke-model {what}] cuda vs lax_ref prefill logits max diff "
            f"{float((outs['cuda'] - outs['lax_ref']).abs().max()):.3g}")

    # ---- phase 3f: the ssm and hybrid families at FULL size -------------
    from repro_torch.configs import hymba_1p5b, mamba2_1p3b
    for arch, mod in (("mamba2-1.3b", mamba2_1p3b),
                      ("hymba-1.5b", hymba_1p5b)):
        held = torch.cuda.memory_allocated(dev)
        _build.reset_launches()
        rep = serve.main(["--arch", arch, "--full", "--backend", "cuda",
                          "--euler", "L-21b", "--width", "16", "--device",
                          "cuda", "--batch", "4", "--max-len", "256",
                          "--requests", "8", "--max-new", "16",
                          "--seed", "0"])
        launches = path_launches(f"serve {arch}")
        assert (rep["n_layers"], rep["d_model"]) == (
            mod.FULL.n_layers, mod.FULL.d_model), rep["arch"]
        assert rep["tokens"] == 128, rep["tokens"]
        # the launcher's prompts (4-23 tokens, buckets 32 and 128) prefill
        # at M = 32: the small-M kernel takes them and every decode step
        for name in ("posit_encode_prescaled", "logmac_small"):
            assert launches[name] > 0, f"{name} not launched serving {arch}"
        assert launches["logmac_tile"] == 0, launches
        assert launches["paged_flash_decode"] == 0, launches
        # a prefill of the 128-token bucket (RequestBatcher's default
        # first bucket): its projections take the tensor-core kernel, never
        # the tile kernel (the head, on the last position, the small one)
        eng = rep["engine"]
        first = next(iter(rep["results"].values()))
        ids128 = torch.as_tensor((list(first) * 128)[:128], device=dev)
        _build.reset_launches()
        with ssd_subnormals() as tally:
            logits, _ = eng.model.prefill(eng.params, ids128[None, :],
                                          eng.ctx,
                                          eng.model.init_cache(1, 128))
        pre = path_launches(f"prefill {arch} 128 tokens")
        nsub, nval = int(tally["subnormal"]), tally["values"]
        share = 100 * nsub / max(nval, 1)
        log(f"[serve {arch}] the SSD's operands in the 128-token prefill: "
            f"{nsub} subnormal of {nval} values ({share:.4f} %) in "
            f"{tally['operands']} pre-scaled operands, "
            f"{int(tally['with'])} of them holding one or more")
        assert pre["logmac_mma"] > 0 and pre["logmac_tile"] == 0, pre
        assert logits.shape == (1, mod.FULL.vocab_padded)
        assert bool(torch.isfinite(logits).all()), f"non-finite {arch} logits"
        log(f"[serve {arch}] {card}: {rep['tok_per_s']:.2f} tok/s, request "
            f"latency p50 {rep['latency_p50_s']:.3f}s p99 "
            f"{rep['latency_p99_s']:.3f}s, {rep['steps']} steps, "
            f"{rep['refills']} refills, max_memory_allocated "
            f"{rep['max_memory_allocated'] / 2**30:.2f} GiB (of it "
            f"{held / 2**30:.2f} GiB held before the launch)")
        line = {k: rep[k] for k in (
            "tokens", "seconds", "tok_per_s", "latency_p50_s",
            "latency_p99_s", "steps", "refills", "max_memory_allocated",
            "launches")}
        line.update(arch=arch, card=card, allocated_before=held)
        log(f"[serve {arch}] " + json.dumps(line))
        del rep, eng, logits
        torch.cuda.empty_cache()
        smoke_logits_on_card(mod, arch)

    phase_start("3g")
    # ---- phase 3g: training (the QAT train step on lax_ref, the eval step
    # on the kernels) ------------------------------------------------------
    from repro_torch import tree as T
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as TR
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.training import (init_state, make_eval_step,
                                      make_train_step)
    lax_nctx = NumericsContext.from_ecfg(ecfg, backend="lax_ref")

    def smoke_trainer(device):
        m = Model(gemma2_2b.SMOKE, numerics=lax_nctx, device=device)
        opt = AdamW(lr=cosine_schedule(3e-3, 20, 100), weight_decay=0.01)
        return m, opt, make_train_step(m, opt, m.make_ctx())

    # the SMOKE model's initial state, drawn once on the CPU
    cpu_m, cpu_opt, _ = smoke_trainer("cpu")
    state0 = init_state(cpu_m, cpu_opt, 0)
    smoke_data = SyntheticLM(vocab=gemma2_2b.SMOKE.vocab, seed=0)
    with TR.deterministic():
        # 1. two steps on the card and on the CPU, in this process
        smoke_loss = {}
        for device in ("cuda", "cpu"):
            _, _, step_fn = smoke_trainer(device)
            st = state0.to(device)
            smoke_loss[device] = []
            for i in range(2):
                st, out = step_fn(st, smoke_data.batch(i, 4, 64,
                                                       device=device))
                smoke_loss[device].append(float(out["loss"]))
        np.testing.assert_allclose(smoke_loss["cuda"], smoke_loss["cpu"],
                                   rtol=1e-4, atol=2e-3)
        log(f"[train smoke] gemma2 SMOKE L-21b lax_ref, batch 4 seq 64: "
            f"losses on the card {smoke_loss['cuda']}, on the CPU "
            f"{smoke_loss['cpu']}")
        # 2. the same single step twice from the same init: bit-identical
        _, _, step_fn = smoke_trainer(dev)
        runs = []
        for _ in range(2):
            st, out = step_fn(state0.to(dev),
                              smoke_data.batch(0, 4, 64, device=dev))
            runs.append((float(out["loss"]),
                         [float(p.detach().double().sum())
                          for p in T.leaves(st.params)], st))
        assert runs[0][0] == runs[1][0], (runs[0][0], runs[1][0])
        assert runs[0][1] == runs[1][1], "parameter sums differ on replay"
        for a, b in zip(T.leaves(runs[0][2].tree()),
                        T.leaves(runs[1][2].tree())):
            assert torch.equal(a, b), "a state leaf differs on replay"
        log(f"[train determinism] one step replayed: loss {runs[0][0]!r} "
            f"and all {len(runs[0][1])} parameter leaves bit-identical")
        del runs, st, state0, cpu_m
    # 3. hymba-1.5b FULL through the launcher
    hymba = hymba_1p5b.FULL
    init_sums = [float(p.double().sum()) for p in
                 T.leaves(Model(hymba, device=dev).init(0))]
    torch.cuda.empty_cache()
    rep = TR.main(["--arch", "hymba-1.5b", "--steps", "3", "--batch", "2",
                   "--seq", "128", "--log-every", "1", "--euler", "L-21b",
                   "--width", "16", "--backend", "lax_ref", "--seed", "0",
                   "--device", "cuda"])
    assert not torch.are_deterministic_algorithms_enabled()
    assert (rep["n_layers"], rep["d_model"]) == (hymba.n_layers,
                                                 hymba.d_model)
    assert np.isfinite(rep["losses"]).all() and len(rep["losses"]) == 3
    assert np.isfinite(rep["grad_norms"]).all()
    params = rep["state"].params
    sums = [float(p.detach().double().sum()) for p in T.leaves(params)]
    moved = sum(a != b for a, b in zip(sums, init_sums))
    assert moved == len(sums), f"{len(sums) - moved} leaves did not move"
    train_line = {k: rep[k] for k in (
        "arch", "params", "losses", "grad_norms", "seconds", "s_per_step",
        "allocated_before", "max_memory_allocated")}
    train_line["card"] = card
    log(f"[train hymba-1.5b] {card}: {rep['params']} params, losses "
        f"{rep['losses']}, grad norms {rep['grad_norms']}, "
        f"{rep['s_per_step']:.2f} s/step, max_memory_allocated "
        f"{rep['max_memory_allocated'] / 2**30:.2f} GiB (of it "
        f"{rep['allocated_before'] / 2**30:.2f} GiB held before the launch); "
        f"all {moved} parameter leaves moved")
    log("[train hymba-1.5b] " + json.dumps(train_line))
    # the eval step with the trained parameters: the kernels against the
    # reference engine, the logits bar carried through the mean
    # log-softmax: |d loss| <= 2 (2e-3 + 1e-4 max|logit|)
    eval_batch = SyntheticLM(vocab=hymba.vocab, seed=0).batch(
        3, 2, 128, device=dev)
    evals = {}
    for backend in ("lax_ref", "cuda"):
        nctx = NumericsContext.from_ecfg(ecfg, backend=backend)
        m = Model(hymba, numerics=nctx, device=dev)
        if backend == "cuda":
            _build.reset_launches()
        # the trained parameters require grad; the eval step runs without
        # autograd by itself
        evals[backend] = float(make_eval_step(m, m.make_ctx())(
            params, eval_batch)["loss"])
        if backend == "cuda":
            eval_launches = path_launches("eval hymba-1.5b")
        else:
            with torch.no_grad():
                hidden, _ = m.forward(params, eval_batch["inputs"],
                                      m.make_ctx())
                max_logit = float(m.head(params, hidden, m.make_ctx())[
                    ..., :hymba.vocab].abs().max())
            del hidden
    bound = 2 * (2e-3 + 1e-4 * max_logit)
    diff = abs(evals["cuda"] - evals["lax_ref"])
    assert diff <= bound, (evals, bound)
    for name in ("posit_encode_prescaled", "logmac_mma"):
        assert eval_launches[name] > 0, f"{name} not launched in the eval"
    assert eval_launches["logmac_tile"] == 0, eval_launches
    log(f"[train eval] {card}: hymba-1.5b FULL eval loss cuda "
        f"{evals['cuda']!r} vs lax_ref {evals['lax_ref']!r}: |diff| "
        f"{diff:.3g} <= {bound:.3g} (max|logit| {max_logit:.3g}); "
        f"launches {eval_launches}")
    del rep, params, m
    gc.collect()
    torch.cuda.empty_cache()
    # the same first step under remat policy "dots" beside "nothing"
    dots_remat_step(dev, card, ecfg)
    # 4. the plain codec's memory: forward and backward of one [2304,
    # 25600] weight (gemma2's MLP shape, widened) at 256 tokens
    w = (torch.randn((2304, 25600), generator=gen, device=dev)
         * 2304 ** -0.5).requires_grad_(True)
    x = torch.randn((256, 2304), generator=gen, device=dev).requires_grad_(
        True)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = euler_dot_general(x, w, (((1,), (0,)), ((), ())), ecfg)
    out.sum().backward()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - held
    log(f"[codec memory] {card}: euler_dot_general L-21b forward + "
        f"backward of f32 [256, 2304] x [2304, 25600]: peak {peak} bytes "
        f"over the {held} held, {peak / w.numel():.1f} bytes per weight "
        f"value")
    del w, x, out
    torch.cuda.empty_cache()

    def serve_line(rep, what, held, **extra):
        log(f"[serve {what}] {card}: {rep['tok_per_s']:.3f} tok/s, "
            f"{rep['tokens']} tokens in {rep['seconds']:.2f} s, request "
            f"latency p50 {rep['latency_p50_s']:.3f}s p99 "
            f"{rep['latency_p99_s']:.3f}s, {rep['steps']} steps, "
            f"{rep['refills']} refills, max_memory_allocated "
            f"{rep['max_memory_allocated'] / 2**30:.2f} GiB (of it "
            f"{held / 2**30:.2f} GiB held before the launch)")
        line = {k: rep[k] for k in (
            "arch", "n_layers", "d_model", "tokens", "seconds", "tok_per_s",
            "latency_p50_s", "latency_p99_s", "steps", "refills",
            "max_memory_allocated", "launches")}
        line.update(card=card, allocated_before=held, **extra)
        log(f"[serve {what}] " + json.dumps(line))

    phase_start("3h")
    # ---- phase 3h: the moe family, llama4-scout at full width, cut depth -
    # d_model 5120, 40/8 heads of 128, 16 experts of d_ff 8192, top-1,
    # vocab 202048; paged uint16 cache, P16 L-21b.  The attention
    # projections and the head take the fused encode and logmac, decode
    # attention paged decode (G = 5, head_dim 128); the experts' three
    # batched contractions a layer run the reference engine, as in JAX
    from repro_torch.configs import llama4_scout_17b_a16e as llama4
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    t_3h = time.perf_counter()
    rep = serve.main(["--arch", "llama4-scout-17b-a16e", "--full",
                      "--layers", str(LLAMA4_LAYERS), "--paged",
                      "--page-size", "16", "--cache-dtype", "uint16",
                      "--backend", "cuda", "--euler", "L-21b", "--width",
                      "16", "--device", "cuda", "--batch", "4", "--max-len",
                      "256", "--requests", "4", "--max-new", "4",
                      "--seed", "0"])
    launches = path_launches("serve llama4-scout")
    assert (rep["n_layers"], rep["d_model"]) == (LLAMA4_LAYERS, 5120)
    assert rep["tokens"] == 16, rep["tokens"]
    for name in ("posit_encode_prescaled", "logmac_small",
                 "paged_flash_decode"):
        assert launches[name] > 0, f"{name} not launched serving llama4"
    assert launches["logmac_tile"] == 0, launches
    eng = rep["engine"]
    per_layer = sum(t.numel() for t in T.leaves(eng.params["layers"][0])
                    ) * 4
    first = next(iter(rep["results"].values()))
    ids16 = torch.as_tensor((list(first) * 16)[:16], device=dev)
    with torch.no_grad():
        logits, _ = eng.model.prefill(eng.params, ids16[None, :], eng.ctx,
                                      eng.model.init_cache(1, 16, "uint16"))
    assert logits.shape == (1, llama4.FULL.vocab_padded)
    assert bool(torch.isfinite(logits[:, :llama4.FULL.vocab]).all())
    secs_3h = time.perf_counter() - t_3h
    log(f"[serve llama4-scout] {card}: L = {LLAMA4_LAYERS} of "
        f"{llama4.FULL.n_layers} layers at full width; weights "
        f"{per_layer / 2**30:.2f} GiB a layer, peak "
        f"{rep['max_memory_allocated'] / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; "
        f"phase seconds so far {secs_3h:.1f} (the experts on the reference "
        f"engine)")
    serve_line(rep, "llama4-scout", held, layers=LLAMA4_LAYERS,
               weight_bytes_per_layer=per_layer)
    del rep, eng, logits
    gc.collect()
    torch.cuda.empty_cache()
    smoke_logits_on_card(llama4, "llama4-scout", "uint16")

    phase_start("3i")
    # ---- phase 3i: the audio family, musicgen-large FULL -----------------
    # 48 layers, d 2048, 32/32 heads of 64 (paged decode at G = 1), gelu
    # MLP, vocab 2048; served from EnCodec token ids, then one prefill from
    # the stub frontend's float frame embeddings against lax_ref
    from repro_torch.configs import musicgen_large
    from repro_torch.data import batch_for_step
    from repro_torch.numerics import backends as NB
    held = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    rep = serve.main(["--arch", "musicgen-large", "--full", "--paged",
                      "--page-size", "16", "--cache-dtype", "uint16",
                      "--backend", "cuda", "--euler", "L-21b", "--width",
                      "16", "--device", "cuda", "--batch", "4", "--max-len",
                      "256", "--requests", "8", "--max-new", "16",
                      "--seed", "0"])
    launches = path_launches("serve musicgen-large")
    assert (rep["n_layers"], rep["d_model"]) == (48, 2048), rep["arch"]
    assert rep["tokens"] == 128, rep["tokens"]
    for name in ("posit_encode_prescaled", "logmac_small",
                 "paged_flash_decode"):
        assert launches[name] > 0, f"{name} not launched serving musicgen"
    serve_line(rep, "musicgen-large", held)
    eng = rep["engine"]
    frames = batch_for_step(SyntheticLM(vocab=musicgen_large.FULL.vocab,
                                        seed=0), 0, 1, 32,
                            embeddings_dim=musicgen_large.FULL.d_model,
                            device=dev)["inputs"]
    assert tuple(frames.shape) == (1, 32, 2048)
    # the frames through all 48 layers: every contraction the kernels take
    # (the fused encode and logmac) also run by the reference engine on the
    # same operands and held to the logits bar; then the whole prefill
    # against lax_ref, whose end-to-end distance is reported: over 48
    # layers a ulp-level difference of the f32 sums can flip an
    # activation's posit or the residual's bfloat16 rounding, and the
    # flips compound (PERF.md)
    class ShadowedCuda(NB.CudaBackend):
        """The cuda backend, each single-contraction euler dot compared
        with the reference engine's on the same operands."""

        name = "cuda-shadowed"
        compared, worst = 0, 0.0

        def dot_general(self, a, b, dimension_numbers, cfg):
            out = super().dot_general(a, b, dimension_numbers, cfg)
            if (cfg.mode == "euler" and NB._single_contraction(
                    a, b, dimension_numbers) is not None):
                ref = NB.LaxRefBackend.dot_general(self, a, b,
                                                   dimension_numbers, cfg)
                if not torch.allclose(out, ref, rtol=1e-4, atol=2e-3):
                    # the operands' pow2 scales: the kernel's (f64 mean)
                    # and torch's _pow2_scale (f32 mean)
                    scales = [(float(PC.posit_encode_prescaled(
                        t.contiguous().float(), cfg.posit)[1]),
                        float(_pow2_scale(t))) for t in (a, b)]
                    raise AssertionError(
                        f"kernel contraction {tuple(a.shape)} x "
                        f"{tuple(b.shape)} off the reference engine by "
                        f"{float((out - ref).abs().max())}; scales "
                        f"(kernel, torch) {scales}")
                self.compared += 1
                self.worst = max(self.worst,
                                 float((out - ref).abs().max()))
            return out

    shadow = NB.register_backend("cuda-shadowed", ShadowedCuda())
    frame_logits = {}
    for backend in ("cuda-shadowed", "lax_ref"):
        nctx = NumericsContext.from_ecfg(ecfg, backend=backend)
        m = Model(musicgen_large.FULL, numerics=nctx, device=dev)
        _build.reset_launches()
        with torch.no_grad():
            frame_logits[backend], _ = m.prefill(
                eng.params, frames, Ctx(numerics=nctx),
                m.init_cache(1, 32, "uint16"))
        if backend != "lax_ref":
            emb_launches = path_launches("prefill musicgen frames")
    for kern in ("posit_encode_prescaled", "logmac_small"):
        assert emb_launches[kern] > 0, emb_launches
    got, want = frame_logits["cuda-shadowed"], frame_logits["lax_ref"]
    assert got.shape == (1, 2048) and bool(torch.isfinite(got).all())
    assert shadow.compared == emb_launches["logmac"], (
        shadow.compared, emb_launches)
    drift = float((got - want).abs().max())
    log(f"[prefill musicgen frames] {card}: [1, 32, 2048] stub-frontend "
        f"embeddings through all 48 layers: each of the {shadow.compared} "
        f"kernel contractions within the logits bar of the reference "
        f"engine on its operands (largest |diff| {shadow.worst:.3g}); the "
        f"logits' end-to-end distance from lax_ref {drift:.3g} (max|logit| "
        f"{float(want.abs().max()):.3g}, argmax "
        f"{'equal' if int(got.argmax()) == int(want.argmax()) else 'differs'}"
        f")")
    del rep, eng, frame_logits, got, want, m
    gc.collect()
    torch.cuda.empty_cache()
    smoke_logits_on_card(musicgen_large, "musicgen-large", "uint16")

    phase_start("3j")
    # ---- phase 3j: lockstep ServeEngine.generate, yi-6b FULL -------------
    # 32 layers, d 4096, GQA 32/4 heads of 128; batch 4 x 8-token prompts,
    # 8 new tokens, greedy, dense uint16 cache: the same tokens as the
    # model's own prefill + decode_step + argmax loop.  A RequestBatcher
    # drain of the same prompts (8-token bucket: no pads) on the same
    # engine is reported beside it, not held equal: its batch-1 prefills
    # see another pow2 pre-scale of the activations (taken over every row
    # of a call) and, at M = 8 against 32, another split of K among the
    # small-M kernel's warps, so its tokens may part from the lockstep
    # ones at a near tie (PERF.md)
    from repro_torch.configs import yi_6b
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    nctx = NumericsContext.from_ecfg(ecfg, backend="cuda")
    m = Model(yi_6b.FULL, remat=False, numerics=nctx, device=dev)
    eng = ServeEngine(m, m.init(0), Ctx(numerics=nctx), max_len=64,
                      batch=4, cache_dtype="uint16")
    prompts = np.random.default_rng(0).integers(
        0, yi_6b.FULL.vocab, (4, 8)).astype(np.int32)
    gen_cfg = GenerationConfig(max_new_tokens=8)
    _build.reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        toks = eng.generate(prompts, gen_cfg)
    torch.cuda.synchronize(dev)
    gen_s = time.perf_counter() - t0
    gen_launches = path_launches("generate yi-6b")
    for name in ("posit_encode_prescaled", "logmac_small"):
        assert gen_launches[name] > 0, gen_launches
    with torch.no_grad():
        cache = m.init_cache(4, 64, "uint16")
        logits, _ = m.prefill(eng.params, torch.as_tensor(prompts,
                                                          device=dev),
                              eng.ctx, cache)
        step = [torch.argmax(logits, -1).to(torch.int32)]
        for i in range(7):
            pos = torch.full((4,), 8 + i, dtype=torch.int32, device=dev)
            logits, _ = m.decode_step(eng.params, step[-1], pos, cache,
                                      eng.ctx)
            step.append(torch.argmax(logits, -1).to(torch.int32))
    assert torch.equal(toks, torch.stack(step, 1)), "generate != stepwise"
    del cache, logits, step
    batcher = RequestBatcher(eng, prompt_buckets=(8,))
    rids = [batcher.submit(p, max_new=8) for p in prompts]
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        res = batcher.run(gen_cfg)
    torch.cuda.synchronize(dev)
    drain_s = time.perf_counter() - t0
    path_launches("drain yi-6b")
    got = toks.cpu().numpy()
    drained = np.stack([np.asarray(res[r]) for r in rids])
    assert drained.shape == got.shape
    assert ((drained >= 0) & (drained < yi_6b.FULL.vocab)).all()
    same = int((drained == got).sum())
    parted = {i: int(np.argmax(drained[i] != got[i]))
              for i in range(4) if (drained[i] != got[i]).any()}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[generate yi-6b] {card}: batch 4 x 8 prompt tokens, 8 new: "
        f"{toks.numel() / gen_s:.3f} tok/s in {gen_s:.2f} s "
        f"({eng.last_decode_steps} decode steps), equal to the stepwise "
        f"loop; the batcher's drain {toks.numel() / drain_s:.3f} tok/s in "
        f"{drain_s:.2f} s, {same} of {toks.numel()} tokens equal to "
        f"generate's (rows parting at token: {parted}); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB (of it "
        f"{held / 2**30:.2f} GiB held before)")
    log("[generate yi-6b] " + json.dumps({
        "card": card, "tokens": int(toks.numel()), "generate_s": gen_s,
        "generate_tok_per_s": toks.numel() / gen_s, "drain_s": drain_s,
        "drain_tok_per_s": toks.numel() / drain_s,
        "tokens_equal_to_drain": same, "rows_parting_at": parted,
        "max_memory_allocated": peak, "allocated_before": held,
        "launches": gen_launches}))
    del eng, m, batcher, toks
    gc.collect()
    torch.cuda.empty_cache()

    phase_start("3k")
    # ---- phase 3k: the public numerics API and the paper's arithmetic ---
    got = phase_numerics(dev, gen, card, path_launches, logmac_kernel)
    # 14 configurations at two row counts, one logmac each, and the
    # out_quant call's
    assert got["posit_decode"] == 4 and got["logmac"] == 29, got
    assert got["posit_quantize"] == 1, got
    # the first two examples, each with its own assertions
    from repro_torch.examples import mixed_precision, quickstart
    _build.reset_launches()
    qs = quickstart.run("cuda")
    mp = mixed_precision.run("cuda")
    torch.cuda.synchronize()
    ex_launches = path_launches("examples")
    for name in ("posit_encode", "posit_encode_prescaled", "logmac"):
        assert ex_launches[name] > 0, f"{name} not launched by the examples"
    log(f"[examples] {card}: quickstart kernel vs engine "
        f"{qs['kernel_diff']:.3g}, lax_ref vs cuda {qs['api_diff']:.3g}; "
        f"mixed_precision lax_ref vs cuda {mp['diff']:.3g} (< 1e-3), "
        f"policy live {mp['live']:.3g}")

    phase_start("3l")
    _free()
    got = phase_multi_device(card, path_launches)
    for name in ("posit_encode_prescaled", "logmac"):
        assert got[name] > 0, f"{name} not launched by the data ranks"

    phase_start("4")
    # ---- phase 4: timings ----------------------------------------------
    flush_buf = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    rows = []
    # encode at the MLP weight shape the main path encodes every step
    xw = torch.randn((2304, 9216), generator=gen, device=dev)
    n = xw.numel()
    enc_ms = time_ms(lambda: PC.posit_encode(xw, ecfg.posit), flush=flush)
    enc_dev = time_ms(lambda: PC.posit_encode(xw, ecfg.posit), flush=flush,
                      device_only=True)
    enc_plain = time_ms(lambda: PC.encode_plain(xw, ecfg.posit), reps=3,
                        flush=flush)
    enc_bytes = n * 4 + n * 4
    rows.append({"name": "posit_encode", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/posit_encode.cu",
                 "replaces": "src/repro/kernels/posit_codec.py:73",
                 "shape": "f32 [2304, 9216] -> uint32",
                 "bytes": enc_bytes, "flops": 0,
                 "ms": enc_ms, "device_ms": enc_dev, "plain_ms": enc_plain})
    # the fused pre-scale + encode at the five weight shapes (the model
    # init's scale) and a decode activation, beside the parent route
    # (torch's _pow2_scale, the divide, the plain encode launch); 12 B a
    # value: x read twice, the words written once
    def parent_route(x):
        return PC.posit_encode((x / _pow2_scale(x)).contiguous(), ecfg.posit)

    for K, N in [(2304, 9216)] + [kn for kn in GEMMA_KN
                                  if kn != (2304, 9216)] + [(4, 2304)]:
        big = N > 100000
        xf = torch.randn((K, N), generator=gen, device=dev) * (
            0.02 if big else (1.0 if K == 4 else K ** -0.5))
        nv = xf.numel()

        def fused():
            return PC.posit_encode_prescaled(xf, ecfg.posit)

        reps = 5 if big else 10
        ms = time_ms(fused, reps=reps, flush=flush)
        dev_ms = time_ms(fused, reps=reps, flush=flush, device_only=True)
        par_ms = time_ms(lambda: parent_route(xf), reps=reps, flush=flush)
        par_dev = time_ms(lambda: parent_route(xf), reps=reps, flush=flush,
                          device_only=True)
        # the plain int64 codec of the head's 590 M values does not fit
        pms = None if big else time_ms(
            lambda: PC.encode_prescaled_plain(xf, ecfg.posit), reps=3,
            flush=flush)
        plan = PC._encode_plan(nv)
        rows.append({"name": "posit_encode_prescaled", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/posit_encode.cu",
                     "replaces": "src/repro/kernels/posit_codec.py:73 and "
                                 "src/repro/core/engine.py:135",
                     "shape": f"f32 [{K}, {N}] -> (uint32, s) ("
                              f"{plan.reduce_blocks} + "
                              f"{plan.encode_blocks} blocks); parent route {par_ms:.4f} ms "
                                f"host-issued, {par_dev:.4f} ms device",
                     "bytes": 12 * nv, "flops": 0, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": pms,
                     "parent_ms": par_ms, "parent_device_ms": par_dev})
        del xf
    # decode of the same weight's P16 words: 4 B in and 4 B out per word
    pw = PC.posit_encode(xw, ecfg.posit)
    dec_ms = time_ms(lambda: PC.posit_decode(pw, ecfg.posit), flush=flush)
    dec_dev = time_ms(lambda: PC.posit_decode(pw, ecfg.posit), flush=flush,
                      device_only=True)
    dec_plain = time_ms(lambda: PC.decode_plain(pw, ecfg.posit), reps=3,
                        flush=flush)
    rows.append({"name": "posit_decode", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/posit_decode.cu",
                 "replaces": "src/repro/kernels/posit_codec.py:77",
                 "shape": "uint32 [2304, 9216] -> f32",
                 "bytes": n * 4 + n * 4, "flops": 0,
                 "ms": dec_ms, "device_ms": dec_dev, "plain_ms": dec_plain})
    del pw
    # the core codec's entries (csrc/posit_core_codec.cu) at the serving
    # shapes, first row of each the kernels line's: the guard's check
    # operand, posit_quantize_prescaled of the MLP weight (its pow2 scale
    # from the fused encode's reduce; 12 B a value: x twice, q once), then
    # the other weight shapes, the head's transposed embedding (read in
    # place) and a decode activation; the guard's sentinels of a 16-token
    # prefill's MLP output, of its logits and of a decode step's output
    # (8 B a value: x twice); out_quant's posit_quantize (no scale; 8 B a
    # value) of the public API call's output; a decode step's K/V write, bf16 [4, 4, 288]
    # -> int16 (52 a decode step; 2 + 2 B a value), beside [2304, 9216]
    # and a strided slice of a prefill slab (copied contiguous first); the
    # gather reference's read of one layer's K or V, int16 [4, 256, 4,
    # 288] -> bf16 (52 a guarded decode step), beside [2304, 9216] -> f32
    spc = ecfg.posit
    core_rows = []
    for K, N in [(2304, 9216)] + [kn for kn in GEMMA_KN
                                  if kn != (2304, 9216)] + [(4, 2304)]:
        big = N > 100000
        xq = (torch.randn((N, K), generator=gen, device=dev).t() * 0.02
              if big else torch.randn((K, N), generator=gen, device=dev)
              * (1.0 if K == 4 else K ** -0.5))
        core_rows.append(("posit_quantize_prescaled", f"f32 [{K}, {N}]"
                          + (" (transposed)" if big else "") + " -> (q, s)",
                          lambda xq=xq: PC.posit_quantize_prescaled(xq, spc),
                          lambda xq=xq: PC.quantize_prescaled_plain(xq, spc),
                          12 * xq.numel(), big))
    for M, N in ((16, 9216), (16, 256000), (4, 2304)):
        xo = torch.randn((M, N), generator=gen, device=dev) * 4.0
        core_rows.append(("posit_sentinels", f"f32 [{M}, {N}] -> int64 [2]",
                          lambda xo=xo: PC.posit_sentinels(xo, spc),
                          lambda xo=xo: PC.sentinels_plain(xo, spc),
                          8 * xo.numel(), False))
    yo = torch.randn((128, 9216), generator=gen, device=dev) * 4.0
    core_rows.append(("posit_quantize", "f32 [128, 9216] (out_quant)",
                      lambda: PC.posit_quantize(yo, spc),
                      lambda: PC.quantize_plain(yo, spc), 8 * yo.numel(),
                      False))
    kv_row = torch.randn((4, 4, 288), generator=gen, device=dev).to(
        torch.bfloat16)
    slab = torch.randn((4, 16, 4, 288), generator=gen, device=dev).to(
        torch.bfloat16)
    core_rows += [
        ("posit_store", "bf16 [4, 4, 288] -> int16 (a K/V write)",
         lambda: PC.posit_store(kv_row, spc),
         lambda: PC.store_plain(kv_row, spc), kv_row.numel() * 4, False),
        ("posit_store", "f32 [2304, 9216] -> int16",
         lambda: PC.posit_store(xw, spc), lambda: PC.store_plain(xw, spc),
         n * 6, False),
        ("posit_store", "bf16 [4, 16, 4, 288][:, 3] -> int16 (strided: "
         "copied first)", lambda: PC.posit_store(slab[:, 3], spc),
         lambda: PC.store_plain(slab[:, 3], spc), kv_row.numel() * 4,
         False)]
    kv_words = PC.posit_store(torch.randn(
        (4, 256, 4, 288), generator=gen, device=dev), spc)
    w16 = PC.posit_store(xw, spc)
    core_rows += [
        ("posit_load", "int16 [4, 256, 4, 288] -> bf16 (a layer's K or V)",
         lambda: PC.posit_load(kv_words, spc, torch.bfloat16),
         lambda: PC.load_plain(kv_words, spc, torch.bfloat16),
         kv_words.numel() * 4, False),
        ("posit_load", "int16 [2304, 9216] -> f32",
         lambda: PC.posit_load(w16, spc, torch.float32),
         lambda: PC.load_plain(w16, spc, torch.float32), n * 6, False)]
    for name, shape, kern, plain, nbytes, big in core_rows:
        reps = 5 if big else 10
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/posit_core_codec.cu",
            "replaces": "no TPU kernel: " + CORE_REPLACES[name]
                        + " (XLA code, no pallas_call)",
            "shape": shape, "bytes": nbytes, "flops": 0,
            "ms": time_ms(kern, reps=reps, flush=flush),
            "device_ms": time_ms(kern, reps=reps, flush=flush,
                                 device_only=True),
            "plain_ms": time_ms(plain, reps=2 if big else 3, flush=flush)})
    del core_rows, kv_words, w16
    # host dispatches a call: the aten ops of the KV-cache codec and the
    # guard's quantize on the card, the kernel route against the plain
    from repro_torch.models.layers import cache_decode, cache_encode
    kv16 = PC.posit_store(slab, spc)
    xa = xw[:4].contiguous()
    dispatch = {
        "cache_encode": (lambda: cache_encode(kv_row, torch.int16, spc),
                         lambda: PC.store_plain(kv_row, spc)),
        "cache_decode": (lambda: cache_decode(kv16, torch.bfloat16, spc),
                         lambda: PC.load_plain(kv16, spc, torch.bfloat16)),
        "the guard's quantize check [4, 9216]": (
            lambda: PC.posit_quantize_prescaled(xa, spc),
            lambda: PC.quantize_prescaled_plain(xa, spc)),
        "the guard's sentinels [4, 9216]": (
            lambda: PC.posit_sentinels(xa, spc),
            lambda: PC.sentinels_plain(xa, spc))}
    with _uncounted():
        log(f"[dispatch] {card}: aten ops a call on the card, kernel route "
            f"/ plain: " + ", ".join(
                f"{k} {aten_ops(a)} / {aten_ops(b)}"
                for k, (a, b) in dispatch.items()))
    del kv_row, slab, kv16, xa
    # logmac: every projection shape at decode width (M=4) at P16, the
    # prefill buckets (M=16, 32) and the 128-token bucket (M=128: the fp16
    # tensor-core kernel at P16 and P8 L-21b, the bf16-piece kernel at P32
    # L-21b on all five shapes and at P16 L-1b, the tile kernel at the
    # unbounded P32 L-21) on the MLP shape, and decode width at the
    # ladder's P8 and the guard's P32 (4 B per weight word at every width,
    # so one byte formula; the fp16 kernel's operations, 2 x 2MNK, at
    # fp16's rate, the bf16-piece kernel's piece products at bf16's, the
    # others' at f32's).  floor_ms: the SASS instructions that decode the
    # K*N weight words of an L-21b format, issued at one per lane per clock
    # (4 x 32 lanes per SM) at the card's top SM clock.  Beside each mma and
    # pieces row, the f32 tile kernel (unchanged since it took every
    # M > 32) on the same inputs
    tile_fn = _build.function("logmac", "logmac_launch",
                              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                              + [ctypes.c_void_p])

    def tile_kernel(a, b, wcfg):
        out = torch.empty((a.shape[0], b.shape[1]), device=dev)
        _build.check(tile_fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             a.shape[0], b.shape[1], a.shape[1],
                             *LM._format_args(wcfg), _build.stream_ptr(a)),
                     "logmac tile")
        return out

    def logmac_row(M, K, N, wcfg, what, reps=10, plain_reps=3):
        a, b = bits((M, K), wcfg.posit), bits((K, N), wcfg.posit)
        plan = LM.plan_of(M, N, K, wcfg)
        products = (sum(p * p for p in plan.pieces) if plan.kind == "pieces"
                    else 2)
        row = {"name": LM.KERNEL_OF[plan.kind], "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/" + (
                   "logmac_pieces.cu" if plan.kind == "pieces"
                   else "logmac.cu"),
               "replaces": "src/repro/kernels/logmac.py:136",
               "shape": f"{what}P{wcfg.width} {wcfg.variant} M={M} K={K} "
                        f"N={N} ({plan.kind}, {plan.blocks(N)} blocks a row "
                        f"tile, S={plan.splits})",
               "bytes": (M * K + K * N + M * N) * 4,
               "flops": 2 * products * M * N * K,
               "peak": (FP16_FLOPS if plan.kind in ("mma", "pieces")
                        else FP32_FLOPS),
               "ms": time_ms(lambda: LM.logmac(a, b, wcfg), reps=reps,
                             flush=flush),
               "device_ms": time_ms(lambda: LM.logmac(a, b, wcfg),
                                    reps=reps, flush=flush,
                                    device_only=True),
               "plain_ms": time_ms(lambda: LM.logmac_plain(a, b, wcfg),
                                   reps=plain_reps, flush=flush),
               "floor_ms": instr[wcfg.width] * K * N
               / (sms * 128 * clk_mhz * 1e6) * 1e3
               if wcfg.variant == "L-21b" else None}
        if plan.kind in ("mma", "pieces"):
            row["f32_flops"] = 4 * M * N * K
            row["tile_device_ms"] = time_ms(lambda: tile_kernel(a, b, wcfg),
                                            reps=reps, flush=flush,
                                            device_only=True)
        del a, b
        rows.append(row)

    instr = decode_instructions(_build.build_dir(), _build.CSRC)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    log(f"[floor] {card}: SASS instructions per decoded word {instr} "
        f"(L-21b; P8, P16 by table); {sms} SMs at {clk_mhz:.0f} MHz")
    mlp = (2304, 9216)
    others = [kn for kn in GEMMA_KN if kn != mlp]
    shapes = ([(16, "L-21b", 4, *mlp)]
              + [(16, "L-21b", 4, K, N) for K, N in others]
              + [(16, "L-21b", M, *mlp) for M in (16, 32, 128)]
              + [(8, "L-21b", 4, *mlp), (32, "L-21b", 4, *mlp),
                 (8, "L-21b", 128, *mlp), (32, "L-21b", 128, *mlp)]
              + [(32, "L-21b", 128, K, N) for K, N in others]
              + [(16, "L-1b", 128, *mlp), (32, "L-21", 128, *mlp)])
    for width, variant, M, K, N in shapes:
        big = N > 100000
        logmac_row(M, K, N, from_variant(width, variant), "",
                   reps=5 if big else 10, plain_reps=2 if big else 3)
    # the fused encode and logmac (P16, decode width M=4) at the weight
    # shapes of the mamba2-1.3b and hymba-1.5b paths (phase 3f), at the
    # model init's scale
    for arch, kns in NEW_FAMILY_KN.items():
        for K, N, what in kns:
            head = what == "head"
            xf = torch.randn((K, N), generator=gen, device=dev) * (
                0.02 if head else K ** -0.5)
            nv = xf.numel()

            def fused():
                return PC.posit_encode_prescaled(xf, ecfg.posit)

            ms = time_ms(fused, flush=flush)
            dev_ms = time_ms(fused, flush=flush, device_only=True)
            pms = time_ms(lambda: PC.encode_prescaled_plain(xf, ecfg.posit),
                          reps=2, flush=flush)
            rows.append({"name": "posit_encode_prescaled", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "posit_encode.cu",
                         "replaces": "src/repro/kernels/posit_codec.py:73 "
                                     "and src/repro/core/engine.py:135",
                         "shape": f"{arch} {what}: f32 [{K}, {N}]",
                         "bytes": 12 * nv, "flops": 0, "ms": ms,
                         "device_ms": dev_ms, "plain_ms": pms})
            del xf
            logmac_row(4, K, N, ecfg, f"{arch} {what}: ", plain_reps=2)
    # the hymba-1.5b eval step of phase 3g (batch 2 x seq 128, M = 256):
    # logmac's tensor-core kernel at every projection shape, and the fused
    # encode of the activations at each K
    for K, N, what in NEW_FAMILY_KN["hymba-1.5b"]:
        logmac_row(256, K, N, ecfg, f"hymba-1.5b eval {what}: ",
                   plain_reps=2)
    for K in sorted({K for K, _, _ in NEW_FAMILY_KN["hymba-1.5b"]}):
        xf = torch.randn((256, K), generator=gen, device=dev)

        def fused():
            return PC.posit_encode_prescaled(xf, ecfg.posit)

        rows.append({"name": "posit_encode_prescaled", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "posit_encode.cu",
                     "replaces": "src/repro/kernels/posit_codec.py:73 "
                                 "and src/repro/core/engine.py:135",
                     "shape": f"hymba-1.5b eval activation: f32 [256, {K}]",
                     "bytes": 12 * xf.numel(), "flops": 0,
                     "ms": time_ms(fused, flush=flush),
                     "device_ms": time_ms(fused, flush=flush,
                                          device_only=True),
                     "plain_ms": time_ms(
                         lambda: PC.encode_prescaled_plain(xf, ecfg.posit),
                         reps=3, flush=flush)})
        del xf
    # the fused encode and logmac at the weight shapes of phases 3h-3j:
    # decode width (M = 4) and the 32-token prefill bucket
    for arch, kns in ZOO_KN.items():
        for K, N, what in kns:
            head = what == "head"
            xf = torch.randn((K, N), generator=gen, device=dev) * (
                0.02 if head else K ** -0.5)
            nv = xf.numel()

            def fused():
                return PC.posit_encode_prescaled(xf, ecfg.posit)

            big = N > 100000
            reps = 5 if big else 10
            rows.append({"name": "posit_encode_prescaled", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "posit_encode.cu",
                         "replaces": "src/repro/kernels/posit_codec.py:73 "
                                     "and src/repro/core/engine.py:135",
                         "shape": f"{arch} {what}: f32 [{K}, {N}]",
                         "bytes": 12 * nv, "flops": 0,
                         "ms": time_ms(fused, reps=reps, flush=flush),
                         "device_ms": time_ms(fused, reps=reps, flush=flush,
                                              device_only=True),
                         # the plain int64 codec of the head's 1 G values
                         # does not fit beside it
                         "plain_ms": None if big else time_ms(
                             lambda: PC.encode_prescaled_plain(
                                 xf, ecfg.posit), reps=2, flush=flush)})
            del xf
            for M in (4, 32):
                logmac_row(M, K, N, ecfg, f"{arch} {what}: ",
                           reps=reps, plain_reps=1 if big else 2)
    # paged decode (window 4096, the local layers) at the serving
    # positions, near the end of max_len 256 and at a 4096 context
    for max_len_t, pos_t, pool in (
            (max_len, [40, 33, 27, 21], (kp, vp)),
            (max_len, [255, 254, 250, 252], (kp, vp)),
            (long_len, pos_long.tolist(), (kp_long, vp_long))):
        nlp_t = max_len_t // ps
        pos_t = torch.tensor(pos_t, dtype=torch.int32, device=dev)
        table = page_table(pos_t, nlp_t)
        args = (q, *pool, table, pos_t, 4096)
        big = nlp_t > 16
        ms = time_ms(lambda: PD.paged_flash_decode(*args, **kw), flush=flush)
        dev_ms = time_ms(lambda: PD.paged_flash_decode(*args, **kw),
                         flush=flush, device_only=True)
        pms = time_ms(lambda: PD.paged_flash_decode_plain(*args, **kw),
                      reps=2 if big else 3, flush=flush)
        npos = int((pos_t + 1).sum())            # valid positions this run
        pages = int(sum(int(p) // ps + 1 for p in pos_t.tolist()))
        pd_bytes = (q.numel() * 4 + pages * ps * KV * hd * 2 * 2
                    + B * nlp_t * 4 + B * 4 + B * KV * G * hd * 4)
        rows.append({"name": "paged_flash_decode", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
                     "replaces": "src/repro/kernels/paged_decode.py:127",
                     "shape": f"B=4 KV=4 G=2 hd=288 ps=16 uint16, max_len "
                              f"{max_len_t}, pos {pos_t.tolist()}",
                     "bytes": pd_bytes, "flops": npos * KV * G * hd * 8,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": pms})
    # paged decode at the geometries of phases 3h (llama4-scout) and 3i
    # (musicgen-large) and chameleon-34b's, at the serving positions
    pos_t = torch.tensor([40, 33, 27, 21], dtype=torch.int32, device=dev)
    table = page_table(pos_t, nlp)
    pages = int(sum(int(p) // ps + 1 for p in pos_t.tolist()))
    npos = int((pos_t + 1).sum())
    for KVg, Gg, hdg in PAGED_GEOMS:
        kp_g, vp_g = kv_pool(PD.RESERVED_PAGES + B * nlp, KVg, hdg)
        q_g = torch.randn((B, 1, KVg * Gg, hdg), generator=gen, device=dev)
        args = (q_g, kp_g, vp_g, table, pos_t, None)
        kw_g = dict(kw, softcap=None)
        rows.append({
            "name": "paged_flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:127",
            "shape": f"B=4 KV={KVg} G={Gg} hd={hdg} ps=16 uint16, max_len "
                     f"{max_len}, pos {pos_t.tolist()}",
            "bytes": (q_g.numel() * 4 + pages * ps * KVg * hdg * 2 * 2
                      + B * nlp * 4 + B * 4 + B * KVg * Gg * hdg * 4),
            "flops": npos * KVg * Gg * hdg * 8,
            "ms": time_ms(lambda: PD.paged_flash_decode(*args, **kw_g),
                          flush=flush),
            "device_ms": time_ms(lambda: PD.paged_flash_decode(*args, **kw_g),
                                 flush=flush, device_only=True),
            "plain_ms": time_ms(
                lambda: PD.paged_flash_decode_plain(*args, **kw_g), reps=3,
                flush=flush)})
        del kp_g, vp_g
    for r in rows:
        bb = r["bytes"] / HBM_BYTES_PER_S * 1e3
        bo = r["flops"] / r.get("peak", FP32_FLOPS) * 1e3
        r["bound_ms"] = max(bb, bo)
        r["bound_by"] = "bytes" if bb >= bo else "operations"
        extra = ""
        if r.get("floor_ms") is not None:
            extra += f", decode-instruction floor {r['floor_ms']:.4f} ms"
        if "tile_device_ms" in r:
            extra += (f", {r['flops']:.4g} tensor-core operations; f32 bound "
                      f"{max(bb, r['f32_flops'] / FP32_FLOPS * 1e3):.4f}"
                      f" ms; the f32 tile kernel on the same inputs "
                      f"{r['tile_device_ms']:.4f} ms device time")
        plain = ("not measured" if r["plain_ms"] is None
                 else f"{r['plain_ms']:.4f} ms")
        log(f"[time] {card}: {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms "
            f"host-issued, {r['device_ms']:.4f} ms device time; plain "
            f"{plain}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}")

    phase_start("end")
    phase_s.pop("end")
    log(f"[phases] seconds per phase: "
        f"{ {k: round(v, 1) for k, v in phase_s.items()} }")

    kernels = []
    # each kernel's first row: the encodes and logmac at the MLP shape
    # (small-M: P16 M=4; mma: P16 M=128; pieces: P32 L-21b M=128; tile:
    # P32 L-21 M=128), paged decode at the serving positions
    for name in ("posit_encode", "posit_encode_prescaled", "posit_decode",
                 *CORE_ENTRIES, "logmac_small", "logmac_mma", "logmac_pieces",
                 "logmac_tile", "paged_flash_decode"):
        r = next(r for r in rows if r["name"] == name)
        if name.startswith("logmac_") or name in CORE_ENTRIES:
            assert total_launches[name] > 0, f"{name}: no launch on a path"
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": total_launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
