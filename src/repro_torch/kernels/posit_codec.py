"""Posit encode and decode: the CUDA kernels and their plain versions.

``encode_body`` builds each pattern straight from the f32 bit fields (no
frexp) with pattern-domain RNE, exactly like ``repro.kernels.posit_codec``:
subnormal inputs flush to zero (DAZ) and Inf/NaN map to NaR.
``posit_encode`` is the wrapper: plain version for a CPU tensor, the
``csrc/posit_encode.cu`` kernel for a CUDA tensor.

``posit_encode_prescaled`` is the cuda backend's operand pass: the
per-tensor pow2 scale ``s = _pow2_scale(x)`` and the words of ``x / s`` in
one kernel pass (a reduce launch, then an encode launch; ``_encode_plan``),
returning ``(words, s)`` with ``s`` a 0-dim tensor on
the tensor's device.  Its plain version is ``encode_prescaled_plain``.
For a tensor whose rows are split over a process group, the pass runs
split (``_launch_grouped``): the reduce launch, the partials summed over
the group, then the encode launch.

``posit_decode`` maps words to f32 through the ILM ``val`` plane
(``decode_planes_raw`` with stages 0), like the TPU decode kernel: zero and
NaR both decode to 0.0 and the mantissa is converted to f32 before it is
scaled.  ``ops.decode`` is its entry.

The core codec's callers (``core.posit``: the KV-cache words, the guard's
quantize check and sentinels, ``out_quant``, fault injection) go to the
entries of ``csrc/posit_core_codec.cu``, whose bits are the core codec's
and not the TPU kernels': NaR decodes to NaN (0.0 above), and the
fraction is rounded as ``decode_to_float`` rounds it, ``1 + frac * 2^-W``
in the output dtype (P32's f32 result can differ by an ulp from the
decode kernel's; bf16 rounds in bf16).  Both codecs follow XLA's flush,
as the JAX package runs on XLA: a subnormal input encodes to 0, a
subnormal counts as 0 in the pre-scale, and a product ``q * s`` that goes
subnormal is a signed 0.

* ``posit_store(x, pc)``: f32 or bf16 -> storage words (``to_storage(
  encode_from_float(x))``), the KV-cache write;
* ``posit_load(words, pc, out_dtype)``: storage words -> f32 or bf16
  (``decode_to_float(from_storage(words))``), the KV-cache read;
* ``posit_quantize(x, pc)``: f32 -> f32, ``quantize(x)`` in one pass, the
  words never in memory (``out_quant``);
* ``posit_quantize_prescaled(x, pc)``: f32 -> ``(quantize(x / s) * s, s)``
  with ``s`` the pow2 pre-scale of x, the guard's check operand: the
  fused encode's reduce launch, then the quantize launch, so ``s`` is
  ``posit_encode_prescaled``'s on the same tensor, bit for bit;
* ``posit_sentinels(x, pc, pre_scale)``: f32 -> int64 ``[2]``, the NaR and
  saturated words of ``x / s`` (or of ``x``), the guard's sentinels, from
  the same reduce; the words never in memory.

Each takes any layout: a tensor whose elements fill one block of memory
(contiguous, or a permutation of it such as a transpose) is read in place
and its output laid out alike; any other view is copied contiguous first.

Patterns come back as ``int32`` tensors holding the uint32 word's bits (low
N bits valid); the plain version's int64 result is narrowed the same way.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import posit as P
from repro_torch.core import engine as _E
from . import _build
from .logmac import decode_planes_raw

_G = 26  # guard bits (>= 23 keeps f32 inputs exact)
M = P.mask


def encode_body(x, pc: P.PositConfig) -> torch.Tensor:
    """f32 -> posit pattern (int64, low N bits), pure integer tensor ops."""
    N, es, G = pc.n_bits, pc.es, _G
    bits = torch.as_tensor(x).to(torch.float32).contiguous().view(
        torch.int32).to(torch.int64) & M(32)
    sign = bits >> 31
    expf = (bits >> 23) & 0xFF
    frac23 = bits & M(23)
    is_zero = expf == 0                         # zero and subnormals (DAZ)
    is_nar = expf == 255                        # Inf/NaN -> NaR
    scale = expf - 127

    over = scale > pc.max_scale
    under = scale < pc.min_scale
    scale_c = torch.clamp(scale, pc.min_scale, pc.max_scale)
    frac_g = torch.where(over | under, torch.zeros_like(frac23),
                         frac23 << (G - 23))

    k = scale_c >> es
    e = scale_c - k * (1 << es)
    kmax, kmin, rcap = pc.k_max, pc.k_min, pc.rcap
    pos = k >= 0
    at_hi, at_lo = k == kmax, k == kmin
    full = torch.full_like
    rb_mid = ((1 << (k.clamp(min=0) + 1)) - 1) << 1
    if pc.bounded:
        w = torch.where(pos, torch.where(at_hi, full(k, rcap), k + 2),
                        torch.where(at_lo, full(k, rcap), -k + 1))
        rb = torch.where(pos, torch.where(at_hi, full(k, M(rcap)), rb_mid),
                         torch.where(at_lo, full(k, 0), full(k, 1)))
    else:
        w = torch.where(pos, torch.where(at_hi, full(k, N - 1), k + 2), -k + 1)
        rb = torch.where(pos, torch.where(at_hi, full(k, M(N - 1)), rb_mid),
                         full(k, 1))
    T = (e << G) | frac_g
    t = (N - 1) - w
    sh = es + G - t
    sh_u = torch.clamp(sh, 1, 31)
    half = (1 << (sh_u - 1)) - 1
    lsb = (T >> sh_u) & 1
    T_r = torch.where(sh > 0, (T + half + lsb) >> sh_u,
                      T << torch.clamp(-sh, 0, 31))
    body = (rb << t.clamp(min=0)) + T_r
    body = torch.clamp(body, 1, M(N - 1))
    body = torch.where(over, full(body, M(N - 1)), body)
    body = torch.where(under, full(body, 1), body)
    pat = torch.where(sign == 1, (-body) & M(N), body)
    pat = torch.where(is_zero, full(pat, 0), pat)
    pat = torch.where(is_nar, full(pat, 1 << (N - 1)), pat)
    return pat


def as_word32(pat: torch.Tensor) -> torch.Tensor:
    """int64 patterns -> int32 tensor with the uint32 word's bits."""
    p = pat & M(32)
    return torch.where(p >= (1 << 31), p - (1 << 32), p).to(torch.int32)


def encode_plain(x, pc: P.PositConfig) -> torch.Tensor:
    """The plain version of the encode kernel: int32 words."""
    return as_word32(encode_body(x, pc))


# csrc/posit_encode.cu's launch geometry (test_torch_encode_prescaled.py
# reads the constants there): threads per block of the encode and reduce
# launches, float4 loads a thread issues together, blocks resident on an
# SM, and the grid caps (one wave on 132 SMs, so an encode block adds at
# most 528 partials).
ENC_THREADS, RED_THREADS, UNROLL = 256, 256, 4
BLOCKS_PER_SM, N_SMS = 4, 132
ENC_MAX_BLOCKS = RED_MAX_BLOCKS = BLOCKS_PER_SM * N_SMS


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """How the encode kernels cover a tensor: a reduce launch of
    ``reduce_blocks`` blocks of RED_THREADS (0 without pre-scale; one
    (sum, count) partial each) then an encode launch of ``encode_blocks``
    blocks of ENC_THREADS."""

    reduce_blocks: int
    encode_blocks: int


def _blocks(numel: int, threads: int, cap: int) -> int:
    vecs = -(-numel // 4)
    return max(1, min(cap, -(-vecs // (threads * UNROLL))))


def _encode_plan(numel: int, pre_scale: bool = True) -> EncodePlan:
    """The launches for ``numel`` values; depends on ``numel`` alone."""
    return EncodePlan(
        _blocks(numel, RED_THREADS, RED_MAX_BLOCKS) if pre_scale else 0,
        _blocks(numel, ENC_THREADS, ENC_MAX_BLOCKS))


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: kernel takes contiguous float32 input "
                         f"(got {x.dtype}, contiguous={x.is_contiguous()})")


def _launch(x: torch.Tensor, pc: P.PositConfig, pre_scale: bool
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One ctypes call of ``posit_encode_launch`` on a checked CUDA tensor:
    the words of ``x / s`` and ``s`` with pre-scale, else the words of ``x``
    and None.  Counts no launch (the wrappers do)."""
    n = x.numel()
    plan = _encode_plan(n, pre_scale)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    s = parts = None
    if pre_scale:
        s = torch.empty((), dtype=torch.float32, device=x.device)
        # one (f64 sum, int64 count) pair of 16 bytes per reduce block
        parts = torch.empty((plan.reduce_blocks, 2), dtype=torch.float64,
                            device=x.device)
    fn = _build.function(
        "posit_encode", "posit_encode_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), out.data_ptr(),
             None if s is None else s.data_ptr(),
             None if parts is None else parts.data_ptr(), n, pc.n_bits,
             pc.es, pc.regime_max or 0, plan.reduce_blocks,
             plan.encode_blocks, _build.stream_ptr(x))
    _build.check(err, "posit_encode_prescaled" if pre_scale
                 else "posit_encode")
    return out, s


def _launch_grouped(x: torch.Tensor, pc: P.PositConfig, group
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused pass split in two ctypes calls around a group sum: the
    reduce launch, each rank's partials summed to one (f64 sum, int64
    count) pair, the pairs summed over ``group`` (ranks may hold
    different partial counts), then the encode launch on that pair.
    Every rank gets the scale of the whole tensor its rows belong to.
    Counts no launch (the wrapper does)."""
    from repro_torch.distributed.collectives import all_reduce
    n = x.numel()
    plan = _encode_plan(n, True)
    stream = _build.stream_ptr(x)
    parts = torch.empty((plan.reduce_blocks, 2), dtype=torch.float64,
                        device=x.device)
    reduce_fn = _build.function(
        "posit_encode", "posit_encode_reduce",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p])
    _build.check(reduce_fn(x.data_ptr(), parts.data_ptr(), n,
                           plan.reduce_blocks, stream),
                 "posit_encode_prescaled (reduce)")
    pair = all_reduce(torch.stack([
        parts[:, 0].sum(), parts.view(torch.int64)[:, 1].sum().to(
            torch.float64)]), group)
    total = torch.empty((1, 2), dtype=torch.float64, device=x.device)
    total[0, 0] = pair[0]
    total.view(torch.int64)[0, 1] = pair[1].to(torch.int64)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    s = torch.empty((), dtype=torch.float32, device=x.device)
    encode_fn = _build.function(
        "posit_encode", "posit_encode_from_partials",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    _build.check(encode_fn(x.data_ptr(), out.data_ptr(), s.data_ptr(),
                           total.data_ptr(), 1, n, pc.n_bits, pc.es,
                           pc.regime_max or 0, plan.encode_blocks, stream),
                 "posit_encode_prescaled (encode)")
    return out, s


def posit_encode(x: torch.Tensor, pc: P.PositConfig) -> torch.Tensor:
    """f32 tensor -> posit words (int32 holding uint32 bits), any shape."""
    if x.device.type == "cpu":
        return encode_plain(x, pc)
    _check_input(x, "posit_encode")
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=torch.int32, device=x.device)
    out, _ = _launch(x, pc, pre_scale=False)
    _build.count_launch("posit_encode", pc.n_bits)
    return out


def encode_prescaled_plain(x, pc: P.PositConfig, pre_scale: bool = True,
                           group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the fused kernel: ``(encode_plain(x / s), s)``
    with ``s = engine._pow2_scale(x, group)``, or 1 without pre-scale."""
    xf = torch.as_tensor(x).to(torch.float32)
    if not pre_scale:
        return (encode_plain(xf, pc),
                torch.ones((), dtype=torch.float32, device=xf.device))
    s = _E._pow2_scale(xf, group)
    return encode_plain(P.flushed_quotient(xf, s), pc), s


def posit_encode_prescaled(x: torch.Tensor, pc: P.PositConfig,
                           pre_scale: bool = True, group=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 tensor -> (posit words of x / s, s), s the per-tensor pow2 scale
    (a 0-dim f32 tensor on x's device; 1 without pre-scale, where the words
    come from ``posit_encode``).  ``group``: the process group over which
    ``x``'s rows are split; s is then the whole tensor's (the split entry,
    :func:`_launch_grouped`).

    On the card the mean log2 that s rounds is summed in f64, where
    ``_pow2_scale`` sums in f32: where that mean lies within the f32 sum's
    rounding error of a .5 tie, the two can pick powers of two a factor 2
    apart, and then every word differs from the plain version's.  The f64
    sum is the nearer to the exact mean (chip_smoke.py phase 2 reports the
    margin on inputs placed next to a tie)."""
    if x.device.type == "cpu":
        return encode_prescaled_plain(x, pc, pre_scale, group)
    _check_input(x, "posit_encode_prescaled")
    if not pre_scale:
        return (posit_encode(x, pc),
                torch.ones((), dtype=torch.float32, device=x.device))
    if group is not None:
        out, s = _launch_grouped(x, pc, group)
    else:
        out, s = _launch(x, pc, pre_scale=True)
    _build.count_launch("posit_encode_prescaled", pc.n_bits)
    return out, s


def decode_plain(pat, pc: P.PositConfig) -> torch.Tensor:
    """The plain version of the decode kernel: f32 values (0 and NaR -> 0)."""
    val, _ = decode_planes_raw(pat, pc, 0, None, None)
    return val


def posit_decode(pat: torch.Tensor, pc: P.PositConfig) -> torch.Tensor:
    """Posit words (int32 holding uint32 bits, low N valid) -> f32, any
    shape."""
    if pat.device.type == "cpu":
        return decode_plain(pat, pc)
    if pat.device.type != "cuda":
        raise ValueError(f"posit_decode: unsupported device {pat.device}")
    if pat.dtype != torch.int32 or not pat.is_contiguous():
        raise ValueError("posit_decode: kernel takes contiguous int32 words "
                         f"(got {pat.dtype}, "
                         f"contiguous={pat.is_contiguous()})")
    out = torch.empty(pat.shape, dtype=torch.float32, device=pat.device)
    lib = _build.load("posit_decode")
    fn = lib.posit_decode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(pat.data_ptr(), out.data_ptr(), pat.numel(), pc.n_bits, pc.es,
             pc.regime_max or 0, _build.stream_ptr(pat))
    _build.check(err, "posit_decode")
    _build.count_launch("posit_decode", pc.n_bits)
    return out


# ---- the core codec's entries (csrc/posit_core_codec.cu) -----------------

_STORE_INPUTS = {torch.float32: 0, torch.bfloat16: 1}
_LOAD_OUTPUTS = {torch.float32: 0, torch.bfloat16: 1}
CORE_THREADS = 256
CORE_MAX_BLOCKS = 132 * 16  # grid-stride beyond this


def store_plain(x, pc: P.PositConfig) -> torch.Tensor:
    """The plain version of ``posit_store``: the core codec's words in
    ``pc``'s storage dtype."""
    return P.to_storage(P.encode_from_float(x, pc), pc)


def load_plain(words, pc: P.PositConfig, out_dtype=torch.float32
               ) -> torch.Tensor:
    """The plain version of ``posit_load`` (NaR -> NaN)."""
    return P.decode_to_float(P.from_storage(words, pc), pc, out_dtype)


def quantize_plain(x, pc: P.PositConfig, s=None) -> torch.Tensor:
    """The plain version of ``posit_quantize`` (``quantize(x)``, ``s``
    None) and of ``posit_quantize_prescaled``'s values:
    ``quantize(x / s) * s`` with XLA's flush of the product."""
    if s is None:
        return P.quantize(x, pc)
    return P.flush_subnormals(P.quantize(P.flushed_quotient(x, s), pc) * s)


def quantize_prescaled_plain(x, pc: P.PositConfig, s=None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``posit_quantize_prescaled``:
    ``(quantize_plain(x, pc, s), s)`` with ``s = engine._pow2_scale(x)``
    unless ``s`` is given (the kernel's, to hold the rest bit for bit)."""
    xf = torch.as_tensor(x).to(torch.float32)
    if s is None:
        s = _E._pow2_scale(xf)
    return quantize_plain(xf, pc, s), s


def sentinels_plain(x, pc: P.PositConfig, pre_scale: bool = True, s=None
                    ) -> torch.Tensor:
    """The plain version of ``posit_sentinels``: ``x / s`` encoded by the
    core codec and classified by ``reliability.ece.word_flags``, as int64
    ``[nar, saturated]`` (saturated: the regime run at its cap, neither
    zero nor NaR).  ``s = engine._pow2_scale(x)`` unless given; no scale
    without pre-scale."""
    from repro_torch.reliability.ece import word_flags
    xf = torch.as_tensor(x).to(torch.float32)
    if pre_scale:
        xf = P.flushed_quotient(xf, _E._pow2_scale(xf) if s is None else s)
    flags = word_flags(P.encode_from_float(xf, pc), pc)
    sat = flags["saturated"] & ~flags["is_zero"] & ~flags["is_nar"]
    return torch.stack([flags["is_nar"].sum(), sat.sum()])


def _in_place(x: torch.Tensor) -> torch.Tensor:
    """``x`` where its elements fill one block of memory in some order
    (then ``torch.empty_like`` lays the output out alike, so element i of
    the block maps to element i of the output's), else a contiguous
    copy."""
    order = sorted(range(x.ndim), key=lambda d: -x.stride(d))
    return x if x.permute(order).is_contiguous() else x.contiguous()


def _core_args(x: torch.Tensor, pc: P.PositConfig, what: str, dtypes
               ) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: kernel takes {sorted(map(str, dtypes))} "
                         f"(got {x.dtype})")
    return _in_place(x)


def _core_blocks(n: int) -> int:
    return max(1, min(CORE_MAX_BLOCKS, -(-n // CORE_THREADS)))


def posit_store(x: torch.Tensor, pc: P.PositConfig) -> torch.Tensor:
    """f32 or bf16 -> ``pc``'s storage words (``pc.storage_dtype``: uint8 /
    int16 / int32 holding the unsigned word), the core codec's encode: +-0
    and subnormals -> 0, Inf and NaN -> NaR.  A ``meta`` tensor
    (the dry run) runs the plain version: shapes only."""
    if x.device.type in ("cpu", "meta"):
        return store_plain(x, pc)
    x = _core_args(x, pc, "posit_store", _STORE_INPUTS)
    out = torch.empty_like(x, dtype=pc.storage_dtype)
    n = x.numel()
    if n:
        fn = _build.function(
            "posit_core_codec", "posit_store_launch",
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p])
        _build.check(fn(x.data_ptr(), _STORE_INPUTS[x.dtype], out.data_ptr(),
                        n, pc.n_bits, pc.es, pc.regime_max or 0,
                        _core_blocks(n), _build.stream_ptr(x)),
                     "posit_store")
        _build.count_launch("posit_store", pc.n_bits)
    return out


def posit_load(words: torch.Tensor, pc: P.PositConfig,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``pc``'s storage words -> f32 or bf16, the core codec's decode
    (NaR -> NaN), rounded in ``out_dtype`` as ``decode_to_float`` rounds.
    A ``meta`` tensor runs the plain version."""
    if words.device.type in ("cpu", "meta"):
        return load_plain(words, pc, out_dtype)
    words = _core_args(words, pc, "posit_load", (pc.storage_dtype,))
    if out_dtype not in _LOAD_OUTPUTS:
        raise ValueError(f"posit_load: kernel writes float32 or bfloat16 "
                         f"(got {out_dtype})")
    out = torch.empty_like(words, dtype=out_dtype)
    n = words.numel()
    if n:
        fn = _build.function(
            "posit_core_codec", "posit_load_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p])
        _build.check(fn(words.data_ptr(), out.data_ptr(),
                        _LOAD_OUTPUTS[out_dtype], n, pc.n_bits, pc.es,
                        pc.regime_max or 0, _core_blocks(n),
                        _build.stream_ptr(words)), "posit_load")
        _build.count_launch("posit_load", pc.n_bits)
    return out


def posit_quantize(x: torch.Tensor, pc: P.PositConfig) -> torch.Tensor:
    """f32 -> f32: ``quantize(x)``.  A ``meta`` tensor runs the plain
    version."""
    if x.device.type in ("cpu", "meta"):
        return quantize_plain(x, pc)
    x = _core_args(x, pc, "posit_quantize", (torch.float32,))
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        fn = _build.function(
            "posit_core_codec", "posit_quantize_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p])
        _build.check(fn(x.data_ptr(), out.data_ptr(), n, pc.n_bits, pc.es,
                        pc.regime_max or 0,
                        _encode_plan(n, False).encode_blocks,
                        _build.stream_ptr(x)), "posit_quantize")
        _build.count_launch("posit_quantize", pc.n_bits)
    return out


def posit_quantize_prescaled(x: torch.Tensor, pc: P.PositConfig
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> ``(quantize(x / s) * s, s)``, ``s`` the pow2 pre-scale of x
    (a 0-dim f32 tensor on x's device): the guard's check operand.  On the
    card ``s`` comes from ``posit_encode_prescaled``'s reduce (the same
    launch and fixed trees, so the same bits on the same tensor; a tensor
    read in place in another order than the row-major one sums its terms
    in memory order), where the plain version takes torch's
    ``_pow2_scale`` (see ``posit_encode_prescaled`` on where the two can
    differ).  A ``meta`` tensor runs the plain version."""
    if x.device.type in ("cpu", "meta"):
        return quantize_prescaled_plain(x, pc)
    x = _core_args(x, pc, "posit_quantize_prescaled", (torch.float32,))
    n = x.numel()
    plan = _encode_plan(n)
    out = torch.empty_like(x)
    s = torch.empty((), dtype=torch.float32, device=x.device)
    # one (f64 sum, int64 count) pair of 16 bytes per reduce block
    parts = torch.empty((plan.reduce_blocks, 2), dtype=torch.float64,
                        device=x.device)
    fn = _build.function(
        "posit_core_codec", "posit_quantize_prescaled_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(x.data_ptr(), out.data_ptr(), s.data_ptr(),
                    parts.data_ptr(), n, pc.n_bits, pc.es,
                    pc.regime_max or 0, plan.reduce_blocks,
                    plan.encode_blocks, _build.stream_ptr(x)),
                 "posit_quantize_prescaled")
    _build.count_launch("posit_quantize_prescaled", pc.n_bits)
    return out, s


def posit_sentinels(x: torch.Tensor, pc: P.PositConfig,
                    pre_scale: bool = True) -> torch.Tensor:
    """f32 -> int64 ``[nar, saturated]``: the words of ``x / s`` (``s``
    the pow2 pre-scale, as ``posit_quantize_prescaled`` takes it) or of
    ``x`` without pre-scale, counted as ``reliability.ece.word_flags``
    classifies them, on x's device.  A ``meta`` tensor runs the plain
    version."""
    if x.device.type in ("cpu", "meta"):
        return sentinels_plain(x, pc, pre_scale)
    x = _core_args(x, pc, "posit_sentinels", (torch.float32,))
    n = x.numel()
    plan = _encode_plan(n, pre_scale)
    parts = (torch.empty((plan.reduce_blocks, 2), dtype=torch.float64,
                         device=x.device) if pre_scale else None)
    counts = torch.empty((plan.encode_blocks, 2), dtype=torch.int64,
                         device=x.device)
    out = torch.empty(2, dtype=torch.int64, device=x.device)
    fn = _build.function(
        "posit_core_codec", "posit_sentinels_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(x.data_ptr(), None if parts is None else parts.data_ptr(),
                    counts.data_ptr(),
                    out.data_ptr(), n, pc.n_bits, pc.es, pc.regime_max or 0,
                    plan.reduce_blocks, plan.encode_blocks,
                    _build.stream_ptr(x)), "posit_sentinels")
    _build.count_launch("posit_sentinels", pc.n_bits)
    return out
