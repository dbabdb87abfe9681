"""Live fault injection on encoded posit words.

Counterpart of ``repro.reliability.faults``.  A :class:`FaultPlan` says
which ops to hit (layer-path pattern + op kind), which bit role to flip
(the G1/G2/G3 decomposition of paper Eq. 5), at what per-word rate and in
which decode-step window.  The ``faulty:<base>`` backend
(``repro_torch.numerics.backends``) applies it: an operand is encoded to
posit words with the bit-accurate codec, seeded single-bit flips land on
selected words, and the corrupted values re-enter the base backend.

Draws come from a ``torch.Generator`` seeded from the plan's seed, the
decode step, the call site's salt and the guard's retry index
(:func:`fold_in`).  They are not the reference's JAX PRNG stream, so the
two packages agree on the deterministic parts (role masks, the n-th set
bit, a flip at given positions) and on rates and orderings, not on which
words a plan hits.

The step and key are host integers: the serving engine runs its decode
loop on the host and activates the plan with :func:`inject` around each
decode step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import hashlib
import json
import threading
import zlib

import torch

from repro_torch.core import posit as P
from repro_torch.kernels import posit_codec as _codec

ROLES = ("sign", "regime_run", "regime_term", "exponent", "fraction", "any")
OPERANDS = ("a", "b", "both")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, serializable description of one fault-injection experiment.

    ``rate`` is the per-word probability that ONE bit of ``role`` is flipped
    (uniform over that word's bits of the role; words with no bit of the
    role are never flipped).  ``start_step``/``end_step`` bound the
    decode-step window ``[start, end)``; ``path``/``op`` are fnmatch
    patterns against the numerics layer path and op kind; ``operand`` picks
    the side of the op that is corrupted ("a" = activations, "b" =
    weights).  ``record`` counts landed injections (:func:`injection_stats`).
    """

    seed: int = 0
    rate: float = 1e-3
    role: str = "any"
    path: str = "*"
    op: str = "*"
    operand: str = "a"
    start_step: int = 0
    end_step: int | None = None
    record: bool = False

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown bit role {self.role!r}; one of {ROLES}")
        if self.operand not in OPERANDS:
            raise ValueError(
                f"unknown operand {self.operand!r}; one of {OPERANDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.start_step < 0:
            raise ValueError(
                f"start_step must be >= 0, got {self.start_step}")
        if self.end_step is not None and self.end_step <= self.start_step:
            raise ValueError(
                f"inverted step window [{self.start_step}, {self.end_step}): "
                "end_step must be > start_step (or None for open-ended)")

    def matches(self, path: str, op: str) -> bool:
        return (fnmatch.fnmatchcase(path, self.path)
                and fnmatch.fnmatchcase(op, self.op))

    def active_at(self, step: int) -> bool:
        return step >= self.start_step and (self.end_step is None
                                            or step < self.end_step)

    # -- serde ------------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))


def fold_in(key: int, data: int) -> int:
    """A new 63-bit seed from ``key`` and ``data`` (the counterpart of
    ``jax.random.fold_in``; different numbers)."""
    h = hashlib.blake2b(f"{int(key)}:{int(data)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFFFFFFFFFF


# --------------------------------------------------------------------------
# Activation: (plan, key, step) for the current decode step
# --------------------------------------------------------------------------

_TLS = threading.local()


def _stack() -> list:
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


@contextlib.contextmanager
def inject(plan: FaultPlan, key: int, step: int):
    """Activate ``plan`` for the extent of the block; ``key`` is an integer
    seed and ``step`` the decode-step index."""
    _stack().append((plan, key, step))
    try:
        yield
    finally:
        _stack().pop()


def current() -> tuple | None:
    """The active (plan, key, step) triple, or None outside any inject()."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def retrying(index: int):
    """Mark the block as recompute attempt ``index`` (>= 1): :func:`corrupt`
    folds the index into its seed, so a retried op draws a fresh fault
    pattern (the transient-upset model)."""
    if index < 1:
        raise ValueError(f"retry index must be >= 1, got {index}")
    prev = getattr(_TLS, "retry", 0)
    _TLS.retry = index
    try:
        yield
    finally:
        _TLS.retry = prev


def retry_index() -> int:
    """Current recompute attempt (0 = first execution)."""
    return getattr(_TLS, "retry", 0)


# --------------------------------------------------------------------------
# Injection ground truth (``FaultPlan.record=True``)
# --------------------------------------------------------------------------

_INJ_LOCK = threading.Lock()
_INJ = {"ops": 0, "words": 0}


def _count_injection(nwords: int):
    n = int(nwords)
    with _INJ_LOCK:
        if n > 0:
            _INJ["ops"] += 1
            _INJ["words"] += n


def injection_stats(reset: bool = False) -> dict:
    """{ops, words} corrupted by recording plans on the PRIMARY execution
    (guard recomputes excluded): the denominator of a detection rate."""
    with _INJ_LOCK:
        out = dict(_INJ)
        if reset:
            _INJ.update(ops=0, words=0)
    return out


# --------------------------------------------------------------------------
# Bit-role masks
# --------------------------------------------------------------------------

def _run_width(body, cfg: P.PositConfig):
    """(run, saturated, regime width) of (N-1)-bit bodies; the run is the
    count of leading copies of the body's top bit, capped at N-1."""
    N = cfg.n_bits
    r0 = (body >> (N - 2)) & 1
    run = P.leading_run(body, N - 1, r0, N - 1)
    sat = run >= cfg.rcap
    rw = torch.where(sat, torch.full_like(run, cfg.rcap),
                     torch.clamp(run, max=cfg.rcap) + 1)
    return run, sat, rw


def _body(p, N: int):
    sign = (p >> (N - 1)) & 1
    return torch.where(sign == 1, -p, p) & P.mask(N - 1)


def role_mask(pats, cfg: P.PositConfig, role: str) -> torch.Tensor:
    """int64 mask of the word-bit positions holding ``role`` per pattern.

    Bit positions are the stored word's (flips apply to the raw word); the
    role layout comes from the magnitude-domain body, as decode sees it.
    ``role="any"`` gives the full N-bit word mask."""
    N = cfg.n_bits
    p = torch.as_tensor(pats).to(torch.int64) & P.mask(N)
    if role == "any":
        return torch.full_like(p, P.mask(N))
    if role == "sign":
        return torch.full_like(p, 1 << (N - 1))
    _, sat, rw = _run_width(_body(p, N), cfg)
    ones = P.mask(N - 1)

    def prefix(length):
        """Mask of the first ``length`` body bits (from the body MSB)."""
        length = torch.clamp(length, 0, N - 1)
        return ones & ~((1 << (N - 1 - length)) - 1)

    run_mask = prefix(rw - (~sat).to(torch.int64))
    if role == "regime_run":
        return run_mask
    if role == "regime_term":
        return prefix(rw) & ~run_mask
    exp_hi = prefix(torch.clamp(rw + cfg.es, max=N - 1))
    if role == "exponent":
        return exp_hi & ~prefix(rw)
    return ones & ~exp_hi  # fraction


def popcount(mask: torch.Tensor, nbits: int = 32) -> torch.Tensor:
    cnt = torch.zeros_like(mask)
    for b in range(nbits):
        cnt = cnt + ((mask >> b) & 1)
    return cnt


def _nth_set_bit(mask, r, nbits: int = 32):
    """One-hot int64 selecting the ``r``-th set bit of ``mask`` (LSB-first)
    among its low ``nbits`` bits; zero where ``r >= popcount(mask)``."""
    out = torch.zeros_like(mask)
    cnt = torch.zeros_like(mask)
    r = torch.as_tensor(r).to(torch.int64)
    for b in range(nbits):
        bit = (mask >> b) & 1
        hit = (bit == 1) & (cnt == r)
        out = torch.where(hit, torch.full_like(out, 1 << b), out)
        cnt = cnt + bit
    return out


def apply_flips(pats, cfg: P.PositConfig, role: str, sel, r):
    """Flip, in every word where ``sel`` holds, bit number ``r mod
    popcount`` (LSB-first) of the word's ``role`` bits.  Zero and NaR words
    and words without a bit of the role are left alone.  Returns
    ``(flipped_pats, hit)``: the deterministic half of :func:`flip_words`."""
    p = torch.as_tensor(pats).to(torch.int64) & P.mask(cfg.n_bits)
    mask = role_mask(p, cfg, role)
    pop = popcount(mask, cfg.n_bits)
    f0 = P.decode_fields(p, cfg)
    sel = torch.as_tensor(sel, device=p.device) & (pop > 0)
    sel = sel & ~(f0["is_zero"] | f0["is_nar"])
    r = torch.as_tensor(r, device=p.device).to(torch.int64)
    onehot = _nth_set_bit(mask, torch.remainder(r, torch.clamp(pop, min=1)),
                          cfg.n_bits)
    flips = torch.where(sel, onehot, torch.zeros_like(onehot))
    return p ^ flips, sel & (flips != 0)


def flip_words(pats, cfg: P.PositConfig, plan: FaultPlan, key: int,
               active: bool = True):
    """Apply the plan's seeded single-bit flips to posit words.

    Each word is selected with probability ``plan.rate``; a selected word
    gets exactly one bit of ``plan.role`` flipped, uniform among its role
    bits.  Zero and NaR words are never flipped (the ECE expectation
    conditions on valid patterns).  ``active`` gates the whole thing (the
    step window).  Returns ``(flipped_pats, flip_mask)``."""
    p = torch.as_tensor(pats).to(torch.int64)
    g = torch.Generator(device=p.device)
    g.manual_seed(int(key))
    sel = torch.rand(p.shape, generator=g, device=p.device) < plan.rate
    r = torch.randint(0, 1 << 30, p.shape, generator=g, device=p.device)
    if not active:
        sel = torch.zeros_like(sel)
    return apply_flips(p, cfg, plan.role, sel, r)


def corrupt(x, cfg, plan: FaultPlan, key: int, step: int, salt: int = 0):
    """Corrupt a float operand tensor through the posit codec.

    Mirrors the engine's datapath: pre-scale (when the EulerConfig uses
    it), encode to posit words, flip per plan, decode back.  Untouched
    words keep their exact float value, so the only perturbation is the
    injected flips.  ``salt`` decorrelates the call sites of one step.
    The encode and decode are the core codec's entries (kernels on a CUDA
    tensor); the flips stay plain: they are the fault model."""
    pc = cfg.posit
    xf = torch.as_tensor(x).to(torch.float32)
    if not plan.active_at(int(step)):
        return xf.to(x.dtype)
    if cfg.pre_scale:
        from repro_torch.core import engine as _E
        s = _E._pow2_scale(xf)
    else:
        s = torch.ones((), dtype=torch.float32, device=xf.device)
    pat = P.from_storage(_codec.posit_store(P.flushed_quotient(xf, s), pc),
                         pc)
    key = fold_in(key, salt)
    r = retry_index()
    if r:  # guard recompute: fresh draw (transient faults don't replay)
        key = fold_in(key, r)
    flipped, hit = flip_words(pat, pc, plan, key)
    if plan.record and r == 0:
        _count_injection(int(hit.sum()))
    xq = P.flush_subnormals(
        _codec.posit_load(P.to_storage(flipped, pc), pc) * s)
    return torch.where(hit, xq, xf).to(x.dtype)


def call_salt(path: str, op: str, operand: str) -> int:
    """Stable per-call-site salt (decorrelates draws across ops in a step)."""
    return zlib.crc32(f"{path}|{op}|{operand}".encode()) & 0x7FFFFFFF
