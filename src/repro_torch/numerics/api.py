"""The numerics entry point: context-scoped policy + backend.

Counterpart of ``repro.numerics.api``.  Every matmul-shaped op funnels
through the module-level ops here (``dot_general``, ``matmul``, ``qk``,
``pv``, ``elementwise``, ``decode_attention``); each call resolves (active
layer path, op kind) against the active :class:`PrecisionPolicy` and
dispatches to the active backend:

    policy = (PrecisionPolicy.uniform(from_variant(16, "L-21b"))
              .with_rule("*attn*", from_variant(8, "L-21b"))
              .with_rule("*head*", EulerConfig(mode="exact")))
    with numerics.use(policy, backend="cuda"):
        y = numerics.matmul(x, w)

Two resolution routes:

  * ambient: ``use(...)`` pushes a :class:`NumericsContext` on a
    thread-local stack; an op given no context reads its top (``DEFAULT``,
    exact numerics on ``lax_ref``, when the stack is empty).
  * explicit: pass a ``NumericsContext`` to the op.  The models do this
    through ``models.layers.Ctx``, so serving and training never read the
    ambient context.

Layer paths come from ``scope(name)`` context managers in the model code
("attn", "mlp", "head"); they nest with "/".
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any

from repro_torch.core import engine as _E
from repro_torch.core.engine import EulerConfig
from repro_torch.kernels import logmac as _LM

from .backends import get_backend
from .policy import PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class NumericsContext:
    """Frozen (policy, backend) pair — the unit of numerics configuration.

    ``group``: the process group over which the batch rows of the
    activations are split (data parallel; ``models.layers.Ctx`` sets it
    from its mesh), or None.  The per-tensor statistics of an operand
    (the pow2 pre-scale, logfxp's max) are then taken over the group, so
    each rank computes with the whole tensor's, as the reference's GSPMD
    run does; an operand whose group a call names as None (a weight
    every rank holds whole) keeps its own, which are the same numbers.
    Not part of the configuration's identity: it takes no part in
    equality or ``to_dict``."""

    policy: PrecisionPolicy = dataclasses.field(
        default_factory=PrecisionPolicy)
    backend: str = "lax_ref"
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def from_ecfg(cls, ecfg: EulerConfig,
                  backend: str = "lax_ref") -> "NumericsContext":
        return cls(policy=PrecisionPolicy.uniform(ecfg), backend=backend)

    def cfg_for(self, path: str, op: str = "dot_general") -> EulerConfig:
        return self.policy.resolve(path, op)

    def to_dict(self) -> dict:
        return {"policy": self.policy.to_dict(), "backend": self.backend}

    @classmethod
    def from_dict(cls, d: dict) -> "NumericsContext":
        return cls(policy=PrecisionPolicy.from_dict(d.get("policy", {})),
                   backend=d.get("backend", "lax_ref"))


DEFAULT = NumericsContext()

_TLS = threading.local()


def _scope_stack() -> list:
    if not hasattr(_TLS, "scope"):
        _TLS.scope = []
    return _TLS.scope


def _ctx_stack() -> list:
    if not hasattr(_TLS, "ctx"):
        _TLS.ctx = []
    return _TLS.ctx


def current() -> NumericsContext:
    """The active ambient context (``DEFAULT`` = exact/lax_ref outside any
    ``use(...)`` block on this thread)."""
    stack = _ctx_stack()
    return stack[-1] if stack else DEFAULT


def current_path() -> str:
    return "/".join(_scope_stack())


@contextlib.contextmanager
def use(policy_or_ctx, backend: str | None = None):
    """Activate a policy or context on this thread for the ``with`` block.

    Accepts a ``NumericsContext``, a ``PrecisionPolicy``, or a bare
    ``EulerConfig`` (a uniform policy).  ``backend`` overrides the
    context's backend when given."""
    if isinstance(policy_or_ctx, NumericsContext):
        ctx = policy_or_ctx
    elif isinstance(policy_or_ctx, PrecisionPolicy):
        ctx = NumericsContext(policy=policy_or_ctx)
    elif isinstance(policy_or_ctx, EulerConfig):
        ctx = NumericsContext.from_ecfg(policy_or_ctx)
    else:
        raise TypeError(f"cannot activate {type(policy_or_ctx).__name__}")
    if backend is not None:
        ctx = dataclasses.replace(ctx, backend=backend)
    stack = _ctx_stack()
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


@contextlib.contextmanager
def scope(name: str):
    """Push a layer-path component for policy pattern matching."""
    stack = _scope_stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def scoped(name: str):
    """Decorator form of :func:`scope`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def resolve(op: str = "dot_general", path: str | None = None,
            ctx: NumericsContext | None = None) -> EulerConfig:
    """The EulerConfig an op made here and now would run under."""
    nctx = ctx if ctx is not None else current()
    p = path if path is not None else current_path()
    return nctx.cfg_for(p, op)


def _dispatch(op: str, ctx: NumericsContext | None, path: str | None,
              groups=None):
    """(backend, cfg, statistics groups) of one op: the groups of its
    operands a and b (``engine.statistics_groups``): ``groups`` where the
    call names them, else the context's group for both."""
    nctx = ctx if ctx is not None else current()
    p = path if path is not None else current_path()
    # the resolved (op, path), for wrapping backends (the Backend protocol
    # does not carry them): read with last_dispatch() during the call
    _TLS.last_dispatch = (op, p)
    if groups is None:
        groups = (nctx.group, nctx.group)
    return get_backend(nctx.backend), nctx.cfg_for(p, op), tuple(groups)


def last_dispatch() -> tuple[str, str]:
    """(op kind, layer path) of the most recent dispatch on this thread;
    the fault and guard wrappers match their rules and label their stats
    with it."""
    return getattr(_TLS, "last_dispatch", ("dot_general", current_path()))


# --------------------------------------------------------------------------
# Guard stats (the ``guarded:<base>`` backend's observable surface)
# --------------------------------------------------------------------------

def guard_stats(reset: bool = False) -> dict:
    """Per-dispatch ABFT guard counters, keyed ``"<layer path>|<op>"``:
    ``{checks, violations, retries, recovered, unrecovered, nar_words,
    saturated_words, sentinel_words}``."""
    from repro_torch.reliability import guards as _G
    return _G.stats(reset=reset)


def guard_totals(reset: bool = False) -> dict:
    """:func:`guard_stats` summed over every dispatch site."""
    from repro_torch.reliability import guards as _G
    return _G.totals(reset=reset)


def drain_guard_events() -> list:
    """Pop pending per-violation guard events (one dict per violated op
    call, with leading-axis row flags); the scheduler polls this at step
    boundaries to retry the affected requests."""
    from repro_torch.reliability import guards as _G
    return _G.drain_events()


def reset_guard_stats():
    from repro_torch.reliability import guards as _G
    _G.reset()


def _under(groups, fn, *args, column_parts: int = 1):
    """``fn(*args)`` with the operands' statistics groups set (where
    either is a group), and inside ``logmac.column_block(column_parts)``
    where the product is a block of its columns."""
    with contextlib.ExitStack() as stack:
        if groups != (None, None):
            stack.enter_context(_E.statistics_groups(*groups))
        if column_parts > 1:
            stack.enter_context(_LM.column_block(column_parts))
        return fn(*args)


def dot_general(a, b, dimension_numbers, ctx: NumericsContext | None = None,
                *, op: str = "dot_general", path: str | None = None,
                groups=None, column_parts: int = 1):
    """``lax.dot_general`` (JAX dimension numbers) under the active
    policy/backend; ``op`` tags the call for policy resolution.
    ``groups``: the process groups (a's, b's) over which each operand is
    split, where the call knows them (a weight every rank holds whole:
    None; a weight split over ``model``: the model group; an activation
    split over data and model: their joint group), in place of the
    context's group for both; each operand's statistics are then the
    whole tensor's.  ``column_parts``: the product is a block of ``1 /
    column_parts`` of its output columns (a column-parallel weight), and
    its sums run in the whole product's order."""
    backend, cfg, groups = _dispatch(op, ctx, path, groups)
    return _under(groups, backend.dot_general, a, b, dimension_numbers, cfg,
                  column_parts=column_parts)


def matmul(a, b, ctx: NumericsContext | None = None, *,
           path: str | None = None):
    """a @ b (contract a's last dim with b's first) under the active policy."""
    backend, cfg, groups = _dispatch("matmul", ctx, path)
    return _under(groups, backend.matmul, a, b, cfg)


def qk(q, k, ctx: NumericsContext | None = None, *, path: str | None = None):
    """Attention scores q·k^T over the last dim: [..., T, D] x [..., S, D]."""
    backend, cfg, groups = _dispatch("qk", ctx, path)
    return _under(groups, backend.qk, q, k, cfg)


def pv(p, v, ctx: NumericsContext | None = None, *, path: str | None = None):
    """Attention values p·v: [..., T, S] x [..., S, D]."""
    backend, cfg, groups = _dispatch("pv", ctx, path)
    return _under(groups, backend.pv, p, v, cfg)


def elementwise(a, b, ctx: NumericsContext | None = None, *,
                path: str | None = None):
    """Elementwise EULER product (SSD state-update path)."""
    backend, cfg, groups = _dispatch("elementwise", ctx, path)
    return _under(groups, backend.elementwise, a, b, cfg)


def decode_attention(q, k_pages, v_pages, page_table, pos,
                     ctx: NumericsContext | None = None, *, pc=None,
                     softcap=None, window=None, path: str | None = None):
    """Paged decode attention over posit-word KV pages, dispatched whole to
    the backend (the ``cuda`` backend may run the fused kernel)."""
    nctx = ctx if ctx is not None else current()
    p = path if path is not None else current_path()
    _TLS.last_dispatch = ("decode_attention", p)
    return get_backend(nctx.backend).decode_attention(
        q, k_pages, v_pages, page_table, pos, nctx, p,
        pc=pc, softcap=softcap, window=window)
