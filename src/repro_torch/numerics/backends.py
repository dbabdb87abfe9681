"""Numerics backends behind a string registry.

Counterpart of ``repro.numerics.backends``:

  "exact"    f32 dot_general — ignores the config's approximation knobs.
  "lax_ref"  the reference engine (``repro_torch.core.engine``): posit
             quantization + two-plane ILM as tensor ops (name kept so
             policies and command lines carry over).
  "cuda"     the kernels (``repro_torch.kernels``), the counterpart of the
             reference's "pallas" backend with its routing rules: an
             euler-mode dot with one contraction and no batch dims runs
             encode + logmac (``pre_scale`` as one fused scale-and-encode
             pass per operand, ``out_quant`` after the kernel, as the
             reference applies them); every other dot runs the
             ``lax_ref`` engine; ``decode_attention`` runs the fused
             flash-decode kernel for integer posit pages under euler qk/pv,
             and the gather reference otherwise.  Each kernel wrapper
             dispatches on its tensors' device, so on CPU tensors the
             backend runs the kernels' plain versions.  Forward only, as
             the reference's "pallas": the kernels have no backward, so
             a dot whose operand requires grad while autograd records
             raises (on every device) and names "lax_ref", the
             differentiable path.

Two wrappers compose around any base by name, nesting left to right:

  "faulty:<base>"   seeded bit flips on the operands' posit words
                    (``repro_torch.reliability.faults``), then the base op.
  "guarded:<base>"  the base op under ABFT checks, sentinels and the
                    escalation ladder (``repro_torch.reliability.guards``).

Like the reference, neither wrapper defines ``decode_attention``: under
them paged decode runs the base ``Backend`` gather reference, whose qk/pv
re-dispatch through the wrappers, so the fused flash-decode kernel is not
launched on a guarded or faulty path.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import engine as _E
from repro_torch.core.engine import EulerConfig


class Backend:
    """Op-set protocol.  Subclasses implement ``dot_general`` and
    ``elementwise``; the named ops default to ``dot_general`` with the
    canonical dimension numbers."""

    name = "base"

    def dot_general(self, a, b, dimension_numbers, cfg: EulerConfig):
        raise NotImplementedError

    def elementwise(self, a, b, cfg: EulerConfig):
        raise NotImplementedError

    def matmul(self, a, b, cfg: EulerConfig):
        """a @ b: contract a's last dim with b's first."""
        dn = (((a.ndim - 1,), (0,)), ((), ()))
        return self.dot_general(a, b, dn, cfg)

    def qk(self, q, k, cfg: EulerConfig):
        """Attention scores over the last dim: [..., T, D] x [..., S, D]."""
        nd = q.ndim
        batch = tuple(range(nd - 2))
        dn = (((nd - 1,), (nd - 1,)), (batch, batch))
        return self.dot_general(q, k, dn, cfg)

    def pv(self, p, v, cfg: EulerConfig):
        """Attention values: [..., T, S] x [..., S, D]."""
        nd = p.ndim
        batch = tuple(range(nd - 2))
        dn = (((nd - 1,), (nd - 2,)), (batch, batch))
        return self.dot_general(p, v, dn, cfg)

    def decode_attention(self, q, k_pages, v_pages, page_table, pos,
                         nctx, path, *, pc=None, softcap=None, window=None):
        """Gather-then-attend reference; the inner qk/pv re-dispatch through
        the op layer, as the dense decode path's contractions do."""
        from repro_torch.kernels import paged_decode as _PD
        from . import api as _api

        def dot_fn(a, b, dn, op):
            return _api.dot_general(a, b, dn, nctx, op=op, path=path)

        return _PD.paged_attention_reference(
            q, k_pages, v_pages, page_table, pos, pc=pc, softcap=softcap,
            window=window, dot_fn=dot_fn)


class ExactBackend(Backend):
    name = "exact"

    def dot_general(self, a, b, dimension_numbers, cfg: EulerConfig):
        return _E.euler_dot_general(a, b, dimension_numbers,
                                    cfg.replace(mode="exact"))

    def elementwise(self, a, b, cfg: EulerConfig):
        return a * b


class LaxRefBackend(Backend):
    name = "lax_ref"

    def dot_general(self, a, b, dimension_numbers, cfg: EulerConfig):
        return _E.euler_dot_general(a, b, dimension_numbers, cfg)

    def elementwise(self, a, b, cfg: EulerConfig):
        return _E.ilm_elementwise(a, b, cfg)


def _single_contraction(a, b, dimension_numbers):
    """Operands permuted so the one contracting dim is a's last and b's
    first (the kernel's layout), or None."""
    (lc, rc), (lb, rb) = dimension_numbers
    if lb or rb or len(lc) != 1 or len(rc) != 1:
        return None
    la, ra = lc[0], rc[0]
    perm_a = tuple(d for d in range(a.ndim) if d != la) + (la,)
    perm_b = (ra,) + tuple(d for d in range(b.ndim) if d != ra)
    return a.permute(*perm_a), b.permute(*perm_b)


class CudaBackend(LaxRefBackend):
    """Fused posit-codec + logmac kernel path (forward/inference)."""

    name = "cuda"

    def dot_general(self, a, b, dimension_numbers, cfg: EulerConfig):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            raise RuntimeError(
                "the 'cuda' backend is forward-only: its kernels have no "
                "backward pass, so the weights would get no gradient; "
                "train on the differentiable reference engine, backend "
                "'lax_ref' (run the cuda backend under torch.no_grad())")
        if cfg.mode != "euler":
            return super().dot_general(a, b, dimension_numbers, cfg)
        pair = _single_contraction(a, b, dimension_numbers)
        if pair is None:
            return super().dot_general(a, b, dimension_numbers, cfg)
        from repro_torch.kernels import ops as _K
        a2, b2 = pair
        K = a2.shape[-1]
        if K != b2.shape[0] or a2.numel() == 0 or b2.numel() == 0:
            return super().dot_general(a, b, dimension_numbers, cfg)
        lhs_free, rhs_free = tuple(a2.shape[:-1]), tuple(b2.shape[1:])
        M = math.prod(lhs_free)
        N = math.prod(rhs_free)
        af = a2.reshape(M, K).to(torch.float32)
        bf = b2.reshape(K, N).to(torch.float32)
        # the engine's per-tensor power-of-2 centering, computed with each
        # operand's words in one kernel pass
        if cfg.pre_scale:   # over the operands' groups, where split
            out = _K.euler_matmul_prescaled(af, bf, cfg,
                                            _E.statistics_group_pair())
        else:
            out = _K.euler_matmul_fused(af, bf, cfg)
        if cfg.out_quant:
            out = _K.quantize(out, cfg.posit)
        return out.reshape(lhs_free + rhs_free).to(cfg.dtype)

    def decode_attention(self, q, k_pages, v_pages, page_table, pos,
                         nctx, path, *, pc=None, softcap=None, window=None):
        cfg_qk = nctx.cfg_for(path, "qk")
        cfg_pv = nctx.cfg_for(path, "pv")
        if (pc is None or cfg_qk.mode != "euler" or cfg_pv.mode != "euler"
                or torch.is_floating_point(k_pages)):
            return super().decode_attention(
                q, k_pages, v_pages, page_table, pos, nctx, path,
                pc=pc, softcap=softcap, window=window)
        from repro_torch.kernels import paged_decode as _PD
        return _PD.paged_flash_decode(
            q, k_pages, v_pages, page_table, pos, window, pc=pc,
            cfg_qk=cfg_qk, cfg_pv=cfg_pv, softcap=softcap)


class FaultyBackend(Backend):
    """Fault-injection wrapper: corrupt posit words, then run the base op.

    When a :class:`repro_torch.reliability.faults.FaultPlan` is active
    (``faults.inject(plan, key, step)``, which the serving engine wraps
    around each decode step) and matches the dispatched (layer path, op
    kind), the selected operand is encoded to posit words, seeded
    single-bit flips of the plan's bit role are applied, and the corrupted
    values go to the wrapped backend.  Exact-mode ops are immune."""

    def __init__(self, base: "str | Backend"):
        self.base = get_backend(base)
        self.name = f"faulty:{self.base.name}"

    def _corrupt(self, a, b, cfg: EulerConfig):
        from repro_torch.reliability import faults as _F
        from . import api as _api
        ctx = _F.current()
        if ctx is None or cfg.mode not in ("euler", "posit", "quant_only"):
            return a, b
        plan, key, step = ctx
        op, path = _api.last_dispatch()
        if not plan.matches(path, op):
            return a, b
        if plan.operand in ("a", "both"):
            a = _F.corrupt(a, cfg, plan, key, step,
                           salt=_F.call_salt(path, op, "a"))
        if plan.operand in ("b", "both"):
            b = _F.corrupt(b, cfg, plan, key, step,
                           salt=_F.call_salt(path, op, "b"))
        return a, b

    def dot_general(self, a, b, dimension_numbers, cfg: EulerConfig):
        a, b = self._corrupt(a, b, cfg)
        return self.base.dot_general(a, b, dimension_numbers, cfg)

    def matmul(self, a, b, cfg: EulerConfig):
        a, b = self._corrupt(a, b, cfg)
        return self.base.matmul(a, b, cfg)

    def qk(self, q, k, cfg: EulerConfig):
        q, k = self._corrupt(q, k, cfg)
        return self.base.qk(q, k, cfg)

    def pv(self, p, v, cfg: EulerConfig):
        p, v = self._corrupt(p, v, cfg)
        return self.base.pv(p, v, cfg)

    def elementwise(self, a, b, cfg: EulerConfig):
        a, b = self._corrupt(a, b, cfg)
        return self.base.elementwise(a, b, cfg)


def faulty(base: "str | Backend") -> FaultyBackend:
    """The fault-injection wrapper around ``base``, registered (memoized)
    under ``"faulty:<base>"``."""
    wrapped = FaultyBackend(base)
    return _BACKENDS.setdefault(wrapped.name, wrapped)


class GuardedBackend(Backend):
    """ABFT guard wrapper: run the base op, verify it, escalate on violation
    (:func:`repro_torch.reliability.guards.guard_call`).  ``elementwise``
    has no checksum identity and passes through unguarded."""

    def __init__(self, base: "str | Backend", gcfg=None):
        from repro_torch.reliability import guards as _G
        self.base = get_backend(base)
        self.gcfg = gcfg if gcfg is not None else _G.DEFAULT
        self.name = f"guarded:{self.base.name}"

    def _guarded(self, kind, a, b, dimension_numbers, cfg):
        from repro_torch.reliability import guards as _G
        return _G.guard_call(self.base, kind, a, b, dimension_numbers,
                             cfg, self.gcfg)

    def dot_general(self, a, b, dimension_numbers, cfg: EulerConfig):
        return self._guarded("dot_general", a, b, dimension_numbers, cfg)

    def matmul(self, a, b, cfg: EulerConfig):
        dn = (((a.ndim - 1,), (0,)), ((), ()))
        return self._guarded("matmul", a, b, dn, cfg)

    def qk(self, q, k, cfg: EulerConfig):
        nd = q.ndim
        batch = tuple(range(nd - 2))
        dn = (((nd - 1,), (nd - 1,)), (batch, batch))
        return self._guarded("qk", q, k, dn, cfg)

    def pv(self, p, v, cfg: EulerConfig):
        nd = p.ndim
        batch = tuple(range(nd - 2))
        dn = (((nd - 1,), (nd - 2,)), (batch, batch))
        return self._guarded("pv", p, v, dn, cfg)

    def elementwise(self, a, b, cfg: EulerConfig):
        return self.base.elementwise(a, b, cfg)


def guarded(base: "str | Backend", gcfg=None) -> GuardedBackend:
    """The ABFT guard wrapper around ``base``, registered (memoized) under
    ``"guarded:<base>"``; a non-default ``gcfg`` replaces the registered
    instance (one guard policy per name)."""
    wrapped = GuardedBackend(base, gcfg)
    if gcfg is not None:
        return register_backend(wrapped.name, wrapped)
    return _BACKENDS.setdefault(wrapped.name, wrapped)


_BACKENDS: dict[str, Backend] = {}


def register_backend(name: str, backend: Backend) -> Backend:
    _BACKENDS[name] = backend
    return backend


def get_backend(name: "str | Backend") -> Backend:
    """Look up a backend by name (instances pass through).  ``faulty:`` and
    ``guarded:`` prefixes resolve (and self-register) on demand, nesting
    left to right: ``"guarded:faulty:cuda"`` guards a faulted cuda path."""
    if isinstance(name, Backend):
        return name
    try:
        return _BACKENDS[name]
    except KeyError:
        if name.startswith("faulty:"):
            return faulty(name.split(":", 1)[1])
        if name.startswith("guarded:"):
            return guarded(name.split(":", 1)[1])
        raise KeyError(f"unknown numerics backend {name!r}; "
                       f"available: {sorted(_BACKENDS)}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


register_backend("exact", ExactBackend())
register_backend("lax_ref", LaxRefBackend())
register_backend("cuda", CudaBackend())
