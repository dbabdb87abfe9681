"""Numerics backends behind a string registry.

Counterpart of ``repro.numerics.backends``:

  "exact"    f32 dot_general — ignores the config's approximation knobs.
  "lax_ref"  the reference engine (``repro_torch.core.engine``): posit
             quantization + two-plane ILM as tensor ops (name kept so
             policies and command lines carry over).
  "cuda"     the kernels (``repro_torch.kernels``), the counterpart of the
             reference's "pallas" backend with its routing rules: an
             euler-mode dot with one contraction and no batch dims runs
             encode + logmac (``pre_scale``/``out_quant`` applied around
             the kernel as in the reference); every other dot runs the
             ``lax_ref`` engine; ``decode_attention`` runs the fused
             flash-decode kernel for integer posit pages under euler qk/pv,
             and the gather reference otherwise.  Each kernel wrapper
             dispatches on its tensors' device, so on CPU tensors the
             backend runs the kernels' plain versions.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import engine as _E
from repro_torch.core import posit as _P
from repro_torch.core.engine import EulerConfig


class Backend:
    """Op-set protocol; subclasses implement ``dot_general``."""

    name = "base"

    def dot_general(self, a, b, dimension_numbers, cfg: EulerConfig):
        raise NotImplementedError

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


class LaxRefBackend(Backend):
    name = "lax_ref"

    def dot_general(self, a, b, dimension_numbers, cfg: EulerConfig):
        return _E.euler_dot_general(a, b, dimension_numbers, cfg)


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
        if cfg.pre_scale:  # same per-tensor power-of-2 centering as the engine
            sa, sb = _E._pow2_scale(af), _E._pow2_scale(bf)
            af, bf = af / sa, bf / sb
        out = _K.euler_matmul_fused(af, bf, cfg)
        if cfg.pre_scale:
            out = out * (sa * sb)
        if cfg.out_quant:
            out = _P.quantize(out, cfg.posit)
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


_BACKENDS: dict[str, Backend] = {}


def register_backend(name: str, backend: Backend) -> Backend:
    _BACKENDS[name] = backend
    return backend


def get_backend(name: "str | Backend") -> Backend:
    if isinstance(name, Backend):
        return name
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown numerics backend {name!r}; "
                       f"available: {sorted(_BACKENDS)}") from None


register_backend("exact", ExactBackend())
register_backend("lax_ref", LaxRefBackend())
register_backend("cuda", CudaBackend())
