"""Precision policies: (layer-path pattern, op kind) -> EulerConfig.

Counterpart of ``repro.numerics.policy``; policies round-trip through the
same plain-dict / JSON schema (``ecfg_to_dict``), with dtypes stored by
name ("float32", "bfloat16"), so a policy file written for the reference
loads here unchanged.  Precedence among matching rules: an op-specific rule
beats an any-op rule, then the more literal pattern, then the later rule.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
import os

import torch

from repro_torch.core.engine import EulerConfig, from_variant

OP_KINDS = ("dot_general", "matmul", "qk", "pv", "elementwise",
            "decode_attention")

_DTYPE_FIELD = "dtype"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_name(dtype) -> str:
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"unsupported dtype {dtype}")


def ecfg_to_dict(cfg: EulerConfig) -> dict:
    """Plain-dict form of an EulerConfig (dtype stored by name)."""
    d = dataclasses.asdict(cfg)
    d[_DTYPE_FIELD] = dtype_name(cfg.dtype)
    return d


def ecfg_from_dict(d: dict) -> EulerConfig:
    """Inverse of :func:`ecfg_to_dict`; also accepts the compact variant
    form ``{"width": 16, "variant": "L-21b", ...}`` and ``{"mode": ...}``."""
    d = dict(d)
    if _DTYPE_FIELD in d:
        d[_DTYPE_FIELD] = _DTYPES[d[_DTYPE_FIELD]]
    if "variant" in d:
        variant = d.pop("variant")
        width = d.pop("width", 16)
        return from_variant(width, variant, **d)
    return EulerConfig(**d)


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One (pattern, op) -> config binding; ``op=None`` matches any op."""

    pattern: str
    cfg: EulerConfig
    op: str | None = None

    def __post_init__(self):
        if self.op is not None and self.op not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.op!r}; one of {OP_KINDS}")

    def matches(self, path: str, op: str) -> bool:
        if self.op is not None and self.op != op:
            return False
        return fnmatch.fnmatchcase(path, self.pattern)

    @property
    def specificity(self) -> int:
        return sum(1 for c in self.pattern if c not in "*?[]")

    def to_dict(self) -> dict:
        d = {"pattern": self.pattern, "cfg": ecfg_to_dict(self.cfg)}
        if self.op is not None:
            d["op"] = self.op
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyRule":
        return cls(pattern=d["pattern"], cfg=ecfg_from_dict(d["cfg"]),
                   op=d.get("op"))


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Mapping (layer path, op kind) -> EulerConfig with a default."""

    default: EulerConfig = dataclasses.field(
        default_factory=lambda: EulerConfig(mode="exact"))
    rules: tuple[PolicyRule, ...] = ()

    def __post_init__(self):
        if not isinstance(self.rules, tuple):
            object.__setattr__(self, "rules", tuple(self.rules))

    def resolve(self, path: str, op: str = "dot_general") -> EulerConfig:
        if op not in OP_KINDS:
            raise ValueError(f"unknown op kind {op!r}; one of {OP_KINDS}")
        return _resolve_cached(self, path, op)

    def with_rule(self, pattern: str, cfg: EulerConfig,
                  op: str | None = None) -> "PrecisionPolicy":
        return dataclasses.replace(
            self, rules=self.rules + (PolicyRule(pattern, cfg, op),))

    @classmethod
    def uniform(cls, cfg: EulerConfig) -> "PrecisionPolicy":
        return cls(default=cfg)

    def to_dict(self) -> dict:
        return {"default": ecfg_to_dict(self.default),
                "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionPolicy":
        default = (ecfg_from_dict(d["default"]) if "default" in d
                   else EulerConfig(mode="exact"))
        rules = tuple(PolicyRule.from_dict(r) for r in d.get("rules", ()))
        return cls(default=default, rules=rules)


def load_policy(spec: str) -> PrecisionPolicy:
    """A policy from a JSON file path or inline JSON (``to_dict`` schema)."""
    if os.path.isfile(spec):
        with open(spec) as f:
            return PrecisionPolicy.from_dict(json.load(f))
    if not spec.lstrip().startswith(("{", "[")):
        raise FileNotFoundError(f"policy file not found: {spec}")
    return PrecisionPolicy.from_dict(json.loads(spec))


@functools.lru_cache(maxsize=4096)
def _resolve_cached(policy: PrecisionPolicy, path: str, op: str) -> EulerConfig:
    best = None
    best_score = None
    for i, rule in enumerate(policy.rules):
        if not rule.matches(path, op):
            continue
        score = (rule.op is not None, rule.specificity, i)
        if best_score is None or score > best_score:
            best, best_score = rule, score
    return best.cfg if best is not None else policy.default
