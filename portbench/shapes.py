"""A configuration's derived sizes, from its file alone (no program code):
the yardstick's weights, counts and reference read them here.  What
differs by model family lives in ``families/<family>.py``."""
from __future__ import annotations

import dataclasses

from . import families


@dataclasses.dataclass(frozen=True)
class Shapes:
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    window: int | None = None
    n_global_layers: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # the model object's other keys, for a family's own sizes
    extra: dict = dataclasses.field(default_factory=dict, compare=False,
                                    hash=False)

    @classmethod
    def of(cls, model: dict) -> "Shapes":
        """The sizes of a configuration file's ``model`` object."""
        families.load(model["family"])
        names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        return cls(**{k: v for k, v in model.items() if k in names},
                   extra={k: v for k, v in model.items() if k not in names})

    @property
    def fam(self):
        """The family's module."""
        return families.load(self.family)

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 16) * 16

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_state

    @property
    def d_proj(self) -> int:
        """in_proj's packed [z, x, B, C, dt] width."""
        return 2 * self.d_inner + 2 * self.ssm_state + self.n_ssm_heads

    def window_of(self, i: int) -> int | None:
        """Layer i's attention window (None: global)."""
        return self.fam.window_of(self, i)

    def projections(self) -> list[tuple[str, int, int]]:
        """(name, K, N) of one layer's projection contractions."""
        return self.fam.projections(self)
