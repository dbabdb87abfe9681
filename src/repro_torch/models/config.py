"""Architecture configuration dataclass shared by all model families
(a copy of the reference's ``repro.models.config``; pure Python)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"            # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int | None = None

    # attention
    rope_theta: float = 10_000.0
    window: int | None = None                # sliding-window size (if any)
    local_global_period: int | None = None   # gemma2: 1 global per P layers
    n_global_layers: int = 0                 # hymba: this many global layers
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    qk_norm: bool = False

    # mlp
    mlp: str = "silu_gated"  # silu_gated | gelu_gated | relu2 | gelu

    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False         # arctic: dense FFN in parallel
    capacity_factor: float = 1.25

    # ssm (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    post_norm: bool = False                  # gemma2: post-block RMSNorms
    dtype: str = "float32"

    # execution knobs (scale/perf, not architecture)
    scan_layers: bool = True                 # reference: scan over stacked layers
    q_chunk: int = 1024                      # flash-attention block sizes
    kv_chunk: int = 1024
    loss_chunk: int = 512                    # T-chunk of the reference loss
    cache_dtype: str = "bfloat16"
    # modality frontend stub: if True the model also accepts precomputed
    # frame/patch embeddings instead of token ids (audio / vlm families)
    embedding_inputs: bool = False

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 15) // 16) * 16  # TP-divisible vocab

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(1, self.d_inner // self.ssm_head_dim)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode cost is sub-quadratic in context (SSM/hybrid-SWA)."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """Attention flavour for layer i: 'global' | 'local'."""
        if self.family == "hybrid":
            # hymba: few global layers (first / middle / last), rest SWA
            if self.n_global_layers:
                globals_at = {0, self.n_layers // 2, self.n_layers - 1}
                return "global" if i in globals_at else "local"
            return "global"
        if self.local_global_period:
            return "global" if (i % self.local_global_period ==
                                self.local_global_period - 1) else "local"
        return "global"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
