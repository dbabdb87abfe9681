"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer, 3 global
attention layers (first/middle/last), SWA elsewhere [arXiv:2411.13676; hf]."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
                d_ff=5504, vocab=32001, ssm_state=16)

FULL = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    n_global_layers=3, window=1024,
    mlp="silu_gated",
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    n_global_layers=1, window=32,
    mlp="silu_gated",
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
