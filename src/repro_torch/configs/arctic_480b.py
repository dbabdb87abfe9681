"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
                d_ff=4864, vocab=32000, n_experts=128, top_k=2)

FULL = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, moe_dense_residual=True, capacity_factor=1.25,
    mlp="silu_gated",
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    n_experts=8, top_k=2, moe_dense_residual=True,
    mlp="silu_gated",
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
