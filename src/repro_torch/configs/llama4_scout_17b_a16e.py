"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
                d_ff=8192, vocab=202048, n_experts=16, top_k=1)

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, moe_dense_residual=False, capacity_factor=1.25,
    mlp="silu_gated", rope_theta=500_000.0,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512,
    n_experts=4, top_k=1,
    mlp="silu_gated",
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
