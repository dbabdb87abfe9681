"""yi-6b [dense] — llama-architecture GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
                d_ff=11008, vocab=64000)

FULL = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000,
    mlp="silu_gated", rope_theta=5_000_000.0,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="yi-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=384, vocab=512,
    mlp="silu_gated",
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
