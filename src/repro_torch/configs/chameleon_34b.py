"""chameleon-34b [vlm] — early-fusion, VQ image tokens, qk-norm
[arXiv:2405.09818].  VQ image frontend is a stub: input-shape specs provide
precomputed patch-token embeddings."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
                d_ff=22016, vocab=65536)

FULL = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536,
    mlp="silu_gated", qk_norm=True, embedding_inputs=True,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=384, vocab=512,
    mlp="silu_gated", qk_norm=True, embedding_inputs=True,
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
