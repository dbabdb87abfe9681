"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  Modality frontend (EnCodec) is a stub: the
input-shape specs provide precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
                d_ff=8192, vocab=2048)

FULL = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048,
    mlp="gelu", embedding_inputs=True,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=256,
    mlp="gelu", embedding_inputs=True,
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
