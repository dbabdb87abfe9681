"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
                d_ff=24576, vocab=256000)

FULL = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000,
    mlp="relu2", rope_theta=10_000.0,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=512, vocab=512,
    mlp="relu2",
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
