"""gemma2-27b [dense] — local+global alternating attention, logit softcap
[arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
                d_ff=36864, vocab=256000)

FULL = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    mlp="gelu_gated", post_norm=True,
    local_global_period=2, window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="gemma2-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab=512,
    mlp="gelu_gated", post_norm=True,
    local_global_period=2, window=32,
    logit_softcap=30.0, attn_softcap=50.0,
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
