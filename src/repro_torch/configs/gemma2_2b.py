"""gemma2-2b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
                d_ff=9216, vocab=256000)

FULL = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=288,
    d_ff=9216, vocab=256000,
    mlp="gelu_gated", post_norm=True,
    local_global_period=2, window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, head_dim=24,
    d_ff=384, vocab=512,
    mlp="gelu_gated", post_norm=True,
    local_global_period=2, window=32,
    logit_softcap=30.0, attn_softcap=50.0,
    loss_chunk=32, q_chunk=32, kv_chunk=32,
)
