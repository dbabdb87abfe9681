"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

EXPECTED = dict(n_layers=48, d_model=2048, d_ff=0, vocab=50280,
                ssm_state=128)

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=1,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=0, n_kv_heads=0, head_dim=1,
    d_ff=0, vocab=512,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    loss_chunk=32,
)
