"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]

d_inner = 2×1024 = 2048; headdim 64 → 32 SSD heads.
Vocab padded 50280 → 50432 for 16-way TP divisibility (see repro.parallel.sharding).
Supports long_500k (O(1) recurrent state)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=64,
    ssm_conv=4,
    norm_type="rmsnorm",
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_chunk=16,
    ssm_conv=4,
    norm_type="rmsnorm",
    vocab_pad_multiple=16,
)
