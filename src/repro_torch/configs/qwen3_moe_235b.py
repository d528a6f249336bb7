"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536/expert
vocab=151936 — 128 experts, top-8. [hf:Qwen/Qwen3 family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    n_experts=128,
    experts_per_token=8,
    pad_heads_to=16,
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-smoke",
    family="moe",
    n_layers=3,           # odd depth exercises the scan+tail split (94 = 94x1)
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=32,
    vocab_size=512,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    n_experts=8,
    experts_per_token=2,
    attn_chunk=64,
    vocab_pad_multiple=16,
)
