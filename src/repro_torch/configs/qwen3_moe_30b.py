"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768/expert
vocab=151936 — 128 experts, top-8. [hf:Qwen/Qwen3-30B-A3B]

head_dim 128 (q dim 4096 > d_model, Qwen3 style). Experts sharded over the
16-way model axis (8 experts/device)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    n_experts=128,
    experts_per_token=8,
    pad_heads_to=16,
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    n_experts=8,
    experts_per_token=2,
    attn_chunk=64,
    vocab_pad_multiple=16,
)
