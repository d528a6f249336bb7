"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer; the vision tower is a
STUB (input_specs provides precomputed patch embeddings, 1600 tokens).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    cross_attn_every=5,
    n_image_tokens=1600,
    pad_heads_to=16,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    cross_attn_every=5,
    n_image_tokens=16,
    attn_chunk=64,
    vocab_pad_multiple=16,
)
