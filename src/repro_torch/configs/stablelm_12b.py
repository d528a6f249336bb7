"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2 family]

head_dim = 5120/32 = 160."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    mlp_type="swiglu",
    norm_type="layernorm",
    pad_heads_to=16,
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="swiglu",
    norm_type="layernorm",
    attn_chunk=64,
    vocab_pad_multiple=16,
)
