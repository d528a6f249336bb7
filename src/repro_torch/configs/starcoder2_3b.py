"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, GELU MLP + LayerNorm. [arXiv:2402.19173]

TP note: 24 q-heads padded to 32 for the 16-way model axis; kv=2 does not
divide 16 → kv projections replicated (see repro.parallel.sharding)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    qkv_bias=True,
    mlp_type="gelu",
    norm_type="layernorm",
    pad_heads_to=16,
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    mlp_type="gelu",
    norm_type="layernorm",
    attn_chunk=64,
    vocab_pad_multiple=16,
)
