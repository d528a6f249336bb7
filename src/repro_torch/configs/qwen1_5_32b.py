"""qwen1.5-32b [dense]: 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5 family]

TP note: 40 heads do not divide the 16-way model axis → q/kv heads padded to
48 (see repro.parallel.sharding)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pad_heads_to=16,
)

SMOKE = ModelConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    attn_chunk=64,
    vocab_pad_multiple=16,
)
