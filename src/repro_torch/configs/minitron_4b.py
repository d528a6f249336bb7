"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned Nemotron (squared-ReLU MLP). [arXiv:2407.14679]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="relu2",
    norm_type="layernorm",
    pad_heads_to=16,
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    mlp_type="relu2",
    norm_type="layernorm",
    attn_chunk=64,
    vocab_pad_multiple=16,
)
