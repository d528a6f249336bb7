"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427]

head_dim 256; local window 2048 → supports long_500k (bounded state).
Attention is small (MQA) → heads replicated on the model axis (pad_heads_to=1);
TP shards the MLP and RG-LRU width instead (see repro.parallel.sharding)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    rnn_width=2560,
    ssm_conv=4,
    pad_heads_to=1,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    block_pattern=("rec", "rec", "attn"),
    local_window=32,
    rnn_width=64,
    ssm_conv=4,
    attn_chunk=32,
    vocab_pad_multiple=16,
)
