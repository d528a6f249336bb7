"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865 — enc-dec; conv audio frontend is a STUB (input_specs provides
precomputed frame embeddings, T_enc = 1500). [arXiv:2212.04356]

Vocab padded 51865 → 52096. Every decoder layer: self-attn + cross-attn."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    n_encoder_layers=4,
    encoder_seq=1500,
    pad_heads_to=1,        # tiny attention: replicate rather than pad/shard
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="gelu",
    norm_type="layernorm",
    n_encoder_layers=2,
    encoder_seq=64,
    attn_chunk=64,
    vocab_pad_multiple=16,
)
