"""Unified model configuration (port of ``repro.models.config``).

One frozen dataclass describes dense GQA transformers, MoE, SSM (Mamba-2 SSD),
hybrid (RG-LRU + local attention), encoder-decoder (Whisper) and VLM
(cross-attention image layers). Family-specific fields are zero/empty when
unused. ``repro_torch/configs/<arch>.py`` instantiates one per architecture.
The fields, properties and parameter counts are the reference's;
:func:`torch_dtype` maps ``cfg.dtype`` to a ``torch.dtype``. The fields that
steer XLA (``remat``, ``scan_unroll``) are kept so that the two packages'
configs compare equal; the port runs eagerly, ignores ``scan_unroll`` and
reads ``remat`` as a checkpoint per layer in a differentiated forward.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def round_up(v: int, mult: int) -> int:
    return (v + mult - 1) // mult * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention / block options ---
    qkv_bias: bool = False
    mlp_type: str = "swiglu"         # swiglu | gelu | relu2
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_chunk: int = 1024           # flash/chunked attention block size

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # --- hybrid (RecurrentGemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn"); () = all attn
    local_window: int = 0                 # sliding-window size for local attention
    rnn_width: int = 0                    # RG-LRU recurrent width (0 -> d_model)

    # --- encoder-decoder (Whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0                  # stub audio-frame tokens (post-conv)

    # --- VLM ---
    cross_attn_every: int = 0             # every k-th layer is a cross-attn layer
    n_image_tokens: int = 0               # stub patch-embedding tokens

    # --- numerics & padding ---
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    pad_heads_to: int = 1                 # pad q-heads to a multiple (TP divisibility)
    remat: bool = True                    # activation checkpointing in scan
    scan_unroll: bool = False             # fully unroll internal scans (dry-run
                                          # cost analysis: while bodies are
                                          # counted once by HloCostAnalysis)
    moe_group_size: int = 4096            # tokens per MoE dispatch group

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def padded_heads(self) -> int:
        return round_up(self.n_heads, self.pad_heads_to)

    @property
    def padded_kv_heads(self) -> int:
        """MHA (kv == q) must pad kv alongside q so GQA grouping stays exact;
        true-GQA kv counts are left as-is (replication decided by sharding)."""
        if self.n_kv_heads and self.n_kv_heads == self.n_heads:
            return self.padded_heads
        return self.n_kv_heads

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM state / bounded local window)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            # attention layers must all be local (bounded window)
            return self.local_window > 0
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs generate tokens (whisper = enc-dec)

    def pattern_for_layers(self) -> Tuple[str, ...]:
        """Expanded per-layer block types of the *decoder* stack."""
        if self.family == "hybrid" and self.block_pattern:
            p = []
            while len(p) < self.n_layers:
                p.extend(self.block_pattern)
            return tuple(p[: self.n_layers])
        if self.family == "vlm" and self.cross_attn_every:
            return tuple(
                "xattn" if (i % self.cross_attn_every) == self.cross_attn_every - 2 else "attn"
                for i in range(self.n_layers)
            )
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.n_layers))
        if self.family == "encdec":
            # every decoder layer: self-attn + cross-attn to the encoder memory
            return tuple("xattn" for _ in range(self.n_layers))
        return tuple("attn" for _ in range(self.n_layers))

    # --- parameter counting (for roofline MODEL_FLOPS) ---
    def param_count(self) -> int:
        d, v = self.d_model, self.padded_vocab
        hd = self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        pattern = self.pattern_for_layers()
        for kind in pattern:
            if kind in ("attn", "xattn"):
                qkv = d * self.padded_heads * hd + 2 * d * self.n_kv_heads * hd
                out = self.padded_heads * hd * d
                per_layer += qkv + out
            if kind == "ssm":
                din = self.d_inner
                in_p = d * (2 * din + 2 * self.ssm_state + self.ssm_heads)
                out_p = din * d
                per_layer += in_p + out_p
            if kind == "rec":
                w = self.rnn_width_
                # in-proj (2 branches), RG-LRU gates (r, i), conv, Λ, out-proj
                per_layer += d * 2 * w + 2 * w * w + self.ssm_conv * w + w + w * d
            # FFN
            if kind != "ssm":
                if self.n_experts:
                    per_layer += self.n_experts * 3 * d * self.d_ff + d * self.n_experts
                elif self.mlp_type == "swiglu":
                    per_layer += 3 * d * self.d_ff
                else:
                    per_layer += 2 * d * self.d_ff
        enc = 0
        if self.n_encoder_layers:
            enc_attn = 4 * d * self.n_heads * hd
            enc_ffn = 2 * d * self.d_ff
            enc = self.n_encoder_layers * (enc_attn + enc_ffn)
        return emb + per_layer + enc

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active = self.n_layers * self.experts_per_token * 3 * self.d_model * self.d_ff
        return total - all_experts + active


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a config's ``dtype`` string ("bfloat16", ...)."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown model dtype {name!r}; expected one of "
                         f"{tuple(_TORCH_DTYPES)}") from None
