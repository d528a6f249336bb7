"""The LM side of the port (port of ``repro.models``), every family of the
reference: parameters (``init_params``, or ``init_quantized_params`` for a
W<bits> tree built leaf by leaf), ``forward`` and its training ``loss_fn``,
``prefill`` and ``decode_step`` with an optional int8 KV cache, weight-only
quantized parameters (``QWeight``, ``quantize_params``) and greedy
:func:`generate` — dense decoders, Qwen3-MoE's experts (:mod:`.moe`), the
hybrid family (RG-LRU blocks, :mod:`.rglru`, and local attention), the SSM
family (Mamba-2's SSD blocks, :mod:`.ssm`), and the cross-attention
families (whisper-tiny's ``encode`` and decoder, llama-3.2-vision-11b's
image layers). The cross-attention families' training comes in a later
slice (ROADMAP.md §1)."""
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.generate import generate
from repro_torch.models.model import (
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    init_quantized_params,
    loss_fn,
    prefill,
)
from repro_torch.models.quantized import (
    QWeight,
    materialize,
    param_bytes,
    quantize_params,
    quantize_weight,
)

__all__ = [
    "ModelConfig",
    "torch_dtype",
    "decode_step",
    "encode",
    "forward",
    "generate",
    "init_cache",
    "init_params",
    "init_quantized_params",
    "loss_fn",
    "prefill",
    "QWeight",
    "materialize",
    "param_bytes",
    "quantize_params",
    "quantize_weight",
]
