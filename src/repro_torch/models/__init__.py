"""The LM side of the port (port of ``repro.models``): the dense family —
parameters, ``forward`` and its training ``loss_fn``, ``prefill`` and
``decode_step`` with an optional int8 KV cache, weight-only quantized
parameters (``QWeight``, ``quantize_params``) and greedy :func:`generate` —
the hybrid family's serving (RG-LRU blocks, :mod:`.rglru`, and local
attention), the SSM family's (Mamba-2's SSD blocks, :mod:`.ssm`), and the
cross-attention families' (whisper-tiny's ``encode`` and decoder,
llama-3.2-vision-11b's image layers). The training of the recurrent and
cross-attention families and the MoE family come in later slices
(ROADMAP.md §1)."""
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.generate import generate
from repro_torch.models.model import (
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
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
    "loss_fn",
    "prefill",
    "QWeight",
    "materialize",
    "param_bytes",
    "quantize_params",
    "quantize_weight",
]
