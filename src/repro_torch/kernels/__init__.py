"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

* ``qmm``       — packed int2/4/8 dequant matmul (``qmm`` and ``qmm_group``)
* ``hsthresh``  — streaming hard threshold H_s (``hist`` and ``mask``)
* ``sqround``   — stochastic rounding quantizer
* ``flashattn`` — online-softmax attention with GQA

The public entry points below dispatch by device: a CUDA tensor launches the
kernel, a CPU tensor runs the plain version.
"""
from repro_torch.kernels.flashattn.ops import flash_attention
from repro_torch.kernels.hsthresh.ops import hsthresh
from repro_torch.kernels.qmm.ops import (
    PackedOperator,
    PackedWeights,
    pack_operator,
    pack_weights,
    packed_matvec,
    packed_rmatvec,
    qmm,
)
from repro_torch.kernels.sqround.ops import sqround

__all__ = [
    "flash_attention",
    "hsthresh",
    "PackedOperator",
    "PackedWeights",
    "pack_operator",
    "pack_weights",
    "packed_matvec",
    "packed_rmatvec",
    "qmm",
    "sqround",
]
