"""The four assigned input-shape suites and the (arch × shape) applicability
map (port of ``repro.configs.shapes``).

  train_4k     seq_len=4096    global_batch=256   → train_step
  prefill_32k  seq_len=32768   global_batch=32    → serve prefill
  decode_32k   seq_len=32768   global_batch=128   → serve_step (1 token, 32k cache)
  long_500k    seq_len=524288  global_batch=1     → serve_step, sub-quadratic only

``long_500k`` runs only for SSM/hybrid archs (O(1) state / bounded local
window); pure full-attention archs skip it (window-vs-full attention asymptotics).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSuite("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSuite("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSuite("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSuite("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable(cfg, shape: ShapeSuite) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 512k dense KV cache is beyond "
                       "design envelope; paper technique does not change attention "
                       "asymptotics")
    return True, ""
