"""Data pipeline (port of ``repro.data``)."""
from repro_torch.data.synthetic import SyntheticStream, synthetic_batch

__all__ = ["SyntheticStream", "synthetic_batch"]
