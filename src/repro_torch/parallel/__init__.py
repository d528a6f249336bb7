"""Serving layer of the port (``repro.parallel``'s solver-serving half, on one
device): the chunked :class:`BatchServer`, the continuous-batching
:class:`ContinuousScheduler` and the write-ahead :class:`ChunkJournal`.

Of the model-training half, :func:`fake_grad_compression` (the Q_b gradient
compression of one device's training step). Not yet ported: sharding over
several devices (the reference's ``shard_map`` half of ``parallel/batch.py``,
``parallel/sharding.py`` and the quantized all-reduce of
``parallel/collectives.py``).
"""
from repro_torch.parallel.batch import (
    BatchServer,
    make_batch_mesh,
    pad_batch,
    pad_state,
    refill_rows,
    strip_state,
)
from repro_torch.parallel.collectives import fake_grad_compression
from repro_torch.parallel.journal import ChunkJournal
from repro_torch.parallel.scheduler import (
    AdmissionQueue,
    ContinuousScheduler,
    Request,
    RequestReport,
    segment_step,
)

__all__ = [
    "AdmissionQueue",
    "BatchServer",
    "ChunkJournal",
    "ContinuousScheduler",
    "fake_grad_compression",
    "Request",
    "RequestReport",
    "make_batch_mesh",
    "pad_batch",
    "pad_state",
    "refill_rows",
    "segment_step",
    "strip_state",
]
