"""Serving layer of the port (``repro.parallel``'s solver-serving half, on one
device): the chunked :class:`BatchServer`, the continuous-batching
:class:`ContinuousScheduler` and the write-ahead :class:`ChunkJournal`.

Not yet ported: sharding the batch over several devices (the reference's
``shard_map`` half of ``parallel/batch.py``), and the model-training half
(``parallel/sharding.py``, ``parallel/collectives.py``).
"""
from repro_torch.parallel.batch import (
    BatchServer,
    make_batch_mesh,
    pad_batch,
    pad_state,
    refill_rows,
    strip_state,
)
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
    "Request",
    "RequestReport",
    "make_batch_mesh",
    "pad_batch",
    "pad_state",
    "refill_rows",
    "segment_step",
    "strip_state",
]
