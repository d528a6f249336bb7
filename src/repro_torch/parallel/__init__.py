"""Serving layer of the port (``repro.parallel``'s solver-serving half): the
chunked :class:`BatchServer`, the continuous-batching
:class:`ContinuousScheduler` and the write-ahead :class:`ChunkJournal`, on
one device or with the batch's rows split over ``torch.distributed`` ranks
(:func:`sharded_qniht_run`, :func:`sharded_segment_run`; the ranks and their
mesh in :mod:`repro_torch.parallel.dist`).

Of the model-training half, :func:`fake_grad_compression` (the Q_b gradient
compression of one device's training step). Not yet ported: the training
half of sharding over several devices (the reference's
``parallel/sharding.py`` and the quantized all-reduce of
``parallel/collectives.py``).
"""
from repro_torch.parallel.batch import (
    BatchServer,
    gather_state,
    make_batch_mesh,
    owned_rows,
    pad_batch,
    pad_state,
    refill_rows,
    shard_state,
    sharded_qniht_run,
    sharded_segment_run,
    strip_state,
)
from repro_torch.parallel.collectives import fake_grad_compression
from repro_torch.parallel.dist import BatchMesh, all_gather_rows, spawn_ranks
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
    "BatchMesh",
    "BatchServer",
    "ChunkJournal",
    "ContinuousScheduler",
    "all_gather_rows",
    "fake_grad_compression",
    "gather_state",
    "Request",
    "RequestReport",
    "make_batch_mesh",
    "owned_rows",
    "pad_batch",
    "pad_state",
    "refill_rows",
    "segment_step",
    "shard_state",
    "sharded_qniht_run",
    "sharded_segment_run",
    "spawn_ranks",
    "strip_state",
]
