"""Write-ahead journal for chunked serving: restartable result streams
(port of ``repro.parallel.journal``).

The serving loop (:class:`repro_torch.parallel.batch.BatchServer`,
``python -m repro_torch.launch.serve``) consumes a deterministic stream of
``(Y_chunk, key_chunk)`` pairs. To survive a kill mid-stream the server
journals each chunk *before* solving it and each result *after*:

Layout (one directory per serve run)::

    <dir>/chunk_000003.y.npy      # submitted observations (written pre-solve)
    <dir>/chunk_000003.key.npy    # the chunk's PRNG key (raw uint32 data)
    <dir>/chunk_000003.mask.npy   # row-validity mask (absent = all rows live)
    <dir>/chunk_000003.meta.json  # shape/dtype + status=submitted (fsync'd)
    <dir>/chunk_000003.x.npy      # solved iterate (atomic tmp -> rename)
    <dir>/chunk_000003.done.json  # completion marker (fsync'd, written last)

Chunk identity is **submission order**: the deterministic stream re-presents
the same chunks in the same order on restart, and the journal's job is to
classify each index as

* **completed** — ``done.json`` present: the result is *drained* from disk
  (the solve is skipped entirely; bit-identical by construction, the bytes
  are literally the same).
* **in-flight** — submitted but no ``done.json`` (the kill landed mid-solve):
  the chunk is *replayed* — solved again from the journaled inputs, which the
  deterministic solver maps to the identical result.
* **unseen** — solved and journaled as normal.

The submit record is verified against the re-presented chunk (bitwise Y and
key equality) before draining or replaying: a stream that diverged from the
journaled one is a configuration error, not a resume, and raises.

Durability mirrors :mod:`repro_torch.train.checkpoint`: metadata and markers
are fsync'd and results are published by atomic rename, so a torn write can
only lose the *marker* — which safely demotes a completed chunk to in-flight
(it gets re-solved, to the same bytes) — never publish a torn result.

On a mesh of ranks (:mod:`repro_torch.parallel.dist`) only rank 0 writes
(``writer=True``); every rank reads, so every rank drains the same chunks on
a resume.

The files are the reference's, byte for byte in layout and dtype, so either
package drains the other's journal: arrays (numpy or torch, on any device)
are stored as numpy, and a key as its two raw uint32 words (the port holds
a key as a (2,) int64 tensor; :func:`key_words` converts).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

__all__ = ["ChunkJournal", "key_words", "write_json_durable"]


def _host(a) -> np.ndarray:
    """``a`` as a numpy array (a torch tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def key_words(key) -> np.ndarray:
    """A PRNG key as the reference journals it: its two raw uint32 words."""
    k = _host(key)
    if k.shape != (2,):
        raise ValueError(f"a PRNG key is two uint32 words, got shape {k.shape}")
    if k.dtype != np.uint32:
        if not np.issubdtype(k.dtype, np.integer) or (k < 0).any() or (k > 0xFFFFFFFF).any():
            raise ValueError(f"key words must be uint32 values, got {k}")
        k = k.astype(np.uint32)
    return k


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json_durable(path: str, obj) -> None:
    """Atomically publish ``obj`` as JSON at ``path``: tmp write, fsync,
    ``os.rename``, directory fsync. The one sanctioned way to drop a JSON
    artifact on a durability-critical path."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))


class ChunkJournal:
    """Per-chunk write-ahead log under one directory (see module docstring).
    ``writer=False`` (a rank other than a mesh's rank 0) reads it and never
    writes: its ``record_*`` calls do nothing."""

    def __init__(self, directory: str, writer: bool = True):
        self.directory = directory
        self.writer = bool(writer)
        if self.writer:
            os.makedirs(directory, exist_ok=True)

    # -- paths ------------------------------------------------------------
    def _p(self, index: int, suffix: str) -> str:
        return os.path.join(self.directory, f"chunk_{index:06d}.{suffix}")

    @staticmethod
    def _norm_mask(row_mask, b: int):
        """Canonical row-validity mask: None ⇔ every row valid (the
        historical all-rows-live contract), else a (B,) bool array with at
        least one False. Journals written before masks existed load as
        all-valid, and an explicitly all-true mask journals identically to
        ``None`` — one on-disk spelling per meaning."""
        if row_mask is None:
            return None
        m = _host(row_mask).astype(bool)
        if m.shape != (b,):
            raise ValueError(
                f"row_mask shape {m.shape} != ({b},): one flag per chunk row")
        return None if bool(m.all()) else m

    # -- write side -------------------------------------------------------
    def record_submit(self, index: int, Y, key, row_mask=None,
                      extra: Optional[dict] = None) -> None:
        """WAL entry: journal a chunk's inputs before its solve starts.

        ``row_mask`` marks which rows are live user requests (None = all —
        the historical contract); padded/harvested rows are journaled as
        *invalid* so they are never replayed as user results. ``extra`` is an
        optional dict of identity metadata (request id, priority, deadline —
        the continuous scheduler journals these) merged into ``meta.json``.

        Idempotent on replay: an existing record for ``index`` is verified
        against the new inputs (bitwise, mask included) instead of rewritten —
        a mismatch means the re-presented stream is not the journaled one,
        and raises.
        """
        if not self.writer:
            return
        Y = _host(Y)
        if os.path.exists(self._p(index, "meta.json")):
            self.verify_submit(index, Y, key, row_mask)
            return
        k = key_words(key)
        mask = self._norm_mask(row_mask, Y.shape[0])
        # jaxlint: allow=JL007 -- write-ahead inputs, not a commit point:
        np.save(self._p(index, "y.npy"), Y)
        # the fsynced meta.json below is the commit; a torn y/key/mask file
        # with no meta just demotes this chunk back to never-submitted
        # jaxlint: allow=JL007 -- see above, meta.json is the commit point
        np.save(self._p(index, "key.npy"), k)
        if mask is not None:
            # jaxlint: allow=JL007 -- see above, meta.json is the commit point
            np.save(self._p(index, "mask.npy"), mask)
        write_json_durable(self._p(index, "meta.json"), {
            "index": index, "status": "submitted",
            "y_shape": list(Y.shape), "y_dtype": str(Y.dtype),
            "key_dtype": str(k.dtype),
            "rows_valid": int(mask.sum()) if mask is not None else Y.shape[0],
            **(extra or {}),
        })

    def record_result(self, index: int, x, row_mask=None) -> None:
        """Publish a chunk's result: atomic x write, then the done marker.

        With a ``row_mask``, ONLY the valid rows are journaled (``x.npy``
        holds the compacted ``x[mask]`` block): a padded or harvested row is
        scratch space, not a user result, and must never be replayable as
        one. ``load_result_full`` reconstructs the full chunk shape with
        zeros at invalid rows — bit-identical to the live solve, whose
        masked rows are zeroed before the solve (``y = 0`` rows fix at
        ``x = 0``).
        """
        if not self.writer:
            return
        x = _host(x)
        mask = self._norm_mask(row_mask, x.shape[0])
        b_total = x.shape[0]
        if mask is not None:
            x = x[mask]
        tmp = self._p(index, "x.npy.tmp")
        with open(tmp, "wb") as f:  # np.save(path) would append another .npy
            np.save(f, x)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, self._p(index, "x.npy"))
        write_json_durable(self._p(index, "done.json"), {
            "index": index, "status": "complete",
            "x_shape": list(x.shape), "x_dtype": str(x.dtype),
            "b_total": b_total, "rows_valid": int(x.shape[0]),
        })

    # -- read side --------------------------------------------------------
    def is_complete(self, index: int) -> bool:
        done = self._p(index, "done.json")
        if not os.path.exists(done):
            return False
        try:
            with open(done) as f:
                return json.load(f).get("status") == "complete"
        except (json.JSONDecodeError, OSError):
            return False

    def completed(self) -> list:
        """Indices with a published result, ascending."""
        return [i for i in self._indices() if self.is_complete(i)]

    def pending(self) -> list:
        """Indices journaled as submitted but not completed (in-flight at the
        kill) — these get replayed, ascending."""
        return [i for i in self._indices() if not self.is_complete(i)]

    def _indices(self) -> list:
        out = []
        if not os.path.isdir(self.directory):
            return out
        for name in os.listdir(self.directory):
            if name.startswith("chunk_") and name.endswith(".meta.json"):
                out.append(int(name[len("chunk_"):len("chunk_") + 6]))
        return sorted(out)

    def load_submit(self, index: int):
        """(Y, key) as journaled for ``index`` (numpy; the key as uint32 words)."""
        return (np.load(self._p(index, "y.npy")),
                np.load(self._p(index, "key.npy")))

    def load_mask(self, index: int):
        """The journaled row-validity mask, or None (= every row valid —
        including journals written before masks existed)."""
        p = self._p(index, "mask.npy")
        return np.load(p) if os.path.exists(p) else None

    def load_result(self, index: int):
        """The journaled result bytes as stored: the full chunk when no mask
        was recorded, else only the valid rows (compacted)."""
        return np.load(self._p(index, "x.npy"))

    def load_result_full(self, index: int):
        """The result at full chunk shape: invalid rows are zeros, exactly as
        the live solve leaves them (masked ``y`` rows are zeroed pre-solve
        and ``x = 0`` is their fixed point)."""
        x = np.load(self._p(index, "x.npy"))
        mask = self.load_mask(index)
        if mask is None:
            return x
        with open(self._p(index, "done.json")) as f:
            b_total = json.load(f)["b_total"]
        full = np.zeros((b_total,) + x.shape[1:], x.dtype)
        full[mask] = x
        return full

    def verify_submit(self, index: int, Y, key, row_mask=None) -> None:
        """Raise unless the journaled inputs for ``index`` equal (Y, key,
        row_mask) bitwise — draining a result for DIFFERENT inputs would
        silently serve the wrong answer."""
        Yj, kj = self.load_submit(index)
        Y = _host(Y)
        if Yj.shape != Y.shape or not np.array_equal(Yj, Y):
            raise ValueError(
                f"journal mismatch at chunk {index}: the re-presented Y differs "
                "from the journaled one — this stream is not the journaled run")
        if not np.array_equal(key_words(kj), key_words(key)):
            raise ValueError(
                f"journal mismatch at chunk {index}: the re-presented key "
                "differs from the journaled one")
        mj = self.load_mask(index)
        mask = self._norm_mask(row_mask, Yj.shape[0])
        same = (mj is None and mask is None) or (
            mj is not None and mask is not None and np.array_equal(mj, mask))
        if not same:
            raise ValueError(
                f"journal mismatch at chunk {index}: the re-presented row "
                "validity mask differs from the journaled one")
