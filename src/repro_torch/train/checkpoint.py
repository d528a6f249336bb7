"""Atomic, optionally asynchronous, retention-pruned checkpoints (port of
``repro.train.checkpoint``).

Layout (one directory per step)::

    <dir>/step_00000100/
        manifest.json        # step, leaf paths, shapes, dtypes, status=complete
        leaf_00000.npy ...   # one file per leaf, a host numpy copy
    <dir>/step_00000100.tmp/ # in-flight writes, renamed atomically on success

A torn checkpoint (no manifest, or a status other than complete) is skipped
and the one before it restored. The state is a tree of NamedTuples, tuples,
lists and dicts with tensors (or numpy arrays) at the leaves; leaf paths are
spelled as JAX spells them (``.X``, ``.last.mu``, ``[0]``, ``['k']``), so the
two packages' manifests read alike.

:func:`restore` puts every leaf on the device of the target's leaf at the
same path, with its dtype checked. On a mesh of ranks every rank holds the
same solver state: :func:`save` meets the other ranks at a barrier and rank
0 alone writes, and every rank restores. The solver state is saved stripped
of the mesh's padding, so it resumes on a mesh of any width
(:func:`repro_torch.parallel.batch.shard_state` places it); the reference's
``shardings`` argument has no counterpart, and the parameter shardings of
training come with the training half of sharding.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import keystr, tree_flatten_with_path, tree_unflatten

_MANIFEST = "manifest.json"

# One lock per checkpoint directory: concurrent saves (two async writers, or an
# async writer racing the final synchronous preemption save) must not
# interleave their rmtree/rename/prune sequences.
_dir_locks: dict = defaultdict(threading.Lock)
_dir_locks_guard = threading.Lock()


def _dir_lock(directory: str) -> threading.Lock:
    with _dir_locks_guard:
        return _dir_locks[os.path.abspath(directory)]


def _fsync_dir(path: str) -> None:
    """Flush a directory entry itself (the rename's durability)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree):
    """[(path, leaf)] in a fixed order (JAX's); leaves are tensors or numpy arrays."""
    return [(keystr(path), leaf) for path, leaf in tree_flatten_with_path(tree)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save(directory: str, step: int, state, *, keep: int = 3,
         async_: bool = False, mesh=None) -> Optional[threading.Thread]:
    """Write a checkpoint of ``state`` as step ``step``. The device→host
    copies happen here; with ``async_=True`` the disk writes run on a
    background thread (returned). With a ``mesh`` of several ranks (a
    :class:`~repro_torch.parallel.dist.BatchMesh`), every rank calls it with
    the same state: the ranks meet at a barrier and only rank 0 writes.

    Durability: the manifest is fsync'd and the directory entry fsync'd
    after the tmp→rename, so a crash at any point leaves either the complete
    new checkpoint or the previous one, never a half-written directory that
    reads as complete. Saves to one directory are serialized by a lock."""
    if mesh is not None and mesh.size > 1:
        from repro_torch.parallel.dist import barrier

        barrier(mesh)
        if not mesh.is_writer:
            return None
    host_leaves = [(name, _host(leaf)) for name, leaf in _flatten(state)]

    def write():
        with _dir_lock(directory):
            final = os.path.join(directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            names = []
            for i, (name, arr) in enumerate(host_leaves):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
                names.append({"path": name, "file": f"leaf_{i:05d}.npy",
                              "shape": list(arr.shape), "dtype": str(arr.dtype)})
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump({"step": step, "leaves": names, "status": "complete"}, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_dir(directory)
            _prune(directory, keep)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _prune(directory: str, keep: int):
    steps = sorted(available_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def available_steps(directory: str):
    """Steps with a complete manifest, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            man = os.path.join(directory, d, _MANIFEST)
            if os.path.exists(man):
                try:
                    with open(man) as f:
                        m = json.load(f)
                    if m.get("status") == "complete":
                        out.append(int(m["step"]))
                except (json.JSONDecodeError, KeyError, ValueError):
                    continue
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, target):
    """Load step ``step`` into the structure of ``target`` (a tree of tensors
    or numpy arrays, whose values are not read): shapes and dtypes must
    match, and each leaf goes to the device of the target's leaf (numpy
    leaves stay numpy)."""
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves = []
    for name, tgt in _flatten(target):
        entry = by_path.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(os.path.join(final, entry["file"]))
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {name}: ckpt {arr.shape} vs {tuple(tgt.shape)}")
        # the dtype is part of the bit-identity contract: a silent cast would
        # restore another computation, not resume this one
        if str(arr.dtype) != entry["dtype"]:
            raise ValueError(
                f"manifest/file dtype mismatch for {name}: manifest says "
                f"{entry['dtype']}, file holds {arr.dtype} (corrupt checkpoint)")
        if arr.dtype != _np_dtype(tgt):
            raise ValueError(
                f"dtype mismatch for {name}: ckpt {arr.dtype} vs target {_np_dtype(tgt)} "
                "— refusing a silent cast that would break bit-identical resume")
        if isinstance(tgt, torch.Tensor):
            leaves.append(torch.from_numpy(arr).to(tgt.device))
        else:
            leaves.append(arr)
    return tree_unflatten(target, iter(leaves))


def restore_latest(directory: str, target):
    """(state, step) from the newest complete checkpoint, past torn ones;
    (None, None) when nothing can be restored."""
    for step in reversed(available_steps(directory)):
        try:
            return restore(directory, step, target), step
        except (OSError, KeyError, ValueError, json.JSONDecodeError):
            continue
    return None, None
