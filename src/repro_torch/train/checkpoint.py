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
same path, with its dtype checked. The reference's ``shardings`` argument (a
mesh placement) has no counterpart until the port has a mesh.
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


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=""):
    """[(path, leaf)] in a fixed order; leaves are tensors or numpy arrays."""
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree) for item in _flatten(v, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save(directory: str, step: int, state, *, keep: int = 3,
         async_: bool = False) -> Optional[threading.Thread]:
    """Write a checkpoint of ``state`` as step ``step``. The device→host
    copies happen here; with ``async_=True`` the disk writes run on a
    background thread (returned).

    Durability: the manifest is fsync'd and the directory entry fsync'd
    after the tmp→rename, so a crash at any point leaves either the complete
    new checkpoint or the previous one, never a half-written directory that
    reads as complete. Saves to one directory are serialized by a lock."""
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
    return _unflatten(target, iter(leaves))


def restore_latest(directory: str, target):
    """(state, step) from the newest complete checkpoint, past torn ones;
    (None, None) when nothing can be restored."""
    for step in reversed(available_steps(directory)):
        try:
            return restore(directory, step, target), step
        except (OSError, KeyError, ValueError, json.JSONDecodeError):
            continue
    return None, None
