"""Process groups for the sharded solver: one ``torch.distributed`` rank per
shard (no counterpart in the reference, whose single controller maps a
``("batch",)`` device mesh with ``shard_map``).

In PyTorch the idiom is multi-controller: every rank runs the same program
on the same global inputs, solves its own block of rows on its own device,
and the ranks exchange the blocks with one ``all_gather``. This module holds
the plumbing that needs:

* :class:`BatchMesh` — the serving mesh: its width, this process's rank in
  it, its device, its process group and backend. A mesh of one device has no
  group and no backend.
* :func:`spawn_ranks` — start ``n`` rank processes (``spawn``: a fork after
  CUDA is initialised is fatal), each in a process group that meets in a
  ``FileStore`` of a fresh temporary directory (never a fixed port: test
  processes run side by side), and return what each rank returned. A rank
  that raises fails the launch: the others are ended and the error is
  raised here. SIGTERM and SIGINT sent to the caller are passed on to the
  ranks, whose preemption guards agree on a stop (:func:`any_rank`).
* :func:`all_gather_rows` — every rank's equally shaped blocks of a list of
  tensors, joined in rank order, in one collective.

The backend is explicit and nothing switches from one to the other: ``nccl``
gives CUDA one rank per card and refuses more ranks than cards; ``gloo``
serves the CPU, and on CUDA only when the caller asks for it by name, with
the ranks sharing the cards as ``cuda:(rank % count)`` (NCCL refuses two
ranks on one GPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import shutil
import signal
import tempfile
import threading
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "BatchMesh", "all_gather_rows", "any_rank", "barrier", "rank_device",
           "spawn_ranks"]

BACKENDS = ("nccl", "gloo")
# a rank waits in a collective for the slowest shard's solve, so the limit is
# a backstop for a lost peer, not a bound on a solve
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
SPAWN_HINT = ("start the ranks with repro_torch.parallel.dist.spawn_ranks, or pass --devices N "
              "to python -m repro_torch.launch.recover (with --batch) or "
              "repro_torch.launch.serve")


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """A 1-D serving mesh of ``size`` ranks (the reference's ``("batch",)``
    axis). ``rank`` is this process's place in it, None for a rank of the
    process group left outside a narrower mesh; ``group`` is None for the
    whole default group (and for a one-device mesh, which has no backend)."""

    size: int
    rank: Optional[int]
    device: torch.device
    group: Any = None
    backend: Optional[str] = None

    @property
    def member(self) -> bool:
        return self.rank is not None

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes what the mesh shares on disk (rank 0)."""
        return self.rank == 0


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: the CPU, or ``cuda:rank`` under NCCL, or
    ``cuda:(rank % count)`` under gloo (the ranks share the cards)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("the ranks were asked to run on CUDA, but "
                           "torch.cuda.is_available() is False")
    count = torch.cuda.device_count()
    if backend == "nccl":
        if rank >= count:
            raise ValueError(f"nccl gives each rank a card of its own: rank {rank} of a machine "
                             f"with {count} card(s); ask for backend='gloo' to share them")
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % count)


def check_backend(backend: Optional[str], device, n: int) -> str:
    """The backend for ``n`` ranks on ``device``: ``backend`` if given (it
    must suit the device), else ``nccl`` on CUDA and ``gloo`` on the CPU."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (use one of {BACKENDS})")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA; use 'gloo' for CPU ranks")
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > count:
            raise ValueError(f"backend 'nccl' needs one card per rank: {n} ranks, {count} "
                             "card(s); ask for backend='gloo' to share the cards")
    return backend


def world_mesh(device) -> BatchMesh:
    """The mesh of the whole default process group, from inside a rank."""
    backend = dist.get_backend()
    rank = dist.get_rank()
    return BatchMesh(size=dist.get_world_size(), rank=rank,
                     device=rank_device(device, rank, backend), group=None, backend=backend)


def narrow(mesh: BatchMesh, n: int) -> BatchMesh:
    """The mesh of the first ``n`` ranks of ``mesh`` (the reference's first N
    devices). Every rank of ``mesh`` must call it: a narrower group is made
    collectively. Ranks past ``n`` get a mesh with ``rank`` None."""
    if not 1 <= n <= mesh.size:
        raise ValueError(f"a mesh of {n} ranks inside one of {mesh.size}")
    if n == mesh.size:
        return mesh
    if mesh.group is not None:
        raise ValueError("narrow a mesh of the whole process group")
    group = dist.new_group(ranks=list(range(n)), backend=mesh.backend)
    rank = mesh.rank if mesh.rank is not None and mesh.rank < n else None
    return dataclasses.replace(mesh, size=n, rank=rank, group=group)


def _wire(t: torch.Tensor, mesh: BatchMesh) -> torch.Tensor:
    """Where a collective's tensor must lie: on the rank's card under NCCL,
    on the host under gloo (whose all_gather takes CPU tensors)."""
    return t.cpu() if mesh.backend == "gloo" else t.to(mesh.device)


def all_gather_rows(mesh: BatchMesh, tensors: Sequence[torch.Tensor],
                    dims: Optional[Sequence[int]] = None) -> list:
    """Every rank's ``tensors`` joined in rank order along ``dims`` (default
    0 for each), in one ``all_gather`` of their bytes. Each rank passes
    tensors of the same shapes and dtypes; the results lie where the inputs
    did. A one-rank mesh returns the tensors as they are."""
    tensors = list(tensors)
    dims = [0] * len(tensors) if dims is None else list(dims)
    if mesh.size == 1:
        return tensors
    if not mesh.member:
        raise ValueError(f"rank {dist.get_rank()} is outside this mesh of {mesh.size} ranks")
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    sizes = [f.numel() for f in flat]
    mine = _wire(torch.cat(flat), mesh)
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    out = []
    offset = 0
    for t, d, n in zip(tensors, dims, sizes):
        blocks = [p[offset:offset + n].clone().view(t.dtype).reshape(t.shape) for p in parts]
        out.append(torch.cat(blocks, dim=d).to(t.device))
        offset += n
    return out


def any_rank(mesh: BatchMesh, flag: bool) -> bool:
    """Whether ``flag`` is set on any rank of the mesh (an all_reduce of the
    flags' max); every rank must call it at the same point."""
    if mesh.size == 1:
        return bool(flag)
    t = _wire(torch.tensor([int(bool(flag))], dtype=torch.int32), mesh)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def barrier(mesh: BatchMesh) -> None:
    """Wait for every rank of the mesh (nothing for one device)."""
    if mesh.size > 1:
        any_rank(mesh, False)


# -- the rank processes -------------------------------------------------------------------

def _solver_libraries():
    """The kernel libraries the solver's paths launch (built before a spawn
    so that N ranks do not each run nvcc)."""
    from repro_torch.kernels.hsthresh.kernel import FUSED_LIBRARY
    from repro_torch.kernels.qmm.kernel import CORE_LIBRARY, LIBRARY

    return (LIBRARY, CORE_LIBRARY, FUSED_LIBRARY)


def _build_all(libraries) -> None:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.build) for lib in libraries]:
            fut.result()


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _rank_entry(rank, fn, n, backend, device, store_path, result_dir, args):
    """A rank: one intra-op thread (the ranks share the host's cores), its
    device, the process group, ``fn(mesh, *args)`` and its result saved for
    the caller."""
    torch.set_num_threads(1)
    dev = rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=DEFAULT_TIMEOUT)
    try:
        out = fn(world_mesh(device), *args)
        _atomic_save(out, os.path.join(result_dir, f"rank_{rank}.pt"))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _forward_signals(ctx):
    """Pass SIGTERM and SIGINT on to the rank processes while they run (the
    caller's process keeps running and reports)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    prev = {sig: signal.signal(sig, forward) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def _rank_errors(ctx, n: int) -> str:
    """The tracebacks of every rank that raised (a rank waiting on a failed
    peer raises too, so the first to end is not always the cause)."""
    parts = []
    for rank, path in enumerate(ctx.error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                parts.append(f"rank {rank}:\n{pickle.load(f)}")
    exits = {rank: p.exitcode for rank, p in enumerate(ctx.processes)}
    return (f"the launch of {n} ranks failed (exit codes {exits})\n" + "\n".join(parts))


def spawn_ranks(fn: Callable, n: int, *, device="cuda", backend: Optional[str] = None,
                args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` in ``n`` rank processes and return their
    results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable. Each rank runs on
    :func:`rank_device` of ``device`` with one intra-op thread, in a process
    group of ``backend`` (default: ``nccl`` on CUDA, ``gloo`` on the CPU;
    ``gloo`` on CUDA only when asked for). On CUDA the solver's kernel
    libraries are built here first. A rank that raises fails the launch;
    ``DEFAULT_TIMEOUT`` bounds each collective."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    backend = check_backend(backend, device, n)
    dev = torch.device(device)
    if dev.type == "cuda":
        rank_device(dev, n - 1, backend)    # raises without CUDA, or for too few cards
        _build_all(_solver_libraries())
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, n, backend, str(dev), os.path.join(tmp, "store"), tmp,
                               tuple(args)),
            nprocs=n, join=False, start_method="spawn")
        with _forward_signals(ctx):
            try:
                while not ctx.join():
                    pass
            except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
                raise RuntimeError(_rank_errors(ctx, n)) from e
        return [torch.load(os.path.join(tmp, f"rank_{r}.pt"), weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
