"""Device lists for ray/point data parallelism, and the workers that run
their blocks.

The JAX package's 1-D ``"rays"`` mesh becomes a list of ``torch.device``s
that one process drives. Each entry holds one shard; a list may name one
device several times (``[cpu] * 8`` stands in for the JAX tests' eight
virtual CPU devices, ``[cuda:0] * 4`` puts four shards on one card).

The shards of a run of consecutive entries on one device are one
contiguous block of the batch, and the data-parallel calls run each such
block as one call on its device: splitting a batch further on one device
buys no concurrency, and the eager march pays its launches per call
(eight 4,096-ray traces on one CPU took 3x one 32,768-ray trace).

``run_blocks`` runs the blocks of different devices at the same time, as
the JAX package's SPMD program works every chip of its mesh at once: one
worker thread per distinct device (``cuda:0`` and ``cuda`` are two, so
``[cuda:0, cuda] * 2`` runs two workers on one card), kept for the life
of the process. A worker makes its device current and the caller's
current stream on that device its current stream (both are thread-local
in torch), so a block's work queues behind the caller's copies to that
device and the caller's gather queues behind the block's work.

The workers take turns at issuing work: one holds the turn, and gives it
up while it waits on its card (``waiting``: the tracer's host syncs, the
tiles' ``nonzero``), so another card's launches go out meanwhile. Launches
queue asynchronously, so every card works at once all the same; the
devices' blocks overlap wherever a block waits. Issued from several
threads at once, each launch waited ~230 us for the interpreter lock on
four H100s, against ~6 us from one thread (``chip_smoke.launch_probe``).
"""
from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

from ..sdf.sdf_function import resolve_device

__all__ = [
    "default_mesh",
    "sharded_rays",
    "replicated",
    "initialize_distributed",
    "pad_to_shards",
    "Placement",
    "device_runs",
    "per_device",
    "run_blocks",
    "waiting",
    "RAY_AXIS",
]

RAY_AXIS = "rays"


def initialize_distributed(**kwargs) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group(**kwargs)``
    when the launcher's environment names a world (``WORLD_SIZE`` > 1) and
    no group exists yet; otherwise nothing. An error from an
    initialisation it attempts propagates. Nothing on a machine names a
    cluster by itself: pass ``init_method="tcp://host:port"``, ``rank``
    and ``world_size`` where the launcher does not set them."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(**kwargs)


def default_mesh(devices=None) -> list[torch.device]:
    """The device list: every visible card (``[cuda:0 .. cuda:n-1]``) by
    default, raising without one; else the given devices in order, each
    through ``resolve_device`` (a CUDA entry without a card raises)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device: pass a device list, e.g. [torch.device('cpu')] * 8"
            )
        return [torch.device("cuda", i) for i in range(n)]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("a device list needs at least one entry")
    return out


def per_device(mesh, make) -> dict:
    """``make(device)`` once for each distinct device of the list, keyed by
    device."""
    out: dict = {}
    for d in mesh:
        if d not in out:
            out[d] = make(d)
    return out


def device_runs(mesh) -> list[tuple[torch.device, int, int]]:
    """(device, first entry, entries) of each run of consecutive entries
    that name one device."""
    runs: list = []
    for i, d in enumerate(mesh):
        if runs and runs[-1][0] == d:
            runs[-1][2] += 1
        else:
            runs.append([d, i, 1])
    return [tuple(r) for r in runs]


class Placement(NamedTuple):
    """Where a batch lives over a device list: split in contiguous shards
    along the first axis (``split``), or one copy per entry."""

    devices: list
    split: bool

    def put(self, x: torch.Tensor) -> list:
        """Split: one ``(device, block)`` per run of ``device_runs``, the
        block the run's shards of ``x`` (the first axis a multiple of the
        list length), contiguous, on its device. Else one copy per entry,
        made once per distinct device."""
        if not self.split:
            copies = per_device(self.devices, x.to)
            return [copies[d] for d in self.devices]
        n = len(self.devices)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} entries")
        rows = x.shape[0] // n
        return [(d, x[a * rows : (a + m) * rows].to(d))
                for d, a, m in device_runs(self.devices)]


def sharded_rays(mesh) -> Placement:
    """Placement of a (N, ...) point/ray batch: the leading dim split over
    the entries, one block per run of one device."""
    return Placement(list(mesh), True)


def replicated(mesh) -> Placement:
    """Placement of structure arrays: one copy on every entry's device."""
    return Placement(list(mesh), False)


def pad_to_shards(n: int, mesh) -> int:
    """Smallest multiple of the list length >= n."""
    k = len(mesh)
    return -(-n // k) * k


# One single-thread executor per distinct device, made at first use.
# ``_ON.device``: the device whose blocks the current thread runs, and
# ``_ON.turn`` whether it holds ``_TURN``.
_WORKERS: dict = {}
_WORKERS_LOCK = threading.Lock()
_ON = threading.local()
_TURN = threading.Lock()


@contextlib.contextmanager
def waiting():
    """The calling worker gives up its turn while it waits on its device
    (a host sync inside the block), and takes a turn again after; outside
    the workers, nothing."""
    if not getattr(_ON, "turn", False):
        yield
        return
    _ON.turn = False
    _TURN.release()
    try:
        yield
    finally:
        _TURN.acquire()
        _ON.turn = True


def _worker(dev) -> ThreadPoolExecutor:
    with _WORKERS_LOCK:
        pool = _WORKERS.get(dev)
        if pool is None:
            pool = _WORKERS[dev] = ThreadPoolExecutor(1, thread_name_prefix=f"sdf-{dev}")
        return pool


def _run_on(dev, stream, items, fn) -> list:
    """``fn(dev, block)`` of each item in order, under ``dev`` and
    ``stream`` where ``dev`` is a card, holding a turn."""
    with contextlib.ExitStack() as ctx:
        if stream is not None:
            ctx.enter_context(torch.cuda.device(stream.device))
            ctx.enter_context(torch.cuda.stream(stream))
        _TURN.acquire()
        _ON.device, _ON.turn = dev, True
        try:
            return [fn(dev, block) for block in items]
        finally:
            _ON.device, _ON.turn = None, False
            _TURN.release()


def run_blocks(blocks, fn) -> list:
    """``fn(device, block)`` of each ``(device, block)`` pair (as
    ``sharded_rays(mesh).put`` gives them), in entry order. The blocks of
    one device run in entry order on its worker; the workers of distinct
    devices run at the same time. The caller waits for every worker, then
    raises the error of the first device (by entry order) whose block
    raised (its worker stops there); nothing is returned or run again. A
    block may not call ``run_blocks``: two workers would wait on each
    other's queues."""
    if getattr(_ON, "device", None) is not None:
        raise RuntimeError("run_blocks called from inside a block of run_blocks")
    groups: dict = {}
    for i, (dev, _) in enumerate(blocks):
        groups.setdefault(dev, []).append(i)
    jobs = []
    for dev, idx in groups.items():
        stream = None
        if dev.type == "cuda":
            # "cuda" means the caller's current card, which a worker thread
            # does not share
            card = dev.index if dev.index is not None else torch.cuda.current_device()
            stream = torch.cuda.current_stream(card)
        items = [blocks[i][1] for i in idx]
        jobs.append((idx, _worker(dev).submit(_run_on, dev, stream, items, fn)))
    out, errors = [None] * len(blocks), []
    for idx, fut in jobs:
        try:
            values = fut.result()
        except Exception as e:
            errors.append((idx[0], e))
            continue
        for i, v in zip(idx, values):
            out[i] = v
    if errors:
        raise min(errors, key=lambda e: e[0])[1]
    return out
