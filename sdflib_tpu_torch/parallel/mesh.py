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
up while it waits on its card (``waiting``: the torch trips' checks, the
tiles' ``nonzero``), so another card's launches go out meanwhile. Launches
queue asynchronously, so every card works at once all the same; the
devices' blocks overlap wherever a block waits. Issued from several
threads at once, each launch waited ~230 us for the interpreter lock on
four H100s, against ~6 us from one thread (``chip_smoke.launch_probe``).

Across processes (``initialize_distributed``, or any process group of
more than one rank), ``default_mesh()`` is a ``ProcessMesh``: every
rank's local cards in rank order, one list that every rank holds. Each
rank runs the blocks of its own entries on its workers as above, and the
blocks come back through collectives issued on the caller's thread
(``gather_blocks``), never from a worker. Every rank calls every sharded call with the same arguments, as
the JAX package's processes run one SPMD program; a list that names the
entries of only some ranks runs on a subgroup of them, and the call
returns None on the other ranks.
"""
from __future__ import annotations

import contextlib
import os
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

from ..sdf.sdf_function import resolve_device

__all__ = [
    "default_mesh",
    "process_mesh",
    "Entry",
    "ProcessMesh",
    "local_entries",
    "local_devices",
    "takes_part",
    "gather_blocks",
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


class Entry(NamedTuple):
    """One entry of a ``ProcessMesh``: the rank that drives it and its
    device in that rank's process."""

    rank: int
    device: torch.device


class ProcessMesh(tuple):
    """A device list over the ranks of a process group: its ``Entry``s in
    order, the same on every rank; ``rank`` is this process's. A slice is
    a ProcessMesh. Its runs (``device_runs``) are runs of one rank's
    device, so two ranks on one card never share a block."""

    def __new__(cls, entries, rank: int):
        self = super().__new__(cls, (Entry(int(r), torch.device(d)) for r, d in entries))
        self.rank = int(rank)
        return self

    def __getitem__(self, i):
        out = super().__getitem__(i)
        return ProcessMesh(out, self.rank) if isinstance(i, slice) else out

    @property
    def local(self) -> list[tuple[int, torch.device]]:
        """(entry index, device) of this rank's entries, in order."""
        return [(i, e.device) for i, e in enumerate(self) if e.rank == self.rank]

    @property
    def ranks(self) -> list[int]:
        """The ranks that hold an entry, ascending."""
        return sorted({e.rank for e in self})


def _world() -> int:
    """The process group's size; 1 without a group."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _local_cards() -> list[torch.device]:
    """This rank's cards: of the host's visible cards, the
    ``LOCAL_RANK``-th of ``LOCAL_WORLD_SIZE`` equal contiguous parts (the
    launcher's environment; by default the rank and the world's size, one
    host). A host with fewer cards than ranks gives rank l the card l mod
    the count (ranks then share a card, which needs gloo: NCCL refuses two
    ranks on one card)."""
    import torch.distributed as dist

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: pass a device list, e.g. [torch.device('cpu')] * 8")
    size = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if n < size:
        return [torch.device("cuda", local % n)]
    k = n // size
    return [torch.device("cuda", i) for i in range(local * k, (local + 1) * k)]


# default_mesh()'s list under a group: (the world group it was made in, the list)
_DEFAULT: list = [None, None]


def process_mesh(local=None) -> ProcessMesh:
    """The device list over every rank of the process group: each rank's
    local entries (``local``, resolved by ``resolve_device``; by default
    its cards, ``_local_cards``) in rank order, gathered with one
    ``all_gather_object``, which every rank calls. The default list is
    gathered once a group."""
    import torch.distributed as dist

    if local is None and _DEFAULT[0] is dist.group.WORLD:
        return _DEFAULT[1]
    mine = [resolve_device(d) for d in (_local_cards() if local is None else local)]
    if not mine:
        raise ValueError("a rank's device list needs at least one entry")
    every: list = [None] * dist.get_world_size()
    with contextlib.ExitStack() as ctx:
        if mine[0].type == "cuda":
            # NCCL gathers objects on the current card: this rank's own
            ctx.enter_context(torch.cuda.device(mine[0]))
        dist.all_gather_object(every, [str(d) for d in mine])
    out = ProcessMesh([(r, d) for r, devs in enumerate(every) for d in devs], dist.get_rank())
    if local is None:
        _DEFAULT[:] = [dist.group.WORLD, out]
    return out


def default_mesh(devices=None):
    """The device list: every visible card (``[cuda:0 .. cuda:n-1]``) by
    default, raising without one, and under a process group of more than
    one rank every rank's cards (``process_mesh()``); else the given
    devices in order, each through ``resolve_device`` (a CUDA entry
    without a card raises), or the given ``ProcessMesh``."""
    if isinstance(devices, ProcessMesh):
        return devices
    if devices is None:
        if _world() > 1:
            return process_mesh()
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


def local_entries(mesh) -> list[tuple[int, torch.device]]:
    """(entry index, device) of the entries this process drives: every
    entry of a plain list, this rank's of a ``ProcessMesh``."""
    return mesh.local if isinstance(mesh, ProcessMesh) else list(enumerate(mesh))


def local_devices(mesh) -> list[torch.device]:
    """The devices of ``local_entries``, in order."""
    return [d for _, d in local_entries(mesh)]


# subgroups by (world group, ranks), made at first use
_GROUPS: dict = {}


def _group(mesh):
    """The process group of a ``ProcessMesh``'s ranks: the world's
    (``None``) where it names every rank, else a subgroup made at its
    first use by ``dist.new_group``, which every rank of the world calls
    in the same order (every rank makes every sharded call), and kept."""
    import torch.distributed as dist

    ranks = tuple(mesh.ranks)
    if len(ranks) == dist.get_world_size():
        return None
    key = (id(dist.group.WORLD), ranks)
    if key not in _GROUPS:
        _GROUPS[key] = (dist.group.WORLD, dist.new_group(list(ranks)))
    return _GROUPS[key][1]


def takes_part(mesh) -> bool:
    """Whether this process has entries in the list (always, for a plain
    list). Of a ``ProcessMesh`` it makes the list's subgroup first, so
    every rank of the world calls it, a rank without entries too."""
    if not isinstance(mesh, ProcessMesh):
        return True
    _group(mesh)
    return mesh.rank in mesh.ranks


def per_device(mesh, make) -> dict:
    """``make(device)`` once for each distinct device of the list, keyed by
    device."""
    out: dict = {}
    for d in mesh:
        if d not in out:
            out[d] = make(d)
    return out


def _runs(mesh) -> list[tuple]:
    """[entry, first entry, entries] of each run of consecutive equal
    entries (a ``ProcessMesh``'s entries are (rank, device))."""
    runs: list = []
    for i, d in enumerate(mesh):
        if runs and runs[-1][0] == d:
            runs[-1][2] += 1
        else:
            runs.append([d, i, 1])
    return runs


def device_runs(mesh) -> list[tuple[torch.device, int, int]]:
    """(device, first entry, entries) of each run of consecutive entries
    that name one device; of a ``ProcessMesh``, the runs of this rank's
    entries."""
    if isinstance(mesh, ProcessMesh):
        return [(e.device, a, m) for e, a, m in _runs(mesh) if e.rank == mesh.rank]
    return [tuple(r) for r in _runs(mesh)]


class Placement(NamedTuple):
    """Where a batch lives over a device list: split in contiguous shards
    along the first axis (``split``), or one copy per entry."""

    devices: list
    split: bool

    def put(self, x: torch.Tensor) -> list:
        """Split: one ``(device, block)`` per run of ``device_runs``, the
        block the run's shards of ``x`` (the first axis a multiple of the
        list length), contiguous, on its device. Else one copy per entry,
        made once per distinct device. Of a ``ProcessMesh``, only this
        rank's runs and entries."""
        if not self.split:
            devs = local_devices(self.devices)
            copies = per_device(devs, x.to)
            return [copies[d] for d in devs]
        n = len(self.devices)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} entries")
        rows = x.shape[0] // n
        return [(d, x[a * rows : (a + m) * rows].to(d))
                for d, a, m in device_runs(self.devices)]


def _as_list(mesh):
    return mesh if isinstance(mesh, ProcessMesh) else list(mesh)


def sharded_rays(mesh) -> Placement:
    """Placement of a (N, ...) point/ray batch: the leading dim split over
    the entries, one block per run of one device."""
    return Placement(_as_list(mesh), True)


def replicated(mesh) -> Placement:
    """Placement of structure arrays: one copy on every entry's device."""
    return Placement(_as_list(mesh), False)


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


# -- the blocks' way back across processes ------------------------------------


def _gather_ranks(mesh, x: torch.Tensor, rows=None) -> dict:
    """Every rank's ``x`` (this rank's rows, the trailing shape and dtype
    alike on every rank) by rank, on this rank's first local device: one
    ``all_gather`` over the list's group of each rank's rows padded to the
    most rows (``rows``: rank -> rows; else the counts are gathered
    first). Under NCCL on the card; under gloo staged through the host.
    Bool rows travel as uint8."""
    import torch.distributed as dist

    home = local_devices(mesh)[0]
    ranks = mesh.ranks
    if len(ranks) == 1:
        return {mesh.rank: x.to(home)}
    group = _group(mesh)
    wire = home if dist.get_backend(group) == "nccl" else torch.device("cpu")
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).to(wire)
    if rows is None:
        n = torch.tensor([y.shape[0]], dtype=torch.int64, device=wire)
        ns = [torch.empty_like(n) for _ in ranks]
        dist.all_gather(ns, n, group=group)
        rows = {r: int(v) for r, v in zip(ranks, ns)}
    most = max(rows.values())
    if y.shape[0] < most:
        y = torch.cat([y, y.new_zeros((most - y.shape[0],) + y.shape[1:])])
    out = [torch.empty_like(y) for _ in ranks]
    dist.all_gather(out, y.contiguous(), group=group)
    return {r: o[: rows[r]].to(home).to(x.dtype) for r, o in zip(ranks, out)}


def gather_blocks(mesh, parts) -> torch.Tensor:
    """The blocks ``run_blocks`` returned for ``device_runs(mesh)``, each
    (entries x rows, ...), concatenated in entry order over the whole list
    on the first local entry's device (a plain list's first entry). Of a
    ``ProcessMesh`` each rank's blocks go out in one ``all_gather``,
    padded to the block of the rank with the most entries, and come back
    in entry order on every rank of the list. Called on the caller's
    thread after ``run_blocks``, never from a block."""
    if not isinstance(mesh, ProcessMesh):
        return torch.cat([p.to(mesh[0]) for p in parts])
    home = local_devices(mesh)[0]
    mine = torch.cat([p.to(home) for p in parts])
    unit = mine.shape[0] // len(mesh.local)
    rows = {r: c * unit for r, c in Counter(e.rank for e in mesh).items()}
    got = _gather_ranks(mesh, mine, rows)
    pieces, taken = [], Counter()
    for e, _, m in _runs(mesh):
        k = taken[e.rank]
        pieces.append(got[e.rank][k * unit : (k + m) * unit])
        taken[e.rank] += m
    return torch.cat(pieces)
