"""Device lists for ray/point data parallelism.

The JAX package's 1-D ``"rays"`` mesh becomes a list of ``torch.device``s
that one process drives. Each entry holds one shard; a list may name one
device several times (``[cpu] * 8`` stands in for the JAX tests' eight
virtual CPU devices, ``[cuda:0] * 4`` puts four shards on one card).

The shards of a run of consecutive entries on one device are one
contiguous block of the batch, and the data-parallel calls run each such
block as one call on its device: splitting a batch further on one device
buys no concurrency, and the eager march pays its launches per call
(eight 4,096-ray traces on one CPU took 3x one 32,768-ray trace).
Blocks on different devices run one after another from this process.
"""
from __future__ import annotations

import os
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
