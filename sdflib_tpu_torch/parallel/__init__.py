"""Multi-device execution: shard query points / rays over a device list.

Port of the JAX package's ``parallel/``. The reference parallelizes with
OpenMP threads inside one host (reference: src/sdf/
OctreeSdfDepthFirst.h:417-527) and has no distributed backend (SURVEY.md
S2.4). The scaling model (SURVEY.md S5.7-5.8): query points / rays are
pure data parallel over devices, SDF structures are replicated when they
fit (or tiled, ``tiles.py``), and coefficient gradients are summed over
the devices. The JAX package's 1-D ``"rays"`` mesh is a list of
``torch.device``s driven by one process, or under a process group a
``ProcessMesh`` of every rank's devices, each rank driving its own
(``mesh.py``).
"""
from .mesh import (
    Entry,
    ProcessMesh,
    default_mesh,
    gather_blocks,
    initialize_distributed,
    local_devices,
    pad_to_shards,
    process_mesh,
    replicated,
    sharded_rays,
)
from .query import sharded_distance, sharded_distance_and_gradient
from .render import sharded_trace
from .fit import data_parallel_fit_step, fit_step

__all__ = [
    "Entry",
    "ProcessMesh",
    "default_mesh",
    "gather_blocks",
    "initialize_distributed",
    "local_devices",
    "pad_to_shards",
    "process_mesh",
    "replicated",
    "sharded_rays",
    "sharded_distance",
    "sharded_distance_and_gradient",
    "sharded_trace",
    "data_parallel_fit_step",
    "fit_step",
]
