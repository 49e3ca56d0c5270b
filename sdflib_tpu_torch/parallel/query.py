"""Sharded SDF queries: points data-parallel, structure replicated.

Port of the JAX package's ``parallel/query.py``. Works with every
structure of the port (``OctreeSdf``, ``ExactOctreeSdf``,
``UniformGridSdf``, ``RealSdf``): the point batch is padded to a multiple
of the device list's length and split into contiguous shards, the shards
of each device (``sharded_rays(mesh).put``) are queried against a replica of
the structure there, every device's block at the same time on its worker
(``run_blocks``), and the answers are concatenated on the first entry's
device (``gather_blocks``; over a ``ProcessMesh``, on every rank of the
list, on its first local entry's device). Each point takes the arithmetic
of a single-device query, so the answers equal ``sdf.get_distance`` bit
for bit.
"""
from __future__ import annotations

import copy
import threading
import weakref

import torch

from .mesh import (
    default_mesh,
    gather_blocks,
    local_devices,
    pad_to_shards,
    per_device,
    run_blocks,
    sharded_rays,
    takes_part,
)

__all__ = ["sharded_distance", "sharded_distance_and_gradient"]


def _device_put_structure(sdf, device):
    """A shallow copy of the structure whose tensors sit on ``device``;
    the caller's object is never changed. Every tensor attribute moves
    (the JAX list's arrays by the port's names: ``_octree_dev``,
    ``leaf_row0``, ``leaf_nchunks``, ``_leaf_bounds``, ``tri_flat``, ``bucket_ids``,
    ``bucket_fields``, ``_packed_t``, ``_finish_table``, ``fields``,
    ``_leaf_grid``, ``_query_grid``, ``_fat_grid``, ``grid`` and the box
    tensors), with ``triangles``; host arrays (``octree_data``,
    ``leaf_offset``, ``leaf_count``, ``leaf_centers``) stay shared, and the
    structure's dict caches are copied so queries through the replica
    leave the caller's untouched."""
    out = copy.copy(sdf)
    for name, val in vars(sdf).items():
        if isinstance(val, torch.Tensor):
            setattr(out, name, val.to(device))
        elif isinstance(val, dict):
            setattr(out, name, dict(val))
    tris = getattr(sdf, "triangles", None)
    if tris is not None:
        out.triangles = type(tris)(*(t.to(device) for t in tris))
    if hasattr(sdf, "device"):
        out.device = device
    return out


# Each structure's replicas by device, with the tensors they were copied
# from; dropped with the structure (weak keys).
_KEPT: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_KEPT_LOCK = threading.Lock()


def _sources(sdf) -> tuple:
    """(tensor, its version counter) for each tensor of the structure,
    the triangles' too (an inference tensor keeps no counter)."""
    tensors = [v for v in vars(sdf).values() if isinstance(v, torch.Tensor)]
    tensors += list(getattr(sdf, "triangles", None) or ())
    return tuple((t, None if t.is_inference() else t._version) for t in tensors)


def _replicas(sdf, mesh) -> dict:
    """One replica for each distinct device of the list (its tensors are
    the structure's own where it already sits there). The replicas are
    kept until a tensor of the structure is replaced (as
    ``build_query_grid`` does) or written in place, so later calls reuse
    their copies, and the tracer's frames on another card, keyed on the
    copies' addresses, replay there."""
    src = _sources(sdf)
    with _KEPT_LOCK:
        kept, reps = _KEPT.get(sdf, ((), {}))
        if len(kept) != len(src) or any(a is not b or u != v
                                        for (a, u), (b, v) in zip(kept, src)):
            reps = {}
        out = per_device(mesh, lambda d: reps[d] if d in reps
                         else _device_put_structure(sdf, d))
        _KEPT[sdf] = (src, {**reps, **out})
    return out


def _blocks(points, mesh):
    """(per-device blocks of the padded batch, the batch's shape, its
    point count)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    flat = pts.reshape(-1, 3)
    P_ = flat.shape[0]
    if P_ % len(mesh):
        flat = torch.nn.functional.pad(flat, (0, 0, 0, pad_to_shards(P_, mesh) - P_))
    return sharded_rays(mesh).put(flat), pts.shape, P_


def sharded_distance(sdf, points, mesh=None):
    """Distances for a point batch sharded over the device list, on its
    first entry's device (None on a rank without entries)."""
    mesh = default_mesh(mesh)
    if not takes_part(mesh):
        return None
    blocks, shape, P_ = _blocks(points, mesh)
    reps = _replicas(sdf, local_devices(mesh))
    parts = run_blocks(blocks, lambda dev, b: reps[dev].get_distance(b))
    d = gather_blocks(mesh, parts)
    return d[:P_].reshape(shape[:-1])


def sharded_distance_and_gradient(sdf, points, mesh=None):
    """Distances + gradients, points sharded over the device list."""
    mesh = default_mesh(mesh)
    if not takes_part(mesh):
        return None
    blocks, shape, P_ = _blocks(points, mesh)
    reps = _replicas(sdf, local_devices(mesh))
    outs = run_blocks(blocks, lambda dev, b: reps[dev].get_distance_and_gradient(b))
    d = gather_blocks(mesh, [o[0] for o in outs])
    g = gather_blocks(mesh, [o[1] for o in outs])
    return d[:P_].reshape(shape[:-1]), g[:P_].reshape(shape)
