"""Sharded sphere tracing: rays data-parallel over the device list.

Port of the JAX package's ``parallel/render.py``. The reference
dispatches one GL compute workgroup per 16x16 pixel tile on a single GPU
(reference: src/render_engine/RenderSdf.cpp:187); here the ray batch is
split into contiguous shards and each device marches its entries' shards
(``sharded_rays(mesh).put``) against a replica of the octree through the
whole-frame trace, every device at the same time on its worker
(``run_blocks``), as the JAX module shard-maps ``_trace_rays_fused``:
the beam prepass, the static march pyramid where the block is wide
enough, the straggler march, the unsort and the normals, on the card as
captured CUDA graphs. No traffic passes between shards until the results
are gathered on the first entry's device.
"""
from __future__ import annotations

import torch

from ..render.sphere_trace import _TRACE_BLOCK, TraceResult, _trace_rays
from .mesh import (
    default_mesh,
    gather_blocks,
    local_devices,
    run_blocks,
    sharded_rays,
    takes_part,
)
from .query import _replicas

__all__ = ["sharded_trace"]


def sharded_trace(
    octree,
    origins,
    dirs,
    mesh=None,
    *,
    eps: float = 1e-5,
    far: float = 4.0,
    max_iters: int = 1024,
    beam: int | None = None,
) -> TraceResult:
    """``trace_octree`` with rays sharded over the device list; each
    device's block of shards runs the whole-frame trace there.

    The beam prepass defaults OFF here, as in the JAX package: its
    per-tile reductions group consecutive rays of the local shard, so
    tile membership (and therefore start depths) differs from the
    single-device 2D tiling, breaking the bit-equality this module
    otherwise guarantees against ``trace_octree(..., beam=None)``. Pass
    beam=4 to trade that for the empty-space skip.

    The shards are sized as the JAX package's: ``ceil(R / entries)`` rays
    rounded up to whole blocks of B, the smaller of 2^17 and the power of
    two at or above that count. A padding ray has a unit direction and
    starts inactive, so it never marches. The sizes come from the whole
    list, so every rank of a ``ProcessMesh`` pads alike; a rank without
    entries returns None."""
    mesh = default_mesh(mesh)
    if not takes_part(mesh):
        return None
    o = torch.as_tensor(origins, dtype=torch.float32)
    shape = o.shape[:-1]
    o = o.reshape(-1, 3)
    d = torch.as_tensor(dirs, dtype=torch.float32, device=o.device).reshape(-1, 3)
    R = o.shape[0]
    Rl0 = -(-R // len(mesh))
    B = min(_TRACE_BLOCK, 1 << max(Rl0 - 1, 1).bit_length())
    Rp = -(-Rl0 // B) * B * len(mesh)
    live = torch.arange(Rp, device=o.device) < R
    o = torch.nn.functional.pad(o, (0, 0, 0, Rp - R))
    d = torch.where(live[:, None], torch.nn.functional.pad(d, (0, 0, 0, Rp - R)),
                    torch.tensor([1.0, 0.0, 0.0], device=o.device))
    reps = _replicas(octree, local_devices(mesh))
    split = sharded_rays(mesh)

    def trace(dev, block):
        o_k, d_k, a_k = block
        return _trace_rays(reps[dev], o_k, d_k, a_k.to(torch.float32), o_k.shape, eps=eps,
                           far=far, max_iters=max_iters, B=B, beam=beam,
                           graphs=dev.type == "cuda")

    parts = run_blocks([(dev, (o_k, d_k, a_k)) for (dev, o_k), (_, d_k), (_, a_k)
                        in zip(split.put(o), split.put(d), split.put(live))], trace)
    hit, pos, acc, normal, iters = (
        gather_blocks(mesh, [p[i] for p in parts])[:R] for i in range(len(TraceResult._fields))
    )
    return TraceResult(
        hit.reshape(shape),
        pos.reshape(shape + (3,)),
        acc.reshape(shape),
        normal.reshape(shape + (3,)),
        iters.reshape(shape),
    )
