"""Octree-TILE sharding: SDF structures partitioned over the device list.

Port of the JAX package's ``parallel/tiles.py`` (SURVEY.md S5.7-5.8;
reference start-grid layout OctreeSdf.h:256-258 is the natural 2^d^3
partition). ``parallel/query.py`` replicates the whole structure on every
entry; the two structures here split it:

* ``TiledExactOctreeSdf``: entry k builds and holds only the subtrees
  rooted at its start cells (its own node words, leaf tables and vertex
  bucket tables, ~1/N of the replicated ones), scanned by kernel K1 on a
  CUDA device;
* ``TiledOctreeSdf``: the approximate octree's dense fused-row grid
  ((2 + num_coeff) words, padded to 128, per finest cell) cut into
  contiguous z-slabs; the grid is z-major, so a slab is a row range and
  ownership is coordinate arithmetic.

Shared query pattern:
  * every entry receives the whole point batch (one copy per distinct
    device);
  * a point's owner is a function of its coordinates, so routing is
    arithmetic, not communication;
  * each in-box point is answered by exactly one entry, out-of-box points
    (the box fallback) by entry 0, and the answers are scattered into
    one output on the first entry's device: each point is written once,
    the counterpart of the JAX package's single psum;
  * every device answers its entries' points at the same time, on its
    worker (``mesh.run_blocks``). The build runs the entries one after
    another.
  * over a ``ProcessMesh`` a rank builds (or loads) only its own
    entries' shards, the memory per device that tiling buys; each rank's
    answers and their indices come back through ``_gather_ranks`` and are
    placed, never summed (``-0.0 + 0.0`` is ``+0.0``), on every rank of
    the list. Only a process that holds every shard writes a container.

Both classes are full SdfFunction citizens with the JAX package's
container keys: distance and gradient queries, ``save()`` and
``SdfFunction.load`` through their format tags (loading needs a device
list as long as the file's shard count).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh import BoundingBox, Mesh
from ..ops.octree_query import _finish, _grid_cells, _leaf_frac
from ..sdf.exact_octree import (
    _DEFAULT_BUCKET_BYTES,
    ExactOctreeSdf,
    _build_exact,
    prepare_cull_inputs,
)
from ..sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK
from ..sdf.sdf_function import SdfFormat, SdfFunction
from ..triangle import TriangleDataSoA, calculate_mesh_triangle_data, soa_to_torch
from .mesh import (
    ProcessMesh,
    _gather_ranks,
    default_mesh,
    local_devices,
    local_entries,
    per_device,
    replicated,
    run_blocks,
    takes_part,
    waiting,
)

__all__ = ["TiledExactOctreeSdf", "TiledOctreeSdf"]


def _pad_to(arr, n, fill=0):
    arr = np.asarray(arr)
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


class _ExactShard(ExactOctreeSdf):
    """One shard of a ``TiledExactOctreeSdf``: the exact octree of the
    start cells [cell_lo, cell_lo + cells), whose flat array starts with
    those cells' words (``_build_exact(seed_cells=...)``). Queries run the
    replicated structure's sort, scan and finish; the walk starts from the
    cell's local word, and there is no dense leaf grid (its start block is
    a cell range, not a grid)."""

    @classmethod
    def make(cls, *, device, box, start_depth, max_depth, min_triangles_per_node,
             strategy, cell_lo, cells, octree_data, leaf_offset, leaf_count,
             tri_flat, leaf_centers, triangles, bucket_byte_budget):
        if tri_flat.numel() * 9 * 4 > bucket_byte_budget:
            raise NotImplementedError(
                "tiled shards above the dense-bucket budget are unsupported; "
                "raise the shard count"
            )
        self = cls.__new__(cls)
        self.cell_lo, self.cells = int(cell_lo), int(cells)
        self._set_state(
            device=device, box=box, start_grid_size=1 << int(start_depth),
            max_depth=int(max_depth), min_triangles_per_node=int(min_triangles_per_node),
            strategy=strategy, octree_data=octree_data, leaf_offset=leaf_offset,
            leaf_count=leaf_count, tri_flat=tri_flat, leaf_centers=leaf_centers,
            sorted_lists=True, bucket_byte_budget=int(bucket_byte_budget),
            triangles=triangles, bucket_format="vertex9",
        )
        self.build_stats = {}
        return self

    def build_query_grid(self) -> None:
        self._leaf_grid = None

    def _start_index(self, ic):
        s = self.start_grid_size
        glob = ic[:, 2] * (s * s) + ic[:, 1] * s + ic[:, 0]
        return (glob - self.cell_lo).clamp(0, self.cells - 1)

    def owns(self, pts, first: bool):
        """The points this shard answers: the in-box points (the finish's
        test) whose clamped start cell (the walk's own arithmetic) it
        holds, and with ``first`` the points outside the box."""
        s = self.start_grid_size
        rel = (pts - self._box_min) / self._box_size3
        in_box = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
        frac = (pts - self._box_min) / (self._box_size3 / s)
        ic = frac.floor().to(torch.int32).clamp(0, s - 1).long()
        local = ic[:, 2] * (s * s) + ic[:, 1] * s + ic[:, 0] - self.cell_lo
        mine = in_box & (local >= 0) & (local < self.cells)
        return mine | ~in_box if first else mine


def _scatter_answers(mesh, shards, copies, owns, query, P, dev0, with_gradient):
    """Each of this process's shards (``local_entries``) answers the
    points it owns, every entry's device at the same time on its worker
    (``run_blocks``; the shards of one device in entry order); the
    answers are scattered into one output on ``dev0`` in shard order.
    Over a ``ProcessMesh`` each rank's indices and answers (as int32
    bits) are gathered first (``_gather_ranks``) and every rank places
    them all."""

    def answer(dev, block):
        k, shard, pts = block
        mine = owns(k, shard, pts)
        with waiting():            # nonzero waits for the count
            idx = mine.nonzero().squeeze(1)
        return idx, (query(k, shard, pts[idx]) if idx.numel() else None)

    parts = run_blocks([(dev, (k, shard, pts)) for (k, dev), shard, pts
                        in zip(local_entries(mesh), shards, copies)], answer)
    d_out = torch.zeros(P, device=dev0)
    g_out = torch.zeros((P, 3), device=dev0) if with_gradient else None
    if isinstance(mesh, ProcessMesh):
        parts = _exchange(mesh, parts, dev0, with_gradient)
    for idx, res in parts:
        if res is None:
            continue
        i0 = idx.to(dev0)
        if with_gradient:
            d_out[i0] = res[0].to(dev0)
            g_out[i0] = res[1].to(dev0)
        else:
            d_out[i0] = res.to(dev0)
    return d_out, g_out


def _exchange(mesh, parts, dev0, with_gradient):
    """Every rank's (indices, answers) of ``_scatter_answers``: this
    rank's packed as int32 rows (the index, then the answers' bits), one
    ``_gather_ranks`` over the list's ranks, unpacked on ``dev0``."""
    width = 5 if with_gradient else 2
    rows = []
    for idx, res in parts:
        if res is None:
            continue
        vals = torch.cat([res[0][:, None], res[1]], 1) if with_gradient else res[:, None]
        rows.append(torch.cat([idx.to(dev0, torch.int32)[:, None],
                               vals.to(dev0).view(torch.int32)], 1))
    mine = torch.cat(rows) if rows else torch.zeros((0, width), dtype=torch.int32, device=dev0)
    out = []
    for got in _gather_ranks(mesh, mine).values():
        if got.shape[0]:
            vals = got[:, 1:].contiguous().view(torch.float32)
            out.append((got[:, 0].long(), (vals[:, 0], vals[:, 1:]) if with_gradient
                        else vals[:, 0]))
    return out


def _holds_every_shard(mesh) -> None:
    """Raises unless this process holds every shard of the list."""
    if isinstance(mesh, ProcessMesh) and len(mesh.ranks) > 1:
        raise ValueError(
            f"this process holds the shards of {len(mesh.local)} of {len(mesh)} entries; "
            "a tiled container is written only by a process that holds every shard"
        )


class TiledExactOctreeSdf(SdfFunction):
    """ExactOctreeSdf with the structure sharded by start-grid tiles.

    Entry k of ``device_mesh`` builds start cells [k n0/N, (k+1) n0/N)
    on its device; each shard keeps its own node words, leaf tables and
    vertex bucket tables (the port's vertex9 tier, which kernel K1 scans
    on a CUDA device). A shard over the dense-bucket budget raises; no
    shard takes another tier. The triangle tables are held once per
    distinct device. Queries accept any (..., 3) batch and return the
    replicated structure's distances and gradients on the first entry's
    device. Over a ``ProcessMesh`` a rank holds its entries' shards
    (``shards``, ``shard_nodes`` and ``per_chip_bucket_bytes`` are
    theirs) and its queries return None where it holds none.
    """

    _STACK_FILL = (
        ("octree", 0),
        ("leaf_offset", 0),
        ("leaf_count", 0),
        ("leaf_centers", 0),
        ("bucket_ids", -1),
        ("bucket_fields", 0),
        ("bucket_cmin", np.inf),
    )

    def __init__(
        self,
        mesh: Mesh | None = None,
        box: BoundingBox | None = None,
        max_depth: int = 5,
        start_depth: int = 2,
        min_triangles_per_node: int = 32,
        strategy: str = "lattice",
        futility: float | None = 0.8,
        device_mesh=None,
        _state: dict | None = None,
    ):
        self.device_mesh = default_mesh(device_mesh)
        if _state is not None:
            self._load_state(_state)
            return
        assert mesh is not None and box is not None
        N = len(self.device_mesh)
        cbox = box.cubified()
        self.box = cbox
        self.max_depth = int(max_depth)
        self.start_depth = int(start_depth)
        self.min_triangles_per_node = int(min_triangles_per_node)
        self.strategy = str(strategy)
        s = 1 << self.start_depth
        n0 = s * s * s
        if n0 % N:
            raise ValueError(
                f"start grid ({n0} cells) must divide evenly over {N} entries"
                " - raise start_depth"
            )
        self.cells_per_chip = n0 // N

        soa = calculate_mesh_triangle_data(mesh)
        local = local_entries(self.device_mesh)
        tris = per_device(local_devices(self.device_mesh), lambda d: soa_to_torch(soa, d))
        # one set of cull tables per device, reused by every shard build
        tables = per_device(local_devices(self.device_mesh),
                            lambda d: prepare_cull_inputs(tris[d], self.strategy))
        shards = []
        for k, dev in local:
            lo = k * self.cells_per_chip
            octree, loff, lcnt, tflat, lcen, _stats = _build_exact(
                tris[dev], cbox.min, float(cbox.size[0]), self.max_depth,
                self.start_depth, self.min_triangles_per_node,
                futility=futility, strategy=self.strategy,
                seed_cells=(lo, lo + self.cells_per_chip),
                shared_tables=tables[dev],
            )
            shards.append(_ExactShard.make(
                device=dev, box=cbox, start_depth=self.start_depth,
                max_depth=self.max_depth,
                min_triangles_per_node=self.min_triangles_per_node,
                strategy=self.strategy, cell_lo=lo, cells=self.cells_per_chip,
                octree_data=octree, leaf_offset=loff, leaf_count=lcnt, tri_flat=tflat,
                leaf_centers=lcen, triangles=tris[dev],
                bucket_byte_budget=_DEFAULT_BUCKET_BYTES,
            ))
        self.shards = shards
        self.triangles = tris[local[0][1]] if local else None
        self.shard_nodes = [int(sh.octree_data.shape[0]) for sh in shards]
        self.max_leaf_count = max((int(sh.leaf_count.max(initial=1)) for sh in shards),
                                  default=1)

    def _query(self, points, with_gradient: bool):
        if not takes_part(self.device_mesh):
            return None
        dev0 = local_devices(self.device_mesh)[0]
        pts = torch.as_tensor(points, dtype=torch.float32)
        flat = pts.reshape(-1, 3)
        d, g = _scatter_answers(
            self.device_mesh, self.shards, replicated(self.device_mesh).put(flat),
            lambda k, sh, p: sh.owns(p, k == 0),
            lambda k, sh, q: sh._query(q, with_gradient),
            flat.shape[0], dev0, with_gradient,
        )
        if with_gradient:
            return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)
        return d.reshape(pts.shape[:-1])

    def get_distance(self, points):
        return self._query(points, with_gradient=False)

    def get_distance_and_gradient(self, points):
        return self._query(points, with_gradient=True)

    def get_sample_area(self) -> BoundingBox:
        return self.box

    def get_format(self) -> SdfFormat:
        return SdfFormat.EXACT_OCTREE_TILED

    def per_chip_bucket_bytes(self) -> list[int]:
        """Bucket-table bytes (ids and vertex fields) of each entry's shard
        (the memory sharding actually buys)."""
        return [sh.bucket_bytes for sh in self.shards]

    # -- serialization ------------------------------------------------------

    def _state_arrays(self) -> dict:
        """The JAX package's keys: the shards' arrays stacked along a
        leading shard axis, padded to the largest (rows to a multiple of
        64). ``bucket_cmin`` (the JAX scan's early-exit key, which the
        port's scans do not read) is written as 0, a valid lower bound.
        Raises in a process that does not hold every shard."""
        _holds_every_shard(self.device_mesh)
        per = []
        for sh in self.shards:
            rows = sh.bucket_ids.shape[0]
            per.append(dict(
                octree=np.asarray(sh.octree_data, np.uint32),
                leaf_offset=np.asarray(sh.leaf_offset, np.int32),
                leaf_count=np.asarray(sh.leaf_count, np.int32),
                leaf_centers=np.asarray(sh.leaf_centers, np.float32),
                bucket_ids=sh.bucket_ids.cpu().numpy(),
                bucket_fields=sh.bucket_fields.cpu().numpy(),
                bucket_cmin=np.zeros(rows, np.float32),
            ))
        stacked = {}
        for name, fill in self._STACK_FILL:
            n = max(p[name].shape[0] for p in per)
            n = -(-n // 64) * 64
            stacked[f"shard_{name}"] = np.stack([_pad_to(p[name], n, fill) for p in per])
        return {
            "box_min": np.asarray(self.box.min, np.float32),
            "box_max": np.asarray(self.box.max, np.float32),
            "max_depth": np.int32(self.max_depth),
            "start_depth": np.int32(self.start_depth),
            "min_triangles_per_node": np.int32(self.min_triangles_per_node),
            "strategy": np.array(self.strategy),
            "cells_per_chip": np.int32(self.cells_per_chip),
            "shard_nodes": np.asarray(self.shard_nodes, np.int64),
            "max_leaf_count": np.int32(self.max_leaf_count),
            **stacked,
            **{f"tri_{n}": a.cpu().numpy().astype(np.float32)
               for n, a in self.triangles._asdict().items()},
        }

    def _load_state(self, state: dict) -> None:
        N = len(self.device_mesh)
        n_saved = int(np.asarray(state["shard_octree"]).shape[0])
        if n_saved != N:
            raise ValueError(
                f"tiled container was saved with {n_saved} shards but the "
                f"device list has {N} entries - rebuild instead of loading"
            )
        self.box = BoundingBox(state["box_min"], state["box_max"])
        self.max_depth = int(state["max_depth"])
        self.start_depth = int(state["start_depth"])
        self.min_triangles_per_node = int(state["min_triangles_per_node"])
        self.strategy = str(state["strategy"])
        self.cells_per_chip = int(state["cells_per_chip"])
        self.shard_nodes = [int(x) for x in state["shard_nodes"]]
        self.max_leaf_count = int(state["max_leaf_count"])
        soa = TriangleDataSoA(*(state[f"tri_{n}"] for n in TriangleDataSoA._fields))
        local = local_entries(self.device_mesh)
        tris = per_device(local_devices(self.device_mesh), lambda d: soa_to_torch(soa, d))
        shards = []
        for k, dev in local:
            octree = np.asarray(state["shard_octree"][k], np.uint32)[: self.shard_nodes[k]]
            # the leaves the shard's words name; the rest is stack padding
            leaf = octree[(octree & IS_LEAF_MASK) != 0] & CHILDREN_INDEX_MASK
            L = int(leaf.max()) + 1 if leaf.size else 1
            ids = np.asarray(state["shard_bucket_ids"][k], np.int32)
            shards.append(_ExactShard.make(
                device=dev, box=self.box, start_depth=self.start_depth,
                max_depth=self.max_depth,
                min_triangles_per_node=self.min_triangles_per_node,
                strategy=self.strategy, cell_lo=k * self.cells_per_chip,
                cells=self.cells_per_chip, octree_data=octree,
                leaf_offset=np.asarray(state["shard_leaf_offset"][k][:L], np.int32),
                leaf_count=np.asarray(state["shard_leaf_count"][k][:L], np.int32),
                tri_flat=torch.as_tensor(ids.reshape(-1), device=dev),
                leaf_centers=np.asarray(state["shard_leaf_centers"][k][:L], np.float32),
                triangles=tris[dev], bucket_byte_budget=_DEFAULT_BUCKET_BYTES,
            ))
        self.shards = shards
        self.shard_nodes = [self.shard_nodes[k] for k, _ in local]
        self.triangles = tris[local[0][1]] if local else None


class TiledOctreeSdf(SdfFunction):
    """OctreeSdf (approximate, polynomial leaves) with the dense fused-row
    grid cut into z-slabs over the device list.

    The fused grid (one (2 + num_coeff)-word row, padded to 128 words for
    tricubic, per finest cell: the dominant memory at depth 7+) is
    z-major, so entry k owns the contiguous row range [k rows, (k+1)
    rows): ownership is one integer compare on the point's cell. Out-of-box
    points go to entry 0. Built from an ``OctreeSdf`` (``_octree=``, or
    built here on the first entry's device from ``mesh``, ``box`` and
    ``octree_kwargs``); sharding the BUILD itself is the exact octree's
    game. Over a ``ProcessMesh`` a rank keeps its entries' slabs
    (``slabs``), builds on its first local entry's device, and its
    queries return None where it holds none.
    """

    def __init__(
        self,
        mesh: Mesh | None = None,
        box: BoundingBox | None = None,
        device_mesh=None,
        _state: dict | None = None,
        _octree=None,
        **octree_kwargs,
    ):
        from ..sdf.octree import OctreeSdf

        self.device_mesh = default_mesh(device_mesh)
        if _state is not None:
            self._load_state(_state)
            return
        if _octree is None:
            assert mesh is not None and box is not None
            _octree = OctreeSdf(mesh, box, device=local_devices(self.device_mesh)[0],
                                **octree_kwargs)
        if _octree._fat_grid is None:
            _octree.build_query_grid()
        if _octree._fat_grid is None:
            raise ValueError("octree has no fused grid (over its byte budget)")
        self.box = _octree.box
        self.max_depth = int(_octree.max_depth)
        self.interpolation = str(_octree.interpolation)
        self.num_coeff = 64 if self.interpolation == "tricubic" else 8
        self.min_border_value = float(_octree.min_border_value)
        self.value_range = float(getattr(_octree, "value_range", 1.0))
        self._shard_fat(_octree._fat_grid)

    def _shard_fat(self, fat: torch.Tensor) -> None:
        """Each local entry's slab of the (g^3, width) int32 fused rows on
        its device (a view where the grid already sits there)."""
        N = len(self.device_mesh)
        g = 1 << self.max_depth
        if (g * g * g) % N:
            raise ValueError(f"grid ({g}^3 cells) must divide evenly over {N} entries")
        rpc = fat.shape[0] // N
        self.rows_per_chip = rpc
        self.slabs = [fat[k * rpc : (k + 1) * rpc].to(d)
                      for k, d in local_entries(self.device_mesh)]
        size3 = float(self.box.size[0])
        self._box = per_device(local_devices(self.device_mesh), lambda d: (
            torch.as_tensor(self.box.min, device=d), torch.full((3,), size3, device=d)))

    def _query(self, points, with_gradient: bool):
        if not takes_part(self.device_mesh):
            return None
        dev0 = local_devices(self.device_mesh)[0]
        pts = torch.as_tensor(points, dtype=torch.float32)
        flat = pts.reshape(-1, 3)
        rpc, depth, nc = self.rows_per_chip, self.max_depth, self.num_coeff
        on = dict(local_entries(self.device_mesh))

        def owns(k, slab, p):
            box_min, size3 = self._box[on[k]]
            _, in_box, lin = _grid_cells(p, box_min, size3, depth)
            local = lin - k * rpc
            mine = in_box & (local >= 0) & (local < rpc)
            return mine | ~in_box if k == 0 else mine

        def query(k, slab, q):
            box_min, size3 = self._box[on[k]]
            rel, in_box, lin = _grid_cells(q, box_min, size3, depth)
            row = slab[(lin - k * rpc).clamp(0, rpc - 1)]
            frac = _leaf_frac(rel, row[..., 1])
            coeffs = row[..., 2 : 2 + nc].view(torch.float32)
            return _finish(q, coeffs, frac, in_box, box_min, size3,
                           self.min_border_value, self.interpolation, with_gradient)

        d, g = _scatter_answers(
            self.device_mesh, self.slabs, replicated(self.device_mesh).put(flat), owns, query,
            flat.shape[0], dev0, with_gradient,
        )
        if with_gradient:
            return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)
        return d.reshape(pts.shape[:-1])

    def get_distance(self, points):
        return self._query(points, with_gradient=False)

    def get_distance_and_gradient(self, points):
        return self._query(points, with_gradient=True)

    def get_sample_area(self) -> BoundingBox:
        return self.box

    def get_format(self) -> SdfFormat:
        return SdfFormat.OCTREE_TILED

    def per_chip_grid_bytes(self) -> list[int]:
        return [int(s.numel()) * 4 for s in self.slabs]

    # -- serialization ------------------------------------------------------

    def _state_arrays(self) -> dict:
        _holds_every_shard(self.device_mesh)
        fat = torch.cat([s.cpu() for s in self.slabs]).numpy().view(np.uint32)
        return {
            "box_min": np.asarray(self.box.min, np.float32),
            "box_max": np.asarray(self.box.max, np.float32),
            "max_depth": np.int32(self.max_depth),
            "interpolation": np.array(self.interpolation),
            "min_border_value": np.float32(self.min_border_value),
            "value_range": np.float32(self.value_range),
            "fat_grid": fat,
        }

    def _load_state(self, state: dict) -> None:
        self.box = BoundingBox(state["box_min"], state["box_max"])
        self.max_depth = int(state["max_depth"])
        self.interpolation = str(state["interpolation"])
        self.num_coeff = 64 if self.interpolation == "tricubic" else 8
        self.min_border_value = float(state["min_border_value"])
        self.value_range = float(state["value_range"])
        fat = np.ascontiguousarray(state["fat_grid"], np.uint32).view(np.int32)
        self._shard_fat(torch.from_numpy(fat))
