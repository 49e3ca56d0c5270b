"""Approximate octree SDF with polynomial leaves: structure and queries.

Port of the JAX package's ``sdf/octree.py`` (reference: include/SdfLib/
OctreeSdf.h:20-292, src/sdf/OctreeSdf.cpp:18-152). The flat array keeps
the reference's meaning (leaf bit 31, 30-bit children/coefficient index,
dense z-major start grid first, coefficients bit-cast inline), so a
structure moves between the packages and the reference's ``.bin``
unchanged. On the device the words are an int32 tensor, where the leaf
bit is the sign, and the coefficients are read through a float32 view
of the same storage; no query returns to the host.

Three query routes, each the JAX function's formulas:

* ``_octree_query``, the walk (OctreeSdf.cpp:93-152): a fixed-depth
  masked descent from the start grid. Its aligned form fetches each node
  as one 8-word row and each leaf's coefficients as one row of a
  (W / num_coeff, num_coeff) view; the layout-agnostic form gathers
  words one by one, for arrays from reference ``.bin`` files.
* ``_octree_query_grid``: one gather from a dense leaf grid at max-depth
  resolution (``build_query_grid``), then the coefficient row.
* ``_octree_query_fat``: one gather of a fused row holding the leaf word,
  its depth and flags, and the coefficients.

The two grid routes are K4 on the card (``ops/octree_query.py``,
``csrc/octree_query.cu``) and its plain torch version on the CPU; the
walk is K10 on the card (``ops/walk.py``, ``csrc/octree_walk.cu``).

Outside the box every route returns the box distance plus
``min_border_value`` (OctreeSdf.cpp:99-104). The leaf grid's depth word
carries the sphere tracer's surface-free flag (bit 16) and free radius
(bits 17-21).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh import BoundingBox, Mesh
from ..ops.octree_query import LeafGrid, grid_query, grid_query_plain
from ..ops.walk import Walk, WalkQuery, walk_query, walk_query_plain
from ..triangle import calculate_mesh_triangle_data, soa_to_torch
from .octree_builder import (
    CHILDREN_INDEX_MASK,
    IS_LEAF_MASK,
    OctreeBuildResult,
    _check_strategy,
    build_octree,
)
from .sdf_function import SdfFormat, SdfFunction, resolve_device

__all__ = ["OctreeSdf"]

_RULES = {"trapezoid", "simpson", "by_distance", "none"}


def _octree_query(
    octree_i32,
    points,
    box_min,
    box_size3,
    start_grid_size: int,
    min_border_value: float,
    *,
    levels: int,
    num_coeff: int,
    interpolation: str,
    with_gradient: bool,
    fast: bool = True,
    plain: bool = False,
):
    """The walk (OctreeSdf.cpp:93-152) over (P, 3) points.

    ``octree_i32`` is the flat array on the device as int32, ``box_min``
    and ``box_size3`` (3,) float32 tensors on its device. ``fast``
    requires the aligned layout the builders emit (children blocks
    8-aligned, coefficient blocks num_coeff-aligned, length a multiple of
    64): each node is then read as one 8-word row and each leaf's
    coefficients as one row. ``fast=False`` is the layout-agnostic form
    for foreign (reference ``.bin``) arrays. The JAX package's one-hot
    ``_select8`` is an in-row ``gather`` here.

    K10 (``ops/walk.py`` ``walk_query``) runs on CUDA points; the
    distance of CUDA points that require a gradient while autograd
    records runs through ``WalkQuery`` (K10, and K11 for the point
    gradient). The plain torch version runs on the CPU, where ``plain``
    pins it (the structure's ``_plain``), and for the normalised gradient
    of points that require a gradient, whose derivative is a second
    derivative of the walk that K11 does not compute: autograd of the
    plain version's graph takes it."""
    coeffs = octree_i32.view(torch.float32)
    walk = Walk(octree_i32, coeffs, box_min, box_size3, float(min_border_value),
                int(start_grid_size), levels, num_coeff, interpolation, fast)
    mode = "normal" if with_gradient else "distance"
    if plain or points.device.type == "cpu":
        return walk_query_plain(walk, points, mode)
    if points.requires_grad and torch.is_grad_enabled():
        if with_gradient:
            return walk_query_plain(walk, points, mode)
        return WalkQuery.apply(coeffs, points.contiguous(), walk._replace(coeffs=None), False)
    return walk_query(walk, points.contiguous(), mode)


def _layout_is_aligned(data: np.ndarray, start_grid_size: int, num_coeff: int) -> bool:
    """Host-side walk checking the aligned layout: total length a multiple
    of 64, children blocks 8-aligned, coefficient blocks num_coeff-aligned.
    The builders always emit it; reference ``.bin`` arrays may not."""
    if data.shape[0] % 64:
        return False
    frontier = data[: start_grid_size**3]
    for _ in range(32):
        is_leaf = (frontier & IS_LEAF_MASK) != 0
        bases = (frontier & CHILDREN_INDEX_MASK).astype(np.int64)
        if np.any(bases[is_leaf] % num_coeff):
            return False
        inner = bases[~is_leaf]
        if inner.size == 0:
            return True
        if np.any(inner % 8):
            return False
        frontier = data[(inner[:, None] + np.arange(8)).reshape(-1)]
    return False  # deeper than any valid octree


def _octree_query_grid(
    octree_i32,
    grid_i32,        # (2^d^3, 2): [leaf word, leaf depth | flags] per finest cell
    points,
    box_min,
    box_size3,
    min_border_value: float,
    *,
    grid_depth: int,
    num_coeff: int,
    interpolation: str,
    with_gradient: bool,
):
    """One-gather descent through the dense leaf grid at max-depth
    resolution, then the leaf's coefficient row (aligned layout only):
    K4 on CUDA tensors (``ops/octree_query.py``)."""
    grid = LeafGrid(grid_i32, False, octree_i32, box_min, box_size3, min_border_value,
                    grid_depth, num_coeff, interpolation)
    return grid_query(grid, points, with_gradient)


def _build_fat_grid(octree_np: np.ndarray, grid: np.ndarray, num_coeff: int) -> np.ndarray:
    """The dense leaf grid fused with the leaf coefficients: one row per
    finest cell = [leaf word, depth | flags, coefficients...], padded to
    a power-of-two width (128 words for tricubic, 16 for trilinear)."""
    base = (grid[:, 0] & CHILDREN_INDEX_MASK).astype(np.int64)
    width = 128 if num_coeff > 6 else 16
    out = np.zeros((grid.shape[0], width), np.uint32)
    out[:, 0] = grid[:, 0]
    out[:, 1] = grid[:, 1]
    out[:, 2 : 2 + num_coeff] = octree_np[base[:, None] + np.arange(num_coeff)]
    return out


def _octree_query_fat(
    fat_i32,         # (2^d^3, width) fused rows
    points,
    box_min,
    box_size3,
    min_border_value: float,
    *,
    grid_depth: int,
    num_coeff: int,
    interpolation: str,
    with_gradient: bool,
):
    """Dense-grid query over fused rows, one row gather per point: K4 on
    CUDA tensors (``ops/octree_query.py``)."""
    grid = LeafGrid(fat_i32, True, None, box_min, box_size3, min_border_value,
                    grid_depth, num_coeff, interpolation)
    return grid_query(grid, points, with_gradient)


def _build_leaf_grid(
    octree_np: np.ndarray, start_grid_size: int, max_depth: int
) -> np.ndarray:
    """Dense (2^max_depth^3, 2) uint32 grid of [leaf word, leaf depth],
    z-major, by host-side level expansion of the flat octree."""
    g = 1 << max_depth
    grid = np.zeros((g, g, g, 2), np.uint32)

    s = start_grid_size
    start_depth = int(np.log2(s))
    zi, yi, xi = np.meshgrid(np.arange(s), np.arange(s), np.arange(s),
                             indexing="ij")
    coords = np.stack([xi, yi, zi], -1).reshape(-1, 3).astype(np.int64)
    words = octree_np[: s * s * s]
    depth = start_depth

    while len(words):
        is_leaf = (words & IS_LEAF_MASK) != 0
        # a leaf at `depth` covers a (g >> depth)^3 block of finest cells
        ls = np.nonzero(is_leaf)[0]
        if len(ls):
            b = g >> depth
            base = coords[ls] * b
            off = np.arange(b)
            ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
            blk = np.stack([ox, oy, oz], -1).reshape(-1, 3)
            cells = base[:, None, :] + blk[None]
            cx = cells[..., 0].ravel()
            cy = cells[..., 1].ravel()
            cz = cells[..., 2].ravel()
            grid[cz, cy, cx, 0] = np.repeat(words[ls], b**3)
            grid[cz, cy, cx, 1] = depth
        inner = np.nonzero(~is_leaf)[0]
        if len(inner) == 0 or depth == max_depth:
            break
        bases = (words[inner] & CHILDREN_INDEX_MASK).astype(np.int64)
        child = np.arange(8)
        idx = (bases[:, None] + child[None]).reshape(-1)
        words = octree_np[idx]
        bits = np.stack([child & 1, (child >> 1) & 1, (child >> 2) & 1], -1)
        coords = (2 * coords[inner][:, None, :] + bits[None]).reshape(-1, 3)
        depth += 1
    return grid.reshape(-1, 2)


def _to_dev_i32(a: np.ndarray, device) -> torch.Tensor:
    """A uint32 host array as an int32 tensor on ``device`` (same bits)."""
    return torch.tensor(np.ascontiguousarray(a, np.uint32).view(np.int32), device=device)


class OctreeSdf(SdfFunction):
    """Octree with trilinear or tricubic polynomial leaves.

    init_algorithm: "uniform" (subdivide everything, OctreeSdf.h:25),
    "no_continuity" (per-node termination) or "continuity" (C0 across
    leaf faces, ``octree_builder_continuity``, the reference's default).
    ``strategy`` names the builders' cull ("distance" or an exact-octree
    strategy; the values do not depend on it). ``device`` holds the
    structure and runs the build and the queries; query points may come
    as numpy arrays or tensors, results are tensors on ``device``.

    ``build_query_grid()`` switches queries to the dense leaf grid
    (8 bytes per finest cell) and builds the fused rows of
    ``_octree_query_fat`` where they fit ``_FAT_GRID_BYTE_BUDGET``. On the
    card the grid routes run K4, and the tracer's march and beam over
    them K5 and K6 (``ops/march.py``); the walk runs K10 (``ops/walk.py``).
    Setting the private ``_plain`` to True pins the plain torch versions
    of all four for this structure (the card's comparisons; the tracer's
    frames key on it).
    """

    # fused rows above this many bytes stay unbuilt: depth 6 tricubic is
    # 128 MiB, depth 7 1 GiB
    _FAT_GRID_BYTE_BUDGET = 1 << 30

    # Cells flagged surface-free keep the polynomial above this (in
    # box-size units) with the error budget below; tracers must use
    # eps <= this margin for exit-stepping to be sound.
    _FREE_CELL_MARGIN = 1e-4
    # Fit-error budget in units of the termination threshold: the true SDF
    # is 1-Lipschitz and the builder drives the (integral) fit error below
    # the threshold, so 10x the threshold covers the pointwise deviation
    # of error-terminated leaves with a wide margin.
    _FREE_CELL_ERR_BUDGET = 10.0

    def __init__(
        self,
        mesh: Mesh,
        box: BoundingBox,
        max_depth: int = 6,
        start_depth: int = 1,
        termination_threshold: float = 1e-3,
        termination_rule: str = "trapezoid",
        error_decay: float = 0.0,
        init_algorithm: str = "no_continuity",
        interpolation: str = "tricubic",
        strategy: str = "distance",
        *,
        device="cuda",
    ):
        if termination_rule not in _RULES:
            raise ValueError(f"unknown termination rule {termination_rule!r}")
        if init_algorithm == "uniform":
            rule = "none"
        elif init_algorithm in ("no_continuity", "continuity"):
            rule = termination_rule
        else:
            raise ValueError(f"unknown init_algorithm {init_algorithm!r}")
        _check_strategy(strategy)
        device = resolve_device(device)
        cbox = box.cubified()   # OctreeSdf.cpp:43-46
        tris = soa_to_torch(calculate_mesh_triangle_data(mesh), device)
        args = (tris, cbox.min, float(cbox.size[0]), int(max_depth), int(start_depth))
        kw = dict(termination_rule=rule, termination_threshold=termination_threshold,
                  error_decay=error_decay, interpolation=interpolation, strategy=strategy)
        if init_algorithm == "continuity":
            from .octree_builder_continuity import build_octree_continuity

            result: OctreeBuildResult = build_octree_continuity(*args, **kw)
        else:
            result = build_octree(*args, **kw)
        self._set_state(
            device=device,
            box=cbox,
            start_grid_size=1 << int(start_depth),
            max_depth=int(max_depth),
            value_range=result.value_range,
            min_border_value=result.min_border_value,
            octree_data=result.octree_u32,
            interpolation=interpolation,
            leaf_depths=result.leaf_depths,
            termination_threshold=termination_threshold,
        )
        self.build_stats = result.stats

    @classmethod
    def from_jax_state(cls, state: dict, device="cuda") -> "OctreeSdf":
        """The structure held by a state dict of the JAX package's
        ``OctreeSdf._state_arrays()`` (the ``.npz`` container's arrays),
        on ``device``."""
        self = cls.__new__(cls)
        self._set_state(
            device=resolve_device(device),
            box=BoundingBox(state["box_min"], state["box_max"]),
            start_grid_size=int(state["start_grid_size"]),
            max_depth=int(state["max_depth"]),
            value_range=float(state["value_range"]),
            min_border_value=float(state["min_border_value"]),
            octree_data=np.asarray(state["octree_data"], np.uint32),
            interpolation=str(state.get("interpolation", "tricubic")),
            leaf_depths=np.asarray(state.get("leaf_depths", []), np.int32),
            termination_threshold=float(state.get("termination_threshold", 1e-3)),
        )
        self.build_stats = {}
        return self

    def _set_state(self, *, device, box, start_grid_size, max_depth, value_range,
                   min_border_value, octree_data, interpolation, leaf_depths,
                   termination_threshold):
        self.device = device
        self.box = box
        self.start_grid_size = start_grid_size
        self.start_depth = int(np.log2(start_grid_size))
        self.max_depth = max_depth
        self.value_range = float(value_range)
        self.min_border_value = float(min_border_value)
        self.octree_data = octree_data
        self.interpolation = interpolation
        self.termination_threshold = float(termination_threshold)
        self._leaf_depths = leaf_depths
        self._octree_dev = _to_dev_i32(octree_data, device)
        self._box_min = torch.as_tensor(box.min, device=device)
        self._box_size3 = torch.full((3,), float(box.size[0]), device=device)
        self._fast_layout = _layout_is_aligned(
            octree_data, start_grid_size, self.num_coefficients
        )
        self._query_grid = None
        self._fat_grid = None
        self._plain = False

    @property
    def num_coefficients(self) -> int:
        return 64 if self.interpolation == "tricubic" else 8

    # -- query grids ----------------------------------------------------------

    def build_query_grid(self, march_flags: bool = True) -> None:
        """Build the dense leaf grid (8 bytes x 8^max_depth, aligned layout
        only) that queries then descend in one gather, and the fused rows
        where they fit the byte budget. ``march_flags`` marks the
        surface-free cells for the sphere tracer (``_mark_free_cells``)."""
        if not self._fast_layout:
            raise ValueError("query grid requires the aligned (builder-emitted) layout")
        grid = _build_leaf_grid(self.octree_data, self.start_grid_size, self.max_depth)
        if march_flags:
            grid = self._mark_free_cells(grid)
        self._query_grid = _to_dev_i32(grid, self.device)
        nc = self.num_coefficients
        fat_bytes = grid.shape[0] * (128 if nc > 6 else 16) * 4
        if fat_bytes <= self._FAT_GRID_BYTE_BUDGET:
            self._fat_grid = _to_dev_i32(_build_fat_grid(self.octree_data, grid, nc),
                                         self.device)
        else:
            self._fat_grid = None

    def _mark_free_cells(self, grid: np.ndarray) -> np.ndarray:
        """Set bit 16 of the depth word for cells that provably contain no
        surface:

            d_poly(center) > (sqrt(3)/2) * cell_size + err_budget + margin

        The true SDF is 1-Lipschitz, so it is positive throughout such a
        cell, and the polynomial (within its fit-error budget) stays above
        the tracer's hit threshold.

        Bits 17-21 store a free radius r - 1 with r in {1, 2, 4, 8, 16}
        (0 where the cell is not free): every cell within Chebyshev
        distance r - 1 is free too, so a tracer may step to the exit of
        the (2r - 1)-cell box. Computed by erosion doubling, three
        separable axis min-filters per level."""
        g = 1 << self.max_depth
        box_min = np.asarray(self.box.min, np.float32)
        box_size = float(self.box.size[0])
        cell_size = box_size / g
        cut = (
            0.5 * np.sqrt(3.0) * cell_size
            + self._FREE_CELL_ERR_BUDGET * self.termination_threshold
            + self._FREE_CELL_MARGIN * box_size
        )

        n_cells = g * g * g
        free = np.zeros(n_cells, bool)
        chunk = 1 << 20
        zi, yi, xi = np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing="ij")
        centers_all = np.stack([xi.ravel(), yi.ravel(), zi.ravel()], -1).astype(np.float32)
        for i in range(0, n_cells, chunk):
            centers = box_min + (centers_all[i : i + chunk] + 0.5) * cell_size
            d = self.get_distance(centers).cpu().numpy()
            free[i : i + chunk] = d > cut

        # out-of-grid counts as free: beyond the box the SDF is the exact
        # box fallback, which the march handles with its own safe step
        def _erode(a: np.ndarray, r: int) -> np.ndarray:
            for ax in range(3):
                m = a
                for s in range(1, r + 1):
                    lo = np.ones_like(a)
                    hi = np.ones_like(a)
                    sl_lo = [slice(None)] * 3
                    sl_hi = [slice(None)] * 3
                    sl_lo[ax] = slice(s, None)
                    sl_hi[ax] = slice(None, -s)
                    lo[tuple(sl_hi)] = a[tuple(sl_lo)]
                    hi[tuple(sl_lo)] = a[tuple(sl_hi)]
                    m = m & lo & hi
                a = m
            return a

        f3 = free.reshape(g, g, g)
        radius = f3.astype(np.uint32)  # 1 where the cell itself is free
        er, r_acc = f3, 1
        for step in (1, 2, 4, 8):
            if 2 * (r_acc + step) + 1 > g:
                break
            er = _erode(er, step)
            r_acc += step
            np.maximum(radius, er.astype(np.uint32) * r_acc, out=radius)
        rad_m1 = np.where(radius > 0, radius - 1, 0).astype(np.uint32)

        out = grid.copy()
        out[:, 1] |= free.astype(np.uint32) << 16
        out[:, 1] |= (rad_m1.reshape(-1) & 0x1F) << 17
        return out

    # -- queries ----------------------------------------------------------------

    def _leaf_grid(self, fat: bool) -> LeafGrid:
        """The thin leaf grid (``fat`` False) or the fused rows, for K4-K6."""
        return LeafGrid(self._fat_grid if fat else self._query_grid, fat, self._octree_dev,
                        self._box_min, self._box_size3, self.min_border_value,
                        self.max_depth, self.num_coefficients, self.interpolation)

    def _query(self, points, with_gradient: bool):
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        flat = pts.reshape(-1, 3).contiguous()
        # plain queries take the thin grid; the fused rows serve the tracer
        if self._query_grid is not None:
            query = grid_query_plain if self._plain else grid_query
            out = query(self._leaf_grid(False), flat, with_gradient)
        else:
            out = _octree_query(
                self._octree_dev, flat, self._box_min, self._box_size3,
                self.start_grid_size, self.min_border_value,
                levels=self.max_depth - self.start_depth, fast=self._fast_layout,
                num_coeff=self.num_coefficients, interpolation=self.interpolation,
                with_gradient=with_gradient, plain=self._plain,
            )
        if with_gradient:
            d, g = out
            return d.reshape(pts.shape[:-1]), g.reshape(pts.shape)
        return out.reshape(pts.shape[:-1])

    def get_distance(self, points):
        return self._query(points, with_gradient=False)

    def get_distance_and_gradient(self, points):
        return self._query(points, with_gradient=True)

    def get_sample_area(self) -> BoundingBox:
        return self.box

    def get_format(self) -> SdfFormat:
        return SdfFormat.OCTREE

    def get_depth_density(self) -> np.ndarray:
        """Leaf volume share per depth, summing to 1 (OctreeSdf.cpp:232-277)."""
        density = np.zeros(self.max_depth + 1, np.float64)
        if len(self._leaf_depths):
            for d in range(self.max_depth + 1):
                density[d] = np.sum(self._leaf_depths == d) * 0.125**d
        return density.astype(np.float32)

    # -- serialization ------------------------------------------------------------

    def _state_arrays(self) -> dict:
        """The arrays of the JAX package's container schema."""
        return {
            "box_min": np.asarray(self.box.min, np.float32),
            "box_max": np.asarray(self.box.max, np.float32),
            "start_grid_size": np.int32(self.start_grid_size),
            "max_depth": np.int32(self.max_depth),
            "value_range": np.float32(self.value_range),
            "min_border_value": np.float32(self.min_border_value),
            "octree_data": np.asarray(self.octree_data, np.uint32),
            "interpolation": np.array(self.interpolation),
            "leaf_depths": np.asarray(self._leaf_depths, np.int32),
            "termination_threshold": np.float32(self.termination_threshold),
        }
