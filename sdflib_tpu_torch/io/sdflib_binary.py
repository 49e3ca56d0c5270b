"""Reference-format (.bin) serialization of the approximate octree and
the uniform grid.

A numpy copy of the OCTREE and GRID parts of the JAX package's
``io/sdflib_binary.py`` (that module imports JAX through its ``sdf/``
imports). Reads and writes the reference's cereal PortableBinaryArchive
container (reference: src/sdf/SdfFunction.cpp:9-79):

  byte 0  : archive endianness flag (0x01 = little endian)
  int32   : SdfFormat enum (GRID=0, OCTREE=1, EXACT_OCTREE=2;
            SdfFunction.h:16-22)
  OCTREE  : BoundingBox (6 f32) + int32 startGridSize + u32 maxDepth
            + f32 valueRange + f32 minBorderValue
            + vector<OctreeNode> (u64 count + u32 data)
            (OctreeSdf.h:222-238)
  GRID    : BoundingBox (6 f32) + 3 x int32 gridSize
            + vector<float> (u64 count + f32 data, z-major)
            (UniformGridSdf.h:60-74)

An array that the reference wrote need not have the builders' aligned
layout; ``OctreeSdf`` then queries it through the walk's
layout-agnostic form. EXACT_OCTREE containers raise
``NotImplementedError``: their format is not ported yet.
"""
from __future__ import annotations

import struct

import numpy as np

__all__ = ["save_sdflib_bin", "load_sdflib_bin"]

_FMT_GRID, _FMT_OCTREE, _FMT_EXACT = 0, 1, 2


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("Truncated .bin container")
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def f32v(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), dtype="<f4").copy()

    def vec_u32(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self.take(4 * n), dtype="<u4").copy()

    def vec_f32(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self.take(4 * n), dtype="<f4").copy()


def load_sdflib_bin(path: str, device="cuda"):
    """Load a reference .bin container onto ``device`` (an OCTREE
    container gives an ``OctreeSdf``, a GRID one a ``UniformGridSdf``)."""
    from ..sdf.grid import UniformGridSdf
    from ..sdf.octree import OctreeSdf

    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.u8() != 1:
        raise ValueError("Only little-endian .bin containers are supported")
    fmt = r.i32()
    if fmt == _FMT_OCTREE:
        state = {
            "box_min": r.f32v(3),
            "box_max": r.f32v(3),
            "start_grid_size": np.int32(r.i32()),
            "max_depth": np.int32(r.u32()),
            "value_range": np.float32(r.f32()),
            "min_border_value": np.float32(r.f32()),
            "octree_data": r.vec_u32(),
            "interpolation": np.array("tricubic"),
            "leaf_depths": np.zeros(0, np.int32),
        }
        return OctreeSdf.from_jax_state(state, device=device)
    if fmt == _FMT_GRID:
        box_min, box_max = r.f32v(3), r.f32v(3)
        gs = np.frombuffer(r.take(12), dtype="<i4").copy()
        state = {
            "box_min": box_min,
            "box_max": box_max,
            "grid_size": gs,
            # the reference stores z-major flat; the grid is (nz, ny, nx)
            "grid": r.vec_f32().reshape(gs[2], gs[1], gs[0]),
        }
        return UniformGridSdf.from_jax_state(state, device=device)
    if fmt == _FMT_EXACT:
        raise NotImplementedError(
            "EXACT_OCTREE .bin containers are not ported yet "
            "(ROADMAP.md, Queue 1 item 4.1)"
        )
    raise ValueError(f"Unknown SdfFormat {fmt} in {path!r}")


def save_sdflib_bin(sdf, path: str) -> None:
    """Write a reference-compatible .bin container of an ``OctreeSdf`` or
    a ``UniformGridSdf``."""
    from ..sdf.grid import UniformGridSdf
    from ..sdf.octree import OctreeSdf

    out = bytearray()
    out += b"\x01"  # little-endian archive flag
    if isinstance(sdf, OctreeSdf):
        if sdf.interpolation != "tricubic":
            raise ValueError(
                ".bin export requires tricubic octrees (the reference's "
                "compiled interpolation method, OctreeSdf.cpp:16)"
            )
        out += struct.pack("<i", _FMT_OCTREE)
        out += np.asarray(sdf.box.min, "<f4").tobytes()
        out += np.asarray(sdf.box.max, "<f4").tobytes()
        out += struct.pack("<i", sdf.start_grid_size)
        out += struct.pack("<I", sdf.max_depth)
        out += struct.pack("<f", sdf.value_range)
        out += struct.pack("<f", sdf.min_border_value)
        data = np.asarray(sdf.octree_data, "<u4")
        out += struct.pack("<Q", data.size)
        out += data.tobytes()
    elif isinstance(sdf, UniformGridSdf):
        out += struct.pack("<i", _FMT_GRID)
        out += np.asarray(sdf.box.min, "<f4").tobytes()
        out += np.asarray(sdf.box.max, "<f4").tobytes()
        out += struct.pack("<3i", *sdf.grid_size)
        grid = sdf.grid.cpu().numpy().astype("<f4")  # (nz, ny, nx) -> z-major flat
        out += struct.pack("<Q", grid.size)
        out += grid.tobytes()
    else:
        raise NotImplementedError(
            f".bin export of {type(sdf).__name__} is not ported yet "
            "(ROADMAP.md, Queue 1 item 4.1)"
        )
    with open(path, "wb") as f:
        f.write(bytes(out))
