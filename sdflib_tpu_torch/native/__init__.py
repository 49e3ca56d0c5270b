"""Native C ABI shim: SDF queries on the host without Python tensors.

A copy of the JAX package's ``native/`` (this package imports nothing of
it): a ctypes wrapper over the C++ shared library ``sdflib_c.cpp`` (kept
byte-equal to the JAX package's), the equivalent of the reference's
SdfLibUnity FFI surface (reference: src/tools/SdfLibUnity/
SdfExportFunc.h:16-59). It loads and evaluates the three .bin formats
(GRID / OCTREE / EXACT_OCTREE) with the reference's format-generic
getDistance. Structures are built on the device by this package,
serialized with ``io.sdflib_binary``, and consumed here. The library is
compiled with g++ on first use (a temp file and an atomic rename) and
cached next to the source as ``_sdflib_c.so``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "NativeSdf", "NativeOctreeSdf", "build_native_library",
    "native_available",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sdflib_c.cpp")
_SO = os.path.join(_HERE, "_sdflib_c.so")
_LOCK = threading.Lock()
_LIB = None


def build_native_library(force: bool = False) -> str:
    """Compile the shared library if needed; returns its path."""
    with _LOCK:
        if force or not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            # build into a process-unique temp file + atomic rename so
            # concurrent builders (pytest-xdist workers) never dlopen a
            # half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-fopenmp",
                   "-o", tmp, _SRC]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except subprocess.CalledProcessError:
                # retry without OpenMP (minimal toolchains)
                cmd.remove("-fopenmp")
                subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, _SO)
    return _SO


def native_available() -> bool:
    try:
        _load_lib()
        return True
    except Exception:
        return False


def _load_lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_native_library())
        lib.sdflib_load.restype = ctypes.c_void_p
        lib.sdflib_load.argtypes = [ctypes.c_char_p]
        lib.sdflib_create_from_data.restype = ctypes.c_void_p
        lib.sdflib_create_from_data.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float,
            ctypes.c_int32, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
        ]
        lib.sdflib_format.restype = ctypes.c_int32
        lib.sdflib_format.argtypes = [ctypes.c_void_p]
        lib.sdflib_save.restype = ctypes.c_int
        lib.sdflib_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.sdflib_delete.argtypes = [ctypes.c_void_p]
        lib.sdflib_get_distance.restype = ctypes.c_float
        lib.sdflib_get_distance.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float
        ]
        lib.sdflib_get_distance_gradient.restype = ctypes.c_float
        lib.sdflib_get_distance_gradient.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.sdflib_get_distance_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
        ]
        lib.sdflib_octree_data.restype = ctypes.POINTER(ctypes.c_uint32)
        lib.sdflib_octree_data.argtypes = [ctypes.c_void_p]
        lib.sdflib_octree_data_size.restype = ctypes.c_uint64
        lib.sdflib_octree_data_size.argtypes = [ctypes.c_void_p]
        lib.sdflib_start_grid_size.restype = ctypes.c_int32
        lib.sdflib_start_grid_size.argtypes = [ctypes.c_void_p]
        lib.sdflib_bb_min.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
        ]
        lib.sdflib_bb_size.restype = ctypes.c_float
        lib.sdflib_bb_size.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class NativeSdf:
    """Handle to a C++-evaluated SDF (GRID / OCTREE / EXACT_OCTREE)."""

    def __init__(self, handle: int):
        if not handle:
            raise ValueError("null native SDF handle")
        self._h = ctypes.c_void_p(handle)
        self._lib = _load_lib()

    # -- constructors ----------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "NativeSdf":
        """Load a reference-format .bin container (any format)."""
        h = _load_lib().sdflib_load(path.encode())
        if not h:
            raise IOError(f"failed to load .bin: {path}")
        return cls(h)

    @property
    def format(self) -> str:
        """SdfFormat name (SdfFunction.h:16-22)."""
        return {0: "grid", 1: "octree", 2: "exact_octree"}[
            int(self._lib.sdflib_format(self._h))
        ]

    @classmethod
    def from_octree(cls, octree) -> "NativeSdf":
        """Wrap an in-memory OctreeSdf (tricubic) for native evaluation."""
        if octree.interpolation != "tricubic":
            raise ValueError("native shim evaluates tricubic octrees only")
        data = np.ascontiguousarray(np.asarray(octree.octree_data, np.uint32))
        bb_min = np.asarray(octree.box.min, np.float32)
        h = _load_lib().sdflib_create_from_data(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            data.size,
            bb_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            float(octree.box.size[0]),
            int(octree.start_grid_size),
            int(octree.max_depth),
            float(octree.value_range),
            float(octree.min_border_value),
        )
        return cls(h)

    # -- queries ----------------------------------------------------------------

    def get_distance(self, points) -> np.ndarray:
        pts = np.ascontiguousarray(np.asarray(points, np.float32))
        flat = pts.reshape(-1, 3)
        out = np.empty(flat.shape[0], np.float32)
        self._lib.sdflib_get_distance_batch(
            self._h,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            flat.shape[0],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out.reshape(pts.shape[:-1])

    def get_distance_and_gradient(self, point):
        g = (ctypes.c_float * 3)()
        d = self._lib.sdflib_get_distance_gradient(
            self._h, float(point[0]), float(point[1]), float(point[2]), g
        )
        return float(d), np.array([g[0], g[1], g[2]], np.float32)

    # -- metadata / raw access (engine upload role) ------------------------------

    @property
    def octree_data(self) -> np.ndarray:
        n = self._lib.sdflib_octree_data_size(self._h)
        ptr = self._lib.sdflib_octree_data(self._h)
        if not ptr or n == 0:
            raise ValueError("octree_data is only exposed for OCTREE handles")
        return np.ctypeslib.as_array(ptr, (n,)).copy()

    @property
    def start_grid_size(self) -> int:
        return int(self._lib.sdflib_start_grid_size(self._h))

    @property
    def bb_min(self) -> np.ndarray:
        out = (ctypes.c_float * 3)()
        self._lib.sdflib_bb_min(self._h, out)
        return np.array([out[0], out[1], out[2]], np.float32)

    @property
    def bb_size(self) -> float:
        return float(self._lib.sdflib_bb_size(self._h))

    def save(self, path: str) -> None:
        if self._lib.sdflib_save(self._h, path.encode()) != 0:
            raise IOError(f"failed to save {path}")

    def close(self):
        if self._h:
            self._lib.sdflib_delete(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass


# Backwards-compatible name (the shim originally evaluated OCTREE only).
NativeOctreeSdf = NativeSdf
