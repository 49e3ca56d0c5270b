"""Abstract SDF interface + format-dispatched ``.npz`` serialization.

The same container as the JAX package's ``sdf/sdf_function.py``: an
``.npz`` of the structure's state arrays with a ``__format__`` tag, so a
container saved by either package loads into the other (reference role:
SdfFunction.cpp:9-79). Queries take (..., 3) points and return torch
tensors on the structure's device.
"""
from __future__ import annotations

import abc
from enum import Enum

import numpy as np
import torch

from ..mesh import BoundingBox

__all__ = ["SdfFormat", "SdfFunction", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points run on the card unless the "
            "caller passes device='cpu'"
        )
    return dev


class SdfFormat(str, Enum):
    """The format tags of the JAX package (SdfFunction.h:16-22 role)."""

    GRID = "grid"
    OCTREE = "octree"
    EXACT_OCTREE = "exact_octree"
    OCTREE_TILED = "octree_tiled"
    EXACT_OCTREE_TILED = "exact_octree_tiled"
    NONE = "none"


class SdfFunction(abc.ABC):
    """Base class of every SDF structure."""

    @abc.abstractmethod
    def get_distance(self, points):
        """Batched signed distance. points (..., 3) -> (...)."""

    @abc.abstractmethod
    def get_distance_and_gradient(self, points):
        """Batched signed distance + gradient. -> ((...), (..., 3))."""

    @abc.abstractmethod
    def get_sample_area(self) -> BoundingBox:
        """The region the structure covers."""

    @abc.abstractmethod
    def get_format(self) -> SdfFormat:
        ...

    def _state_arrays(self) -> dict:
        """Subclasses return the numpy arrays/metadata to persist."""
        raise NotImplementedError

    def save(self, path: str) -> None:
        """Save with a leading format tag."""
        state = self._state_arrays()
        state["__format__"] = np.array(self.get_format().value)
        np.savez(path, **state)

    @staticmethod
    def load(path: str, device="cuda", device_mesh=None) -> "SdfFunction":
        """Load a container written by either package onto ``device``. A
        tiled container loads onto ``device_mesh`` (a device list as long
        as the file's shard count); without one, onto every visible card
        for a CUDA ``device`` without an index, else onto ``device``
        alone."""
        device = resolve_device(device)
        with np.load(path, allow_pickle=False) as f:
            state = {k: f[k] for k in f.files}
        if "__format__" not in state:
            raise ValueError(
                f"{path!r} is not an SDF container (missing format tag)"
            )
        fmt = SdfFormat(str(state.pop("__format__")))
        if fmt == SdfFormat.GRID:
            from .grid import UniformGridSdf

            return UniformGridSdf.from_jax_state(state, device=device)
        if fmt == SdfFormat.EXACT_OCTREE:
            from .exact_octree import ExactOctreeSdf

            return ExactOctreeSdf.from_jax_state(state, device=device)
        if fmt == SdfFormat.OCTREE:
            from .octree import OctreeSdf

            return OctreeSdf.from_jax_state(state, device=device)
        if fmt in (SdfFormat.EXACT_OCTREE_TILED, SdfFormat.OCTREE_TILED):
            from ..parallel.mesh import default_mesh
            from ..parallel.tiles import TiledExactOctreeSdf, TiledOctreeSdf

            if device_mesh is None:
                whole = device.type == "cuda" and device.index is None
                device_mesh = default_mesh() if whole else [device]
            cls = TiledExactOctreeSdf if fmt == SdfFormat.EXACT_OCTREE_TILED else TiledOctreeSdf
            return cls(_state=state, device_mesh=device_mesh)
        raise ValueError(f"{path!r} holds no structure (format {fmt.value!r})")
