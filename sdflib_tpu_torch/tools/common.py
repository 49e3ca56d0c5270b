"""Shared CLI helpers for the tool suite.

Port of the JAX package's ``tools/common.py``, plus what every port tool
shares: the ``--device`` flag (the card by default; the JAX tools take
JAX's default backend), container loading by file suffix, and timing with
CUDA events where the JAX tools wait with ``block_until_ready``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..mesh import BoundingBox, Mesh, load_mesh
from ..sdf.sdf_function import resolve_device

__all__ = [
    "load_model",
    "prepare_box",
    "TERMINATION_RULES",
    "add_device_arg",
    "load_sdf",
    "timed",
]

# CLI rule names mirror the reference's stringToTerminationRule
# (OctreeSdf.h:124-144) plus our internal names.
TERMINATION_RULES = {
    "trapezoidal_rule": "trapezoid",
    "trapezoid": "trapezoid",
    "simpsons_rule": "simpson",
    "simpson": "simpson",
    "by_distance_rule": "by_distance",
    "by_distance": "by_distance",
    "none": "none",
}

_MESH_SUFFIXES = (".ply", ".obj", ".stl", ".off")


def load_model(path: str, normalize: bool = False) -> Mesh:
    """Load a mesh; optionally normalize coordinates to a 2-unit cube around
    the origin (SdfExporter/main.cpp:85-92)."""
    mesh = load_mesh(path)
    if normalize:
        bb = mesh.bounding_box
        scale = 2.0 / float(np.max(bb.size))
        v = (mesh.vertices - bb.center) * scale
        mesh = Mesh(v.astype(np.float32), mesh.indices)
    return mesh


def prepare_box(mesh: Mesh, bb_margin_percent: float = 20.0) -> BoundingBox:
    """Model box + margin as a percentage of the max extent
    (SdfExporter/main.cpp:96-98, default 20%)."""
    box = mesh.bounding_box
    margin = (bb_margin_percent / 100.0) * float(np.max(box.size))
    return box.add_margin(margin)


def add_device_arg(p) -> None:
    """The one flag the port's tools add to the JAX tools' flags."""
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain versions of the kernels)")


def load_sdf(path: str, device, mesh_as_real: bool = False):
    """A container by suffix onto ``device``: ``.bin`` (the reference's
    cereal format), else ``.npz``; with ``mesh_as_real`` a mesh file
    becomes its brute-force ``RealSdf``."""
    from ..io.sdflib_binary import load_sdflib_bin
    from ..sdf.real import RealSdf
    from ..sdf.sdf_function import SdfFunction

    if mesh_as_real and path.endswith(_MESH_SUFFIXES):
        return RealSdf(load_mesh(path), device=device)
    if path.endswith(".bin"):
        return load_sdflib_bin(path, device=device)
    return SdfFunction.load(path, device=device)


def timed(fn, device):
    """(fn(), seconds) for a call made after one warm call: CUDA events on
    a CUDA device, the host clock (the result moved to the host) on
    another."""
    device = resolve_device(device)
    fn()
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
        return out, start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    out = fn()
    if isinstance(out, torch.Tensor):
        out = out.cpu()
    return out, time.perf_counter() - t0
