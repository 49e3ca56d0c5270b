"""Dependency-free PNG writer (stb_image_write replacement).

A copy of the JAX package's ``render/image.py``, held bit-equal to it by
tests/test_torch_mesh_triangle.py.

The reference tools write PNGs via stb (ImageQueryTime/main.cpp:255-403);
this writes 8-bit RGB/RGBA/grayscale PNGs with zlib from the stdlib.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "to_u8"]


def to_u8(img) -> np.ndarray:
    """Clamp a float [0,1] image to uint8."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """img: (H, W), (H, W, 1), (H, W, 3) or (H, W, 4); float [0,1] or u8."""
    arr = to_u8(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    raw = b"".join(
        b"\x00" + arr[row].tobytes() for row in range(h)
    )
    compressed = zlib.compress(raw, 6)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", compressed))
        f.write(chunk(b"IEND", b""))
