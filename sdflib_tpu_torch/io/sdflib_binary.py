"""Reference-format (.bin) serialization of the approximate octree, the
uniform grid and the exact octree.

A numpy copy of the JAX package's ``io/sdflib_binary.py`` (that module
imports JAX through its ``sdf/`` imports). Reads and writes the
reference's cereal PortableBinaryArchive container (reference:
src/sdf/SdfFunction.cpp:9-79):

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
  EXACT_OCTREE: BoundingBox + i32 startGridSize + u32 startDepth
            + u32 minTrianglesInLeafs + u32 maxTrianglesInLeafs
            + u32 maxTrianglesEncodedInLeafs + u32 bitEncodingStartDepth
            + u32 bitsPerIndex + u32 maxDepth
            + vector<OctreeNode{childrenIndex u32, trianglesArrayIndex u32}>
            + vector<u32> trianglesSets (count-prefixed packed index sets,
              bitsPerIndex bits each, MSB first)
            + vector<u8> trianglesMasks (per-parent-list bitmasks)
            + vector<TriangleData> (37 f32 each: origin 3, mat3 columns 9,
              b 2, c 2, v2 1, v3 2, edgesNormal 9, verticesNormal 9)
            (ExactOctreeSdf.h:138-199)

An array that the reference wrote need not have the builders' aligned
layout; ``OctreeSdf`` then queries it through the walk's
layout-agnostic form. EXACT_OCTREE import decodes the bit encoding into
flat leaf lists in index order (decode: ExactOctreeSdf.cpp:70-175), so
the loaded structure has ``sorted_lists`` false; export re-encodes the
flat lists into the two-tier encoding, byte for byte as the JAX package
writes it. The codec runs on the host.
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
    container gives an ``OctreeSdf``, a GRID one a ``UniformGridSdf``, an
    EXACT_OCTREE one an ``ExactOctreeSdf``)."""
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
        return _load_exact_bin(r, device)
    raise ValueError(f"Unknown SdfFormat {fmt} in {path!r}")


def _decode_packed_set(sets: np.ndarray, start: int, bpi: int):
    """Decode one count-prefixed packed triangle-index set
    (ExactOctreeSdf.cpp:70-87): bpi-bit big-endian indices in a u32
    stream. Returns (ids, the position after the count word)."""
    count = int(sets[start])
    base = start + 1
    if count == 0:
        return np.zeros(0, np.int64), base
    b_idx = np.arange(count, dtype=np.int64) * bpi
    word = b_idx >> 5
    bit = (b_idx & 31).astype(np.uint64)
    w0 = sets[base + word].astype(np.uint64)
    w1 = sets[base + word + 1].astype(np.uint64)
    lo = (w0 << bit) & np.uint64(0xFFFFFFFF)
    ids = (lo >> np.uint64(32 - bpi)) | (w1 >> (np.uint64(64) - (bit + np.uint64(bpi))))
    return ids.astype(np.int64), base


def _load_exact_bin(r: _Reader, device):
    """Decode a reference EXACT_OCTREE container into an ``ExactOctreeSdf``
    on ``device``: walk the two-word-node tree, expanding the packed sets
    and the per-parent bitmasks into flat leaf lists (index order)."""
    from ..sdf.exact_octree import _LEAF_CHUNK, ExactOctreeSdf

    box_min = r.f32v(3)
    box_max = r.f32v(3)
    start_grid_size = r.i32()
    start_depth = r.u32()
    min_tris = r.u32()
    r.u32()   # maxTrianglesInLeafs
    r.u32()   # maxTrianglesEncodedInLeafs
    bit_start_depth = r.u32()
    bpi = r.u32()
    max_depth = r.u32()
    n_nodes = r.u64()
    nodes = np.frombuffer(r.take(8 * n_nodes), dtype="<u4").reshape(-1, 2)
    # one zero pad word: the packed-set decode always touches word idx + 1
    sets = np.concatenate([r.vec_u32(), np.zeros(1, np.uint32)])
    n_masks = r.u64()
    masks_bits = np.unpackbits(np.frombuffer(r.take(n_masks), dtype=np.uint8))  # MSB first
    n_tris = r.u64()
    tdata = np.frombuffer(r.take(4 * 37 * n_tris), dtype="<f4").reshape(-1, 37)

    IS_LEAF = 1 << 31
    CMASK = IS_LEAF - 1

    # the reference's TriangleData -> SoA; v_world rebuilt through the
    # transposed frame (the transform is orthonormal)
    origin = tdata[:, 0:3]
    transform = tdata[:, 3:12].reshape(-1, 3, 3).transpose(0, 2, 1)  # glm columns
    v2x = tdata[:, 16]
    v3xy = tdata[:, 17:19]
    inv = transform.transpose(0, 2, 1)
    v2w = origin + inv[:, :, 0] * v2x[:, None]
    v3w = origin + np.einsum("tij,tj->ti", inv[:, :, :2], v3xy)
    v_world = np.stack([origin, v2w, v3w], axis=1).astype(np.float32)
    tri = {
        "origin": origin, "transform": transform, "b": tdata[:, 12:14],
        "c": tdata[:, 14:16], "v2x": v2x, "v3xy": v3xy,
        "edges_normal": tdata[:, 19:28].reshape(-1, 3, 3),
        "vertices_normal": tdata[:, 28:37].reshape(-1, 3, 3), "v_world": v_world,
    }

    # walk the tree, materialising each leaf's list
    s = start_grid_size
    cell = (box_max[0] - box_min[0]) / s
    new_nodes: list[np.ndarray] = [np.zeros(s**3, np.uint32)]
    total_words = s**3
    patches: list[tuple[int, int]] = []
    leaf_lists: list[np.ndarray] = []
    leaf_centers: list[np.ndarray] = []
    # (reference node, our slot, depth, centre, inherited list); the start
    # grid is z-major in both layouts
    stack = []
    for z in range(s):
        for y in range(s):
            for x in range(s):
                lin = (z * s + y) * s + x
                center = box_min + cell * (np.array([x, y, z]) + 0.5)
                stack.append((lin, lin, start_depth, center, None))
    child_off = np.array([[(i & 1), (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.float64)

    while stack:
        ridx, slot, depth, center, tri_list = stack.pop()
        word, tri_idx = int(nodes[ridx, 0]), int(nodes[ridx, 1])
        is_leaf = bool(word & IS_LEAF)
        # below the bit-encoding depth every node filters the inherited
        # list by its own mask (ExactOctreeSdf.cpp:108-163); inner nodes at
        # that depth carry a packed set
        if not is_leaf and depth == bit_start_depth:
            tri_list, _ = _decode_packed_set(sets, tri_idx, bpi)
        elif depth > bit_start_depth:
            n = len(tri_list)
            bits = masks_bits[tri_idx * 8 : tri_idx * 8 + n]
            tri_list = tri_list[bits[:n].astype(bool)]
        if is_leaf:
            ids = _decode_packed_set(sets, tri_idx, bpi)[0] if depth <= bit_start_depth else tri_list
            patches.append((slot, len(leaf_lists) | IS_LEAF))
            leaf_lists.append(np.asarray(ids, np.int32))
            leaf_centers.append(center.astype(np.float32))
            continue
        children = word & CMASK
        base = total_words
        new_nodes.append(np.zeros(8, np.uint32))
        total_words += 8
        patches.append((slot, base))
        node_size = cell / (1 << (depth - start_depth))
        for ci in range(8):
            ccenter = center + (child_off[ci] - 0.5) * 0.5 * node_size
            stack.append((children + ci, base + ci, depth + 1, ccenter, tri_list))

    pad = (-total_words) % 64
    if pad:
        new_nodes.append(np.zeros(pad, np.uint32))
    octree = np.concatenate(new_nodes)
    for slot, wordv in patches:
        octree[slot] = wordv

    # CSR spans padded to _LEAF_CHUNK
    counts = np.array([len(l) for l in leaf_lists], np.int64)
    spans = -(-np.maximum(counts, 1) // _LEAF_CHUNK) * _LEAF_CHUNK if len(counts) else np.array(
        [_LEAF_CHUNK], np.int64)
    L = max(len(leaf_lists), 1)
    leaf_offset = np.zeros(L, np.int32)
    leaf_count = np.zeros(L, np.int32)
    if len(leaf_lists):
        leaf_offset[: len(spans)] = np.concatenate([[0], np.cumsum(spans)[:-1]])
        leaf_count[: len(leaf_lists)] = counts
    tri_flat = np.full(int(spans.sum()), -1, np.int32)
    if len(leaf_lists):
        flat_ids = np.concatenate(leaf_lists)
        within = np.arange(flat_ids.size) - np.repeat(np.cumsum(counts) - counts, counts)
        tri_flat[np.repeat(leaf_offset[: len(counts)].astype(np.int64), counts) + within] = flat_ids

    state = {
        "box_min": box_min,
        "box_max": box_max,
        "start_grid_size": np.int32(start_grid_size),
        "max_depth": np.int32(max_depth),
        "min_triangles_per_node": np.int32(min_tris),
        "octree_data": octree,
        "leaf_offset": leaf_offset,
        "leaf_count": leaf_count,
        "tri_flat": tri_flat,
        **{f"tri_{k}": np.array(v, np.float32) for k, v in tri.items()},
    }
    # leaf_centers stays out of the state, so the lists count as unsorted
    # (they keep the reference's index order); the centres are set after
    sdf = ExactOctreeSdf.from_jax_state(state, device=device)
    sdf.leaf_centers = (np.stack(leaf_centers).astype(np.float32) if leaf_centers
                        else np.zeros((1, 3), np.float32))
    return sdf


def _pack_index_set(ids: np.ndarray, bpi: int) -> np.ndarray:
    """Pack triangle ids MSB first at bpi bits each into u32 words, the
    last word zero-padded (the encoding ExactOctreeSdf.cpp:70-87 decodes)."""
    ids = np.asarray(ids, np.int64)
    bits = ((ids[:, None] >> np.arange(bpi - 1, -1, -1)) & 1).astype(np.uint8).reshape(-1)
    bits = np.concatenate([bits, np.zeros((-bits.size) % 32, np.uint8)])
    return np.packbits(bits).view(">u4").astype(np.uint32)


def _save_exact_bin(sdf, out: bytearray) -> None:
    """Encode an ``ExactOctreeSdf`` into the reference's bit-encoded
    container (ExactOctreeSdf.h:138-165 field order). Inner nodes' sets
    are rebuilt bottom-up as sorted unions of their descendants' leaf
    lists, the structure the reference's 8-way merge produces
    (ExactOctreeSdfDepthFirst.h:195-283)."""
    from ..sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK

    octree = np.asarray(sdf.octree_data, np.uint32)
    offs = np.asarray(sdf.leaf_offset)
    cnts = np.asarray(sdf.leaf_count)
    flat = sdf.tri_flat.cpu().numpy()
    T = sdf.triangles.origin.shape[0]
    s = sdf.start_grid_size
    start_depth = sdf.start_depth
    max_depth = sdf.max_depth
    bit_start = max(start_depth, max_depth - 2)
    bpi = max(1, int(np.ceil(np.log2(max(T, 2)))))

    # pass 1: each node's sorted list, children before parents (an
    # explicit post-order walk; the JAX package recurses)
    lists: dict[int, np.ndarray] = {}
    for root in range(s**3):
        todo = [(root, False)]
        while todo:
            slot, expanded = todo.pop()
            word = int(octree[slot])
            if word & IS_LEAF_MASK:
                lid = word & CHILDREN_INDEX_MASK
                lists[slot] = np.sort(flat[offs[lid] : offs[lid] + cnts[lid]].astype(np.int64))
                continue
            base = word & CHILDREN_INDEX_MASK
            if expanded:
                lists[slot] = np.unique(np.concatenate([lists[base + c] for c in range(8)]))
            else:
                todo.append((slot, True))
                todo.extend((base + c, False) for c in range(8))

    # pass 2: the reference's nodes, sets and masks, breadth first
    ref_nodes: list[list[int]] = [[0, 0] for _ in range(s**3)]
    sets_words: list[np.ndarray] = []
    sets_len = 0
    masks_bytes: list[np.ndarray] = []
    masks_len = 0
    max_encoded = 0

    def emit_set(ids) -> int:
        nonlocal sets_len, max_encoded
        start = sets_len
        packed = _pack_index_set(ids, bpi)
        sets_words.append(np.array([len(ids)], np.uint32))
        sets_words.append(packed)
        sets_len += 1 + len(packed)
        max_encoded = max(max_encoded, len(ids))
        return start

    def emit_mask(parent_list, child_list) -> int:
        nonlocal masks_len
        packed = np.packbits(np.isin(parent_list, child_list))  # MSB first
        masks_bytes.append(packed)
        start = masks_len
        masks_len += len(packed)
        return start

    queue = [(lin, lin, start_depth, None) for lin in range(s**3)]
    qi = 0
    while qi < len(queue):
        slot, ref_idx, depth, parent_list = queue[qi]
        qi += 1
        word = int(octree[slot])
        is_leaf = bool(word & IS_LEAF_MASK)
        node = ref_nodes[ref_idx]
        tri_idx = 0
        if (is_leaf and depth <= bit_start) or (not is_leaf and depth == bit_start):
            tri_idx = emit_set(lists[slot])
        elif depth > bit_start:
            tri_idx = emit_mask(parent_list, lists[slot])
        if is_leaf:
            node[0] = 0x80000000
            node[1] = tri_idx
            continue
        child_base = len(ref_nodes)
        ref_nodes.extend([[0, 0] for _ in range(8)])
        node[0] = child_base
        node[1] = tri_idx
        our_base = word & CHILDREN_INDEX_MASK
        nxt_parent = lists[slot] if depth >= bit_start else None
        for c in range(8):
            queue.append((our_base + c, child_base + c, depth + 1, nxt_parent))

    all_counts = cnts[: max(len(offs), 1)]
    out += struct.pack("<i", _FMT_EXACT)
    out += np.asarray(sdf.box.min, "<f4").tobytes()
    out += np.asarray(sdf.box.max, "<f4").tobytes()
    out += struct.pack("<i", s)
    out += struct.pack("<I", start_depth)
    out += struct.pack("<I", int(sdf.min_triangles_per_node))
    out += struct.pack("<I", int(all_counts.max(initial=0)))
    out += struct.pack("<I", int(max_encoded))
    out += struct.pack("<I", bit_start)
    out += struct.pack("<I", bpi)
    out += struct.pack("<I", max_depth)
    nodes_arr = np.asarray(ref_nodes, np.uint32)
    out += struct.pack("<Q", len(nodes_arr))
    out += nodes_arr.astype("<u4").tobytes()
    sets_arr = np.concatenate(sets_words) if sets_words else np.zeros(0, np.uint32)
    out += struct.pack("<Q", len(sets_arr))
    out += sets_arr.astype("<u4").tobytes()
    masks_arr = np.concatenate(masks_bytes) if masks_bytes else np.zeros(0, np.uint8)
    out += struct.pack("<Q", len(masks_arr))
    out += masks_arr.tobytes()

    # TriangleData records (37 f32 each; glm's mat3 stored column-major)
    tris = {k: v.cpu().numpy() for k, v in sdf.triangles._asdict().items()}
    rec = np.zeros((T, 37), "<f4")
    rec[:, 0:3] = tris["origin"]
    rec[:, 3:12] = tris["transform"].transpose(0, 2, 1).reshape(T, 9)
    rec[:, 12:14] = tris["b"]
    rec[:, 14:16] = tris["c"]
    rec[:, 16] = tris["v2x"]
    rec[:, 17:19] = tris["v3xy"]
    rec[:, 19:28] = tris["edges_normal"].reshape(T, 9)
    rec[:, 28:37] = tris["vertices_normal"].reshape(T, 9)
    out += struct.pack("<Q", T)
    out += rec.tobytes()


def save_sdflib_bin(sdf, path: str) -> None:
    """Write a reference-compatible .bin container of an ``OctreeSdf``, a
    ``UniformGridSdf`` or an ``ExactOctreeSdf``."""
    from ..sdf.exact_octree import ExactOctreeSdf
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
    elif isinstance(sdf, ExactOctreeSdf):
        _save_exact_bin(sdf, out)
    else:
        raise NotImplementedError(f".bin export not supported for {type(sdf).__name__}")
    with open(path, "wb") as f:
        f.write(bytes(out))
