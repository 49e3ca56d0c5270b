"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all
started together, and the objects link into one shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library lands in ``_build/`` inside the
package, named by a hash of the sources and flags: a changed source
rebuilds, an unchanged one loads the existing file, and ptxas's report
of each kernel's registers and spills lies beside it (``ptxas_report``).
Each entry point
launches on the stream it is given and returns ``cudaGetLastError()``;
``launch`` calls one (looked up once a process, ``entry``) on the
current stream of a tensor's card and
``check`` turns a non-zero code into an exception. The wrappers count
their launches through ``count_launch``.

Nothing here runs at import: the CPU-only test machine imports every
module and has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

import torch

__all__ = ["library", "library_path", "entry", "launch", "check", "count_launch", "sm_count",
           "ptxas_report", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

# No --use_fast_math: the region ladder decides regions by sign tests, and
# the kernels must agree with their plain torch versions. --fmad=false
# keeps every a*b+c a separate multiply and add, as the eager torch ops
# compute it, so kernel and plain version round alike.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the leaf grid's leading arguments (ops/octree_query.py grid_args): rows,
# width, coefficients, words, depth, tricubic, box_min, box_size3,
# min_border
_GRID = [_P, _I, _P, _I, _I, _I, _P, _P, _F]
# the walk's leading arguments (ops/walk.py walk_args): words, coefficients,
# W, start grid size, levels, tricubic, fast, box_min, box_size3,
# min_border
_WALK = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _F]
_SIGNATURES = {
    # () -> the most points of the one-launch Morton order on the current card
    "sdf_morton_order_max": [],
    # (points, P, order, stream)
    "sdf_morton_order": [_P, _I, _P, _P],
    # (points, P, box scratch, codes, stream)
    "sdf_morton_codes": [_P, _I, _P, _P, _P],
    # (points, order, P, fields, T, S, scratch, best, idx, stream)
    "sdf_nearest_triangle": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P],
    # (bucket_ids, bucket_fields, num_rows, points, b0, nc, num_windows,
    #  win, stream)
    "sdf_scan_window": [_P, _P, _I, _P, _P, _P, _I, _P, _P],
    # (bucket_ids, bucket_fields, num_rows, points, point_leaf, group_start,
    #  num_groups, leaf_row0, leaf_nrows, win, stream)
    "sdf_scan_grouped": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    # () -> warps of the grouped kernel an SM holds at once
    "sdf_scan_grouped_warps_per_sm": [],
    # (table, num_rows, w, rows, n, out, stream)
    "sdf_row_min_block": [_P, _I, _I, _P, _I, _P, _P],
    # (table, num_rows, w, rows, n, tile, out, stream)
    "sdf_row_min_tile": [_P, _I, _I, _P, _I, _I, _P, _P],
    # (w) -> shared-memory bytes of the tile kernel
    "sdf_row_min_tile_smem": [_I],
    # (grid..., points, n, d, g or null, group, stream)
    "sdf_octree_query": [*_GRID, _P, _I, _P, _P, _I, _P],
    # (grid..., pos, acc, last_d, active, its, dirs, n, eps, far, trips, stream)
    "sdf_march": [*_GRID, _P, _P, _P, _P, _P, _P, _I, _F, _F, _I, _P],
    # (grid..., pos, acc, active, dirs, r0, rd, n, margin, half margin, far,
    #  trips, stream)
    "sdf_beam": [*_GRID, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _I, _P],
    # (points, P, leaf grid, depth, box_min, box_size3, key, stream)
    "sdf_exact_descend": [_P, _I, _P, _I, _P, _P, _P, _P],
    # (points or null, keys or null, P, leaf grid, depth, box_min x y z, box
    #  size x y z, bits, SMs, work, work words, lid_s, order, stream)
    "sdf_leaf_sort": [_P, _P, _I, _P, _I, *[_F] * 6, _I, _I, _P, ctypes.c_longlong, _P, _P,
                      _P],
    # (points, order, P, lid_s, leaf bounds, size, pts_s, b0, nc, stream)
    "sdf_exact_sorted_gather": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P],
    # (pts_s, win, order, P, table, box_min x y z, box size x y z, fallback,
    #  d, g or null, stream)
    "sdf_exact_finish": [_P, _P, _P, _I, _P, *[_F] * 7, _P, _P, _P],
    # (walk..., points, n, mode, group, d, g or null, stream)
    "sdf_walk_query": [*_WALK, _P, _I, _I, _I, _P, _P, _P],
    # (walk..., points, n, gd, gg or null, keys and share or both null, grad
    #  points or null, stream)
    "sdf_walk_keys": [*_WALK, _P, _I, _P, _P, _P, _P, _P, _P],
    # (walk..., lid_s, order, P, share, with gg, grad coeffs, partials, stream)
    "sdf_walk_reduce": [*_WALK, _P, _P, _I, _P, _I, _P, _P, _P],
    # (walk..., points, n, gd, gg or null, grad coeffs or null, grad points
    #  or null, stream)
    "sdf_walk_backward": [*_WALK, _P, _I, _P, _P, _P, _P, _P],
    # (walk..., origins, dirs, n, width, eps, far, max_iters, form, hit, pos,
    #  depth, its, counter, stats or null, stream)
    "sdf_walk_march": [*_WALK, _P, _P, _I, _I, _F, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # (walk..., pos, acc, last_d, active, its, dirs, n, eps, far, trips, stream)
    "sdf_walk_segment": [*_WALK, _P, _P, _P, _P, _P, _P, _I, _F, _F, _I, _P],
    # (walk..., pos, acc, active, dirs, r0, rd, n, margin, half margin, far,
    #  trips, stream)
    "sdf_walk_beam": [*_WALK, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _I, _P],
    # (rows, T, centers, N, cand, cand row stride, valid, valid row stride,
    #  K, h, qh, eps, near, reach, lanes, keep, counts, sqd, stats or null,
    #  stream)
    "sdf_region_cull": [_P, _I, _P, _I, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _I,
                        _F, _F, _F, _F, _F, _I, _P, _P, _P, _P, _P],
}

_lib: ctypes.CDLL | None = None
_so: Path | None = None
_entries: dict[str, ctypes._CFuncPtr] = {}
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _compile() -> Path:
    """The library file of the current sources and flags, compiled when
    it does not exist yet."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = _BUILD / f"libsdf_kernels-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    jobs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    outs = [(job, *job.communicate()) for job in jobs]
    try:
        for job, out, err in outs:
            if job.returncode != 0:
                raise RuntimeError(f"nvcc failed ({job.returncode}):\n{out}\n{err}")
        so.with_suffix(".ptxas.txt").write_text("".join(out + err for _, out, err in outs))
        res = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)
    return so


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sdf_error_string.argtypes = [ctypes.c_int]
    lib.sdf_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, compiled on the first call of the process when
    no build of the current sources exists yet. Threads that make the
    first call together wait for one build."""
    global _lib, _so
    if _lib is not None:
        return _lib
    with _LIB_LOCK:
        if _lib is None:
            so = _compile()
            _lib, _so = _load(so), so
    return _lib


def library_path() -> Path:
    """The file of the loaded kernel library (built if need be)."""
    library()
    return _so


def ptxas_report() -> dict[str, str]:
    """ptxas's resource line of each kernel of the loaded library, by the
    kernel's (mangled) name; empty when the report is missing."""
    path = library_path().with_suffix(".ptxas.txt")
    report, name = {}, None
    for line in path.read_text().splitlines() if path.exists() else []:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name is not None and ("spill" in line or "Used" in line):
            report[name] = (report.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return report


def entry(name: str) -> ctypes._CFuncPtr:
    """The library's entry point ``name``, looked up once a process."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(), name)
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Call the library's entry point ``name`` with ``args`` and the
    current stream of the CUDA ``device`` (read at every call: a CUDA
    graph's capture replaces it), and raise if it returns an error. The
    call enters ``device`` only when it is not the current card, where the
    launch would find the stream of another card."""
    fn = entry(name)
    current = torch.cuda.current_device()
    idx = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == current:
        code = fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            code = fn(*args, stream)
    check(code, name)


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA card (read once a card)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().sdf_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")


def count_launch(counters: dict, name: str) -> None:
    """Add one to a wrapper's launch counter ``counters[name]`` (its
    module's ``globals()``): ``parallel``'s workers launch from several
    threads, and ``+= 1`` on a global is not atomic."""
    with _COUNT_LOCK:
        counters[name] += 1
