"""K3a and K3b: row-fetch probes, the rate at which the card fetches rows.

Given (N,) row ids into a (NB, W) float32 table, fetch each row and
return its minimum. ``row_min_block`` launches K3a (``csrc/row_gather.cu``,
replacing scripts/perf_pallas_gather.py:_blk_kernel, one warp a row) and
``row_min_tile`` K3b (replacing :_dma_kernel, ``tile`` rows a CTA through
a ring of asynchronous copies) for CUDA tensors; both take
``row_min_plain`` for CPU tensors, the counterpart of the script's
``xla_gather_min``. The kernels clamp row ids outside [0, NB), where the
plain version raises. ``row_min_tile`` raises on ``N % tile != 0``, where
the TPU kernel's ``grid=(n // tile,)`` drops the ragged tail.
``block_launch_count`` and ``tile_launch_count`` count kernel launches.

The probes are not on the query path: their rate over the exact octree's
field table bounds K1's row stream (``chip_smoke.py``).

On the card, ``python -m sdflib_tpu_torch.ops.row_gather`` reproduces the
script's command line and defaults (``--nb 2^19 --w 512 --n 2^19 --tile
512``, seed 0) and prints each version's time and rate.
"""
from __future__ import annotations

import argparse

import torch

from ..kernels import build

__all__ = [
    "row_min_plain", "row_min_block", "row_min_tile",
    "block_launch_count", "tile_launch_count",
]

block_launch_count = 0
tile_launch_count = 0
_MAX_SMEM = 232_448   # bytes of shared memory a CTA may use on Hopper


def row_min_plain(table, rows):
    """(N,) minimum of each fetched row of the (NB, W) table."""
    return table[rows.long()].amin(dim=1)


def _check(table, rows):
    if table.ndim != 2 or table.dtype != torch.float32:
        raise ValueError("table must be a (NB, W) float32 tensor")
    if rows.ndim != 1 or rows.dtype != torch.int32:
        raise ValueError("rows must be a (N,) int32 tensor")
    if rows.device != table.device:
        raise ValueError("table and rows must be on one device")
    if table.device.type == "cpu":
        return False
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.shape[1] % 4 or table.shape[1] == 0 or table.data_ptr() % 16:
        raise ValueError("the kernels need W % 4 == 0 and a 16-byte aligned table")
    if table.shape[0] == 0:
        raise ValueError("the table has no rows")
    return True


def row_min_block(table, rows):
    """K3a: (N,) row minima, one warp a row."""
    if not _check(table, rows):
        return row_min_plain(table, rows)
    table, rows = table.contiguous(), rows.contiguous()
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=table.device)
    build.launch("sdf_row_min_block", table.device, table.data_ptr(), table.shape[0],
                 table.shape[1], rows.data_ptr(), rows.shape[0], out.data_ptr())
    build.count_launch(globals(), "block_launch_count")
    return out


def row_min_tile(table, rows, *, tile: int = 512):
    """K3b: (N,) row minima, ``tile`` rows a CTA by asynchronous copies.
    N must be a multiple of ``tile``."""
    if tile <= 0 or rows.shape[0] % tile:
        raise ValueError(f"N = {rows.shape[0]} is not a multiple of tile = {tile}")
    if not _check(table, rows):
        return row_min_plain(table, rows)
    table, rows = table.contiguous(), rows.contiguous()
    if build.library().sdf_row_min_tile_smem(table.shape[1]) > _MAX_SMEM:
        raise ValueError(f"rows of {table.shape[1]} floats overflow the tile ring")
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=table.device)
    build.launch("sdf_row_min_tile", table.device, table.data_ptr(), table.shape[0],
                 table.shape[1], rows.data_ptr(), rows.shape[0], tile, out.data_ptr())
    build.count_launch(globals(), "tile_launch_count")
    return out


def _best_ms(fn, iters: int = 5) -> float:
    """Best of ``iters`` calls after a warmup (CUDA events), ms."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main(argv=None) -> None:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nb", type=int, default=1 << 19, help="table rows")
    ap.add_argument("--w", type=int, default=512, help="row width (f32)")
    ap.add_argument("--n", type=int, default=1 << 19, help="fetches")
    ap.add_argument("--tile", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("row_gather: no CUDA device")
    dev = torch.device("cuda", 0)

    rng = np.random.default_rng(0)
    table = torch.as_tensor(
        rng.standard_normal((args.nb, args.w), dtype=np.float32), device=dev
    )
    rows = torch.as_tensor(rng.integers(0, args.nb, args.n).astype(np.int32), device=dev)
    ref = row_min_plain(table, rows)
    gb = args.n * args.w * 4 / 1e9
    print(f"device: {torch.cuda.get_device_name(0)}")
    for name, fn in (
        ("plain gather", lambda: row_min_plain(table, rows)),
        ("row_min_block", lambda: row_min_block(table, rows)),
        ("row_min_tile", lambda: row_min_tile(table, rows, tile=args.tile)),
    ):
        if not torch.equal(fn(), ref):
            raise RuntimeError(f"{name} disagrees with row_min_plain")
        ms = _best_ms(fn)
        print(f"{name:13s}: {ms:8.3f} ms  {args.n / ms / 1e3:8.1f} M rows/s  "
              f"{gb / ms * 1e3:8.1f} GB/s")


if __name__ == "__main__":
    main()
