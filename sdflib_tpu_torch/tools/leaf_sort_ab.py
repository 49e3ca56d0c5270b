"""leaf-sort-ab: the leaf sort's design knobs timed against each other on
one card.

    python -m sdflib_tpu_torch.tools.leaf_sort_ab [--variants a,b,...] [--sizes 16,18,...]

Each variant is a copy of this checkout's package with
``csrc/exact_descend.cu`` (and, where the tile changes, ``SORT_TILE`` in
``ops/exact_query.py``) rewritten (``VARIANTS``); "base" is the checkout
itself. Every variant's kernels are built at once, then each runs in a
process of its own, twice, in turns (base, variants, variants reversed,
base). A process makes the d6 and d7 batches of ``chip_smoke.py`` in
miniature: a leaf grid of random ids below 145,636 (depth 6) or
2,052,765 (depth 7) leaves and 2^k uniform points (seed 0), holds the
sort ``torch.equal`` to ``torch.sort(keys, stable=True)`` (diagnostic
variants, whose output is wrong by design, skip that), and prints one
``leaf_sort_ab`` JSON line: at each size, CUDA events best of 5 after a
warm-up, and the profiler's device ms a call of the key launch, the
digit passes and the memset.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CU = "csrc/exact_descend.cu"
_PY = "ops/exact_query.py"
# name -> [(file under the package, pattern, replacement)]: each pattern
# must match at least once. Names ending in "?" are diagnostics that take
# a piece of the work out: their output is wrong, or unstable, by design,
# and their stores are clamped into the output.
_CLAMP = (_CU, r"const unsigned at = place\[digit_of\(k, shift, width\)\] \+ i;",
          "const unsigned at = min(place[digit_of(k, shift, width)] + i, "
          "static_cast<unsigned>(P - 1));")
VARIANTS = {
    "base": [],
    "items8": [(_CU, r"kSortItems = 16;", "kSortItems = 8;"),
               (_PY, r"SORT_TILE = 4096", "SORT_TILE = 2048")],
    "occupancy3": [(_CU, r"__launch_bounds__\(kSortThreads\)\n    leaf_sort_pass_kernel",
                    "__launch_bounds__(kSortThreads, 3)\n    leaf_sort_pass_kernel")],
    "key-blocks2": [(_CU, r"std::min\(steps, 4 \* sms\)", "std::min(steps, 2 * sms)")],
    # a look-back that finds a tile not yet published sleeps before it reads again
    "backoff100": [(_CU, r"(        else if \(now - spin_start > kSpinLimitNs\) __trap\(\);)",
                    r"\1\n        __nanosleep(100);")],
    # each lane its own group: no match instruction, counts racing
    "no-match?": [(_CU, r"__match_any_sync\(kFull, d\)", "(1u << lane)"), _CLAMP],
    # no tile waits for the earlier ones: every tile writes as if first
    "no-lookback?": [(_CU, r"if \(tile > 0\) \{\n    int at", "if (false) {\n    int at"),
                     _CLAMP],
    # the key launch counts no digit: every digit starts at 0
    "no-hist?": [(_CU, r"atomicAdd\(&count\[plan\.off\[p\] \+ digit_of\(key, plan\.shift\[p\], "
                       r"plan\.width\[p\]\)\], 1u\);", "(void)key;"), _CLAMP],
}
# "phases": each digit pass's block 0 thread records the global timer
# when the block starts, has its tile, has ranked it, has looked back, and
# ends, a row a tile, read back through an entry of its own
# (``sdf_leaf_sort_phases``); the output is right.
_PHASE_TABLE = 1 << 14
VARIANTS["phases"] = [
    (_CU, r"(  if \(threadIdx\.x == 0\) tile_index = static_cast<int>\(atomicAdd\(tile_counter, 1u\)\);)",
     r"  const unsigned long long t0 = global_ns();\n\1"),
    (_CU, r"(  const int tile = tile_index;)", r"\1\n  const unsigned long long t1 = global_ns();"),
    (_CU, r"(  __syncthreads\(\);\n)(  // each digit's count in the tile)",
     r"\1  const unsigned long long t2 = global_ns();\n\2"),
    (_CU, r"(  __syncthreads\(\);\n  block_exclusive_scan\(place, R\);)",
     r"  const unsigned long long t3 = global_ns();\n\1"),
    (_CU, r"(    else vals_out\[at\] = sm\.tile\.val\[i\];\n  \}\n)\}",
     r"\1  if (threadIdx.x == 0 && tile < %d) {\n"
     r"    unsigned long long* row = g_phase[shift == 0 ? 0 : 1][tile];\n"
     r"    row[0] = t0; row[1] = t1; row[2] = t2; row[3] = t3; row[4] = global_ns();\n"
     r"  }\n}" % _PHASE_TABLE),
    (_CU, r"(constexpr unsigned long long kSpinLimitNs = 2000000000ull;)",
     r"\1\n__device__ unsigned long long g_phase[2][%d][5];" % _PHASE_TABLE),
    (_CU, r"\Z", "\nextern \"C\" int sdf_leaf_sort_phases(void* out) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));\n}\n"),
]
DEFAULT = ("base", "items8", "occupancy3", "key-blocks2", "backoff100", "no-match?",
           "no-lookback?", "no-hist?", "phases")
# the structures' leaf counts and depths, as chip_smoke.py's paths A and B
CELLS = {"d6": (145_636, 6), "d7": (2_052_765, 7)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="leaf-sort-ab")
    p.add_argument("--variants", default=",".join(DEFAULT),
                   help="comma-separated names of VARIANTS")
    p.add_argument("--sizes", default="16,18,20,21,22",
                   help="comma-separated k: batches of 2^k points")
    return p


def _tree(name: str, where: str) -> str:
    """The checkout of variant ``name``: this one for "base", else a copy
    of its package under ``where`` with the variant's rewrites."""
    if not VARIANTS[name]:
        return _ROOT
    tree = os.path.join(where, re.sub(r"\W", "_", name))
    shutil.copytree(os.path.join(_ROOT, "sdflib_tpu_torch"),
                    os.path.join(tree, "sdflib_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for src, pattern, repl in VARIANTS[name]:
        path = os.path.join(tree, "sdflib_tpu_torch", src)
        with open(path) as f:
            text, n = re.subn(pattern, repl, f.read())
        if n == 0:
            raise RuntimeError(f"variant {name}: {pattern!r} matches nothing in {src}")
        with open(path, "w") as f:
            f.write(text)
    return tree


def probe(name: str, tree: str, sizes) -> None:
    """One process's line for variant ``name`` in the checkout ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdflib_tpu_torch.ops import exact_query as eq

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    out = {"variant": name}
    for cell, (L, depth) in CELLS.items():
        grid = torch.as_tensor(rng.integers(0, L, 8 ** depth).astype(np.int32), device=dev)
        bits = eq.sort_bits(L)
        box = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
        for k in sizes:
            pts = torch.as_tensor(rng.uniform(0.0, 1.0, (1 << k, 3)).astype(np.float32),
                                  device=dev)
            run = lambda: eq.launch_leaf_sort(pts, grid, box, depth, bits)
            if not name.endswith("?"):
                keys = eq.exact_descend_plain(pts, grid, torch.zeros(3, device=dev),
                                              torch.ones(3, device=dev), depth)
                want, got = torch.sort(keys, stable=True), run()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise RuntimeError(f"{name}: the sort differs from torch.sort at "
                                       f"{cell} 2^{k}")
            run()
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
            parts = {"keys": 0.0, "passes": 0.0, "memset": 0.0}
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA:
                    continue
                part = ("keys" if "leaf_sort_keys" in e.key else
                        "passes" if "leaf_sort_pass" in e.key else
                        "memset" if "Memset" in e.key else None)
                if part:
                    parts[part] += e.self_device_time_total / 3e3
            out[f"{cell} 2^{k}"] = {"ms": best, **parts, "device": sum(parts.values())}
            if name == "phases":
                out[f"{cell} 2^{k}"]["phases"] = _phases(run, -(-(1 << k) // eq.SORT_TILE))
    print("leaf_sort_ab " + json.dumps(out))


def _phases(run, tiles: int) -> dict:
    """One more sort under the "phases" variant: for each digit pass, over
    its tiles, the median and 90th percentile (us) of the wait for the
    tile, the ranking, the look-back and the rest, the last tile's start
    and the pass's span from the first start."""
    import ctypes

    import torch

    from sdflib_tpu_torch.kernels import build

    run()
    torch.cuda.synchronize()
    table = np.zeros((2, _PHASE_TABLE, 5), np.uint64)
    build.check(build.library().sdf_leaf_sort_phases(ctypes.c_void_p(table.ctypes.data)),
                "sdf_leaf_sort_phases")
    res = {}
    for p in range(2):
        t = table[p, : min(tiles, _PHASE_TABLE)].astype(np.float64) / 1e3
        steps = np.diff(t, axis=1)
        res[f"pass {p}"] = {
            **{f"{what} med/p90": [float(np.median(steps[:, i])),
                                   float(np.percentile(steps[:, i], 90))]
               for i, what in enumerate(("tile", "rank", "lookback", "rest"))},
            "last start": float(t[:, 0].max() - t[:, 0].min()),
            "span": float(t[:, 4].max() - t[:, 0].min()),
        }
    return res


def main(argv=None) -> int:
    from .exact_ab import _build_all

    args = build_parser().parse_args(argv)
    names = ["base", *(n for n in args.variants.split(",") if n != "base")]
    work = tempfile.mkdtemp(prefix="sdf_leaf_sort_ab_")
    try:
        trees = {name: _tree(name, work) for name in names}
        _build_all(sorted(set(trees.values())))
        rest = [n for n in names if n != "base"]
        for name in ["base", *rest, *rest[::-1], "base"]:
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--probe", name,
                                  trees[name], args.sizes], capture_output=True, text=True,
                                 timeout=600)
            print(run.stdout, end="")
            if run.returncode != 0:
                raise RuntimeError(f"the probe of {name} failed:\n{run.stderr[-4000:]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        probe(sys.argv[2], sys.argv[3], [int(k) for k in sys.argv[4].split(",")])
    else:
        sys.exit(main())
