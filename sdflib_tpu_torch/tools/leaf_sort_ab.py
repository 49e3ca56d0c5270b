"""leaf-sort-ab: the leaf sort's design knobs timed against each other,
and against another checkout's sort, on one card.

    python -m sdflib_tpu_torch.tools.leaf_sort_ab [--variants a,b,...] [--parent PATH]
        [--shapes d6:21,d6:16,d7:20,walk:22]

Each variant is a copy of this checkout's package with
``csrc/exact_descend.cu`` (and, where the tile changes, ``SORT_TILE`` in
``ops/exact_query.py``) rewritten (``VARIANTS``); "base" is the checkout
itself, and ``--parent`` adds another checkout (for example the parent
commit's ``git archive``, unpacked) as "parent". Every tree's kernels are
built at once, then each runs in a process of its own, in turns (parent,
base, the variants, the variants reversed, base, parent). A process makes
the smoke's batches in miniature: a leaf grid of random ids below 145,636
(d6: 18 bits) or 2,052,765 (d7: 21 bits) leaves and 2^k uniform points
(seed 0), or ("walk") 2^k given keys below 4,097 (K11's sort of 12 bits),
holds the sort ``torch.equal`` to ``torch.sort(keys, stable=True)``
(diagnostic variants, whose output is wrong by design, skip that), and
prints one ``leaf_sort_ab`` JSON line: at each shape, CUDA events best of
5 after a warm-up, and the profiler's device ms a call of the key launch,
the digit passes and the memset. "base" also times the yardsticks the
same way: K8 and ``torch.sort(stable=True)`` of its int32 keys, and
``torch.sort`` alone (every device activity of the call).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
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


def _items(n: int):
    return [(_CU, r"kSortItems = 16;", f"kSortItems = {n};"),
            (_PY, r"SORT_TILE = 4096", f"SORT_TILE = {256 * n}")]


VARIANTS = {
    "base": [],
    "items8": _items(8),
    "items12": _items(12),
    "items20": _items(20),
    # the lanes of a digit found by __match_any_sync, not a ballot a bit
    "match-any": [(_CU, r"unsigned m = kFull;", "return __match_any_sync(kFull, d);\n  unsigned m = kFull;")],
    # two blocks an SM
    "occupancy2": [(_CU, r"__launch_bounds__\(kSortThreads, 3\)\n    leaf_sort_pass_kernel",
                    "__launch_bounds__(kSortThreads)\n    leaf_sort_pass_kernel")],
    "key-blocks2": [(_CU, r"std::min\(steps, 4 \* sms\)", "std::min(steps, 2 * sms)")],
    # a look-back that finds a tile not yet published sleeps before it reads again
    "backoff100": [(_CU, r"(        else if \(now - spin_start > kSpinLimitNs\) __trap\(\);)",
                    r"\1\n        __nanosleep(100);")],
    # each lane its own group: no match, counts racing
    "no-match?": [(_CU, r"lanes_alike\(d, width\);", "(1u << lane);"), _CLAMP],
    # no tile waits for the earlier ones: every tile writes as if first
    "no-lookback?": [(_CU, r"if \(tile == 0 \|\| t >= R\) return;", "return;"), _CLAMP],
    # the key launch counts no digit: every digit starts at 0
    "no-hist?": [(_CU, r"atomicAdd\(&count\[plan\.off\[p\] \+ digit_of\(key, plan\.shift\[p\], "
                       r"plan\.width\[p\]\)\], 1u\);", "(void)key;"), _CLAMP],
}
# "phases": thread 0 of each digit pass's blocks records the global timer
# when the block starts, has its tile, has counted and published it, has
# ranked it, has looked back, and ends, a row a tile (``SORT_STAMP`` in the
# source), read back through an entry of its own (``sdf_leaf_sort_phases``);
# the output is right.
_PHASE_TABLE = 1 << 14
_STEPS = ("tile", "count", "rank", "lookback", "rest")
VARIANTS["phases"] = [
    (_CU, r"\A", "__device__ unsigned long long g_phase[4][%d][6];\n"
     "#define SORT_STAMP(s) const unsigned long long stamp_##s = global_ns();\n"
     "#define SORT_STAMPS_OUT() if (threadIdx.x == 0 && tile < %d) { "
     "unsigned long long* row = g_phase[shift / width][tile]; row[0] = stamp_0; "
     "row[1] = stamp_1; row[2] = stamp_2; row[3] = stamp_3; row[4] = stamp_4; "
     "row[5] = stamp_5; }\n" % (_PHASE_TABLE, _PHASE_TABLE)),
    (_CU, r"\Z", "\nextern \"C\" int sdf_leaf_sort_phases(void* out) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));\n}\n"),
]
DEFAULT = ("base", "items8", "items12", "items20", "match-any", "occupancy2",
           "key-blocks2", "backoff100", "no-match?", "no-lookback?", "no-hist?", "phases")
# the structures' leaf counts and depths, as chip_smoke.py's paths A and B;
# "walk": K11's given keys, below rows + 1 = 4,097
CELLS = {"d6": (145_636, 6), "d7": (2_052_765, 7), "walk": (4_097, None)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="leaf-sort-ab")
    p.add_argument("--variants", default=",".join(DEFAULT),
                   help="comma-separated names of VARIANTS")
    p.add_argument("--parent", default=None, help="another checkout, timed as \"parent\"")
    p.add_argument("--shapes", default="d6:21,d6:16,d7:20,walk:22",
                   help="comma-separated cell:k, a batch of 2^k points (keys) of a CELLS cell")
    return p


def _events_ms(run, reps: int = 5) -> float:
    """Best of ``reps`` calls after a warm-up, CUDA events, ms."""
    import torch

    run()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _device_ms(run, part) -> dict:
    """Device ms a call over 3 profiled calls, by ``part(name)`` (None:
    left out), and their sum under "device"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and part(e.key) is not None:
            parts[part(e.key)] = parts.get(part(e.key), 0.0) + e.self_device_time_total / 3e3
    return {**parts, "device": sum(parts.values())}


def _sort_part(key: str):
    return ("keys" if "leaf_sort_keys" in key else "passes" if "leaf_sort_pass" in key else
            "memset" if "Memset" in key else None)


def probe(name: str, tree: str, shapes) -> None:
    """One process's line for variant ``name`` in the checkout ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from sdflib_tpu_torch.ops import exact_query as eq

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    out = {"variant": name, "tree": os.path.abspath(tree)}
    box = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    zero, one = torch.zeros(3, device=dev), torch.ones(3, device=dev)
    for cell, k in shapes:
        L, depth = CELLS[cell]
        bits = eq.sort_bits(L)
        if depth is None:                       # given keys
            keys = torch.as_tensor(rng.integers(0, L, 1 << k).astype(np.int32), device=dev)
            run = lambda: eq.launch_leaf_sort(keys, None, None, 0, bits)
        else:
            grid = torch.as_tensor(rng.integers(0, L, 8 ** depth).astype(np.int32), device=dev)
            pts = torch.as_tensor(rng.uniform(0.0, 1.0, (1 << k, 3)).astype(np.float32),
                                  device=dev)
            keys = eq.exact_descend_plain(pts, grid, zero, one, depth)
            run = lambda: eq.launch_leaf_sort(pts, grid, box, depth, bits)
        if not name.endswith("?"):
            want, got = torch.sort(keys, stable=True), run()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{name}: the sort differs from torch.sort at {cell} 2^{k}")
        row = {"bits": bits, "ms": _events_ms(run), **_device_ms(run, _sort_part)}
        if name == "base":
            yard = {"torch.sort": lambda: torch.sort(keys, stable=True)}
            if depth is not None:
                yard["K8 + torch.sort"] = lambda: torch.sort(
                    eq.exact_descend(pts, grid, zero, one, depth), stable=True)
            for yname, fn in yard.items():
                row[yname] = {"ms": _events_ms(fn),
                              "device": _device_ms(fn, lambda key: "all")["device"]}
        if name == "phases":
            row["phases"] = _phases(run, -(-(1 << k) // eq.SORT_TILE), len(eq._digit_plan(bits)))
        out[f"{cell} 2^{k}"] = row
    print("leaf_sort_ab " + json.dumps(out))


def _phases(run, tiles: int, passes: int) -> dict:
    """One more sort under the "phases" variant: for each digit pass, over
    its tiles, the median and 90th percentile (us) of each step (the wait
    for the tile, the count and its publication, the ranking, the
    look-back, the rest), the last tile's start and the pass's span from
    the first start."""
    import ctypes

    import torch

    from sdflib_tpu_torch.kernels import build

    run()
    torch.cuda.synchronize()
    table = np.zeros((4, _PHASE_TABLE, 6), np.uint64)
    build.check(build.library().sdf_leaf_sort_phases(ctypes.c_void_p(table.ctypes.data)),
                "sdf_leaf_sort_phases")
    res = {}
    for p in range(passes):
        t = table[p, : min(tiles, _PHASE_TABLE)].astype(np.float64) / 1e3
        steps = np.diff(t, axis=1)
        res[f"pass {p}"] = {
            **{f"{what} med/p90": [float(np.median(steps[:, i])),
                                   float(np.percentile(steps[:, i], 90))]
               for i, what in enumerate(_STEPS)},
            "last start": float(t[:, 0].max() - t[:, 0].min()),
            "span": float(t[:, 5].max() - t[:, 0].min()),
        }
    return res


def main(argv=None) -> int:
    from .exact_ab import _build_all, copy_with_rewrites, run_in_turns

    args = build_parser().parse_args(argv)
    names = ["base", *(n for n in args.variants.split(",") if n != "base")]
    work = tempfile.mkdtemp(prefix="sdf_leaf_sort_ab_")
    try:
        trees = {name: copy_with_rewrites(work, name, VARIANTS[name]) if VARIANTS[name] else _ROOT
                 for name in names}
        if args.parent:
            trees["parent"] = os.path.abspath(args.parent)
        _build_all(sorted(set(trees.values())))
        run_in_turns(names, lambda name: [sys.executable, os.path.abspath(__file__), "--probe",
                                          name, trees[name], args.shapes],
                     bool(args.parent), timeout=600)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        probe(sys.argv[2], sys.argv[3],
              [(c, int(k)) for c, k in (s.split(":") for s in sys.argv[4].split(","))])
    else:
        sys.exit(main())
