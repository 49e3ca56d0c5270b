"""exact-ab: the leaf sort, K7, K9 and the exact query timed in checkouts of
the port, in turns, on one card.

    python -m sdflib_tpu_torch.tools.exact_ab PARENT [--pairs N] [--variants]

PARENT is another checkout of the repo (for example a ``git archive`` of
the parent commit, unpacked). A first process builds ``chip_smoke.py``'s
path A (d6) and path B (d7) exact structures, profiles each structure's
query as built and again after a save and load (the device activities a
call by name, both ways), and saves them beside their points. Each checkout then runs in processes of its own, in turns:
``--pairs`` pairs of PARENT and this one, the first of a pair taking
turns (with ``--variants``, the variants after the first pair and again,
in the reverse order, before the last). Each process prints one
``exact_ab`` JSON line: the query first (CUDA events best and median of
``QUERY_REPS`` calls, host time a call, busy ms, device activities a
call by name, K1's device ms in it; each profile after a discarded
warm-up call), then the key and its sort as the query runs them (the
leaf sort; in a package without it, K8 and ``torch.sort`` of its int32
keys: events, device time of every activity, host time), then K9 and K7
as the query launches them
(``chip_smoke._exact_times``: events, device and host time; K7 also at
the identity order), ``torch.index_select``, and where the query takes
the window scan, K1w's device time right after K7's gradient form.

``--variants`` adds copies of this checkout with L2 cache hints taken
out of K7's and K9's sources (``HINT_VARIANTS``), one set at a time;
their processes skip the host-bound 2^16 batch. Every checkout's
kernels are built before the first process starts, all at once.

A package that predates the lean launches (``launch_exact_finish``) is
timed through its public wrappers.
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
import time

import numpy as np

# chip_smoke.py's path A and path B structures: torus (nu, nv), depth,
# start depth, bucket byte budget; and the batches (structure, points,
# whether the variants run it)
STRUCTURES = {"d6": (96, 48, 6, 2, None), "d7": (420, 120, 7, 3, 8 << 30)}
BATCHES = (("d6", 1 << 21, True), ("d6", 1 << 16, False), ("d7", 1 << 20, True))
QUERY_REPS = 200
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LOADS = (r"hint::load\(([^;]*?), once\)", r"__ldg(\1)")
# name -> [(file under the package, pattern, replacement)]
# (``copy_with_rewrites``)
HINT_VARIANTS = {
    "k7-loads": [("csrc/exact_finish.cu", *_LOADS)],
    "k7-stores": [("csrc/exact_finish.cu", r"hint::store2\(([^,;]+), ([^,;]+), ([^,;]+), keep\)",
                   r"*reinterpret_cast<float2*>(\1) = make_float2(\2, \3)"),
                  ("csrc/exact_finish.cu", r"hint::store\(([^,;]+), ([^,;]+), keep\)",
                   r"*(\1) = \2")],
    "k7-pair": [("csrc/exact_finish.cu", r"hint::store2\(([^,;]+), ([^,;]+), ([^,;]+), keep\)",
                 r"hint::store(\1, \2, keep); hint::store(\1 + 1, \3, keep)")],
    "k9-loads": [("csrc/exact_descend.cu", *_LOADS)],
}
HINT_VARIANTS["none"] = (HINT_VARIANTS["k7-loads"] + HINT_VARIANTS["k7-stores"]
                         + HINT_VARIANTS["k9-loads"])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="exact-ab")
    p.add_argument("parent", help="another checkout of the repo")
    p.add_argument("--pairs", type=int, default=10,
                   help="processes of the parent and of this checkout, each")
    p.add_argument("--variants", action="store_true",
                   help="also time this checkout with L2 hints taken out")
    return p


def copy_with_rewrites(where: str, name: str, rewrites, root: str = _ROOT) -> str:
    """A copy of ``root``'s package under ``where`` (in a directory named
    after ``name``), each (file under the package, pattern, replacement) of
    ``rewrites`` applied; every pattern must match at least once. Returns
    the copy's checkout. The A/B tools' variants (``HINT_VARIANTS``,
    ``leaf_sort_ab.VARIANTS``, ``chip_smoke.CULL_VARIANTS``) are made so."""
    tree = os.path.join(where, re.sub(r"\W", "_", name))
    shutil.copytree(os.path.join(root, "sdflib_tpu_torch"),
                    os.path.join(tree, "sdflib_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for src, pattern, repl in rewrites:
        path = os.path.join(tree, "sdflib_tpu_torch", src)
        with open(path) as f:
            text, n = re.subn(pattern, repl, f.read())
        if n == 0:
            raise RuntimeError(f"variant {name}: {pattern!r} matches nothing in {src}")
        with open(path, "w") as f:
            f.write(text)
    return tree


def run_in_turns(names, argv, parent: bool, timeout: int = 900) -> None:
    """``argv(name)`` run in a process each, in turns: "parent" (where
    ``parent``), "base", the other ``names``, the same reversed, "base",
    "parent"; prints each process's output as it ends and raises on the
    first that fails."""
    rest = [n for n in names if n != "base"]
    ends = ["parent"] if parent else []
    for name in [*ends, "base", *rest, *rest[::-1], "base", *ends]:
        run = subprocess.run(argv(name), capture_output=True, text=True, timeout=timeout)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            raise RuntimeError(f"the probe of {name} failed:\n{run.stderr[-4000:]}")


def _build_all(trees) -> None:
    """Every checkout's kernel library, built at once (one process each)."""
    jobs = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                              " from sdflib_tpu_torch.kernels import build; build.library()",
                              tree], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for tree in trees]
    for tree, job in zip(trees, jobs):
        out, err = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"the kernels of {tree} did not build:\n{err[-4000:]}")


def _query_ms(fn, reps: int) -> tuple[float, float]:
    """(best, median) CUDA-event ms of ``reps`` calls after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return min(ms), float(np.median(ms))


def _profile(cs, fn, label: str) -> dict:
    """The query's busy ms, device activities a call (by name) and device
    ms by kernel, from ``chip_smoke.breakdown``."""
    parts, named = dict.fromkeys(cs.EXACT_PARTS), {}
    _, busy, acts = cs.breakdown(fn, label, top=0, device_ms=parts, activities=named,
                                 warm=True)
    return {"busy": busy, "activities": acts, "by kernel": parts,
            "by name": {k[:70]: v for k, v in sorted(named.items())}}


def _public_runs(sdf, x, eq) -> dict:
    """``chip_smoke._exact_runs`` through the public wrappers, for a
    package without the lean launches."""
    import torch

    q, order, lid_s, pts_s, win = x["q"], x["order"], x["lid_s"], x["pts_s"], x["win"]
    P = q.shape[0]
    runs = {}
    for mode in ("window", "grouped"):
        rows = (lid_s, sdf.leaf_row0, sdf.leaf_nchunks) if mode == "window" else ()
        size = P + (-P) % 32 if mode == "window" else P
        runs[f"K9 {mode}"] = (lambda rows=rows, size=size: eq.exact_sorted_gather(
            q, order, *rows, size=size), "exact_sorted_gather_kernel")
    identity = torch.arange(P, device=q.device)
    for grad in (False, True):
        form = "gradient" if grad else "distance"
        for name, o in ((f"K7 {form}", order), (f"K7 {form} identity", identity)):
            runs[name] = (lambda o=o, grad=grad: eq.exact_finish(
                pts_s, win, o, sdf._finish_table, sdf._box_min, sdf._box_size3, sdf._fallback,
                with_gradient=grad), "exact_finish_kernel")
    return runs


def probe(tree: str, store: str, quick: bool) -> None:
    """One process's line for the checkout ``tree`` on the structures and
    points ``main`` saved in ``store`` (``quick``: no 2^16 batch)."""
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.append(_ROOT)
    import torch

    import chip_smoke as cs
    import sdflib_tpu_torch
    from sdflib_tpu_torch import SdfFunction
    from sdflib_tpu_torch.ops import exact_query as eq
    from sdflib_tpu_torch.ops import scan

    dev = torch.device("cuda", 0)
    out = {"package": os.path.dirname(sdflib_tpu_torch.__file__)}
    sdfs = {}
    for name, n, in_quick in BATCHES:
        if quick and not in_quick:
            continue
        if name not in sdfs:
            sdfs[name] = SdfFunction.load(os.path.join(store, f"{name}.npz"), device=dev)
        sdf = sdfs[name]
        pts = torch.as_tensor(np.load(os.path.join(store, f"{name}_pts.npy"))[:n], device=dev)
        label = f"{name} 2^{n.bit_length() - 1}"
        query = lambda: sdf.get_distance(pts)
        t = {}
        t["query"], t["query median"] = _query_ms(query, QUERY_REPS)
        t["query host us"] = cs._host_us(query, reps=QUERY_REPS)
        t["query profile"] = _profile(cs, query, f"{label}, {tree}")
        t["query scan"] = sdf.last_scan_stats["scan"]
        window = t["query scan"] == "window"
        if window:
            t["gradient query"], t["gradient query median"] = _query_ms(
                lambda: sdf.get_distance_and_gradient(pts), QUERY_REPS)
        x = cs._exact_inputs(sdf, pts)
        if hasattr(eq, "launch_leaf_sort"):
            bits = eq.sort_bits(sdf.num_leaves)
            sort = lambda: eq.launch_leaf_sort(x["q"], sdf._leaf_grid, sdf._box_host,
                                               sdf.max_depth, bits)
        else:
            sort = lambda: torch.sort(eq.exact_descend(x["q"], sdf._leaf_grid, sdf._box_min,
                                                       sdf._box_size3, sdf.max_depth),
                                      stable=True)
        t["key and sort"], t["key and sort device"] = cs._timed(sort, "")
        t["key and sort host us"] = cs._host_us(sort)
        lean = hasattr(eq, "launch_exact_finish")
        runs = cs._exact_runs(sdf, x) if lean else _public_runs(sdf, x, eq)
        t.update(cs._exact_times(runs, x))
        if window:                 # K1w right after K7's gradient form
            pts_w, b0, nc, _ = sdf._sorted_windows(x["q"])
            k7 = runs["K7 gradient"][0]
            parts = {"exact_finish_kernel": 0.0, "scan_window_kernel": 0.0}
            cs.breakdown(lambda: (k7(), scan.scan_window(sdf.bucket_ids, sdf.bucket_fields,
                                                         pts_w, b0, nc)),
                         f"{label}, K7 gradient then K1w", top=0, device_ms=parts)
            t["K1w after K7 gradient device"] = parts["scan_window_kernel"]
            t["K1w alone device"] = cs._device_ms(
                lambda: scan.scan_window(sdf.bucket_ids, sdf.bucket_fields, pts_w, b0, nc),
                ("scan_window_kernel",))
        out[label] = t
    print("exact_ab " + json.dumps(out))


def _structures(store: str) -> None:
    """Path A's d6 and path B's d7 structures, built here, each query
    profiled as built and after a save and load, saved with its points."""
    import torch

    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    from sdflib_tpu_torch import ExactOctreeSdf, SdfFunction
    from sdflib_tpu_torch.utils.primitives import make_torus

    dev = torch.device("cuda", 0)
    for name, (nu, nv, depth, start, budget) in STRUCTURES.items():
        mesh = make_torus(R=0.3, r=0.12, nu=nu, nv=nv)
        box = mesh.bounding_box.add_margin(0.14)
        t0 = time.perf_counter()
        sdf = ExactOctreeSdf(mesh, box, max_depth=depth, start_depth=start,
                             min_triangles_per_node=32, bucket_byte_budget=budget, device=dev)
        print(f"exact_ab: {name} built in {time.perf_counter() - t0:.1f} s")
        n = max(n for s, n, _ in BATCHES if s == name)
        pts = cs._uniform(box, n, 0, dev)
        path = os.path.join(store, f"{name}.npz")
        sdf.save(path)
        np.save(os.path.join(store, f"{name}_pts.npy"), pts.cpu().numpy())
        loaded = SdfFunction.load(path, device=dev)
        rows = {}
        for how, s in (("built", sdf), ("loaded", loaded), ("built again", sdf)):
            rows[how] = _profile(cs, lambda: s.get_distance(pts), f"{name} 2^{n.bit_length() - 1}, "
                                 f"{how}")
        print("exact_ab structures " + json.dumps({name: rows}))
        del sdf, loaded
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    parent = os.path.abspath(args.parent)
    work = tempfile.mkdtemp(prefix="sdf_exact_ab_")
    try:
        store = os.path.join(work, "store")
        os.makedirs(store)
        variants = ([copy_with_rewrites(work, name, rw) for name, rw in HINT_VARIANTS.items()]
                    if args.variants else [])
        t0 = time.perf_counter()
        _build_all([parent, _ROOT, *variants])
        print(f"exact_ab: {2 + len(variants)} checkouts' kernels built in "
              f"{time.perf_counter() - t0:.1f} s")
        sub = subprocess.run([sys.executable, os.path.abspath(__file__), "--structures", store],
                             capture_output=True, text=True, timeout=900)
        print(sub.stdout, end="")
        if sub.returncode != 0:
            raise RuntimeError(f"the structures failed:\n{sub.stderr[-4000:]}")
        turns = [tree for i in range(args.pairs)
                 for tree in ((parent, _ROOT) if i % 2 == 0 else (_ROOT, parent))]
        turns[2:2] = variants
        turns[-2:-2] = variants[::-1]
        for tree in turns:
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--probe", tree,
                                  store, "1" if tree in variants else "0"],
                                 capture_output=True, text=True, timeout=900)
            print(run.stdout, end="")
            if run.returncode != 0:
                raise RuntimeError(f"the probe of {tree} failed:\n{run.stderr[-4000:]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        probe(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
    elif sys.argv[1:2] == ["--structures"]:
        _structures(sys.argv[2])
    else:
        sys.exit(main())
