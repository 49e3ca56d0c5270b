#!/usr/bin/env python3
"""Smoke test of sdflib_tpu_torch on one CUDA GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It
builds the CUDA kernels from ``sdflib_tpu_torch/csrc`` (the first run of
a checkout compiles them with nvcc) and drives the exact-octree paths:

* ptxas's registers and spills of each kernel, and the branches in K2's
  machine code (``<true>``: the instance for points in Morton order, with
  the branching ladder; ``<false>``: points as given, select ladder);
* K2 against its plain version at the oracle's 10k points, the gradient
  batch's 4k and 2^20 points (the approximate builders' sweep, checked on
  its first 2^16), with its grid of point tiles x triangle slices, timed
  in both point orders and the Morton sort alone;
* the bench torus of bench.py (9,216 triangles, box margin 0.14), the
  port's own depth-6 region build, ``get_distance`` on 2^21 uniform
  points (seed 0, the window scan), and the 10k-point oracle gate (seed
  7) against the brute-force ``RealSdf`` through the grouped scan, which
  sparse batches take, and again with the window scan pinned;
* K1w against its plain version at d6 2^21 and 2^16 points, with its
  rows visited and active-lane share;
* K1g against its plain version at d6 2^16 and d7 2^20 points, with its
  work (groups holding points, rows fetched, the shares of slots with an
  id and of rows with a dead half), its bound and its fetch floor: its
  own row stream through the faster K3 probe;
* both scans pinned at 2^16 to 2^21 points;
* the depth-7 cell: the 100,800-triangle torus of bench.py's big mesh,
  start depth 3, 2^20 uniform points (the grouped scan) and its oracle
  gate, K2 and its Morton-code kernel at the d7 oracle's shape (10k x
  100,800), and K1w on the 2^20 points (checked on the first 2^16 of
  their windows);
* the row-fetch probes K3a/K3b at the defaults of
  scripts/perf_pallas_gather.py and over the rows each K1 mode fetches;
* main path C, the approximate octree at bench.py's configuration
  (bench.py:117-149): the bench torus, ``OctreeSdf(max_depth=6,
  start_depth=2, termination_threshold=1e-3)`` built by "no_continuity"
  and by "continuity" (each seeds its lattice through K2), each held to
  the JAX package's words and leaves per depth and to its error against
  ``RealSdf`` on the 10k oracle points; ``build_query_grid``; the three
  query routes held to each other on 2^16 points; ``get_distance`` and
  ``get_distance_and_gradient`` timed on 2^22 uniform points (seed 1)
  beside their bound from bytes; and the compiled reference's goldens
  (its walk over ``octree_torus.bin``, its two builders' ``.bin``) loaded
  through the port's ``io`` and queried on the card. K2 is held against
  its plain version at the seed lattice's shape (125 x 9,216);
* main path D, the sphere tracer at bench.py's configuration
  (bench.py:151-187): path C's no_continuity octree after
  ``build_query_grid``, 1024^2 rays from z = -1.2 along +z,
  ``max_iters=1024``, eps 1e-5, far 4; rays/s (best of 3 after a warmup)
  beside the frame's bound from bytes, the hits, rounds, ray-trips, the
  device activities and a ``breakdown`` of a frame; the hits held to a
  plain host march through ``get_distance`` on every 16th ray, to
  ``RealSdf`` (q95 below 8e-3) and to the trace without a beam; then a
  512^2 camera frame in sdf_render's defaults shaded five ways (written
  as PNGs to a temporary directory) and a 512^2 plane cut;
* main path E, the uniform grid: ``UniformGridSdf(depth=7)`` on the bench
  torus (128^3 corners) by BASIC init (K2 over every corner) and by
  OCTREE init (K1 through a depth-6 exact octree), the two held to each
  other and to ``RealSdf`` at 10k corners, queries timed on 2^22 points
  beside their bound, the GRID ``.bin`` round trip bit-equal, and K2 held
  against its plain version at 2^21 x 9,216.

Each kernel is held against its plain torch version on the card and
timed beside it with CUDA events (best of 3 after a warmup). Launch
counts are reset before each path and read after it. Every phase raises
on failure, so the exit code is non-zero then, and without a CUDA device.
The line before the last lists every kernel as JSON; the last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

BENCH_LEAVES = 145_636     # leaf count of the JAX package's d6 build
BIG_LEAVES = 2_097_152     # ... and of its d7 build (BIGMESH_r05.json)
ORACLE_TOL = 1e-5
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and device-memory bytes per second.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Flops counted from the kernels' code, rsqrt as one: a triangle frame
# from 9 vertex floats (edges 6, three normalisations 3 x (5 + 1) and
# 2 x (3 + 1), the normal and sy 9 each, the projected vertices 15, the
# edge directions 6), and one point against a derived frame (offset 3,
# projection 15, the region ladder's common terms 12 and its cheapest
# return 4). K2's packed rows hold the frame, so it pays the second only.
FLOPS_FRAME = 78
FLOPS_PAIR = 34
ROW_BYTES = 64 * 4 + 9 * 64 * 4    # one bucket row: 64 ids + 576 floats
ROW_BYTES_HALF = 9 * 32 * 4        # the fields of 32 slots of a row

# The JAX package's approximate octrees at path C's configuration, built
# on the CPU by scripts/approx_reference_jax.py: octree words, leaves per
# depth, re-opened leaves, and rms / 95th percentile of |octree - RealSdf|
# on the 10k oracle points (seed 7).
APPROX_REF = {
    "no_continuity": dict(words=243_136, leaves={2: 24, 3: 232, 4: 548, 5: 1008, 6: 1920},
                          rms=4.3180485954508185e-4, q95=8.57540697325021e-4),
    "continuity": dict(words=320_640, leaves={2: 24, 3: 360, 4: 756, 5: 1392, 6: 2560},
                       rms=4.3823750456795096e-4, q95=8.72185395564884e-4, reopened=170),
}
# Leaves per depth may stray 5% from the JAX build's, words and leaves in
# all 1%: many of the torus's midpoints sit on exact nearest-triangle
# ties (its symmetry planes), where the last ulp picks one of two mirror
# triangles, and with it one of two mirror gradients, for the children's
# fits; that moves leaves between depths (no_continuity: 41 of 1,008 at
# depth 5) and hardly changes the totals (scripts/approx_build_ties.py).
APPROX_DEPTH_TOL = 0.05
# One query point's bytes through the grid route: the point in, its grid
# row (8 B), its leaf's 64 coefficients, the distance out; the gradient
# writes 12 B more.
APPROX_POINT_BYTES = 12 + 8 + 64 * 4 + 4
APPROX_GRAD_BYTES = APPROX_POINT_BYTES + 12
GOLDEN = os.path.join("tests", "golden", "data")
# One march step's bytes on the fused-row route, counted from
# render/sphere_trace.py (_grid_distance_and_step and _march): the
# position (12 B) and direction (12 B) in, the fused row's two-word
# header (8 B) and 64 coefficients (256 B), and the state written back:
# position 12, accumulated distance 4, last distance 4, active flag 4.
TRACE_STEP_BYTES = 12 + 12 + 8 + 64 * 4 + 12 + 4 + 4 + 4
# One uniform-grid query point: the point in and the distance out (the
# gradient writes 12 B more); the grid itself counts once per call.
GRID_POINT_BYTES = 12 + 4
GRID_GRAD_BYTES = GRID_POINT_BYTES + 12


def _cuda_ms(fn, reps: int = 3) -> float:
    """Best of ``reps`` timed calls (CUDA events, after one warmup), ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) for the work, and which of bytes or operations
    sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _instance(mangled: str) -> str:
    """The bool template argument of a mangled kernel name, if any."""
    return "<true>" if "ILb1E" in mangled else "<false>" if "ILb0E" in mangled else ""


def _sass_branches(so_path, short: str) -> str:
    """Instruction, branch (BRA) and convergence-barrier (BSSY) counts in
    the machine code of each kernel whose name holds ``short``."""
    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return "cuobjdump not found"
    out = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                         text=True).stdout
    found = []
    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        if short in name:
            code = [ln for ln in part.splitlines() if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
            found.append(f"{short}{_instance(name)} {len(code)} instructions, "
                         f"{sum(' BRA' in ln for ln in code)} BRA, "
                         f"{sum('BSSY' in ln for ln in code)} BSSY")
    return "; ".join(found) or "not found"


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from sdflib_tpu_torch.ops import nearest, row_gather, scan

    scan.launch_count = scan.grouped_launch_count = nearest.launch_count = 0
    nearest.morton_launch_count = 0
    row_gather.block_launch_count = row_gather.tile_launch_count = 0


def read_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from sdflib_tpu_torch.ops import nearest, row_gather, scan

    return {
        "nearest": nearest.launch_count,
        "nearest_morton": nearest.morton_launch_count,
        "scan_window": scan.launch_count,
        "scan_grouped": scan.grouped_launch_count,
        "row_min_block": row_gather.block_launch_count,
        "row_min_tile": row_gather.tile_launch_count,
    }


def k2_vs_plain(pts, fields, tris, label, n_check=None):
    """K2 against its plain version on the first ``n_check`` points
    (all by default): squared distances equal, index ties agree by
    signed distance; then both timed. (max |sq diff|, kernel ms, plain
    ms, bound)."""
    import torch

    from sdflib_tpu_torch.ops import nearest
    from sdflib_tpu_torch.ops.point_triangle import gather_triangles, signed_dist_pair

    n_check = pts.shape[0] if n_check is None else n_check
    bk, ik = nearest.nearest_triangle(pts, fields)
    tiles_p, S = nearest.last_grid
    q = pts[:n_check]
    bk, ik = bk[:n_check], ik[:n_check]
    bp, ip = nearest.nearest_triangle_plain(q, fields)
    torch.cuda.synchronize()
    _check(torch.equal(bk, bp), f"K2 squared distances differ from the plain version's ({label})")
    diff = ik != ip
    if bool(diff.any()):   # last-ulp ties: the signed distances must agree
        dk = signed_dist_pair(q[diff], gather_triangles(tris, ik[diff]))
        dp = signed_dist_pair(q[diff], gather_triangles(tris, ip[diff]))
        _check(bool(((dk - dp).abs() <= 1e-6).all()), f"K2 tie winners disagree ({label})")
    err = float((bk - bp).abs().max())
    ms = _cuda_ms(lambda: nearest.nearest_triangle(pts, fields))
    # the kernel's two point orders, whichever the wrapper takes
    as_given_ms = _cuda_ms(lambda: nearest._launch(pts, fields, None))
    morton_ms = _cuda_ms(lambda: nearest._launch(pts, fields, nearest.morton_order(pts)))
    sort_ms = _cuda_ms(lambda: nearest.morton_order(pts))
    sorts = pts.shape[0] * fields.shape[0] >= nearest.MORTON_PAIRS
    plain_ms = _cuda_ms(lambda: nearest.nearest_triangle_plain(q, fields))
    P, T = pts.shape[0], fields.shape[0]
    bound = _bound(P * 12 + T * 19 * 4 + P * 8, P * T * FLOPS_PAIR)
    print(f"K2 nearest vs plain ({label}): grid {tiles_p} point tiles x {S} slices "
          f"= {tiles_p * S} CTAs; max |sq diff| {err:.3e}, index ties "
          f"{int(diff.sum())} of {n_check} checked; kernel {ms:.4f} ms "
          f"({P * T / ms / 1e6:.3f} G pairs/s; the wrapper takes the "
          f"{'Morton' if sorts else 'given'} order; points as given, select "
          f"ladder {as_given_ms:.4f} ms; Morton order and its sort, branching "
          f"ladder {morton_ms:.4f} ms, of which the sort {sort_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms on "
          f"{n_check} points (P={P}, T={T}); bound {bound[0]:.4f} ms ({bound[1]})")
    return err, ms, plain_ms, bound


def breakdown(fn, label, top=6):
    """Where a call's time goes: CUDA-event time, device and host time
    per call from torch.profiler over 3 calls, the busy share, and the
    kernels with the most device time. Returns (CUDA-event ms, device
    busy ms, device activities a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev_ms = _cuda_ms(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    on_dev = [e for e in avgs if e.device_type == DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total / 3 for e in on_dev}
    host_ms = sum(e.self_cpu_time_total for e in avgs
                  if e.device_type == DeviceType.CPU) / 3e3
    busy_ms = sum(dev_us.values()) / 1e3
    print(f"breakdown, {label}: {ev_ms:.4f} ms a call (CUDA events); device "
          f"busy {busy_ms:.4f} ms ({busy_ms / ev_ms:.1%}), host self time "
          f"under the profiler {host_ms:.4f} ms, "
          f"{sum(e.count for e in on_dev) // 3} device activities a call")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3:.4f} ms ({us / 1e3 / ev_ms:.1%})  {key[:90]}")
    return ev_ms, busy_ms, sum(e.count for e in on_dev) // 3


def _uniform(box, n: int, seed: int, dev):
    """``n`` uniform points (numpy seed) 1e-4 inside ``box``, on ``dev``."""
    import torch

    lo = np.asarray(box.min) + 1e-4
    hi = np.asarray(box.max) - 1e-4
    return torch.as_tensor(
        np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32), device=dev
    )


def approx_path(dev, root: str, n_query: int):
    """Main path C: the approximate octree at bench.py's configuration on
    ``dev``. The counts run from the first build to the last golden
    query; then the routes are held to each other, the queries timed on
    ``n_query`` points and K2 checked at the seed lattice's shape.
    Returns (the path's launch counts, K2's check there)."""
    import torch

    from sdflib_tpu_torch import OctreeSdf, RealSdf
    from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin
    from sdflib_tpu_torch.sdf import octree as oq
    from sdflib_tpu_torch.utils.primitives import make_torus

    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    opts = _uniform(box, 10_000, 7, dev)
    pts = _uniform(box, n_query, 1, dev)

    reset_counts()
    oracle = RealSdf(mesh, device=dev)
    d_ref = oracle.get_distance(opts)
    built = {}
    for alg in ("no_continuity", "continuity"):
        ref = APPROX_REF[alg]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sdf = OctreeSdf(mesh, box, max_depth=6, start_depth=2, termination_threshold=1e-3,
                        init_algorithm=alg, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        st = sdf.build_stats
        leaves = {int(k): int(v) for k, v in sorted(st["leaves_per_depth"].items())}
        words = int(sdf.octree_data.shape[0])
        extra = (f", re-opened {st['resubdivided']}, midpoints clamped "
                 f"{st['midpoints_clamped']}" if alg == "continuity" else
                 f", level chunks queued {st['level_enqueue_s']:.3f} s, waited on and "
                 f"copied back {st['level_device_and_d2h_s']:.3f} s, host epilogue "
                 f"{st['level_host_epilogue_s']:.3f} s")
        print(f"approx build {alg} d6: {build_s:.3f} s, octree words {words} (JAX "
              f"{ref['words']}), leaves per depth {leaves} (JAX {ref['leaves']}), mean "
              f"candidates per node {st['tris_per_node']}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB{extra}")
        _check(abs(words - ref["words"]) <= 0.01 * ref["words"],
               f"{alg}: {words} octree words, >1% from the JAX build's {ref['words']}")
        total, ref_total = sum(leaves.values()), sum(ref["leaves"].values())
        _check(abs(total - ref_total) <= 0.01 * ref_total,
               f"{alg}: {total} leaves, >1% from the JAX build's {ref_total}")
        for depth, n in ref["leaves"].items():
            _check(abs(leaves.get(depth, 0) - n) <= APPROX_DEPTH_TOL * n,
                   f"{alg}: {leaves.get(depth, 0)} leaves at depth {depth}, "
                   f">{APPROX_DEPTH_TOL:.0%} from {n}")
        if alg == "continuity":
            _check(st["resubdivided"] > 0, "the continuity build re-opened no leaf")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sdf.build_query_grid()
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        fat_bytes = sdf._fat_grid.numel() * 4
        print(f"approx query grid {alg}: build_query_grid {grid_s:.3f} s, leaf grid "
              f"{sdf._query_grid.numel() * 4 / 2**20:.1f} MiB, fat grid "
              f"{fat_bytes / 2**20:.1f} MiB ({fat_bytes} B)")

        err = (sdf.get_distance(opts) - d_ref).abs()
        rms = float(err.square().mean().sqrt())
        q95 = float(torch.quantile(err, 0.95))
        print(f"approx accuracy gate {alg}: |octree - RealSdf| on 10000 points: rms "
              f"{rms:.4e} (JAX {ref['rms']:.4e}), q95 {q95:.4e} (JAX {ref['q95']:.4e}), "
              f"max {float(err.max()):.4e}")
        _check(rms <= 4e-3 and q95 <= 8e-3, f"{alg}: rms {rms} / q95 {q95} above 4e-3 / 8e-3")
        _check(abs(rms - ref["rms"]) <= 0.1 * ref["rms"],
               f"{alg}: rms {rms} >10% from the JAX build's {ref['rms']}")
        _check(abs(q95 - ref["q95"]) <= 0.1 * ref["q95"],
               f"{alg}: q95 {q95} >10% from the JAX build's {ref['q95']}")
        built[alg] = sdf

    # the compiled reference's goldens through the port's io, on the card
    # (tests/test_reference_parity.py:147-157, 206-226)
    walk = np.load(os.path.join(root, GOLDEN, "octree_walk.npz"))
    cases = [("octree_torus.bin", walk["points"], walk["dist"], walk["grad"])]
    bld = np.load(os.path.join(root, GOLDEN, "builders_torus.npz"))
    for tag in ("octree_nc", "octree_cont"):
        cases.append((f"builders_{tag}.bin", bld["points"], bld[f"{tag}_dist"],
                      bld[f"{tag}_grad"]))
    for name, gp, gd, gg in cases:
        gold = load_sdflib_bin(os.path.join(root, GOLDEN, name), device=dev)
        q = torch.as_tensor(gp, device=dev)
        d = gold.get_distance(q)
        d2, g = gold.get_distance_and_gradient(q)
        gd, gg = torch.as_tensor(gd, device=dev), torch.as_tensor(gg, device=dev)
        d_err = float(torch.maximum((d - gd).abs().max(), (d2 - gd).abs().max()))
        g_bad = float(((g - gg).norm(dim=-1) > 1e-3).float().mean())
        print(f"approx C++ golden {name}: {q.shape[0]} points, aligned layout "
              f"{gold._fast_layout}, max |d - C++| {d_err:.3e}, share of gradients off "
              f"by >1e-3 {g_bad:.2e}")
        _check(d_err <= 5e-5, f"{name}: distance {d_err} from the C++ walk's, above 5e-5")
        _check(g_bad < 1e-3, f"{name}: {g_bad} of gradients off by >1e-3")
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"launches on main path C (approximate octree): {launches}")
    _check(launches["nearest"] > 0, "nearest was not launched on path C")

    # the three routes on the first 2^16 points, JAX's tolerances
    # (tests/test_octree.py:205-207)
    sdf = built["no_continuity"]
    sub = pts[: 1 << 16]
    kw = dict(num_coeff=sdf.num_coefficients, interpolation=sdf.interpolation,
              with_gradient=True)
    box_args = (sdf._box_min, sdf._box_size3)
    levels = sdf.max_depth - sdf.start_depth
    routes = {
        "walk, aligned": oq._octree_query(sdf._octree_dev, sub, *box_args, sdf.start_grid_size,
                                          sdf.min_border_value, levels=levels, fast=True, **kw),
        "walk, any layout": oq._octree_query(sdf._octree_dev, sub, *box_args,
                                             sdf.start_grid_size, sdf.min_border_value,
                                             levels=levels, fast=False, **kw),
        "grid": oq._octree_query_grid(sdf._octree_dev, sdf._query_grid, sub, *box_args,
                                      sdf.min_border_value, grid_depth=sdf.max_depth, **kw),
        "fat": oq._octree_query_fat(sdf._fat_grid, sub, *box_args, sdf.min_border_value,
                                    grid_depth=sdf.max_depth, **kw),
    }
    d_w, g_w = routes.pop("walk, aligned")
    for name, (d, g) in routes.items():
        dd, gd = float((d - d_w).abs().max()), float((g - g_w).abs().max())
        print(f"approx routes on 2^16 points: {name} vs the aligned walk: max |d| diff "
              f"{dd:.3e}, max |g| diff {gd:.3e}")
        _check(dd <= 1e-6 and gd <= 1e-4, f"route {name} differs from the walk")

    # the query on n_query points: each route timed, then the profiler
    n = pts.shape[0]
    bound = n * APPROX_POINT_BYTES / PEAK_BYTES * 1e3
    bound_g = n * APPROX_GRAD_BYTES / PEAK_BYTES * 1e3
    ms = _cuda_ms(lambda: sdf.get_distance(pts))
    ms_g = _cuda_ms(lambda: sdf.get_distance_and_gradient(pts))
    print(f"approx get_distance d6 {n} points (grid route): {ms:.4f} ms "
          f"({n / ms * 1e3:.4e} q/s); bound {bound:.4f} ms (bytes, "
          f"{APPROX_POINT_BYTES} B a point) = {bound / ms:.1%} of it")
    print(f"approx get_distance_and_gradient d6 {n} points (grid route): {ms_g:.4f} ms "
          f"({n / ms_g * 1e3:.4e} q/s); bound {bound_g:.4f} ms (bytes, "
          f"{APPROX_GRAD_BYTES} B a point) = {bound_g / ms_g:.1%} of it")
    for name, fn in (
        ("walk, aligned", lambda: oq._octree_query(
            sdf._octree_dev, pts, *box_args, sdf.start_grid_size, sdf.min_border_value,
            levels=levels, fast=True, **dict(kw, with_gradient=False))),
        ("fat", lambda: oq._octree_query_fat(
            sdf._fat_grid, pts, *box_args, sdf.min_border_value, grid_depth=sdf.max_depth,
            **dict(kw, with_gradient=False))),
    ):
        r_ms = _cuda_ms(fn)
        print(f"approx distance d6 {n} points, {name} route: {r_ms:.4f} ms "
              f"({n / r_ms * 1e3:.4e} q/s)")
    breakdown(lambda: sdf.get_distance(pts), f"approx get_distance d6 {n} points, grid route",
              top=8)
    breakdown(lambda: sdf.get_distance_and_gradient(pts),
              f"approx get_distance_and_gradient d6 {n} points, grid route", top=8)

    # K2 at the builders' seed lattice: (2^start_depth + 1)^3 x T
    cbox = box.cubified()
    axis = np.arange(5, dtype=np.float32) * np.float32(cbox.size[0] / 4)
    gz, gy, gx = np.meshgrid(axis, axis, axis, indexing="ij")
    lattice = torch.as_tensor(
        (np.stack([gx, gy, gz], -1).reshape(-1, 3) + cbox.min).astype(np.float32), device=dev
    )
    k2 = k2_vs_plain(lattice, oracle.fields, oracle.triangles, "approx seed lattice")
    del built, sdf, routes
    torch.cuda.empty_cache()
    return launches, k2


def _ortho_rays(n: int, dev):
    """bench.py's trace rays (bench.py:159-166): an n x n grid of origins
    on z = -1.2 over [-0.5, 0.5]^2, directions +z, on ``dev``."""
    import torch

    u = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    gu, gv = np.meshgrid(u, u)
    origins = np.stack([gu, gv, np.full_like(gu, -1.2)], -1).astype(np.float32)
    dirs = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), origins.shape).copy()
    return torch.as_tensor(origins, device=dev), torch.as_tensor(dirs, device=dev)


def _plain_march(sdf, origins, dirs, eps: float, far: float, max_iters: int):
    """The reference shader's raycast loop (sdfOctreeRender.comp:392-409)
    on the host: one ``get_distance`` call over the active rays per trip,
    step max(d, 0), hit at d <= eps. eps and far in box units. Returns
    (hit, depth)."""
    import torch

    box_size = float(sdf.box.size[0])
    pos, d_flat = origins.reshape(-1, 3).clone(), dirs.reshape(-1, 3)
    acc = torch.zeros(pos.shape[0], device=pos.device)
    last = torch.full_like(acc, float("inf"))
    active = torch.ones_like(acc, dtype=torch.bool)
    for _ in range(max_iters):
        idx = active.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        d = sdf.get_distance(pos[idx])
        step = d.clamp_min(0.0)
        pos[idx] += d_flat[idx] * step[:, None]
        acc[idx] += step
        last[idx] = d
        active[idx] = (d > eps * box_size) & (acc[idx] < far * box_size)
    return last <= eps * box_size, acc


def trace_path(dev, n_rays: int):
    """Main path D, the sphere tracer at bench.py's configuration
    (bench.py:151-187): path C's no_continuity octree (built here, its
    seed lattice through K2) after ``build_query_grid``, n_rays^2 rays on
    z = -1.2 marching +z, ``max_iters=1024``, eps 1e-5, far 4. The counts
    run from the build to the first frame. Then the frame is timed, its
    bound printed, its hits held to a plain host march, to ``RealSdf`` and
    to the trace without a beam; then a 512^2 camera frame shaded five
    ways and a 512^2 plane cut. Returns the path's launch counts."""
    import tempfile

    import torch

    from sdflib_tpu_torch import OctreeSdf, RealSdf
    from sdflib_tpu_torch.render import (
        Camera,
        ambient_occlusion,
        iteration_heatmap,
        normal_color,
        render_plane_cut,
        shade_lambert,
        soft_shadow,
        trace_octree,
        write_png,
    )
    from sdflib_tpu_torch.utils.primitives import make_torus

    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    origins, dirs = _ortho_rays(n_rays, dev)
    R = origins.shape[0] * origins.shape[1]
    kw = dict(eps=1e-5, far=4.0, max_iters=1024)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdf = OctreeSdf(mesh, box, max_depth=6, start_depth=2, termination_threshold=1e-3,
                    init_algorithm="no_continuity", device=dev)
    sdf.build_query_grid()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stats = {}
    res = trace_octree(sdf, origins, dirs, stats_out=stats, **kw)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"trace path D: octree and query grid built in {build_s:.3f} s; launches on "
          f"main path D: {launches}")
    _check(launches["nearest"] > 0, "nearest was not launched on path D")

    hit = res.hit
    n_hit = int(hit.sum())
    trips = int(res.iterations.sum(dtype=torch.int64))
    _check(res.depth.shape == (n_rays, n_rays) and bool(torch.isfinite(res.depth).all())
           and bool(torch.isfinite(res.normal[hit]).all()), "trace outputs are not finite")
    _check(0 < n_hit < R, f"{n_hit} of {R} rays hit")
    ms = _cuda_ms(lambda: trace_octree(sdf, origins, dirs, **kw))
    bound = trips * TRACE_STEP_BYTES / PEAK_BYTES * 1e3
    print(f"trace d6 {n_rays}^2 rays (beam 4, fused rows): {ms:.4f} ms a frame, "
          f"{R / ms * 1e3:.6e} rays/s; hits {n_hit}; ray-trips (sum of iterations) "
          f"{trips}, max {int(res.iterations.max())} a ray; rounds (iters, marched, "
          f"still active) {stats['rounds']}; bound {bound:.4f} ms (bytes, "
          f"{TRACE_STEP_BYTES} B a ray-trip) = {bound / ms:.2%} of the frame")
    # the frame split: 8 trips over every ray (and the normals) with and
    # without the beam prepass, the later rounds the rest of the frame
    first_ms = _cuda_ms(lambda: trace_octree(sdf, origins, dirs, **dict(kw, max_iters=8)))
    round1_ms = _cuda_ms(lambda: trace_octree(sdf, origins, dirs, beam=None,
                                              **dict(kw, max_iters=8)))
    print(f"trace frame split: beam prepass {first_ms - round1_ms:.4f} ms; the first round "
          f"(8 trips over all {R} rays) and the normals {round1_ms:.4f} ms; the later "
          f"rounds {ms - first_ms:.4f} ms")
    ev_ms, busy_ms, acts = breakdown(lambda: trace_octree(sdf, origins, dirs, **kw),
                                     f"trace d6 {n_rays}^2 rays", top=10)
    print(f"trace d6 {n_rays}^2 rays: {acts} device activities a frame, device busy "
          f"{busy_ms / ev_ms:.1%}")

    # the hits against RealSdf (the fit gate of path C) and a plain host
    # march through get_distance (grid route, beam off) on every 16th ray
    oracle = RealSdf(mesh, device=dev)
    err = oracle.get_distance(res.position[hit]).abs()
    q95 = float(torch.quantile(err, 0.95))
    step = max(n_rays // 64, 1)
    sub_o, sub_d = origins[::step, ::step], dirs[::step, ::step]
    t0 = time.perf_counter()
    hit_p, acc_p = _plain_march(sdf, sub_o, sub_d, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    sub_hit = hit[::step, ::step].reshape(-1)
    agree = float((sub_hit == hit_p).float().mean())
    both = sub_hit & hit_p
    d_err = float((res.depth[::step, ::step].reshape(-1)[both] - acc_p[both]).abs().max())
    print(f"trace hits: |RealSdf| at {n_hit} hits q95 {q95:.4e}, max {float(err.max()):.4e}; "
          f"plain host march of {sub_hit.numel()} rays ({plain_s:.3f} s): hit masks agree "
          f"{agree:.4%}, max |depth diff| on {int(both.sum())} common hits {d_err:.3e}")
    _check(q95 < 8e-3, f"q95 of |RealSdf| at the hits {q95} >= 8e-3")
    _check(agree > 0.998, f"hit masks agree with the plain march on {agree:.4%}")
    _check(d_err <= 1e-3, f"depths differ from the plain march's by {d_err}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nob = trace_octree(sdf, origins, dirs, beam=None, **kw)
    torch.cuda.synchronize()
    nob_s = time.perf_counter() - t0
    agree = float((nob.hit == hit).float().mean())
    both = nob.hit & hit
    d_err = float((nob.depth[both] - res.depth[both]).abs().max())
    print(f"trace without the beam: {nob_s * 1e3:.4f} ms (host clock), ray-trips "
          f"{int(nob.iterations.sum(dtype=torch.int64))}; hit masks agree with beam 4 on "
          f"{agree:.6%} ({int((nob.hit != hit).sum())} rays differ), max |depth diff| "
          f"{d_err:.3e}")
    _check(agree > 0.998, f"beam and no-beam hit masks agree on {agree:.4%}")
    _check(d_err <= 1e-3, f"beam and no-beam depths differ by {d_err}")
    del nob

    # a 512^2 camera frame in sdf_render's defaults, shaded five ways
    area = sdf.get_sample_area()
    center = np.asarray(area.center, np.float64)
    cam = Camera(position=center + np.array([0.6, 0.45, 0.9]) * float(np.linalg.norm(area.size)),
                 target=center, fov_y_deg=45.0)
    co, cd = (torch.as_tensor(a, device=dev) for a in cam.rays(512, 512))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cres = trace_octree(sdf, co, cd, **kw)
    torch.cuda.synchronize()
    cam_s = time.perf_counter() - t0
    light = (0.577, 0.577, 0.577)
    ao = ambient_occlusion(sdf.get_distance, cres.position, cres.normal)
    shadow = soft_shadow(sdf.get_distance, cres.position, light)
    images = {
        "normal": normal_color(cres.normal, cres.hit),
        "lit": shade_lambert(cres.position, cres.normal, cres.hit, light_dir=light,
                             view_dir=cd, ao=ao, shadow=shadow),
        "ao": ao,
        "shadow": shadow,
        "iterations": iteration_heatmap(cres.iterations, kw["max_iters"]),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cut = render_plane_cut(sdf, resolution=512)
    cut_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        for name, img in list(images.items()) + [("plane_cut", cut)]:
            img = img.cpu().numpy() if isinstance(img, torch.Tensor) else img
            _check(bool(np.isfinite(img).all()) and img.min() >= 0.0 and img.max() <= 1.0,
                   f"{name} image is not finite in [0, 1]")
            write_png(os.path.join(tmp, f"{name}.png"), img)
        sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
    print(f"camera frame 512^2 (sdf_render defaults): {cam_s * 1e3:.3f} ms (host clock), "
          f"hits {int(cres.hit.sum())}, ray-trips {int(cres.iterations.sum(dtype=torch.int64))}; "
          f"shaded and written: {sizes}")
    print(f"plane cut 512^2: {cut_s * 1e3:.3f} ms (host clock, image to numpy included)")
    del sdf, res, cres, images, oracle
    torch.cuda.empty_cache()
    return launches


def grid_path(dev):
    """Main path E, the uniform grid: ``UniformGridSdf(depth=7)`` on the
    bench torus (box margin 0.14), 128^3 corners, built by BASIC init (one
    K2 sweep of the corners) and by OCTREE init (K1 through a depth-6
    exact octree); the counts run over both builds. Both are held to each
    other and to ``RealSdf`` at 10k corners, queries timed on 2^22 points
    (seed 1) beside their bound, the GRID .bin round trip held bit-equal,
    and K2 held against its plain version at the corners' shape. Returns
    (the path's launch counts, K2's check there)."""
    import tempfile

    import torch

    from sdflib_tpu_torch import RealSdf, UniformGridSdf
    from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin, save_sdflib_bin
    from sdflib_tpu_torch.utils.primitives import make_torus

    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    reset_counts()
    grids, secs = {}, {}
    for init in ("basic", "octree"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grids[init] = UniformGridSdf(mesh, box, depth=7, init_algorithm=init, device=dev)
        torch.cuda.synchronize()
        secs[init] = time.perf_counter() - t0
        g = grids[init]
        print(f"grid build d7 {init}: {secs[init]:.3f} s, grid {g.grid_size}, "
              f"{g.grid.numel() * 4 / 2**20:.1f} MiB, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"launches on main path E (uniform grid): {launches}")
    for name in ("nearest", "scan_window"):
        _check(launches[name] > 0, f"{name} was not launched on path E")

    basic, octree = grids["basic"], grids["octree"]
    init_diff = float((basic.grid - octree.grid).abs().max())
    # every corner, as the init computes them (z-major)
    gmin = np.asarray(basic.box.min, np.float32)
    xs, ys, zs = (gmin[a] + basic.cell_size * np.arange(k, dtype=np.float32)
                  for a, k in enumerate(basic.grid_size))
    gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
    all_corners = torch.as_tensor(np.stack([gx, gy, gz], -1).reshape(-1, 3), device=dev)
    idx = np.random.default_rng(7).choice(all_corners.shape[0], 10_000, replace=False)
    flat = torch.as_tensor(idx, device=dev)
    oracle = RealSdf(mesh, device=dev)
    d_ref = oracle.get_distance(all_corners[flat])
    real_err = max(float((g.grid.reshape(-1)[flat] - d_ref).abs().max())
                   for g in grids.values())
    print(f"grid gates d7: max |basic - octree| over all corners {init_diff:.3e}; "
          f"max |grid - RealSdf| at 10000 corners {real_err:.3e} (both inits)")
    _check(init_diff <= 1e-5, f"BASIC and OCTREE inits differ by {init_diff}")
    _check(real_err <= 1e-5, f"grid differs from RealSdf by {real_err} at its corners")

    pts = _uniform(basic.box, 1 << 22, 1, dev)
    n = pts.shape[0]
    grid_bytes = basic.grid.numel() * 4
    for label, fn, per_point in (
        ("get_distance", lambda: basic.get_distance(pts), GRID_POINT_BYTES),
        ("get_distance_and_gradient", lambda: basic.get_distance_and_gradient(pts),
         GRID_GRAD_BYTES),
    ):
        ms = _cuda_ms(fn)
        bound = (n * per_point + grid_bytes) / PEAK_BYTES * 1e3
        print(f"grid {label} d7 {n} points: {ms:.4f} ms ({n / ms * 1e3:.4e} q/s); bound "
              f"{bound:.4f} ms (bytes: {per_point} B a point + the {grid_bytes} B grid) "
              f"= {bound / ms:.1%} of it")
    breakdown(lambda: basic.get_distance(pts), f"grid get_distance d7 {n} points")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grid.bin")
        save_sdflib_bin(basic, path)
        back = load_sdflib_bin(path, device=dev)
        nbytes = os.path.getsize(path)
    same = (torch.equal(back.grid, basic.grid) and back.grid_size == basic.grid_size
            and torch.equal(back.get_distance(pts[:1 << 16]), basic.get_distance(pts[:1 << 16])))
    print(f"grid .bin round trip: {nbytes} B, bit-equal {same}")
    _check(same, "the GRID .bin round trip is not bit-equal")

    # K2 at the BASIC init's shape: every corner x every triangle
    k2 = k2_vs_plain(all_corners, oracle.fields, oracle.triangles,
                     "grid BASIC init, 2^21 corners, checked on 2^16", n_check=1 << 16)
    del grids, basic, octree, back, pts, all_corners, oracle
    torch.cuda.empty_cache()
    return launches, k2


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sdflib_tpu_torch")):
        raise SystemExit("chip_smoke: sdflib_tpu_torch not found beside this script")
    sys.path.insert(0, root)

    from sdflib_tpu_torch import ExactOctreeSdf, RealSdf
    from sdflib_tpu_torch.kernels import build
    from sdflib_tpu_torch.ops import nearest, row_gather, scan
    from sdflib_tpu_torch.ops.point_triangle import (
        pack_triangle_fields,
        sq_dist_from_vertex_cols,
    )
    from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data, soa_to_torch
    from sdflib_tpu_torch.utils.primitives import make_torus

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    report = build.ptxas_report()
    for short in ("nearest_kernel", "merge_kernel", "morton_kernel", "scan_window_kernel",
                  "scan_grouped_kernel", "row_min_block_kernel", "row_min_tile_kernel"):
        lines = [(_instance(k), v) for k, v in report.items() if short in k]
        for tag, line in lines or [("", "not reported")]:
            print(f"ptxas {short}{tag}: {line}")
    print(f"SASS {_sass_branches(build.library_path(), 'nearest_kernel')}")
    print(f"SASS {_sass_branches(build.library_path(), 'scan_grouped_kernel')}")
    print(f"SASS {_sass_branches(build.library_path(), 'scan_window_kernel')}")
    print(f"K1g occupancy: {build.library().sdf_scan_grouped_warps_per_sm()} warps an SM")

    def uniform(box, n, seed):
        return _uniform(box, n, seed, dev)

    def scan_work(sdf, pts):
        """(pairs, valid slots of the touched rows, touched rows) of a
        query: each point scans its own leaf's list; each touched row is
        fetched and its frames derived at least once."""
        leaf = sdf._descend(pts)
        cnt = torch.as_tensor(sdf.leaf_count, device=dev).long()
        touched = torch.unique(leaf)
        return (int(cnt[leaf].sum()), int(cnt[touched].sum()),
                int(sdf.leaf_nchunks[touched].sum()))

    def scan_bound(sdf, pts, in_bytes_per_point):
        pairs, slots, rows = scan_work(sdf, pts)
        nbytes = rows * ROW_BYTES + pts.shape[0] * (in_bytes_per_point + 4)
        return _bound(nbytes, pairs * FLOPS_PAIR + slots * FLOPS_FRAME)

    def winner_dist(sdf, pts_s, win):
        v = sdf.triangles.v_world.reshape(-1, 9)[win.long()]
        return sq_dist_from_vertex_cols(
            pts_s[:, 0], pts_s[:, 1], pts_s[:, 2], lambda r: v[:, r]
        ).sqrt()

    def grouped_vs_plain(sdf, pts, label):
        """K1g against its plain version on one batch: (max winner distance
        difference, kernel ms, plain ms)."""
        pts_s, lid_s, start, G, _ = sdf._sorted_groups(pts)
        args = (sdf.bucket_ids, sdf.bucket_fields, pts_s, lid_s, start,
                sdf.leaf_row0, sdf.leaf_nchunks)
        wk = scan.scan_grouped(*args)
        wp = scan.scan_grouped_plain(*args)
        live = sdf.leaf_nchunks[lid_s.long()] > 0
        err = float((winner_dist(sdf, pts_s, wk) - winner_dist(sdf, pts_s, wp))[live]
                    .abs().max())
        _check(err <= 1e-6, f"K1g winner distances differ by {err} ({label})")
        ms = _cuda_ms(lambda: scan.scan_grouped(*args))
        plain_ms = _cuda_ms(lambda: scan.scan_grouped_plain(*args))
        print(f"K1g grouped scan vs plain ({label}): max |winner dist diff| "
              f"{err:.3e}, ids differ {int((wk != wp).sum())}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms (P={pts.shape[0]}, G={G})")
        return err, ms, plain_ms

    def grouped_work(sdf, pts, ms, label):
        """K1g's work and floors on one batch: its bound, the groups that
        hold points out of NG, the rows it fetches (its row stream), the
        share of their slots with an id >= 0 and of rows whose slots 0-31
        or 32-63 are all -1, and its fetch floor, its own row stream
        through the faster K3 probe. Returns the bound."""
        pts_s, lid_s, start, G, _ = sdf._sorted_groups(pts)
        stream = scan.grouped_row_stream(lid_s, start, sdf.leaf_row0, sdf.leaf_nchunks)
        ids = sdf.bucket_ids[stream.clamp(0, sdf.bucket_ids.shape[0] - 1)]
        rows = stream.shape[0]
        lo_dead = (ids[:, :32] < 0).all(1)
        hi_dead = (ids[:, 32:] < 0).all(1)
        live_bytes = (rows * 256 + int((~lo_dead).sum() + (~hi_dead).sum()) * ROW_BYTES_HALF
                      + pts.shape[0] * 16)
        bound = scan_bound(sdf, pts, 12 + 4)
        pad = (-rows) % 512
        padded = torch.cat([stream, stream[:pad]]).int()
        res, _, _ = probe(sdf.bucket_fields, padded,
                          f"K1g's {label} row stream + {pad} wrapped rows")
        floor = min(t for _, t in res.values()) * rows / padded.shape[0]
        print(f"K1g work ({label}): {int((start[1:] > start[:-1]).sum())} groups hold "
              f"points of NG={start.shape[0] - 1} (G={G}); {rows} rows fetched = "
              f"{rows * ROW_BYTES / 1e6:.1f} MB, {rows * ROW_BYTES / ms / 1e6:.1f} GB/s; "
              f"slots with an id >= 0 {float((ids >= 0).float().mean()):.4f}; rows with "
              f"slots 32-63 all -1 {float(hi_dead.float().mean()):.4f}, slots 0-31 all -1 "
              f"{float(lo_dead.float().mean()):.4f}; live-half bytes "
              f"{live_bytes / 1e6:.1f} MB ({live_bytes / PEAK_BYTES * 1e3:.4f} ms)")
        print(f"K1g bound ({label}): {bound[0]:.4f} ms ({bound[1]}), kernel {ms:.4f} ms "
              f"= {bound[0] / ms:.1%} of bound; fetch floor (the faster probe over its "
              f"fields rows, scaled to the unpadded stream) {floor:.4f} ms = "
              f"{floor / ms:.1%} of the kernel's time")
        return bound

    def probe(table, rows, label, counted=False):
        """Both K3 probes against row_min_plain, then timed; with
        ``counted`` the counts restart after the comparison, so they hold
        the timed launches only. ({name: (err, ms)}, plain ms, bound)."""
        ref = row_gather.row_min_plain(table, rows)
        fns = {"row_min_block": lambda: row_gather.row_min_block(table, rows),
               "row_min_tile": lambda: row_gather.row_min_tile(table, rows)}
        errs = {name: float((fn() - ref).abs().max()) for name, fn in fns.items()}
        for name, err in errs.items():
            _check(err == 0.0, f"{name} disagrees with row_min_plain ({label})")
        if counted:
            reset_counts()
        res = {name: (errs[name], _cuda_ms(fn)) for name, fn in fns.items()}
        plain_ms = _cuda_ms(lambda: row_gather.row_min_plain(table, rows))
        n, w = rows.shape[0], table.shape[1]
        uniq = int(torch.unique(rows).numel())
        bound = _bound(uniq * w * 4 + n * 8, n * w)
        parts = [f"{name} {ms:.4f} ms ({n / ms / 1e3:.1f} M rows/s, "
                 f"{n * w * 4 / ms / 1e6:.1f} GB/s)" for name, (_, ms) in res.items()]
        print(f"K3 probes, {label} (N={n}, W={w}, {uniq} distinct rows, tile 512): "
              + ", ".join(parts) + f"; row_min_plain {plain_ms:.4f} ms; bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        return res, plain_ms, bound

    def morton_vs_plain(pts, label):
        """K2's Morton-code kernel against its plain version (codes
        equal), then both timed. (max |code diff|, kernel ms, plain ms,
        bound)."""
        lo, hi = (t.contiguous() for t in torch.aminmax(pts, dim=0))
        ck = nearest.morton_codes(pts, lo, hi)
        cp = nearest.morton_codes_plain(pts, lo, hi)
        _check(torch.equal(ck, cp), f"Morton codes differ from the plain version's ({label})")
        ms = _cuda_ms(lambda: nearest.morton_codes(pts, lo, hi))
        plain_ms = _cuda_ms(lambda: nearest.morton_codes_plain(pts, lo, hi))
        P = pts.shape[0]
        bound = _bound(P * 12 + 24 + P * 4, P * 9)
        print(f"K2 Morton codes vs plain ({label}): equal; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (P={P}); bound {bound[0]:.6f} ms ({bound[1]})")
        return 0.0, ms, plain_ms, bound

    def window_stats(sdf, pts):
        """The sorted windows of a batch, the rows K1w visits (the union of
        each window's point spans: the points are leaf-sorted, so each new
        leaf in a window adds its span) and the share of lanes that need
        each visited row."""
        pts_s, b0, nc, _ = sdf._sorted_windows(pts)
        live = nc > 0
        first = torch.ones_like(live)
        first[1:] = b0[1:] != b0[:-1]
        first[::32] = True
        visit = first & live
        rows = int(nc[visit].sum())
        return pts_s, b0, nc, visit, rows, int(nc[live].sum()) / (32 * max(rows, 1))

    def window_vs_plain(sdf, pts, label, n_check=None):
        """K1w against its plain version on the windows of the first
        ``n_check`` leaf-sorted points (all by default; the plain version
        takes windows one by one, so these are the timed windows), winner
        distances within 1e-6; then timed, the plain version on the
        checked windows. (max diff, kernel ms, plain ms, the windows'
        (sorted points, b0, nc, visited leaf runs, rows visited))."""
        pts_s, b0, nc, visit, rows, share = window_stats(sdf, pts)
        n = pts_s.shape[0] if n_check is None else n_check
        args = (sdf.bucket_ids, sdf.bucket_fields, pts_s, b0, nc)
        wk = scan.scan_window(*args).reshape(-1)[:n]
        check = (sdf.bucket_ids, sdf.bucket_fields, pts_s[:n], b0[:n], nc[:n])
        wp = scan.scan_window_plain(*check).reshape(-1)
        live = nc[:n] > 0
        err = float((winner_dist(sdf, pts_s[:n], wk) - winner_dist(sdf, pts_s[:n], wp))[live]
                    .abs().max())
        _check(err <= 1e-6, f"K1w winner distances differ by {err} ({label})")
        ms = _cuda_ms(lambda: scan.scan_window(*args))
        plain_ms = _cuda_ms(lambda: scan.scan_window_plain(*check))
        print(f"K1w window scan vs plain ({label}): max |winner dist diff| {err:.3e}, "
              f"ids differ {int((wk != wp).sum())} of {n} checked, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms on {n} points (P={pts_s.shape[0]}, "
              f"{pts_s.shape[0] // 32} windows, {rows} rows visited = "
              f"{rows * ROW_BYTES / 1e6:.1f} MB, {rows * ROW_BYTES / ms / 1e6:.1f} GB/s, "
              f"active-lane share {share:.4f})")
        return err, ms, plain_ms, (pts_s, b0, nc, visit, rows)

    kernels = {}
    launches = {}

    # -- K2 against its plain version: 10k points x the bench torus ---------
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    opts = uniform(box, 10_000, 7)
    pts = uniform(box, 1 << 21, 0)
    tris = soa_to_torch(calculate_mesh_triangle_data(mesh), dev)
    fields = pack_triangle_fields(tris)
    k2_err, k2_ms, k2_plain_ms, k2_bound = k2_vs_plain(opts, fields, tris, "d6 oracle")
    kernels["nearest"] = dict(err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound=k2_bound)
    k2_err4, _, _, _ = k2_vs_plain(opts[:4000], fields, tris, "d6 gradient batch")
    k2_err20, _, _, _ = k2_vs_plain(uniform(box, 1 << 20, 1), fields, tris,
                                    "2^20 points, checked on 2^16", n_check=1 << 16)
    kernels["nearest"]["err"] = max(k2_err, k2_err4, k2_err20)

    # -- main path A, d6: build, dense query, oracle gates -------------------
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdf = ExactOctreeSdf(mesh, box, max_depth=6, start_depth=2,
                         min_triangles_per_node=32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cnt = sdf.leaf_count
    print(f"exact build d6: {build_s:.3f} s, leaves {sdf.num_leaves}, mean list "
          f"{cnt.mean():.3f}, max list {int(cnt.max())}, buckets "
          f"{sdf.bucket_bytes / 2**20:.1f} MB, splits "
          f"{sdf.build_stats['build_splits']}")
    _check(abs(sdf.num_leaves - BENCH_LEAVES) <= 0.05 * BENCH_LEAVES,
           f"leaf count {sdf.num_leaves} is >5% from {BENCH_LEAVES}")

    for n, want in ((1 << 16, "grouped"), (1 << 18, "grouped"), (1 << 21, "window")):
        d = sdf.get_distance(pts[:n])
        torch.cuda.synchronize()
        _check(d.shape == (n,) and bool(torch.isfinite(d).all()),
               f"get_distance output on {n} points is not finite (P,)")
        took = sdf.last_scan_stats
        _check(took["scan"] == want, f"{n} points took the {took['scan']} scan")
        print(f"scan choice d6: {n} points -> {took['scan']} (G={took['G']}, "
              f"padded {sdf._padded_batch(n)} vs 4 x {sdf.num_leaves} leaves)")

    oracle = RealSdf(mesh, device=dev)
    d_ref = oracle.get_distance(opts)
    gates = {}
    for impl in (None, "xla_window"):
        if impl is not None:
            sdf.set_scan_impl(impl)
        d_ex = sdf.get_distance(opts)
        gates[sdf.last_scan_stats["scan"]] = float((d_ex - d_ref).abs().max())
    sdf._default_scan_impl()
    d_g, g_ex = sdf.get_distance_and_gradient(opts[:4000])
    _check(sdf.last_scan_stats["scan"] == "grouped", "the gradient batch took the window scan")
    d_gr, g_ref = oracle.get_distance_and_gradient(opts[:4000])
    g_err = float((d_g - d_gr).abs().max())
    stable = d_gr.abs() > 1e-3
    g_bad = float(((g_ex - g_ref).norm(dim=-1)[stable] > 1e-3).float().mean())
    torch.cuda.synchronize()
    launches["d6"] = read_counts()
    print(f"oracle gate d6: max |exact - RealSdf| on 10000 points: grouped scan "
          f"{gates['grouped']:.3e}, window scan {gates['window']:.3e}; gradient "
          f"path on 4000: max dist err {g_err:.3e}, gradient mismatch share {g_bad:.2e}")
    for name, err in gates.items():
        _check(err <= ORACLE_TOL, f"oracle max error {err} > {ORACLE_TOL} ({name} scan)")
    _check(g_err <= ORACLE_TOL, f"gradient-path distance error {g_err}")
    _check(g_bad < 5e-3, f"gradient mismatch share {g_bad}")
    print(f"launches on main path A (d6): {launches['d6']}")
    for name in ("nearest", "scan_window", "scan_grouped"):
        _check(launches["d6"][name] > 0, f"{name} was not launched on path A")

    # -- K1w against its plain version on the 2^21 bench points -------------
    k1_err, k1_ms, k1_plain_ms, (pts_s, b0, nc, visit, rows) = window_vs_plain(
        sdf, pts, "d6 2^21")
    kernels["scan_window"] = dict(err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
                                  bound=scan_bound(sdf, pts, 12 + 8))
    print(f"K1w bound d6 2^21: {kernels['scan_window']['bound'][0]:.4f} ms "
          f"({kernels['scan_window']['bound'][1]})")
    # the rows K1w fetches, in its order, as one stream for the probes
    lens = nc[visit].long()
    offs = torch.arange(rows, device=dev) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens)
    k1_stream = (torch.repeat_interleave(b0[visit].long(), lens) + offs).int()

    # -- K1g against its plain version on 2^16 d6 points --------------------
    g_err6, g_ms6, g_plain6 = grouped_vs_plain(sdf, pts[: 1 << 16], "d6, 2^16 points")
    g_bound6 = grouped_work(sdf, pts[: 1 << 16], g_ms6, "d6 2^16")
    w_err6, w_ms6, _, _ = window_vs_plain(sdf, pts[: 1 << 16], "d6 2^16")
    print(f"K1w on the same 2^16 points: {w_ms6:.4f} ms ({w_ms6 / g_ms6:.2f}x K1g)")
    kernels["scan_window"]["err"] = max(k1_err, w_err6)
    kernels["scan_grouped"] = dict(err=g_err6, ms=g_ms6, plain_ms=g_plain6, bound=g_bound6)

    # -- both scans pinned, d6 ----------------------------------------------
    for n in (1 << k for k in range(16, 22)):
        q = pts[:n]
        row = []
        for impl, name in (("xla", "grouped"), ("xla_window", "window")):
            sdf.set_scan_impl(impl)
            ms = _cuda_ms(lambda: sdf.get_distance(q))
            row.append(f"{name} {ms:.4f} ms ({n / ms * 1e3:.4e} q/s)")
        print(f"get_distance d6 2^{n.bit_length() - 1} points, scan pinned: "
              + ", ".join(row))
    sdf.set_scan_impl("xla")
    breakdown(lambda: sdf.get_distance(pts[:n]), "d6 2^21 points, grouped scan pinned")
    sdf._default_scan_impl()
    breakdown(lambda: sdf.get_distance(pts[: 1 << 16]), "d6 2^16 points (auto: grouped)")

    # -- end-to-end query timing, kernel path and plain path ----------------
    q_ms = _cuda_ms(lambda: sdf.get_distance(pts))
    q_plain_ms = _cuda_ms(lambda: sdf._query(pts, False, plain=True))
    n = pts.shape[0]
    print(f"get_distance d6 2^21 points (auto: window): kernel path {q_ms:.3f} ms "
          f"({n / q_ms * 1e3:.4e} q/s), plain path {q_plain_ms:.3f} ms "
          f"({n / q_plain_ms * 1e3:.4e} q/s)")

    # -- K3a/K3b: the probe script's defaults, then K1w's fetch stream ------
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal((1 << 19, 512), dtype=np.float32),
                            device=dev)
    rows_d = torch.as_tensor(rng.integers(0, 1 << 19, 1 << 19).astype(np.int32),
                             device=dev)
    res_def, plain_def, bound_def = probe(table, rows_d, "script defaults")
    del table, rows_d
    pad = (-k1_stream.shape[0]) % 512
    stream = torch.cat([k1_stream, k1_stream[:pad]])
    res_k1, _, _ = probe(sdf.bucket_fields, stream,
                         f"K1w's 2^21-point fetch stream + {pad} wrapped rows", counted=True)
    launches["probe"] = read_counts()
    print(f"launches on the probe path (K1w's stream): {launches['probe']}")
    for name in ("row_min_block", "row_min_tile"):
        _check(launches["probe"][name] > 0, f"{name} was not launched on the probe path")
        err, ms = res_def[name]
        kernels[name] = dict(err=err, ms=ms, plain_ms=plain_def, library_ms=plain_def,
                             bound=bound_def)
    fetch_ms = min(ms for _, ms in res_k1.values()) * rows / stream.shape[0]
    print(f"K1w achieved row-fetch bound: {fetch_ms:.4f} ms for its {rows} rows "
          f"(faster probe, scaled to the unpadded stream) vs K1w {k1_ms:.4f} ms "
          f"({fetch_ms / k1_ms:.1%} of its time)")
    del sdf, oracle, pts, pts_s, b0, nc, stream, k1_stream
    torch.cuda.empty_cache()

    # -- main path B, the depth-7 cell: 100,800 triangles, 2^20 points ------
    big = make_torus(R=0.3, r=0.12, nu=420, nv=120)
    big_box = big.bounding_box.add_margin(0.14)
    bpts = uniform(big_box, 1 << 20, 0)
    bopts = uniform(big_box, 10_000, 7)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bsdf = ExactOctreeSdf(big, big_box, max_depth=7, start_depth=3,
                          min_triangles_per_node=32, bucket_byte_budget=8 << 30,
                          device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cnt = bsdf.leaf_count
    print(f"exact build d7 ({big.indices.size // 3} triangles): {build_s:.3f} s, "
          f"leaves {bsdf.num_leaves}, mean list {cnt.mean():.3f}, max list "
          f"{int(cnt.max())}, buckets {bsdf.bucket_bytes / 2**20:.1f} MB, splits "
          f"{bsdf.build_stats['build_splits']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _check(abs(bsdf.num_leaves - BIG_LEAVES) <= 0.05 * BIG_LEAVES,
           f"d7 leaf count {bsdf.num_leaves} is >5% from {BIG_LEAVES}")
    d = bsdf.get_distance(bpts)
    torch.cuda.synchronize()
    _check(d.shape == (1 << 20,) and bool(torch.isfinite(d).all()),
           "d7 get_distance output is not finite (P,)")
    _check(bsdf.last_scan_stats["scan"] == "grouped", "the d7 batch took the window scan")
    big_oracle = RealSdf(big, device=dev)
    err7 = float((bsdf.get_distance(bopts) - big_oracle.get_distance(bopts)).abs().max())
    torch.cuda.synchronize()
    launches["d7"] = read_counts()
    print(f"oracle gate d7: max |exact - RealSdf| {err7:.3e} on 10000 points "
          f"({bsdf.last_scan_stats['scan']} scan); launches on main path B (d7): "
          f"{launches['d7']}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _check(err7 <= ORACLE_TOL, f"d7 oracle max error {err7} > {ORACLE_TOL}")
    big_tris = big_oracle.triangles
    k2_err7, _, _, _ = k2_vs_plain(bopts, big_oracle.fields, big_tris, "d7 oracle")
    kernels["nearest"]["err"] = max(kernels["nearest"]["err"], k2_err7)
    m_err, m_ms, m_plain_ms, m_bound = morton_vs_plain(bopts, "d7 oracle")
    kernels["nearest_morton"] = dict(err=m_err, ms=m_ms, plain_ms=m_plain_ms, bound=m_bound)
    for name in ("nearest", "nearest_morton", "scan_grouped"):
        _check(launches["d7"][name] > 0, f"{name} was not launched on path B")
    row = []
    for impl, name in (("xla", "grouped"), ("xla_window", "window")):
        bsdf.set_scan_impl(impl)
        ms = _cuda_ms(lambda: bsdf.get_distance(bpts))
        row.append(f"{name} {ms:.4f} ms ({bpts.shape[0] / ms * 1e3:.4e} q/s)")
    bsdf._default_scan_impl()
    print("get_distance d7 2^20 points, scan pinned: " + ", ".join(row))
    breakdown(lambda: bsdf.get_distance(bpts), "d7 2^20 points (auto: grouped)")
    g_err7, g_ms7, g_plain7 = grouped_vs_plain(bsdf, bpts, "d7, 2^20 points")
    grouped_work(bsdf, bpts, g_ms7, "d7 2^20")
    w_err7, w_ms7, _, _ = window_vs_plain(bsdf, bpts, "d7 2^20, checked on 2^16",
                                          n_check=1 << 16)
    print(f"K1w on the same d7 2^20 points: {w_ms7:.4f} ms ({w_ms7 / g_ms7:.2f}x K1g)")
    kernels["scan_grouped"]["err"] = max(g_err6, g_err7)
    kernels["scan_window"]["err"] = max(kernels["scan_window"]["err"], w_err7)
    del bsdf, big_oracle, big_tris, bpts, bopts
    torch.cuda.empty_cache()

    # -- main path C, the approximate octree at bench.py's configuration ----
    launches["approx"], k2c = approx_path(dev, root, 1 << 22)
    kernels["nearest"]["err"] = max(kernels["nearest"]["err"], k2c[0])

    # -- main path D, the sphere tracer at bench.py's configuration --------
    launches["trace"] = trace_path(dev, 1024)

    # -- main path E, the uniform grid at depth 7 ---------------------------
    launches["grid"], k2e = grid_path(dev)
    kernels["nearest"]["err"] = max(kernels["nearest"]["err"], k2e[0])

    meta = {
        "nearest": ("sdflib_tpu_torch/csrc/nearest.cu",
                    "sdflib_tpu/ops/pallas_kernels.py:50"),
        "nearest_morton": ("sdflib_tpu_torch/csrc/nearest.cu",
                           "sdflib_tpu/ops/pallas_kernels.py:50"),
        "scan_window": ("sdflib_tpu_torch/csrc/scan_window.cu",
                        "sdflib_tpu/ops/pallas_scan.py:56"),
        "scan_grouped": ("sdflib_tpu_torch/csrc/scan_grouped.cu",
                         "sdflib_tpu/ops/pallas_scan.py:255"),
        "row_min_block": ("sdflib_tpu_torch/csrc/row_gather.cu",
                          "scripts/perf_pallas_gather.py:56"),
        "row_min_tile": ("sdflib_tpu_torch/csrc/row_gather.cu",
                         "scripts/perf_pallas_gather.py:80"),
    }
    print(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(counts[name] for counts in launches.values()),
            "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
            "library_ms": k.get("library_ms"),
        }
        for name, k in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
