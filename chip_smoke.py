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
  in both point orders and the point order alone;
* the bench torus of bench.py (9,216 triangles, box margin 0.14), the
  port's own depth-6 region build, ``get_distance`` on 2^21 uniform
  points (seed 0, the window scan), and the 10k-point oracle gate (seed
  7) against the brute-force ``RealSdf`` through the grouped scan, which
  sparse batches take, and again with the window scan pinned;
* K1w against its plain version at d6 2^21 and 2^16 points, with its
  rows visited and active-lane share;
* K7-K9 and the leaf sort, the exact query's finish, descent key, sort
  and sorted gather (``exact_kernels_vs_plain``), against their plain
  versions at d6 2^21 (window), d6 2^16 and d7 2^20 (grouped), every
  61st point moved out of the box and every 97th winner -1: K8's keys,
  the leaf sort's sorted keys and order (``torch.equal`` to
  ``torch.sort`` of K8's plain keys; also given the node walk's keys)
  and K9's outputs (both modes) equal, K7's distances bit-equal with and
  without the gradient, its gradients within 1e-6, through the public
  wrappers and the lean launches the query calls, each timed as the
  query launches it by CUDA events, the profiler's device time and host
  time a call beside its plain version and bound, the leaf sort beside
  the parent's K8 + ``torch.sort`` and its design's floor, K9 grouped
  beside ``torch.index_select``; at d6 2^21 the leaf sort's edge sweep
  (``leaf_sort_sweep``: 0 to 2^20 + 3 points, 1 to 2^21 + 1 leaves, NaN
  and far points, one leaf, descending keys); the three batches'
  ``get_distance`` (one leaf sort launch a query) beside the query with
  the plain versions of the sort, K9 and K7 (``_query(plain_glue=True)``,
  equal answers, with the gradient too) and the all-plain query, and
  each profiled after a discarded warm-up call (``exact_breakdown``: no
  torch sort kernel, no more device activities a call than 7 for the d6
  2^21 window query and 22 for the grouped ones, d6 and d7; the leaf
  sort, K9, K1 and K7 by name, and every activity's count a call);
* K1g against its plain version at d6 2^16 and d7 2^20 points, with its
  work (groups holding points, rows fetched, the shares of slots with an
  id and of rows with a dead half), its bound and its fetch floor: its
  own row stream through the faster K3 probe;
* both scans pinned at 2^16 to 2^21 points;
* K13, the exact build's region cull (one launch a node group): path A's
  and path B's builds launch it once a group and never the plain
  version (``CullLog``); the d6 build both ways through ``_build_exact``
  (the plain cull pinned, then K13: seconds, identical arrays, equal to
  path A's) and once more with every group held bit-equal to the plain
  route, each form timed on the most populous group of each width
  (``build_both_ways``, ``cull_vs_plain``); on path B the top group (128
  nodes x 131,072 slots, expanded rows) and the most populous group of 128
  slots the same way (kept from a second build, after path B's peak
  device memory was read), the top group's row in the JSON line; the d7
  build's breakdown, phases and profiler, in a process of its own
  (``build_profile_alone``);
* the depth-7 cell: the 100,800-triangle torus of bench.py's big mesh,
  start depth 3, 2^20 uniform points (the grouped scan) and its oracle
  gate, K2 at the d7 oracle's shape (10k x 100,800) and its point order
  there and at mesh_preview's 262,144 points (bit-equal to
  ``morton_order_plain``; below the cutoff one launch, and in a process
  of its own the profiler's only device activity; split by the profiler,
  with aminmax and the stable sort timed alone), at the cutoff and one
  past it, and K1w on the 2^20 points (checked on the first 2^16 of
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
  through the port's ``io`` and queried on the card. K4, the grid query
  kernel, is held against its plain version on the 2^22 points on both
  grid routes, with and without the gradient (1e-6 in distance, 1e-5 in
  gradient), each group size (lanes a point: 1, 4, 8) held bit-equal
  to one thread a point and timed beside the bound (``k4_vs_plain``); the
  profiler's breakdown of the queries runs in a process of its own
  (``approx_profile``). K2 is held against its plain version at the seed
  lattice's shape (125 x 9,216);
* main path D, the sphere tracer at bench.py's configuration
  (bench.py:151-187): path C's no_continuity octree after
  ``build_query_grid``, 1024^2 rays from z = -1.2 along +z,
  ``max_iters=1024``, eps 1e-5, far 4. The frame takes the static
  pyramid over the thin grid as one captured CUDA graph with no host
  sync: the first frame's seconds (its capture), a second frame that
  replays it with one launch, both bit-equal to the eager schedule; the
  frame on the fused rows bit-equal to it (hit, position, depth, normal,
  iterations) and both timed; the kernel frame (K4's
  normals, K5's rounds, K6's prepass) against the frame with the plain
  step pinned (hit masks on >= 99.9%, q99 of |depth diff| on common hits
  <= 1e-4 of the box), whose live rays' cells give the frame's bound
  (inputs once, each touched row once); K6 and K5 against their plain
  versions in the frame's forms (the 256-trip prepass and the first
  round each in one launch), their forms held bit-equal and timed
  (``segments_vs_plain``, with K6's device time), after K6's trip
  histogram and its 16-, 64- and 256-trip budgets (``beam_histogram``);
  then the graph path and the dynamic scheduler (``pyramid=False``) each
  timed (best of 3 after a warmup) with rays/s,
  a ``breakdown`` (device activities, busy share, host syncs and graph
  launches from the profiler and from ``stats_out``) and a timeline
  (idle gaps), useful against offered ray-trips and the bound; the two
  held to each other (hit masks on >= 99.8%, depths within 1e-3); the
  graph path's hits held to a plain host march through ``get_distance``
  on every 16th ray, to ``RealSdf`` (q95 below 8e-3) and to the trace
  without a beam; then a 512^2 camera frame in sdf_render's defaults
  shaded five ways (written as PNGs to a temporary directory) and a 512^2
  plane cut;
* path D on the walk (``walk_frame_path``): path C's octree saved and
  loaded with no query grid, one graph a frame of K14's rounds, K15's
  prepass and K10's normals, held bit-equal to the earlier eager route
  (torch trips over K10) and to the all-torch plain frame (hit masks on
  >= 99.9%, q99 of |depth diff| <= 1e-4 of the box), K14 and K15 held
  the same two ways (``walk_segments_vs_plain``), and the C++ SdfLib's
  two ``.bin`` files through the same route;
* main path E, the uniform grid: ``UniformGridSdf(depth=7)`` on the bench
  torus (128^3 corners) by BASIC init (K2 over every corner) and by
  OCTREE init (K1 through a depth-6 exact octree), the two held to each
  other and to ``RealSdf`` at 10k corners, queries timed on 2^22 points
  beside their bound, the GRID ``.bin`` round trip bit-equal, and K2 held
  against its plain version at 2^21 x 9,216;
* main path F, differentiable queries (``diff_path``): path C's
  no_continuity octree, ``octree_query_diff`` (K10 forward, K11
  backward) on 2^22 points (seed 1) bit-equal to the walk route (K10 as
  well) and within 1e-6 of the grid route; the coefficient gradient of
  mean((d - t)^2) timed with its forward beside their bound from bytes,
  K11's pieces' device time and launches by the profiler, one entry's
  ``data_parallel_fit_step`` bit-equal to ``fit_step``, the gradient held
  to the CPU on 2^16 points (1e-4 relative on the touched rows) and to
  central differences on 8 coefficients; the point gradient against
  ``get_distance_and_gradient``; ``render_depth_diff`` (K12's march) on
  bench.py's 1024^2 rays (eps 1e-4, far 4, 256 trips) against path D's
  trace; 30 Adam steps of ``depth_fit_loss`` (tests/test_diff.py's
  recipe), whose last loss must fall below half the first; K10, K11's
  key launch, leaf sort and reduction, and K12 each launched; then K10 in
  each mode, layout and group size (bit-equal to one another and to K12's
  one trip), K11 in four forms (bit-equal run to run on the aligned
  layout; its pieces held to their plain versions bit for bit and timed
  each) and K12 on the frame against their plain versions, timed beside
  them and their bounds, and K10 at the frame's ray ends at each group
  size (``walk_kernels_vs_plain``); K12's persistent warps bit-equal to one
  thread a ray (the render and its gradient too) and to themselves run
  to run, both forms timed in the same call, with the one-thread form's
  lane use and live warps and the warps' slot-trips (``_k12_forms``);
* main path G, the exact path's leftovers (``leftovers_path``), on path
  A's configuration: the EXACT_OCTREE ``.bin`` written, reloaded on the
  card and held to the 10k oracle gate through K1, the compiled
  reference's ``builders_exact.bin`` within 2e-5, the copied native
  library on the port's file within 1e-5; the frame19 and id-only tiers
  (2^21 points and the oracle gate, each timed beside K1; pinning K1
  raises); ``set_scan_chunk`` 16 and 128; the lattice, basic, precise and
  per_vertex builds (seconds, leaves beside JAX's, mean list, bucket
  bytes, the oracle gate) and the approximate d6 build with the lattice
  cull held to JAX's words and leaves. Its grid knob runs on path B's
  structure: the node walk, then ``build_query_grid``, the 2^20 answers
  unchanged;
* main path H, the CLI tools and ``parallel`` (``tools_path``): bench.py's
  torus as a binary PLY through every tool's ``main(argv)`` on the card:
  ``sdf_export`` at its defaults (approximate d7 to .npz and .bin), exact
  d6 (lattice, to .npz and .bin) and grid; ``sdf_error`` on 2^22 samples
  of each octree against the mesh (RMSE below 4e-3; the exact one's max
  error <= 1e-5); ``sdf_error_compare`` (the .bin row equals the .npz
  row); ``sdf_render`` at 1024^2 with AO and shadows and from the .bin
  (equal hit shares); ``sdf_light``; ``sdf_view`` (a 512^2 sweep, a pick
  in the tube: a non-empty list within 1e-5 of ``RealSdf``);
  ``image_query_time`` at 1024^2; ``exact_mean_triangles`` (its leaves
  the structure's); ``interp_params``; ``mesh_preview`` (K2 on every
  trip); ``scaling_bench``; then ``parallel`` on ``default_mesh()``, on
  four entries of the card in one call and in four calls (``cuda:0`` and
  ``cuda`` twice): ``sharded_distance`` (2^22, 2^21 and the
  10k oracle points), ``sharded_distance_and_gradient`` (2^20) and
  ``sharded_trace`` (bench.py's 1024^2 rays, each list twice: the first
  call of a shard shape captures its graphs) bit-equal to the
  single-device calls, and ten fit steps whose loss falls, the first
  within 1e-6 of the one-entry step (the four calls run on two worker
  threads of the card, ``parallel.mesh.run_blocks``); then the tiled
  exact octree on eight entries within rtol 1e-6, atol 1e-7 of the
  replicated one on 2^21 points (0.1 beyond the box), its shard bytes
  below the replicated table and its round trip, and the tiled d7
  approximate octree against its grid route on 2^22 points; K2 against
  its plain version at the tools' shapes, 2^22 and 262,144 points x
  9,216 triangles (after the path's launch counts are read);
* with two cards or more (``multicard_path``; one card prints that it
  had one): bench.py's 1024^2 ``sharded_trace``, the 2^22-point
  approximate, 2^21-point exact and 10k-point ``RealSdf``
  ``sharded_distance`` on one card, two and every card, bit-equal to the
  single-device calls, with their rates and efficiencies, and each
  every-card call's span on each card (``card_spans``, CUDA events) and
  device timeline split by card (``card_timeline``);
* ``parallel`` across processes (``process_path``): on one card two
  ranks on it under gloo, on two cards or more one rank a card under
  NCCL, started with ``torch.multiprocessing`` (spawn) and a ``file://``
  rendezvous; each rank loads path A's d6 exact structure, path C's d6
  octree and a tiled exact octree of two shards a rank, runs the
  2^21-point exact query (K1w), the 10k oracle points through the exact
  query (K1g) and ``RealSdf`` (K2), the 2^22-point approximate query,
  the gradients on 2^20 points, the 1024^2 trace, the fit step on 2^20
  points and the tiled query over a ``ProcessMesh``, each bit-equal to
  its call on the rank's one device (the fit step's loss and new
  coefficients within 1e-6),
  timed between barriers; the ranks' launch counts join the kernels'.

Each kernel is held against its plain torch version on the card and
timed beside it with CUDA events (best of 3 after a warmup). Launch
counts are reset before each path and read after it. Every phase raises
on failure, so the exit code is non-zero then, and without a CUDA device.
The line before the last lists every kernel as JSON; the last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
# The JAX package's exact d6 builds of the bench torus under the other
# cull strategies, on the CPU (scripts/strategy_reference_jax.py): leaves
# and mean list length; precise and per_vertex at d5 too. JAX's precise
# cull keeps every candidate of a node with a padded list (ROADMAP.md,
# Queue 3), so its leaves hold all 9,216 triangles; the port's are held to
# no gate of JAX's there. Its approximate d6 lattice build has the words
# and leaves of APPROX_REF["no_continuity"].
STRATEGY_REF = {
    ("lattice", 6): dict(leaves=262_144, mean=122.7928),
    ("basic", 6): dict(leaves=261_010, mean=159.7711),
    ("per_vertex", 6): dict(leaves=96_587, mean=24.4552),
    ("per_vertex", 5): dict(leaves=32_768, mean=36.9453),
    ("precise", 6): dict(leaves=512, mean=9216.0),
    ("precise", 5): dict(leaves=512, mean=9216.0),
}
# The depth each strategy's build runs at on the card: d6, cut to d5 for
# a strategy whose d6 build took more than 120 s (PERF.md section 6).
STRATEGY_DEPTH = {"lattice": 6, "basic": 6, "precise": 6, "per_vertex": 6}
# The differentiable query's backward, beyond the forward's 280 B a point:
# the 64 coefficient gradients a point (256 B) that the scatter adds into
# the gradient array.
DIFF_BACKWARD_BYTES = 256
# K10-K12 (path F), each input read once and each output written once.
# K10: the point in and d out (16 B a point, 12 more with a gradient out),
# and the node words and coefficient rows the points touch
# (_walk_touched); K11: the point and gd in (16 B; gg 12 more), the touched
# node words, the whole coefficient gradient out, and with the point
# gradient the touched rows in and 12 B a point out; K12: a ray's origin
# and direction in, hit, position, depth and trips out (45 B), and the
# octree's words once (at most the rows its rays touch: ~1 MB, 0.3 us).
# The forward's 280 B a point (APPROX_POINT_BYTES) and the backward's 256
# more (DIFF_BACKWARD_BYTES) are the figures of every point re-reading
# its row, which path F prints beside them.
# Flops counted from csrc/walk.cuh and csrc/octree_walk.cu: the walk ~18
# and ~12 a level; K10 then K4's polynomial (FLOPS_K4, FLOPS_K4_GRAD);
# K11 ~3 a coefficient (~15 with gg); a K12 trip ~310 (a 4-level walk,
# the value, the step).
WALK_RAY_BYTES = 24 + 1 + 12 + 4 + 4
# K11's pieces on the aligned layout, each input once and each output
# once: the key launch reads a point and gd (16 B; gg 12 more) and the
# touched node words, and writes a key and a share (4 + 16 B; 16 more with
# gg); the leaf sort reads a key and writes it sorted and the order (16
# B); the reduction reads a sorted key, the order and a share (28 B; 16
# more with gg) and writes each touched row once.
K11_KEY_BYTES = 16 + 4 + 16
K11_SORT_BYTES = 4 + 4 + 8
K11_REDUCE_BYTES = 4 + 8 + 16
K11_GG_KEY_BYTES = 12 + 16
K11_GG_REDUCE_BYTES = 16
FLOPS_WALK_START = 18
FLOPS_WALK_LEVEL = 12
FLOPS_K11 = 3 * 64
FLOPS_K11_GG = 15 * 64
FLOPS_WALK_TRIP = 310
# One query point's bytes through the grid route: the point in, its grid
# row (8 B), its leaf's 64 coefficients, the distance out; the gradient
# writes 12 B more.
APPROX_POINT_BYTES = 12 + 8 + 64 * 4 + 4
APPROX_GRAD_BYTES = APPROX_POINT_BYTES + 12
GOLDEN = os.path.join("tests", "golden", "data")
# One march step's bytes if each trip re-read its row (the earlier
# statement of the frame's bound, kept as a note): the position (12 B)
# and direction (12 B) in, the row's two words (8 B) and 64 coefficients
# (256 B), and the state written back: position 12, accumulated distance
# 4, last distance 4, active flag 4.
TRACE_STEP_BYTES = 12 + 12 + 8 + 64 * 4 + 12 + 4 + 4 + 4
# A traced ray's bytes in and out once: origin and direction in (24 B);
# hit (1), position (12), depth (4), normal (12), iterations (4) out.
FRAME_RAY_BYTES = 24 + 1 + 12 + 4 + 12 + 4
# Flops counted from csrc/leaf_eval.cuh and csrc/march.cu: a tricubic
# query point (its cell, the position in the leaf, 32 lanes of 6 and the
# 31-add tree) ~250, with the normalized gradient ~900; a march trip (the
# value, the free-box exit, the move and the tests) ~290, a beam trip
# ~320.
FLOPS_K4 = 250
FLOPS_K4_GRAD = 900
FLOPS_MARCH_TRIP = 290
FLOPS_BEAM_TRIP = 320
# A ray's march state: pos 12, acc 4, last_d 4, active 4, its 4 read and
# written, dirs 12 read; a beam's: pos 12, acc 4, active 4 read and
# written, dirs 12, r0 4 and rd 4 read.
MARCH_STATE_BYTES = 2 * 28 + 12
BEAM_STATE_BYTES = 2 * 20 + 20
# One uniform-grid query point: the point in and the distance out (the
# gradient writes 12 B more); the grid itself counts once per call.
GRID_POINT_BYTES = 12 + 4
GRID_GRAD_BYTES = GRID_POINT_BYTES + 12
# K7-K9, the exact query's finish, key and sorted gather. K7: a point's
# 12 B, winner 4 B and order 8 B in, its distance out (the gradient 12 B
# more); each touched triangle's 37 fields once (the world vertices' 9 more
# with the gradient). K8: the point in, its key out, each touched grid
# cell's word once. Flops counted from csrc/exact_finish.cu and
# exact_descend.cu: the box test 12, the frame 18, the ladder's tests and
# the feature's terms ~40 (the normal ~30 more), K8's cell ~12.
FINISH_POINT_BYTES = 12 + 4 + 8 + 4
FINISH_GRAD_BYTES = FINISH_POINT_BYTES + 12
FINISH_ROW_BYTES = 37 * 4
FINISH_GRAD_ROW_BYTES = FINISH_ROW_BYTES + 9 * 4
FLOPS_FINISH = 70
FLOPS_FINISH_GRAD = 100
FLOPS_DESCEND = 12
# The leaf sort (K8's key and a stable radix sort by it): its bound counts
# the point in and lid_s (4 B) and the order (8 B) out, and each touched
# grid word once; its design moves 16 B a point in the key launch (the
# point in, the key out) and 16 B a digit pass on average (64 B in three
# passes: 4 B in and 8 B out, 8 in and 8 out, 8 in and 12 out).
SORT_POINT_BYTES = 12 + 4 + 8
SORT_DESIGN_BYTES = 16
SORT_PASS_BYTES = 16
# The most device activities a profiled exact query may take with K7-K9
# (the leaf sort, the gather, the group assembly, K1, K7).
EXACT_MAX_ACTIVITIES = 40
# ... and in each scan no more than the query takes with the leaf sort
# (the d6 2^21 window query; the grouped queries, d6 and d7 2^20): 8 and
# 23 on an H100 with its three digit passes at depths 6 and 7 (7 and 22
# with two), where K8 and torch's sort took 18 and 33
EXACT_ACTIVITIES = {"window": 8, "grouped": 23}
# The exact query's launch counters (the leaf sort, K9, K7), and the names
# of its kernels in a profile: the leaf sort's two kernels and its memset,
# and torch's radix sort, which a query over the leaf grid must not run.
EXACT_KERNELS = ("leaf_sort", "exact_sorted_gather", "exact_finish")
EXACT_PARTS = ("leaf_sort", "Memset", "exact_sorted_gather_kernel", "scan_window_kernel",
               "scan_grouped_kernel", "exact_finish_kernel", "DeviceRadixSort")


def _torch_sort_kernel(name: str) -> bool:
    """Whether a device activity is one of torch's sorts: a name with
    "sort" in it that is not the leaf sort, K9 or ``searchsorted``."""
    low = name.lower()
    return "sort" in low and not any(k in low for k in ("leaf_sort", "sorted_gather",
                                                         "searchsorted"))


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


def _graph_ms(fn, reps: int = 20) -> float:
    """Device ms of ``fn``'s launches without their host time: CUDA events
    around ``reps`` replays of one CUDA graph of ``fn`` (captured after a
    warm-up on a side stream), over ``reps``. The profiler drops some
    launches' device activity inside the full smoke; this does not use it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) for the work, and which of bytes or operations
    sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _instance(mangled: str) -> str:
    """The bool or int template arguments of a mangled kernel name, if any."""
    args = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"(?<=[IE])L([bi])(\d+)E", mangled)]
    return f"<{', '.join(args)}>" if args else ""


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
    from sdflib_tpu_torch.ops import (
        cull, exact_query, march, nearest, octree_query, row_gather, scan, walk,
    )

    scan.launch_count = scan.grouped_launch_count = nearest.launch_count = 0
    cull.launch_count = 0
    nearest.morton_launch_count = 0
    row_gather.block_launch_count = row_gather.tile_launch_count = 0
    octree_query.launch_count = march.launch_count = march.beam_launch_count = 0
    exact_query.finish_launch_count = exact_query.descend_launch_count = 0
    exact_query.gather_launch_count = exact_query.sort_launch_count = 0
    walk.launch_count = walk.backward_launch_count = walk.march_launch_count = 0
    walk.key_launch_count = walk.sort_launch_count = walk.reduce_launch_count = 0
    walk.segment_launch_count = walk.beam_launch_count = 0


def read_counts():
    """Every kernel wrapper's launch count, by kernel name. A frame's
    captured pieces count their kernels at the warm-up run and at the
    capture; replays launch them without the wrapper."""
    from sdflib_tpu_torch.ops import (
        cull, exact_query, march, nearest, octree_query, row_gather, scan, walk,
    )

    return {
        "region_cull": cull.launch_count,
        "exact_finish": exact_query.finish_launch_count,
        "exact_descend": exact_query.descend_launch_count,
        "leaf_sort": exact_query.sort_launch_count,
        "exact_sorted_gather": exact_query.gather_launch_count,
        "nearest": nearest.launch_count,
        "nearest_morton": nearest.morton_launch_count,
        "scan_window": scan.launch_count,
        "scan_grouped": scan.grouped_launch_count,
        "row_min_block": row_gather.block_launch_count,
        "row_min_tile": row_gather.tile_launch_count,
        "octree_query": octree_query.launch_count,
        "march": march.launch_count,
        "beam": march.beam_launch_count,
        "walk_query": walk.launch_count,
        "walk_backward": walk.backward_launch_count,
        "walk_keys": walk.key_launch_count,
        "walk_sort": walk.sort_launch_count,
        "walk_reduce": walk.reduce_launch_count,
        "walk_march": walk.march_launch_count,
        "walk_segment": walk.segment_launch_count,
        "walk_beam": walk.beam_launch_count,
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


def _bits_equal(a, b) -> bool:
    """Equal bit for bit: floats compared as their int32 words, so signed
    zeros and NaN payloads count."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _timed(fn, key: str) -> tuple[float, float]:
    """(CUDA-event ms, profiler device ms) of one call of ``fn``: the
    events best of 3 after a warm-up (the host's issue time included when
    it outlasts the device's work); the device time of the activities
    whose name holds ``key`` (lower case) over 3 profiled calls, profiled
    again, up to PROFILE_TRIES sessions, while a session records none."""
    ev = _cuda_ms(fn)
    dev = 0.0
    for _ in range(PROFILE_TRIES):
        dev = _device_ms(fn, (key,))
        if dev > 0.0:
            break
    return ev, dev


def _exact_inputs(sdf, pts):
    """One batch as the query hands it to K7-K9: every 61st point moved out
    of the box (1.6x about its centre), K8's keys, the leaf sort's sorted
    keys and order (as the query launches it), the scan the structure
    chooses, and the sorted points and winners of the structure's own scan
    with every 97th winner -1."""
    from sdflib_tpu_torch.ops import exact_query as eq
    from sdflib_tpu_torch.ops import scan

    q = pts.clone()
    centre = sdf._box_min + 0.5 * sdf._box_size3
    q[::61] = centre + 1.6 * (q[::61] - centre)
    P = q.shape[0]
    keys = eq.exact_descend(q, sdf._leaf_grid, sdf._box_min, sdf._box_size3, sdf.max_depth)
    lid_s, order = eq.launch_leaf_sort(q, sdf._leaf_grid, sdf._box_host, sdf.max_depth,
                                       eq.sort_bits(sdf.num_leaves))
    kind = sdf._choose_scan(P)
    if kind == "window":
        pts_s, b0, nc, _ = sdf._sorted_windows(q)
        win = scan.scan_window(sdf.bucket_ids, sdf.bucket_fields, pts_s, b0, nc).reshape(-1)
    else:
        pts_s, lid_g, start, _, _ = sdf._sorted_groups(q)
        win = scan.scan_grouped(sdf.bucket_ids, sdf.bucket_fields, pts_s, lid_g, start,
                                sdf.leaf_row0, sdf.leaf_nchunks)
    pts_s, win = pts_s[:P].contiguous(), win[:P].clone()
    win[::97] = -1
    return dict(q=q, keys=keys, lid_s=lid_s, order=order, kind=kind, pts_s=pts_s, win=win)


def _host_us(fn, reps: int = 200) -> float:
    """Host time (us) a call of ``fn``, ``reps`` calls issued back to back:
    the Python and launch path, without the device's work, which the
    stream's queue absorbs (a call that syncs waits for it, though)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _exact_runs(sdf, x) -> dict:
    """K9 (both modes) and K7 (both forms) on one batch of ``_exact_inputs``,
    as the query launches them (the lean launches): {name: (fn, the
    kernel's name in a profile)}. K7 also at the identity order (its
    outputs in sorted order: the same work without the scattered writes)."""
    import torch

    from sdflib_tpu_torch.ops import exact_query as eq

    q, order, lid_s, pts_s, win = x["q"], x["order"], x["lid_s"], x["pts_s"], x["win"]
    P = q.shape[0]
    runs = {}
    for mode in ("window", "grouped"):
        window = mode == "window"
        size = P + (-P) % 32 if window else P
        runs[f"K9 {mode}"] = (
            lambda window=window, size=size: eq.launch_sorted_gather(
                q, order, lid_s if window else None, sdf._leaf_bounds if window else None,
                size),
            "exact_sorted_gather_kernel")
    identity = torch.arange(P, device=q.device)
    for grad in (False, True):
        form = "gradient" if grad else "distance"
        for name, o in ((f"K7 {form}", order), (f"K7 {form} identity", identity)):
            runs[name] = (lambda o=o, grad=grad: eq.launch_exact_finish(
                pts_s, win, o, P, sdf._finish_table, sdf._box_host, sdf._fallback, grad),
                "exact_finish_kernel")
    return runs


def _exact_times(runs: dict, x) -> dict:
    """Each of ``runs`` (``_exact_runs``) timed: CUDA events, the
    profiler's device time and the host time a call (``_host_us``); and
    K9 grouped's library call, ``torch.index_select``, in events and
    device time. ms (host us) by name."""
    import torch

    t = {}
    for name, (fn, key) in runs.items():
        t[name], t[f"{name} device"] = _timed(fn, key)
        t[f"{name} host us"] = _host_us(fn)
    t["index_select"], t["index_select device"] = _timed(
        lambda: torch.index_select(x["q"], 0, x["order"]), "")
    return t


def _walk_keys(sdf, q):
    """The node walk's int32 leaf keys of ``q`` on a structure that has the
    dense grid (the grid set aside for the call)."""
    grid, sdf._leaf_grid = sdf._leaf_grid, None
    try:
        return sdf._leaf_keys(q)
    finally:
        sdf._leaf_grid = grid


# The leaf sort's edge sweep: batch sizes (a tile is 4,096 keys) and leaf
# counts (1 bit for 1 and 2 leaves, digits of 5 + 5 for 513, of 6 + 6 + 6
# for 2^18 and of 8 + 7 + 7 for 2^21 + 1); then keys of every plan from one
# pass to four (1, 7, 8, 9, 12, 21 and 31 bits) at the tile's edges, and
# K11's 2^22 keys of 12 bits.
SWEEP_SIZES = (0, 1, 255, 256, 257, 4095, 4096, 4097, (1 << 20) + 3)
SWEEP_LEAVES = (1, 2, 513, 1 << 18, (1 << 21) + 1)
SWEEP_BITS = (1, 7, 8, 9, 12, 21, 31)
SWEEP_BIT_SIZES = (4095, 4096, 4097, (1 << 20) + 3)


def leaf_sort_sweep(dev) -> int:
    """The leaf sort at every size of ``SWEEP_SIZES`` against grids of
    every leaf count of ``SWEEP_LEAVES`` (random ids below L, every id
    present where the grid has room; points over 1.2x the box, every 97th
    far outside it, every 101st coordinate NaN), in both modes, the lean
    launch and the public wrapper, ``torch.equal`` to
    ``torch.sort(keys, stable=True)``; then every point in one leaf and
    keys in descending order at 2^20 + 3; keys of every bits of
    ``SWEEP_BITS`` at ``SWEEP_BIT_SIZES`` in both modes (a run of few
    values, a descending run, both extremes; a depth-5 grid of such ids);
    K11's 2^22 keys of 12 bits. Returns the cases checked."""
    import torch

    from sdflib_tpu_torch.ops import exact_query as eq

    lo, size = (-0.25, 0.5, -1.0), 2.0
    box_min = torch.tensor(lo, dtype=torch.float32, device=dev)
    box_size3 = torch.full((3,), size, dtype=torch.float32, device=dev)
    box = (*lo, size, size, size)
    cases = 0

    def same(got, want, what):
        nonlocal cases
        cases += 1
        _check(got[0].dtype == torch.int32 and got[1].dtype == torch.int64
               and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
               f"the leaf sort differs from torch.sort ({what})")

    for L in SWEEP_LEAVES:
        rng = np.random.default_rng(L)
        depth = 7 if L > 8 ** 5 else 5
        cells = 8 ** depth
        grid = rng.integers(0, L, cells).astype(np.int32)
        grid[rng.permutation(cells)[: min(L, cells)]] = (np.arange(min(L, cells))
                                                         * (L // min(L, cells)))
        grid[0] = L - 1
        grid = torch.as_tensor(grid, device=dev)
        bits = eq.sort_bits(L)
        for P in SWEEP_SIZES:
            pts = (np.asarray(lo, np.float32)
                   + rng.uniform(-0.1, 1.1, (P, 3)).astype(np.float32) * np.float32(size))
            pts[::97] *= np.float32(40.0)
            pts.reshape(-1)[::101] = np.nan
            pts = torch.as_tensor(pts, device=dev)
            what = f"P={P}, L={L}"
            want = eq.leaf_sort_plain(pts, grid, box_min, box_size3, depth)
            same(eq.launch_leaf_sort(pts, grid, box, depth, bits), want, what)
            same(eq.leaf_sort(pts, grid, box_min, box_size3, depth, bits), want, what)
            keys = eq.exact_descend_plain(pts, grid, box_min, box_size3, depth)
            same(eq.launch_leaf_sort(keys, None, None, 0, bits), eq.leaf_sort_plain(keys),
                 f"{what}, keys given")
        if L == SWEEP_LEAVES[-1]:
            P = SWEEP_SIZES[-1]
            one = torch.full_like(grid, L // 3)
            same(eq.launch_leaf_sort(pts, one, box, depth, bits),
                 eq.leaf_sort_plain(pts, one, box_min, box_size3, depth), "one leaf")
            down = (L - 1 - torch.arange(P, device=dev) % L).to(torch.int32)
            same(eq.launch_leaf_sort(down, None, None, 0, bits), eq.leaf_sort_plain(down),
                 "descending keys")
    for bits in SWEEP_BITS:
        top = (1 << bits) - 1
        rng = np.random.default_rng(bits)
        grid = rng.integers(0, top + 1, 8 ** 5, dtype=np.int64)
        grid[:2] = (0, top)
        grid = torch.as_tensor(grid.astype(np.int32), device=dev)
        for P in SWEEP_BIT_SIZES + ((1 << 22,) if bits == 12 else ()):
            keys = rng.integers(0, top + 1, P, dtype=np.int64)
            keys[: P // 8] = rng.integers(0, min(top, 3) + 1, P // 8)
            keys[P // 8: P // 4] = top - np.arange(P // 4 - P // 8) % (top + 1)
            keys[-1], keys[0] = top, 0
            keys = torch.as_tensor(keys.astype(np.int32), device=dev)
            what = f"P={P}, {bits} bits"
            same(eq.launch_leaf_sort(keys, None, None, 0, bits), eq.leaf_sort_plain(keys),
                 f"{what}, keys given")
            pts = (np.asarray(lo, np.float32)
                   + rng.uniform(-0.1, 1.1, (P, 3)).astype(np.float32) * np.float32(size))
            pts.reshape(-1)[::101] = np.nan
            pts = torch.as_tensor(pts, device=dev)
            same(eq.launch_leaf_sort(pts, grid, box, 5, bits),
                 eq.leaf_sort_plain(pts, grid, box_min, box_size3, 5), what)
    torch.cuda.synchronize()
    return cases


def exact_kernels_vs_plain(sdf, pts, label, sweep: bool = False):
    """K8, the leaf sort, K9 and K7 against their plain versions on one
    batch of ``_exact_inputs``. K8's keys, the leaf sort's sorted keys and
    order (``torch.equal`` to ``torch.sort(exact_descend_plain(...),
    stable=True)``, the lean launch and the public wrapper, over the grid
    and given the node walk's keys) and K9's outputs equal (both modes,
    the public wrapper and the lean launch the query calls), K7's
    distances bit-equal on every point (with and without the gradient,
    both calls, at the batch's order and at the identity), its gradients
    within 1e-6; with ``sweep``, the leaf sort's edge sweep
    (``leaf_sort_sweep``). Each timed as the query launches it
    (``_exact_times``: CUDA events, the profiler's device time, host time)
    beside its plain version and its bound; the leaf sort also beside the
    parent's path, K8 and ``torch.sort`` of its int32 keys (its
    ``library_ms``), ``torch.sort`` alone, and its design's floor; K9
    grouped beside ``index_select``. Returns {row: dict(err, ms, device_ms,
    plain_ms, bound, library_ms)} for the JSON line: K8, the leaf sort, K9
    in window mode and in grouped mode (the mode with a library call), K7
    in both forms; each ``ms`` is the lean launch's events."""
    import torch

    from sdflib_tpu_torch.ops import exact_query as eq

    x = _exact_inputs(sdf, pts)
    q, keys, lid_s, order, kind = x["q"], x["keys"], x["lid_s"], x["order"], x["kind"]
    pts_s, win = x["pts_s"], x["win"]
    P = q.shape[0]
    out_share = float(((q < sdf._box_min) | (q >= sdf._box_min + sdf._box_size3)).any(1)
                      .float().mean())
    res = {}
    # K8
    dargs = (q, sdf._leaf_grid, sdf._box_min, sdf._box_size3, sdf.max_depth)
    _check(torch.equal(keys, eq.exact_descend_plain(*dargs)),
           f"K8's keys differ from the plain version's ({label})")
    g = 1 << sdf.max_depth
    cell = ((q - sdf._box_min) / sdf._box_size3 * g).to(torch.int32).clamp(0, g - 1).long()
    cells = int(torch.unique((cell[:, 2] * g + cell[:, 1]) * g + cell[:, 0]).numel())
    ev, dev = _timed(lambda: eq.exact_descend(*dargs), "exact_descend_kernel")
    res["exact_descend"] = dict(err=0.0, ms=ev, device_ms=dev,
                                plain_ms=_cuda_ms(lambda: eq.exact_descend_plain(*dargs)),
                                bound=_bound(P * (12 + 4) + cells * 4, P * FLOPS_DESCEND))
    # the leaf sort: the query's sorted keys and order, the public wrapper,
    # the node walk's keys given
    bits = eq.sort_bits(sdf.num_leaves)
    passes = len(eq._digit_plan(bits))
    want = eq.leaf_sort_plain(*dargs)
    lean = lambda: eq.launch_leaf_sort(q, sdf._leaf_grid, sdf._box_host, sdf.max_depth, bits)
    for got in ((lid_s, order), lean(), eq.leaf_sort(*dargs, bits)):
        _check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
               f"the leaf sort differs from torch.sort of K8's plain keys ({label})")
    walk = _walk_keys(sdf, q)
    _check(all(torch.equal(a, b) for a, b in zip(
        eq.launch_leaf_sort(walk, None, None, 0, bits), eq.leaf_sort_plain(walk))),
           f"the leaf sort of the node walk's keys differs from torch.sort ({label})")
    swept = leaf_sort_sweep(q.device) if sweep else 0
    parent = lambda: torch.sort(eq.exact_descend(*dargs), stable=True)
    st = {}
    for name, fn in (("leaf sort", lean), ("K8 + torch.sort", parent),
                     ("torch.sort", lambda: torch.sort(keys, stable=True))):
        st[name], st[f"{name} device"] = _timed(fn, "")       # every activity of the call
        st[f"{name} host us"] = _host_us(fn)
    design_ms = P * (SORT_DESIGN_BYTES + SORT_PASS_BYTES * passes) / PEAK_BYTES * 1e3
    res["leaf_sort"] = dict(err=0.0, ms=st["leaf sort"], device_ms=st["leaf sort device"],
                            plain_ms=_cuda_ms(lambda: eq.leaf_sort_plain(*dargs)),
                            bound=_bound(P * SORT_POINT_BYTES + cells * 4, P * FLOPS_DESCEND),
                            library_ms=st["K8 + torch.sort"])
    # K9, both modes, through the public wrapper and the query's launch
    leaves = int(torch.unique(lid_s).numel())
    for mode in ("window", "grouped"):
        if mode == "window":
            size = P + (-P) % 32
            rows = (lid_s, sdf.leaf_row0, sdf.leaf_nchunks)
            gbytes = P * (12 + 8 + 4) + leaves * 8 + size * (12 + 8)
        else:
            size, rows = P, ()
            gbytes = P * (12 + 8) + size * 12
        want = eq.exact_sorted_gather_plain(q, order, *rows, size=size)
        for got in (eq.exact_sorted_gather(q, order, *rows, size=size),
                    eq.launch_sorted_gather(q, order, lid_s if rows else None,
                                            sdf._leaf_bounds if rows else None, size)):
            _check(all((a is None and b is None) or _bits_equal(a, b)
                       for a, b in zip(got, want)),
                   f"K9's outputs differ from the plain version's ({label}, {mode})")
        res[f"K9 {mode}"] = dict(
            err=0.0, plain_ms=_cuda_ms(lambda: eq.exact_sorted_gather_plain(q, order, *rows,
                                                                           size=size)),
            bound=_bound(gbytes, 0))
    # K7, both forms, through the public wrapper and the query's launch
    rel = (pts_s - sdf._box_min) / sdf._box_size3
    in_box = ((rel >= 0.0) & (rel < 1.0)).all(1)
    touched = int(torch.unique(win.clamp_min(0)[in_box]).numel())
    for grad in (False, True):
        form = "gradient" if grad else "distance"
        fargs = (pts_s, win, order, sdf._finish_table, sdf._box_min, sdf._box_size3,
                 sdf._fallback)
        gerr = 0.0
        for o in (order, torch.arange(P, device=q.device)):
            want = eq.exact_finish_plain(pts_s, win, o, *fargs[3:], with_gradient=grad)
            for got in (eq.exact_finish(pts_s, win, o, *fargs[3:], with_gradient=grad),
                        eq.launch_exact_finish(pts_s, win, o, P, sdf._finish_table,
                                               sdf._box_host, sdf._fallback, grad)):
                kd, pd = (got[0], want[0]) if grad else (got, want)
                _check(_bits_equal(kd, pd), f"K7's distances differ from the plain version's "
                       f"({label}, {form}): max {float((kd - pd).abs().max())}")
                if grad:
                    gerr = max(gerr, float((got[1] - want[1]).abs().max()))
        _check(gerr <= 1e-6, f"K7's gradients differ by {gerr} ({label})")
        nbytes = (P * (FINISH_GRAD_BYTES if grad else FINISH_POINT_BYTES)
                  + touched * (FINISH_GRAD_ROW_BYTES if grad else FINISH_ROW_BYTES))
        res[f"K7 {form}"] = dict(
            err=gerr, plain_ms=_cuda_ms(lambda: eq.exact_finish_plain(*fargs,
                                                                      with_gradient=grad)),
            bound=_bound(nbytes, P * (FLOPS_FINISH_GRAD if grad else FLOPS_FINISH)))
    t = _exact_times(_exact_runs(sdf, x), x)
    for name in ("K9 window", "K9 grouped", "K7 distance", "K7 gradient"):
        res[name].update(ms=t[name], device_ms=t[f"{name} device"],
                         library_ms=t["index_select"] if name == "K9 grouped" else None)
    rows = [f"{name}: kernel {r['ms']:.4f} ms ({r['device_ms']:.4f} device), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]})"
            for name, r in res.items()]
    print(f"K7-K9 vs plain ({label}, P={P}, the query's scan: {kind}; {out_share:.4f} of the "
          f"points outside the box, {int((win < 0).sum())} winners of -1, {touched} "
          f"triangles touched, {cells} grid cells, {leaves} leaves): K8 keys, the leaf sort "
          f"(over the grid and given the walk's keys{f', and {swept} sweep cases' if sweep else ''}"
          f"), K9's outputs (both modes) equal, K7's distances bit-equal (both forms), max "
          f"|gradient diff| {res['K7 gradient']['err']:.3e}; " + "; ".join(rows))
    print(f"leaf sort {label} ({bits} bits, digits {eq._digit_plan(bits)}): "
          + ", ".join(f"{name} {st[name]:.4f} ms ({st[f'{name} device']:.4f} device, "
                      f"{st[f'{name} host us']:.1f} us host)"
                      for name in ("leaf sort", "K8 + torch.sort", "torch.sort"))
          + f"; bound {res['leaf_sort']['bound'][0]:.6f} ms, design floor "
          f"({SORT_DESIGN_BYTES + SORT_PASS_BYTES * passes} B a point) {design_ms:.6f} ms")
    print(f"exact_times {label}: " + json.dumps({k: round(v, 6) for k, v in {**st, **t}.items()}))
    return {"exact_descend": res["exact_descend"], "leaf_sort": res["leaf_sort"],
            "exact_sorted_gather": res["K9 window"],
            "exact_sorted_gather_grouped": res["K9 grouped"],
            "exact_finish": res["K7 distance"], "exact_finish_grad": res["K7 gradient"]}


# -- K13, the exact build's region cull ------------------------------------------

# K13's bound: flops of an anchor's squared distance in pass 1 (the frame
# products shared by the 27 anchors), of a winner's corner distance, and of
# an anchor of pass 2 (the distance again, the gradient and the 8 corner
# terms; a kept slot needs one anchor at least), or of one the skip test
# settles (the distance again, its root, the near test and the skip test's
# 7); bytes a pair (id, valid, keep, sqd_center), a touched field row, a
# node (its centre and count).
FLOPS_CULL_EVAL = 34
FLOPS_CULL_CORNER = 46
FLOPS_CULL_PASS2 = 102
FLOPS_CULL_SKIP = 34 + 2 + 7
CULL_PAIR_BYTES = 4 + 1 + 1 + 4
CULL_ROW_BYTES = 19 * 4
CULL_NODE_BYTES = 12 + 8
# the builds the smoke breaks down: depth -> (torus, start depth, bucket budget)
BUILDS = {6: (dict(nu=96, nv=48), 2, None), 7: (dict(nu=420, nv=120), 3, 8 << 30)}


@contextlib.contextmanager
def plain_cull():
    """While entered, the exact build culls with the region cull's plain
    version (``_cull_group(plain=True)``, the chunks of the parent's build)."""
    from sdflib_tpu_torch.sdf import exact_octree as eo

    real = eo._cull_group
    eo._cull_group = functools.partial(real, plain=True)
    try:
        yield
    finally:
        eo._cull_group = real


class CullLog:
    """While entered, ``_ExactBuild.cull`` counts the node groups it culls
    and ``region_cull_plain`` its calls, on the plain route and the
    wrapper's CPU route (``groups``, ``plain_calls``); the group with the
    most nodes of each width in ``widths`` is kept as (centers, cand,
    valid, half) in ``kept`` (the first of equals); with ``check`` each
    group's K13 result is held bit-equal to the plain route's
    (``_cull_group(plain=True)``, the chunks of the parent's build) in
    every form of the kernel, ``checked`` counts them, and ``tally`` sums
    pass 2's tallies of the form ``lanes_for`` picks (evaluations, near
    keeps, skips, full evaluations)."""

    def __init__(self, widths=(), check=False):
        self.widths = None if widths is None else set(widths)
        self.check = check
        self.groups = self.plain_calls = self.checked = 0
        self.kept = {}
        self.tally = [0, 0, 0, 0]

    def __enter__(self):
        import torch

        from sdflib_tpu_torch.ops import cull as cull_mod
        from sdflib_tpu_torch.sdf import exact_octree as eo

        self._eo, self._cull, self._plain = eo, eo._ExactBuild.cull, eo.region_cull_plain
        self._mod = cull_mod
        log = self

        def plain(*args):
            log.plain_calls += 1
            return log._plain(*args)

        def cull(build, group, half):
            log.groups += 1
            centers, cand, valid = group[:3]
            N, K = cand.shape
            if ((log.widths is None or K in log.widths)
                    and (K not in log.kept or N > log.kept[K][1].shape[0])):
                log.kept[K] = (centers, cand, valid, half)
            out = log._cull(build, group, half)
            if log.check:
                eo.region_cull_plain = log._plain
                try:
                    want = eo._cull_group("region", build.tables, centers, cand, valid, half,
                                          eo._chunk_rows(K, build.pair_budget), plain=True)
                finally:
                    eo.region_cull_plain = plain
                _check(cull_equal(out, want), f"K13 differs from region_cull_plain on a "
                                              f"{N} x {K} group (half {half})")
                for lanes in cull_mod.LANES:
                    stats = torch.zeros(4, dtype=torch.int64, device=centers.device)
                    got = cull_mod.region_cull(build.tables, centers, cand, valid, half,
                                               lanes=lanes, stats=stats)
                    _check(cull_equal(got, want), f"K13 with {lanes} lanes differs from "
                           f"region_cull_plain on a {N} x {K} group (half {half})")
                    if lanes == cull_mod.lanes_for(K):
                        log.tally = [a + b for a, b in zip(log.tally, stats.tolist())]
                log.checked += 1
            return out

        eo._ExactBuild.cull, eo.region_cull_plain = cull, plain
        cull_mod.region_cull_plain = plain
        return self

    def __exit__(self, *exc):
        self._eo._ExactBuild.cull, self._eo.region_cull_plain = self._cull, self._plain
        self._mod.region_cull_plain = self._plain
        return False


def cull_equal(got, want) -> bool:
    """keep, counts and sqd_center bit for bit."""
    import torch

    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)))


def cull_bound(cand, valid, keep, skipped=None) -> tuple[float, str]:
    """K13's least time on a group (``FLOPS_CULL_*``, ``CULL_*_BYTES``):
    every pair's bytes, each touched field row once, the nodes; pass 1 over
    the valid pairs, the 216 corners a node, pass 2's 27 anchors for each
    culled pair and one for each kept pair. With ``skipped`` (pass 2's
    skip tally of the run), that many of those anchors, at most all of the
    culled pairs', count at ``FLOPS_CULL_SKIP``: the work this run's data
    needs. Without it every anchor counts in full."""
    import torch

    N, K = cand.shape
    pairs, kept = int(valid.sum()), int(keep.sum())
    rows = int(torch.unique(cand[valid]).numel())
    nbytes = N * K * CULL_PAIR_BYTES + rows * CULL_ROW_BYTES + N * CULL_NODE_BYTES
    anchors = (pairs - kept) * 27 + kept
    skip = min(skipped or 0, anchors - kept)
    ops = (pairs * 27 * FLOPS_CULL_EVAL + N * 216 * FLOPS_CULL_CORNER
           + (anchors - skip) * FLOPS_CULL_PASS2 + skip * FLOPS_CULL_SKIP)
    return _bound(nbytes, ops)


def _skip_line(tally) -> str:
    """Pass 2's tallies (evaluations, near keeps, skips, full evaluations)
    as a line."""
    evals, near, skipped, full = tally
    return (f"pass 2's anchor evaluations {evals}: {near} kept by the near test, {skipped} "
            f"skipped by the skip test ({skipped / max(evals, 1):.1%}), {full} in full")


def cull_vs_plain(tables, group, label, plain_reps: int = 3):
    """K13 in each form against the plain route (``_cull_group(plain=True)``)
    on one node group: bit-equal, each form and the plain route timed (CUDA
    events), and the picked form's pass 2 tallies from a stats launch,
    which the bound counts (``cull_bound``). Returns dict(err, ms (the form
    ``lanes_for`` picks), plain_ms, bound, full_bound (every anchor in
    full), forms {lanes: ms}, lanes, skipped_share)."""
    import torch

    from sdflib_tpu_torch.ops import cull
    from sdflib_tpu_torch.sdf import exact_octree as eo

    centers, cand, valid, half = group
    N, K = cand.shape
    C = eo._chunk_rows(K, 1 << 21)          # _build_exact's default pair budget

    def plain():
        return eo._cull_group("region", tables, centers, cand, valid, half, C, plain=True)

    want = plain()
    forms = {}
    for lanes in cull.LANES:
        _check(cull_equal(cull.region_cull(tables, centers, cand, valid, half, lanes=lanes),
                          want), f"K13 with {lanes} lanes differs from plain ({label})")
        forms[lanes] = _cuda_ms(lambda: cull.region_cull(tables, centers, cand, valid, half,
                                                         lanes=lanes))
    lanes = cull.lanes_for(K)
    plain_ms = _cuda_ms(plain, reps=plain_reps)
    stats = torch.zeros(4, dtype=torch.int64, device=centers.device)
    cull.region_cull(tables, centers, cand, valid, half, stats=stats)
    skip = stats.tolist()
    bound = cull_bound(cand, valid, want[0], skipped=skip[2])
    full = cull_bound(cand, valid, want[0])
    rows = ", expanded rows" if cand.stride(0) == 0 else ""
    print(f"K13 region cull vs plain ({label}, N={N}, K={K}{rows}, "
          f"{int(valid.sum())} valid pairs, {int(want[1].sum())} kept): bit-equal in every form; "
          + ", ".join(f"{n} lanes {ms:.4f} ms" for n, ms in forms.items())
          + f"; picked {lanes}; plain {plain_ms:.3f} ms ({C} nodes a chunk); bound "
          f"{bound[0]:.4f} ms ({bound[1]}, the skipped anchors at {FLOPS_CULL_SKIP} flops) = "
          f"{bound[0] / forms[lanes]:.1%} of the picked form, {forms[lanes] / bound[0]:.2f}x; "
          f"every anchor in full {full[0]:.4f} ms, "
          f"{forms[lanes] / full[0]:.2f}x; {_skip_line(skip)}")
    return dict(err=0.0, ms=forms[lanes], plain_ms=plain_ms, bound=bound, full_bound=full,
                forms=forms, lanes=lanes, skipped_share=skip[2] / max(skip[0], 1))


# K13's A/B variants (``cull_ab``): name -> [(file under the package,
# pattern, replacement)] (``tools/exact_ab.py`` ``copy_with_rewrites``)
_CULL_CU = "csrc/region_cull.cu"
CULL_VARIANTS = {
    # the skip test in the warp form too, or in neither form
    "warp-skip": [(_CULL_CU, r"region_cull_warp_kernel<kStats, false>",
                   "region_cull_warp_kernel<kStats, true>")],
    "noskip": [(_CULL_CU, r"region_cull_block_kernel<kStats, true>",
                "region_cull_block_kernel<kStats, false>")],
    # the warp form with the whole register file a thread (one block an SM)
    "warp-regs": [(_CULL_CU, r"__launch_bounds__\(kWarpThreads, 2\)",
                   "__launch_bounds__(kWarpThreads, 1)")],
}


def cull_ab(parent: str | None = None, variants: str = "warp-skip,noskip") -> None:
    """K13 timed on the exact build's own node groups in checkouts of the
    port and in variants of this one, in turns, on one card: ``python3 -c
    "import chip_smoke as cs; cs.cull_ab('PARENT')"`` from this checkout,
    PARENT another (for example a ``git archive`` of the parent commit,
    unpacked) or None. A first process builds d6 and d7 (``BUILDS``, as
    paths A and B build them) with this checkout, keeps the most populous
    group of each width (``CullLog``) and saves each with the plain route's
    result (``_cull_ab_store``). Each tree then runs in a process of its
    own, in turns (``tools/exact_ab.py`` ``run_in_turns``: parent, this
    one, the ``CULL_VARIANTS`` named, the same reversed, this one, parent),
    each printing one ``cull_ab`` JSON line (``_cull_ab_probe``)."""
    from sdflib_tpu_torch.tools.exact_ab import _build_all, copy_with_rewrites, run_in_turns

    root = os.path.dirname(os.path.abspath(__file__))
    names = ["base", *(n for n in variants.split(",") if n)]

    def argv(call: str, *args: str) -> list:
        return [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                f" import chip_smoke as cs; cs.{call}(*sys.argv[2:])", root, *args]

    work = tempfile.mkdtemp(prefix="chip_smoke_cull_ab_")
    try:
        trees = {name: copy_with_rewrites(work, name, CULL_VARIANTS[name]) if name != "base"
                 else root for name in names}
        if parent is not None:
            trees["parent"] = os.path.abspath(parent)
        _build_all(sorted(set(trees.values())))
        groups = os.path.join(work, "groups")
        os.makedirs(groups)
        out = subprocess.run(argv("_cull_ab_store", groups), capture_output=True, text=True,
                             timeout=900)
        _check(out.returncode == 0, f"_cull_ab_store failed:\n{out.stderr[-4000:]}")
        run_in_turns(names, lambda name: argv("_cull_ab_probe", name, trees[name], groups),
                     parent is not None)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _cull_ab_tris(depth: int, dev):
    """The triangles and cubified box of ``BUILDS[depth]``'s torus, and its
    start depth."""
    from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data, soa_to_torch
    from sdflib_tpu_torch.utils.primitives import make_torus

    torus, start, _ = BUILDS[depth]
    mesh = make_torus(R=0.3, r=0.12, **torus)
    cbox = mesh.bounding_box.add_margin(0.14).cubified()
    return soa_to_torch(calculate_mesh_triangle_data(mesh), dev), cbox, start


def _cull_ab_store(where: str) -> None:
    """``cull_ab``'s groups: d6 and d7 built with this checkout, each
    width's most populous group and its plain result saved under ``where``."""
    import torch

    from sdflib_tpu_torch.sdf import exact_octree as eo

    dev = torch.device("cuda", 0)
    for depth in (6, 7):
        tris, cbox, start = _cull_ab_tris(depth, dev)
        with CullLog(widths=None) as log:
            eo._build_exact(tris, cbox.min, float(cbox.size[0]), depth, start, 32)
        tables = eo.prepare_cull_inputs(tris, "region")
        for K, (centers, cand, valid, half) in sorted(log.kept.items()):
            want = eo._cull_group("region", tables, centers, cand, valid, half,
                                  eo._chunk_rows(K, 1 << 21), plain=True)
            expanded = cand.stride(0) == 0
            torch.save(dict(depth=depth, K=K, N=centers.shape[0], half=half,
                            centers=centers.cpu(), expanded=expanded,
                            cand=(cand[:1] if expanded else cand).cpu(),
                            valid=(valid[:1] if expanded else valid).cpu(),
                            want=[x.cpu() for x in want]),
                       os.path.join(where, f"d{depth}_{K}.pt"))
        del log, tables, tris
        torch.cuda.empty_cache()


def _cull_ab_probe(name: str, tree: str, where: str) -> None:
    """One tree's K13 on ``cull_ab``'s saved groups, in a process of its
    own: in each form the tree has, held bit-equal to the plain result and
    timed (CUDA events, best of 5 after a warm-up); where the tree's
    ``region_cull`` takes ``stats``, pass 2's tallies (evaluations, near
    keeps, skips, full evaluations); the tree's ptxas line for each of
    K13's kernels. Prints one ``cull_ab`` JSON line with the card's name
    and power limit."""
    import inspect

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from sdflib_tpu_torch.kernels import build
    from sdflib_tpu_torch.ops import cull
    from sdflib_tpu_torch.sdf import exact_octree as eo

    dev = torch.device("cuda", 0)
    has_stats = "stats" in inspect.signature(cull.region_cull).parameters
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"variant": name, "tree": os.path.abspath(tree), "card": smi, "groups": {}}
    tables = {}
    for path in sorted(os.listdir(where), key=lambda p: (p[:2], int(p[3:-3]))):
        g = torch.load(os.path.join(where, path))
        depth, K, N = g["depth"], g["K"], g["N"]
        if depth not in tables:
            tables = {depth: eo.prepare_cull_inputs(_cull_ab_tris(depth, dev)[0], "region")}
        tab = tables[depth]
        centers = g["centers"].to(dev)
        cand, valid = g["cand"].to(dev), g["valid"].to(dev)
        if g["expanded"]:
            cand, valid = cand.expand(N, -1), valid.expand(N, -1)
        want = [x.to(dev) for x in g["want"]]
        row = {"N": N, "pairs": int(valid.sum()), "kept": int(want[1].sum()),
               "picked": cull.lanes_for(K)}
        for lanes in cull.LANES:
            run = lambda: cull.region_cull(tab, centers, cand, valid, g["half"], lanes=lanes)
            _check(cull_equal(run(), want), f"{name}: K13 with {lanes} lanes differs from the "
                   f"plain route on d{depth} K={K}")
            row[str(lanes)] = _cuda_ms(run, reps=5)
        if has_stats:
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            cull.region_cull(tab, centers, cand, valid, g["half"], stats=stats)
            row["stats"] = dict(zip(("evals", "near", "skipped", "full"), stats.tolist()))
        out["groups"][f"d{depth} K={K}"] = row
    out["ptxas"] = {k: v for k, v in build.ptxas_report().items() if "region_cull" in k}
    print("cull_ab " + json.dumps(out))


def build_both_ways(dev, depth: int, sdf) -> dict:
    """The exact build at ``depth`` (``BUILDS``) through ``_build_exact``,
    the plain cull pinned and with K13, each timed (host clock, synchronised),
    their octree, leaf_offset, leaf_count, tri_flat and leaf_centers
    identical and equal to ``sdf``'s (the main path's build); then once
    more with every group's K13 result held bit-equal to the plain route's,
    keeping the most populous group of each width for ``cull_vs_plain``."""
    import torch

    from sdflib_tpu_torch.sdf import exact_octree as eo
    from sdflib_tpu_torch.triangle import calculate_mesh_triangle_data, soa_to_torch
    from sdflib_tpu_torch.utils.primitives import make_torus

    torus, start, _ = BUILDS[depth]
    mesh = make_torus(R=0.3, r=0.12, **torus)
    cbox = mesh.bounding_box.add_margin(0.14).cubified()
    tris = soa_to_torch(calculate_mesh_triangle_data(mesh), dev)
    args = (tris, cbox.min, float(cbox.size[0]), depth, start, 32)
    out, secs = {}, {}
    for name, pin in (("plain", plain_cull), ("K13", contextlib.nullcontext)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with pin():
            out[name] = eo._build_exact(*args)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    a, b = out["K13"], out["plain"]
    same = (all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3])) and torch.equal(a[3], b[3])
            and np.array_equal(a[4], b[4]))
    _check(same, f"the d{depth} build with K13 differs from the plain cull's")
    main = (sdf.octree_data, sdf.leaf_offset, sdf.leaf_count)
    _check(all(np.array_equal(x, y) for x, y in zip(main, b[:3]))
           and torch.equal(sdf.tri_flat, b[3]), f"the main path's d{depth} build differs")
    with CullLog(widths=None, check=True) as log:
        eo._build_exact(*args)
    print(f"exact build d{depth} both ways (_build_exact): plain cull {secs['plain']:.3f} s, "
          f"K13 {secs['K13']:.3f} s ({secs['plain'] / secs['K13']:.1f}x); octree, leaf_offset, "
          f"leaf_count, tri_flat, leaf_centers identical, and the main path's too; K13 "
          f"bit-equal to the plain route on all {log.checked} groups in every form "
          f"(widths {sorted(log.kept)}); {_skip_line(log.tally)}")
    del out
    return dict(plain_s=secs["plain"], k13_s=secs["K13"], groups=log.checked, kept=log.kept,
                tables=eo.prepare_cull_inputs(tris, "region"))


BUILD_PARTS = (("K13 region cull", ("region_cull",)),
               ("sorts (the compactions' torch.sort)", ("sort", "Sort")),
               ("gathers, scatters, index", ("gather", "scatter", "index", "Index")),
               ("reductions", ("reduce", "Reduce")),
               ("copies, fills", ("Memcpy", "Memset", "copy", "fill", "Fill")),
               ("elementwise", ("elementwise", "vectorized", "unrolled")))
SYNC_CALLS = ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaDeviceSynchronize")


def build_profile_alone(depth: int, plain: int = 0, profiled: int = 1) -> None:
    """The exact build's breakdown at ``depth`` (``BUILDS``), in a process
    of its own (the full smoke starts one for d7 with K13): ``ExactOctreeSdf``
    built once as the main path builds it (its wall seconds), once with
    each phase synchronised at its ends (seconds of the cull, of
    ``_compact_rows`` and ``_compact_leaf_rows``, of the rest of
    ``finish``: the group's host read of its kept counts, the leaf and
    child bookkeeping; of ``_fill_tri_flat``; of the rest of
    ``_build_exact``; of the buckets and the rest of the entry point), and
    with ``profiled`` once under torch.profiler (device time by kind of
    kernel, the busy share, host time in the CUDA calls that wait). With
    ``plain`` the cull's plain version is pinned (the parent's build)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdflib_tpu_torch import ExactOctreeSdf
    from sdflib_tpu_torch.sdf import exact_octree as eo
    from sdflib_tpu_torch.utils.primitives import make_torus

    dev = torch.device("cuda", 0)
    torus, start, budget = BUILDS[depth]
    mesh = make_torus(R=0.3, r=0.12, **torus)
    box = mesh.bounding_box.add_margin(0.14)
    label = f"d{depth} {'plain cull' if plain else 'K13'}"
    if plain:                         # for the rest of this process
        eo._cull_group = functools.partial(eo._cull_group, plain=True)

    def build():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sdf = ExactOctreeSdf(mesh, box, max_depth=depth, start_depth=start,
                             min_triangles_per_node=32, bucket_byte_budget=budget, device=dev)
        torch.cuda.synchronize()
        return sdf, time.perf_counter() - t0

    sdf, wall = build()
    leaves = sdf.num_leaves
    del sdf
    acc, calls = collections.defaultdict(float), collections.Counter()

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                acc[name] += time.perf_counter() - t0
                calls[name] += 1
        return run

    patched = [(eo, n) for n in ("_compact_rows", "_compact_leaf_rows", "_fill_tri_flat",
                                 "_build_exact", "calculate_mesh_triangle_data")]
    patched += [(eo._ExactBuild, "cull"), (eo._ExactBuild, "finish"),
                (eo.ExactOctreeSdf, "_set_state")]
    real = {(obj, n): getattr(obj, n) for obj, n in patched}
    for (obj, n), fn in real.items():
        setattr(obj, n, timed(n, fn))
    _, phased = build()
    for (obj, n), fn in real.items():
        setattr(obj, n, fn)
    parts = {
        "calculate_mesh_triangle_data (host numpy)": acc["calculate_mesh_triangle_data"],
        "cull": acc["cull"],
        "_compact_rows": acc["_compact_rows"],
        "_compact_leaf_rows": acc["_compact_leaf_rows"],
        "finish's rest (host read of the kept counts, bookkeeping)":
            acc["finish"] - acc["_compact_rows"] - acc["_compact_leaf_rows"],
        "_fill_tri_flat": acc["_fill_tri_flat"],
        "_build_exact's rest (levels, merges, host epilogue)":
            acc["_build_exact"] - acc["cull"] - acc["finish"] - acc["_fill_tri_flat"],
        "_set_state (the bucket tables, the query's tables)": acc["_set_state"],
        "the rest of the entry point": (phased - acc["_build_exact"] - acc["_set_state"]
                                        - acc["calculate_mesh_triangle_data"]),
    }
    print(f"build breakdown, {label} ({leaves} leaves): {wall:.3f} s as the main path builds it; "
          f"{phased:.3f} s with each phase synchronised ({calls['cull']} groups, "
          f"{calls['finish']} finishes):")
    for name, s in parts.items():
        print(f"    {s:.3f} s ({s / phased:.1%})  {name}")
    if not profiled:
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_s = build()
    avgs = prof.key_averages()
    on_dev = collections.defaultdict(float)
    for e in avgs:
        if e.device_type == DeviceType.CUDA:
            on_dev[e.key] += e.self_device_time_total / 1e6
    busy = sum(on_dev.values())
    waits = sum(e.self_cpu_time_total for e in avgs if e.key in SYNC_CALLS) / 1e6
    groups, left = collections.defaultdict(float), dict(on_dev)
    for name, marks in BUILD_PARTS:
        for key in [k for k in left if any(m in k for m in marks)]:
            groups[name] += left.pop(key)
    groups["other kernels"] = sum(left.values())
    acts = sum(e.count for e in avgs if e.device_type == DeviceType.CUDA)
    print(f"build profile, {label}: {prof_s:.3f} s under the profiler, device busy {busy:.3f} s "
          f"({busy / prof_s:.1%}), host time in {'/'.join(SYNC_CALLS)} {waits:.3f} s "
          f"({waits / prof_s:.1%}), {acts} device activities")
    for name, s in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {s:.4f} s ({s / max(busy, 1e-12):.1%} of busy)  {name}")
    for key, s in sorted(on_dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"      {s:.4f} s  {key[:90]}")
    _check(busy > 0.0, f"the build's profiler session recorded no device activity ({label})")


def morton_profile(pts, label):
    """K2's point order split into its pieces at ``pts``' shape: one
    ``morton_order`` call under torch.profiler (device ms of each activity,
    host self time), then CUDA-event ms of the whole call, of
    ``torch.aminmax`` alone and of a stable ``torch.sort`` of the int32
    codes alone (the pieces of the plain order). Below the one-launch
    cutoff the order must be the profiler's only device activity."""
    import torch

    from sdflib_tpu_torch.ops import nearest

    dev_ms = dict.fromkeys(("morton_order_kernel", "morton_box_kernel", "morton_codes_kernel"))
    ev_ms, busy_ms, acts = breakdown(lambda: nearest.morton_order(pts), f"Morton order, {label}",
                                     top=8, device_ms=dev_ms)
    lo, hi = torch.aminmax(pts, dim=0)
    codes = nearest.morton_codes_plain(pts, lo, hi)
    aminmax_ms = _cuda_ms(lambda: torch.aminmax(pts, dim=0))
    sort_ms = _cuda_ms(lambda: torch.sort(codes, stable=True))
    print(f"Morton order pieces ({label}, P={pts.shape[0]}): the order {ev_ms:.4f} ms (CUDA "
          f"events), device busy {busy_ms:.4f} ms in {acts} activities ("
          + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms.items() if v)
          + f"); alone: aminmax {aminmax_ms:.4f} ms, the stable sort of the int32 codes "
          f"{sort_ms:.4f} ms")
    if pts.shape[0] <= nearest.morton_order_max(pts.device):
        _check(acts == 1 and dev_ms["morton_order_kernel"] > 0,
               f"the order made {acts} device activities a call ({label}): one kernel, no "
               f"aminmax or sort")


def morton_profile_alone(n: int, seed: int) -> None:
    """``morton_profile`` of ``n`` uniform points (``seed``) in the d7
    torus's box, in a process of its own: the full smoke starts one a
    shape. On an H100 the profiler recorded no device activity for the
    order's launch inside the full smoke, nor in a child's second profiled
    call (as for K4's launches, ``approx_profile``); a fresh process's
    first recorded it each time."""
    import torch

    from sdflib_tpu_torch.utils.primitives import make_torus

    dev = torch.device("cuda", 0)
    box = make_torus(R=0.3, r=0.12, nu=420, nv=120).bounding_box.add_margin(0.14)
    morton_profile(_uniform(box, n, seed, dev), f"{n} points, a process of its own")


# Profiler sessions a breakdown takes at most (see ``breakdown``).
PROFILE_TRIES = 3
# Host-side profiler events that wait for the device (a tensor read as a
# Python number, a nonzero's size) and that launch a CUDA graph.
SYNC_EVENTS = ("aten::_local_scalar_dense", "aten::nonzero")
GRAPH_LAUNCH_EVENTS = ("cudaGraphLaunch",)


def breakdown(fn, label, top=6, counts=None, device_ms=None, activities=None,
              warm=False):
    """Where a call's time goes: CUDA-event time, device and host time
    per call from torch.profiler over 3 calls, the busy share, and the
    kernels with the most device time. Returns (CUDA-event ms, device
    busy ms, device activities a call). ``counts``, a dict of event
    names, receives each name's calls a call (summed over the names of a
    tuple key); ``device_ms``, a dict of name parts, the device ms a call
    of the activities whose names hold each part; ``activities``, a
    dict, receives each device activity's count a call by name. ``warm``
    profiles one more call first and drops its activities: at the start
    of a session the profiler can miss the first call's first activities
    (at d7 2^20 about 10 of the query's 33, which read as 29 a call). On
    an H100 a profiler session now and then records no device activity
    at all, torch's own kernels included, or only some of one call's: such
    a session is profiled again, up to ``PROFILE_TRIES`` sessions in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    ev_ms = _cuda_ms(fn)
    steps = schedule(wait=0, warmup=1, active=3, repeat=1) if warm else None
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=steps) as prof:
            for _ in range(4 if warm else 3):
                fn()
                if warm:
                    torch.cuda.synchronize()
                    prof.step()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        # a warm session's step annotations span whole calls: no activity
        avgs = [e for e in avgs if not e.key.startswith("ProfilerStep")]
        on_dev = [e for e in avgs if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in on_dev) >= 3:
            break
        print(f"breakdown, {label}: the profiler session recorded less than one device "
              f"activity a call")
    dev_us = collections.defaultdict(float)      # a name may head several rows
    for e in on_dev:
        dev_us[e.key] += e.self_device_time_total / 3
    host_ms = sum(e.self_cpu_time_total for e in avgs
                  if e.device_type == DeviceType.CPU) / 3e3
    busy_ms = sum(dev_us.values()) / 1e3
    print(f"breakdown, {label}: {ev_ms:.4f} ms a call (CUDA events); device "
          f"busy {busy_ms:.4f} ms ({busy_ms / ev_ms:.1%}), host self time "
          f"under the profiler {host_ms:.4f} ms, "
          f"{sum(e.count for e in on_dev) // 3} device activities a call")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3:.4f} ms ({us / 1e3 / ev_ms:.1%})  {key[:90]}")
    for names in counts or {}:
        counts[names] = sum(e.count for e in avgs if e.key in names) / 3
    for part in device_ms or {}:
        device_ms[part] = sum(us for key, us in dev_us.items() if part in key) / 1e3
    for e in on_dev if activities is not None else ():
        activities[e.key] = activities.get(e.key, 0.0) + e.count / 3
    return ev_ms, busy_ms, sum(e.count for e in on_dev) // 3


def device_timeline(fn, label, long_us: float = 20.0):
    """One call of ``fn`` under torch.profiler, read as a timeline: the
    union of the device activities' intervals over the span from the
    first one's start to the last one's end (one call, so the share
    cannot pass 100%), and the idle gaps in that span, split at
    ``long_us``: short gaps between queued kernels (a graph's nodes, or
    launches ahead of the device) and long ones, where the device waited
    on the host. Returns (span ms, busy ms, short-gap ms, long gaps,
    long-gap ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy = short = long_sum = 0.0
    gaps = []
    lo, hi = spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            gaps.append(start - hi)
            lo = start
        hi = max(hi, end)
    busy += hi - lo
    span = hi - spans[0][0]
    long_gaps = [g for g in gaps if g >= long_us]
    short, long_sum = sum(gaps) - sum(long_gaps), sum(long_gaps)
    print(f"timeline, {label}: {len(spans)} device activities over {span / 1e3:.4f} ms, "
          f"busy {busy / 1e3:.4f} ms ({busy / span:.1%}); idle {short / 1e3:.4f} ms in "
          f"{len(gaps) - len(long_gaps)} gaps under {long_us:.0f} us (mean "
          f"{short / max(len(gaps) - len(long_gaps), 1):.3f} us), {long_sum / 1e3:.4f} ms in "
          f"{len(long_gaps)} gaps of {long_us:.0f} us or more (largest "
          f"{sorted(long_gaps, reverse=True)[:5]} us)")
    return span / 1e3, busy / 1e3, short / 1e3, len(long_gaps), long_sum / 1e3


def _uniform(box, n: int, seed: int, dev):
    """``n`` uniform points (numpy seed) 1e-4 inside ``box``, on ``dev``."""
    import torch

    lo = np.asarray(box.min) + 1e-4
    hi = np.asarray(box.max) - 1e-4
    return torch.as_tensor(
        np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32), device=dev
    )


def _cuda_ms_prep(prep, fn, reps: int = 3) -> float:
    """Best of ``reps`` calls of ``fn`` (CUDA events, after one warmup),
    each after ``prep()``, which runs before the start event: ms of ``fn``
    alone."""
    import torch

    prep()
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        prep()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def k4_vs_plain(sdf, pts):
    """K4 against its plain version on both grid routes of ``sdf`` (thin
    grid, fused rows), with and without the gradient: max |d diff| <=
    1e-6, gradient components within 1e-5. Each group size (the lanes that
    share a point, ``octree_query.GROUPS``; 1 is one thread a point) is
    held bit-equal to the group of 1 and timed; the default group and the
    plain version are timed beside the bound: the points in and the
    outputs out once, each touched grid row and coefficient row (or fused
    row) once, and the kernel's flops. Returns {(fat, grad): (max err, ms,
    plain ms, bound)} of the default group."""
    import torch

    from sdflib_tpu_torch.ops import octree_query as oq

    n, nc = pts.shape[0], sdf.num_coefficients
    _, in_box, lin = oq._grid_cells(pts, sdf._box_min, sdf._box_size3, sdf.max_depth)
    cells = torch.unique(lin[in_box])
    coeff_rows = int(torch.unique((sdf._query_grid[cells, 0] & 0x3FFFFFFF) // nc).numel())
    # a fused row's live words 0-65 span 3 of its 128-B lines
    row_bytes = {False: cells.numel() * 8 + coeff_rows * nc * 4,
                 True: cells.numel() * (2 + nc) * 4}
    out = {}
    for fat in (False, True):
        grid = sdf._leaf_grid(fat)
        for grad in (False, True):
            label = f"{'fused rows' if fat else 'thin grid'}{', gradient' if grad else ''}"
            ref = oq.grid_query_plain(grid, pts, grad)
            ref = ref if grad else (ref,)
            forms = {}
            one = None
            for group in oq.GROUPS:
                got = oq.grid_query(grid, pts, grad, group=group)
                got = got if grad else (got,)
                one = got if one is None else one
                d_err = float((got[0] - ref[0]).abs().max())
                g_err = float((got[1] - ref[1]).abs().max()) if grad else 0.0
                _check(d_err <= 1e-6, f"K4 distances differ from the plain version's by "
                                      f"{d_err} ({label}, group {group})")
                _check(g_err <= 1e-5, f"K4 gradients differ from the plain version's by "
                                      f"{g_err} ({label}, group {group})")
                _check(all(torch.equal(a, b) for a, b in zip(got, one)),
                       f"K4 group {group} departs from the group of 1 ({label})")
                forms[group] = (max(d_err, g_err), _cuda_ms(
                    lambda: oq.grid_query(grid, pts, grad, group=group)))
                del got
            same = all(torch.equal(a, b) for a, b in zip(one, ref))
            del one, ref
            err, ms = forms[oq.GROUP[grad]]
            plain_ms = _cuda_ms(lambda: oq.grid_query_plain(grid, pts, grad))
            bound = _bound(n * (16 + (12 if grad else 0)) + row_bytes[fat],
                           n * (FLOPS_K4_GRAD if grad else FLOPS_K4))
            print(f"K4 grid query vs plain ({label}, {n} points): max |diff| {err:.3e} (d "
                  f"within 1e-6, g within 1e-5), bit-equal to plain {same}; every group "
                  f"bit-equal to one thread a point; kernel, group {oq.GROUP[grad]}: {ms:.4f} ms "
                  f"({n / ms * 1e3:.4e} q/s), plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms "
                  f"({bound[1]}; {cells.numel()} cells, {coeff_rows} coefficient rows "
                  f"touched) = {bound[0] / ms:.1%} of the kernel's time; lanes a point: "
                  + ", ".join(f"{g} {t:.4f} ms" for g, (_, t) in forms.items()))
            out[(fat, grad)] = (err, ms, plain_ms, bound)
    # coherent warps (the points sorted by cell, as a traced frame's hits
    # come): few rows a warp, which each warp reads one thread a point
    srt = pts[torch.argsort(lin)].contiguous()
    grid = sdf._leaf_grid(False)
    one = oq.grid_query(grid, srt, False, group=1)
    times = {}
    for group in oq.GROUPS:
        _check(torch.equal(oq.grid_query(grid, srt, False, group=group), one),
               f"K4 group {group} departs from the group of 1 on sorted points")
        times[group] = _cuda_ms(lambda: oq.grid_query(grid, srt, False, group=group))
    # what the order costs: the sort by cell, the points' gather and the
    # distances' scatter back
    d_srt = torch.empty_like(one)
    sort_ms = _cuda_ms(lambda: d_srt.index_copy_(0, (order := torch.argsort(lin)),
                                                  pts[order][:, 0]))
    print(f"K4 on the same points sorted by cell (thin grid; every group bit-equal to one "
          f"thread a point): " + ", ".join(f"{g} {t:.4f} ms" for g, t in times.items())
          + f"; the sort, the gather and the unsort {sort_ms:.4f} ms")
    return out


def _row_bytes(sdf, grid, cells) -> int:
    """Bytes of each touched row of ``grid`` read once, for the cells
    (linear indices) ``cells``: a thin grid's 8-B row and the coefficient
    row each word names, or each fused row's live words."""
    import torch

    nc = sdf.num_coefficients
    cells = torch.unique(cells)
    if grid.fat:
        return cells.numel() * (2 + nc) * 4
    rows = torch.unique((grid.rows[cells, 0] & 0x3FFFFFFF) // nc).numel()
    return cells.numel() * 8 + rows * nc * 4


BEAM_MARKS = (8, 16, 32, 64, 128, 255)


def beam_histogram(sdf, origins, dirs, kw):
    """K6's trip histogram on the frame's beams: the plain beam run one
    trip at a time from the frame's setup, the beams still live after
    each of ``BEAM_MARKS`` trips; then K6 from the same start with
    budgets of 16, 64 and 256 trips in one launch, timed (CUDA events
    around a call, and its device time from graph replays, ``_graph_ms``)."""
    import importlib

    import torch

    from sdflib_tpu_torch.ops import march as om

    st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
    R = origins.shape[0] * origins.shape[1]
    frame = st._Frame(sdf, origins.shape, R, R, R, beam=4, graphs=False, **kw)
    frame.o_in.copy_(origins.reshape(-1, 3))
    frame.d_in.copy_(dirs.reshape(-1, 3))
    frame.live_in.fill_(1.0)
    frame._setup()
    grid = sdf._leaf_grid(False)
    bufs = [frame.b_pos, frame.b_acc, frame.b_active]
    consts = (frame.b_dirs, frame.b_r0, frame.b_rd, frame.route.margin, frame.beam_far)
    start = [b.clone() for b in bufs]
    live, useful, longest = {}, 0, 0
    for t in range(1, st._BEAM_ITERS + 1):     # trip t of every beam live before it
        n_live = int((bufs[2] > 0).sum())
        if not n_live:
            break
        useful, longest = useful + n_live, t
        om.beam_segment_plain(grid, *bufs, *consts, 1)
        if t in BEAM_MARKS:
            live[t] = int((bufs[2] > 0).sum())
    live.update({t: 0 for t in BEAM_MARKS if t not in live})

    def restore():
        for b, x in zip(bufs, start):
            b.copy_(x)

    budgets = {}
    restore_ms = _graph_ms(restore)
    for k in (16, 64, 256):
        def launch():
            om.beam_segment(grid, *bufs, *consts, k)
        budgets[k] = (_cuda_ms_prep(restore, launch),
                      _graph_ms(lambda: (restore(), launch())) - restore_ms)
    restore()
    n = bufs[0].shape[0]
    past = max(min(longest, 64) - 16, 1)
    print(f"K6 trip histogram ({n} beams, the plain beam trip by trip): live after "
          + ", ".join(f"{t} trips {k}" for t, k in live.items())
          + f"; {useful} useful trips ({useful / n:.2f} a beam), the longest beam {longest} "
          f"trips; K6 in one launch with a budget of "
          + ", ".join(f"{k} trips {ms:.4f} ms (device {dev:.4f})"
                      for k, (ms, dev) in budgets.items())
          + f"; the tail, (64-trip - 16-trip device ms) / the longest beam's {past} trips "
          f"past 16: {(budgets[64][1] - budgets[16][1]) / past * 1e3:.4f} us a trip")
    del frame


def segments_vs_plain(sdf, origins, dirs, kw):
    """K6 and K5 against their plain versions in the frame's forms, on the
    tracer's rows (the thin grid and the words): the whole beam prepass
    (its 256 trips of every beam) in one K6 launch from its setup, then
    (the beams marched) the first round's 8 trips of every ray in one K5
    launch from its start. The end states are compared (active flags, step
    counts, depths), then each launch is timed from the same start state
    (restored before the start event), beside its bound: the state read
    and written once, each touched row once (the plain version's cells,
    trip by trip), and the kernel's flops a useful trip. Then each
    kernel's forms from the same starts, held bit-equal and timed: the
    prepass in one launch and in 16-trip launches (the earlier form); a
    64-trip budget of every ray in one K5 launch, in four 16-trip launches
    and on the fused rows. Returns {"beam": ...,
    "march": ...}, each (max |depth diff|, ms, plain ms, bound)."""
    import importlib

    import torch

    from sdflib_tpu_torch.ops import march as om
    from sdflib_tpu_torch.ops import octree_query as oq

    st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
    R = origins.shape[0] * origins.shape[1]
    frame = st._Frame(sdf, origins.shape, R, R, R, beam=4, graphs=False, **kw)
    frame.o_in.copy_(origins.reshape(-1, 3))
    frame.d_in.copy_(dirs.reshape(-1, 3))
    frame.live_in.fill_(1.0)
    frame._setup()
    grid, fat = sdf._leaf_grid(False), sdf._leaf_grid(True)
    box = float(sdf.box.size[0])

    def restorer(bufs, start):
        def restore():
            for b, x in zip(bufs, start):
                b.copy_(x)
        return restore

    def run(name, segment, plain, bufs, consts, trips, state_bytes, flops):
        start = [b.clone() for b in bufs]
        ref = [b.clone() for b in start]
        cells, useful = [], 0
        act = 2 if name == "beam" else 3
        for _ in range(trips):       # the plain version trip by trip: its cells
            live = ref[act] > 0
            _, in_box, lin = oq._grid_cells(ref[0][live], grid.box_min, grid.box_size3,
                                            grid.depth)
            cells.append(lin[in_box])
            useful += int(live.sum())
            plain(grid, *ref, *consts, 1)
        got = [b.clone() for b in start]
        segment(grid, *got, *consts, trips)
        agree = float((got[act] == ref[act]).float().mean())
        d_err = float((got[1] - ref[1]).abs().max())
        its_eq = float((got[4] == ref[4]).float().mean()) if name == "march" else 1.0
        _check(agree >= 0.999 and its_eq >= 0.999,
               f"{name}: active flags agree on {agree:.4%}, step counts on {its_eq:.4%}")
        _check(float(torch.quantile((got[1] - ref[1]).abs(), 0.99)) <= 1e-4 * box,
               f"{name}: depths differ from the plain version's, q99 above 1e-4 of the box")
        restore = restorer(bufs, start)
        ms = _cuda_ms_prep(restore, lambda: segment(grid, *bufs, *consts, trips))
        plain_ms = _cuda_ms_prep(restore, lambda: plain(grid, *bufs, *consts, trips))
        n = bufs[0].shape[0]
        touched = torch.cat(cells)
        rows = _row_bytes(sdf, grid, touched)
        bound = _bound(n * state_bytes + rows, useful * flops)
        print(f"{name} launch vs plain ({n} rays, {trips} trips in one launch, {useful} useful "
              f"trips, {int(torch.unique(touched).numel())} cells, {rows} B of thin-grid and "
              f"coefficient rows touched): active flags agree on {agree:.6%}, step counts on "
              f"{its_eq:.6%}, max |depth diff| {d_err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}) = "
              f"{bound[0] / ms:.1%} of the kernel's time")
        restore()
        segment(grid, *bufs, *consts, trips)
        return d_err, ms, plain_ms, bound

    def forms(name, bufs, fns, device=False):
        """Each form from the same start state: bit-equal to the first, and
        timed (with ``device``, also its device ms from graph replays)."""
        start = [b.clone() for b in bufs]
        restore = restorer(bufs, start)
        first, times = None, {}
        for label, fn in fns.items():
            restore()
            fn()
            end = [b.clone() for b in bufs]
            first = end if first is None else first
            _check(all(torch.equal(a, b) for a, b in zip(end, first)),
                   f"{name}: the form '{label}' departs from '{next(iter(fns))}'")
            times[label] = _cuda_ms_prep(restore, fn)
            if device:
                times[label] = (times[label], _graph_ms(lambda: (restore(), fn()))
                                - _graph_ms(restore))
        restore()
        print(f"{name} forms from one start, bit-equal: " + ", ".join(
            f"{k} {t:.4f} ms" if not device else f"{k} {t[0]:.4f} ms (device {t[1]:.4f})"
            for k, t in times.items()))
        return times

    beam_bufs = [frame.b_pos, frame.b_acc, frame.b_active]
    beam_consts = (frame.b_dirs, frame.b_r0, frame.b_rd, frame.route.margin, frame.beam_far)
    forms("K6 beam prepass (65,536 beams x 256 trips)", beam_bufs, {
        "one launch": lambda: om.beam_segment(grid, *beam_bufs, *beam_consts, st._BEAM_ITERS),
        "16-trip launches": lambda: [om.beam_segment(grid, *beam_bufs, *beam_consts, 16)
                                     for _ in range(0, st._BEAM_ITERS, 16)],
    }, device=True)
    out = {"beam": run("beam", om.beam_segment, om.beam_segment_plain, beam_bufs, beam_consts,
                       st._BEAM_ITERS, BEAM_STATE_BYTES, FLOPS_BEAM_TRIP)}
    frame._start()
    bufs = [frame.pos, frame.acc, frame.last_d, frame.active, frame.its]
    consts = (frame.dirs, frame.eps_w, frame.far_w)
    forms(f"K5 march ({R} rays x 64 trips)", bufs, {
        "one launch": lambda: om.march_segment(grid, *bufs, *consts, 64),
        "16-trip launches": lambda: [om.march_segment(grid, *bufs, *consts, 16)
                                     for _ in range(4)],
        "fused rows": lambda: om.march_segment(fat, *bufs, *consts, 64),
    })
    out["march"] = run("march", om.march_segment, om.march_segment_plain, bufs, consts,
                       frame.schedule[0][0], MARCH_STATE_BYTES, FLOPS_MARCH_TRIP)
    del frame
    return out


def approx_path(dev, root: str, n_query: int):
    """Main path C: the approximate octree at bench.py's configuration on
    ``dev``. The counts run from the first build to the last golden
    query; then the routes are held to each other, the queries timed on
    ``n_query`` points and K2 checked at the seed lattice's shape.
    Returns (the path's launch counts, K2's check there, K4's checks at
    ``n_query`` points, ``k4_vs_plain``)."""
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
    for name in ("nearest", "octree_query"):
        _check(launches[name] > 0, f"{name} was not launched on path C")

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
    k4 = k4_vs_plain(sdf, pts)

    # the query on n_query points: each route timed, then the profiler;
    # the bound is K4's (inputs once, each touched row once), beside the
    # earlier statement, each point re-reading its rows
    n = pts.shape[0]
    for label, fn, (_, _, _, bound), per_point in (
        ("get_distance", lambda: sdf.get_distance(pts), k4[(False, False)], APPROX_POINT_BYTES),
        ("get_distance_and_gradient", lambda: sdf.get_distance_and_gradient(pts),
         k4[(False, True)], APPROX_GRAD_BYTES),
    ):
        ms = _cuda_ms(fn)
        print(f"approx {label} d6 {n} points (grid route): {ms:.4f} ms ({n / ms * 1e3:.4e} "
              f"q/s); bound {bound[0]:.4f} ms ({bound[1]}, inputs once) = {bound[0] / ms:.1%} "
              f"of it ({n * per_point / PEAK_BYTES * 1e3:.4f} ms at {per_point} B a point)")
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
    # the profiler records no device activity for K4's launches inside the
    # full smoke, but does in a fresh process: the busy share comes from one
    probe = subprocess.run([sys.executable, "-c", "import sys, chip_smoke as cs; "
                            f"cs.approx_profile(int(sys.argv[1]))", str(n)], cwd=root,
                           capture_output=True, text=True, timeout=600)
    print(probe.stdout, end="")
    _check(probe.returncode == 0, f"path C's profiler process failed:\n{probe.stderr[-4000:]}")

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
    return launches, k2, k4


def approx_profile(n_query: int, n_rays: int = 1024) -> None:
    """Path C's busy share, in a process of its own (``approx_path`` starts
    one): path C's no_continuity octree and its grids built on the card,
    then ``get_distance`` and ``get_distance_and_gradient`` on ``n_query``
    uniform points (seed 1) broken down by the profiler. Inside the full
    smoke the profiler records no device activity for K4's launches. Then
    the walk frame's (``walk_frame_profile``) on the same octree saved
    before its grids and loaded with no grid, ``n_rays``^2 rays: a
    process of the profiler's costs the smoke ~20 s, so the two share
    one."""
    import tempfile

    import torch

    from sdflib_tpu_torch import OctreeSdf
    from sdflib_tpu_torch.utils.primitives import make_torus

    dev = torch.device("cuda", 0)
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    sdf = OctreeSdf(mesh, box, max_depth=6, start_depth=2, termination_threshold=1e-3,
                    init_algorithm="no_continuity", device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    path = os.path.join(tmp, "approx_d6.npz")
    sdf.save(path)
    sdf.build_query_grid()
    pts = _uniform(box, n_query, 1, dev)
    for label, fn in (("get_distance", lambda: sdf.get_distance(pts)),
                      ("get_distance_and_gradient", lambda: sdf.get_distance_and_gradient(pts))):
        _, busy_ms, acts = breakdown(fn, f"approx {label} d6 {n_query} points, grid route "
                                         f"(a process of its own)", top=8)
        _check(acts > 0 and busy_ms > 0.0, f"the profiler saw no device activity ({label})")
    del sdf, pts
    try:
        walk_frame_profile(path, n_rays)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    run from the build to the first frame, which captures the frame's one
    CUDA graph. A second frame replays it; both equal the eager schedule
    bit for bit, with no host sync. The frame on the fused rows equals it
    bit for bit and is timed beside it. The
    kernel frame (K4-K6) is held to the frame with the plain step pinned
    (``_plain``), which also records the cells its live rays touch: the
    frame's bound. Then the graph path and the dynamic scheduler are timed
    and broken down (with K4-K6's device time a frame), K5 and K6 held to
    their plain versions in the frame's forms (``segments_vs_plain``), the
    two ways held to each other, the graph path's hits held to a plain
    host march, to ``RealSdf`` and to the trace without a beam; then a
    512^2 camera frame shaded five ways and a 512^2 plane cut. Returns
    (the path's launch counts, the segments' checks)."""
    import importlib
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
    from sdflib_tpu_torch.ops import march as march_ops
    from sdflib_tpu_torch.ops import octree_query as oq
    from sdflib_tpu_torch.render.sphere_trace import _trace
    from sdflib_tpu_torch.utils.primitives import make_torus

    st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
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
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = trace_octree(sdf, origins, dirs, stats_out=stats, **kw)    # captures the graphs
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches = read_counts()
    print(f"trace path D: octree and query grid built in {build_s:.3f} s; launches on "
          f"main path D: {launches}")
    for name in ("nearest", "octree_query", "march", "beam"):
        _check(launches[name] > 0, f"{name} was not launched on path D")

    hit = res.hit
    n_hit = int(hit.sum())
    trips = int(res.iterations.sum(dtype=torch.int64))
    _check(res.depth.shape == (n_rays, n_rays) and bool(torch.isfinite(res.depth).all())
           and bool(torch.isfinite(res.normal[hit]).all()), "trace outputs are not finite")
    _check(0 < n_hit < R, f"{n_hit} of {R} rays hit")
    sched = stats["rounds"][0][1]
    print(f"trace d6 {n_rays}^2 rays, the graph path's first frame: {capture_s:.3f} s (host "
          f"clock, the warm-up run and the capture included); {stats['graphs_captured']} "
          f"graphs captured, {stats['host_syncs']} host syncs (stats); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB; pyramid {sched} "
          f"({sum(k * n for k, n in sched)} prefix ray-trips offered)")
    _check(stats["graphs_captured"] == 1, f"the frame captured {stats['graphs_captured']} graphs")
    _check(stats["host_syncs"] == 0, f"the frame made {stats['host_syncs']} host syncs")
    again = {}
    res2 = trace_octree(sdf, origins, dirs, stats_out=again, **kw)
    _check(again["graphs_captured"] == 0 and again["graphs_replayed"] == 1
           and again["host_syncs"] == 0, f"the second frame did not replay its graph: {again}")
    eager = _trace(sdf, origins, dirs, block_size=None, beam=4, pyramid=True, stats_out=None,
                   active=None, graphs=False, **kw)
    same = [torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(res, res2, eager)]
    print(f"graph frames against the eager schedule, bit-equal by field: {same}")
    _check(all(same), "the graph frame departs from the eager schedule")
    del res2, eager

    # the tracer's rows: the fused rows (the structure's leaf grid patched
    # to them) trace the same frame bit for bit; each timed as its own
    # captured frame (the frames are dropped around the patch: the route's
    # key names the arrays, not the choice of rows)
    def fresh_frames():
        torch.cuda.synchronize(dev)
        st._FRAMES.frames.clear()

    frame_forms = {"thin grid": _cuda_ms(lambda: trace_octree(sdf, origins, dirs, **kw))}
    fresh_frames()
    sdf._leaf_grid = lambda fat: OctreeSdf._leaf_grid(sdf, True)
    try:
        _check(st._route(sdf, kw["eps"]).march.args[0].fat, "the patch missed the route")
        other = trace_octree(sdf, origins, dirs, **kw)         # captures its own graph
        frame_forms["fused rows"] = _cuda_ms(lambda: trace_octree(sdf, origins, dirs, **kw))
    finally:
        del sdf._leaf_grid
        fresh_frames()
    eq = [torch.equal(a, b) for a, b in zip(res, other)]
    print(f"trace frame on the fused rows against the thin grid, bit-equal by field (hit, "
          f"position, depth, normal, iterations): {eq}")
    _check(all(eq), "the frame on the fused rows departs from the thin-grid frame")
    del other
    print("trace frame forms (ms a frame, CUDA events, best of 3): "
          + ", ".join(f"{k} {t:.4f}" for k, t in frame_forms.items()))
    # K4 at the frame's normals: coherent points, neighbouring rays on
    # neighbouring rows
    at = res.position.reshape(-1, 3).contiguous()
    shade = sdf._leaf_grid(False)
    _, in_box, lin = oq._grid_cells(at, shade.box_min, shade.box_size3, shade.depth)
    normals_bound = _bound(R * (12 + 16) + _row_bytes(sdf, shade, lin[in_box]),
                           R * FLOPS_K4_GRAD)
    normals_plain_ms = _cuda_ms(lambda: oq.grid_query_plain(shade, at, True))
    print("K4 with the gradient at the frame's 1024^2 end positions (the normals): "
          + ", ".join(f"{g} lanes a row {_cuda_ms(lambda: oq.grid_query(shade, at, True, group=g)):.4f} ms"
                      for g in oq.GROUPS)
          + f"; plain {normals_plain_ms:.4f} ms; bound {normals_bound[0]:.4f} ms "
          f"({normals_bound[1]})")

    # the kernel frame (K4-K6) against the frame with the plain step pinned
    # (eager: its torch trips check for live rays, a host sync, every 16
    # trips); that frame also records the cells its live rays touch
    box_size = float(sdf.box.size[0])
    thin = sdf._leaf_grid(False)
    touched = []

    def record(pos, active):
        _, in_box, lin = oq._grid_cells(pos[active > 0], thin.box_min, thin.box_size3,
                                        thin.depth)
        touched.append(torch.unique(lin[in_box]))

    trip, beam_trip = march_ops._trip, march_ops._beam_trip

    def rec_trip(step_fn, pos, acc, last_d, active, *rest):
        record(pos, active)
        trip(step_fn, pos, acc, last_d, active, *rest)

    def rec_beam(beam_step, pos, acc, active, *rest):
        record(pos, active)
        beam_trip(beam_step, pos, acc, active, *rest)

    sdf._plain = True
    march_ops._trip, march_ops._beam_trip = rec_trip, rec_beam
    try:
        pstats = {}
        plain = trace_octree(sdf, origins, dirs, stats_out=pstats, **kw)
    finally:
        march_ops._trip, march_ops._beam_trip = trip, beam_trip
    try:
        plain_frame_ms = _cuda_ms(lambda: trace_octree(sdf, origins, dirs, **kw))
    finally:
        sdf._plain = False
    record(res.position.reshape(-1, 3), torch.ones(R, device=dev))     # the normals
    frame_rows = _row_bytes(sdf, thin, torch.cat(touched))
    frame_bytes = R * FRAME_RAY_BYTES + frame_rows
    frame_bound = _bound(frame_bytes, trips * FLOPS_MARCH_TRIP)
    agree = float((plain.hit == hit).float().mean())
    both = plain.hit & hit
    dd = (plain.depth[both] - res.depth[both]).abs()
    q99 = float(torch.quantile(dd, 0.99))
    print(f"kernel frame against the plain frame ({plain_frame_ms:.4f} ms a frame, eager, "
          f"{pstats['host_syncs']} host syncs): hit masks agree on {agree:.6%}, |depth diff| on "
          f"{int(both.sum())} common hits q99 {q99:.3e}, max {float(dd.max()):.3e} (box "
          f"{box_size:.4f}); iterations equal on "
          f"{float((plain.iterations == res.iterations).float().mean()):.6%}")
    _check(agree >= 0.999, f"kernel and plain frames' hit masks agree on {agree:.4%}")
    _check(q99 <= 1e-4 * box_size, f"kernel and plain frames' depths differ, q99 {q99}")
    print(f"trace frame bound (inputs once: {FRAME_RAY_BYTES} B a ray in and out, "
          f"{frame_rows} B of thin-grid and coefficient rows the plain frame's live rays and "
          f"normals touch, each once): {frame_bound[0]:.4f} ms ({frame_bound[1]})")
    del plain, dd

    # both ways timed, each with its device activities, busy share, host
    # syncs and graph launches from the profiler
    dstats = {}
    dyn = trace_octree(sdf, origins, dirs, pyramid=False, stats_out=dstats, **kw)
    offered = {"graphs": stats["marched_ray_trips"],
               "dynamic": sum(k * n for k, n, _ in dstats["rounds"])}
    # the earlier statement: each useful ray-trip re-reads its row
    trip_bound = trips * TRACE_STEP_BYTES / PEAK_BYTES * 1e3
    frame_ms, kernel_ms = {}, {}
    for way, extra in (("graphs", {}), ("dynamic", {"pyramid": False})):
        def frame():
            return trace_octree(sdf, origins, dirs, **extra, **kw)

        ms = frame_ms[way] = _cuda_ms(frame)
        way_stats = {}
        trace_octree(sdf, origins, dirs, stats_out=way_stats, **extra, **kw)
        counts = {SYNC_EVENTS: 0, GRAPH_LAUNCH_EVENTS: 0}
        kernel_ms[way] = {"octree_query_kernel": 0.0, "march_kernel": 0.0, "beam_kernel": 0.0}
        ev_ms, busy_ms, acts = breakdown(frame, f"trace d6 {n_rays}^2 rays, {way}", top=8,
                                         counts=counts, device_ms=kernel_ms[way])
        k5_ms = kernel_ms[way]["march_kernel"]
        print(f"trace d6 {n_rays}^2 rays (beam 4, thin grid), {way}: {ms:.4f} ms a frame, "
              f"{R / ms * 1e3:.6e} rays/s; {acts} device activities, device busy "
              f"{busy_ms:.4f} ms ({busy_ms / ev_ms:.1%}); host syncs {counts[SYNC_EVENTS]:.0f}, "
              f"graph launches {counts[GRAPH_LAUNCH_EVENTS]:.0f} a frame (profiler); stats: "
              f"host syncs {way_stats.get('host_syncs', 'n/a')}, graphs replayed "
              f"{way_stats.get('graphs_replayed', 'n/a')}; useful ray-trips (sum of "
              f"iterations) {trips} against {offered[way]} offered; bound {frame_bound[0]:.4f} "
              f"ms (inputs once) = {frame_bound[0] / ms:.2%} of the frame ({trip_bound:.4f} ms "
              f"at {TRACE_STEP_BYTES} B a useful ray-trip); device ms a frame of K4 (normals) "
              f"{kernel_ms[way]['octree_query_kernel']:.4f}, K5 (march) {k5_ms:.4f} (the "
              f"bound is {frame_bound[0] / max(k5_ms, 1e-9):.2%} of it), K6 (beam) "
              f"{kernel_ms[way]['beam_kernel']:.4f}")
        if way == "graphs":
            _check(counts[SYNC_EVENTS] == 0 and counts[GRAPH_LAUNCH_EVENTS] == 1,
                   f"the profiler saw {counts[SYNC_EVENTS]} host syncs and "
                   f"{counts[GRAPH_LAUNCH_EVENTS]} graph launches a frame")
        device_timeline(frame, f"trace d6 {n_rays}^2 rays, {way}")
    beam_histogram(sdf, origins, dirs, kw)
    segments = segments_vs_plain(sdf, origins, dirs, kw)
    print(f"trace frames: graphs {frame_ms['graphs']:.4f} ms against dynamic "
          f"{frame_ms['dynamic']:.4f} ms ({frame_ms['dynamic'] / frame_ms['graphs']:.2f}x); "
          f"hits {n_hit}, max {int(res.iterations.max())} iterations a ray; graph stats "
          f"{again}; dynamic rounds (iters, marched, still active) {dstats['rounds']}")
    agree = float((dyn.hit == hit).float().mean())
    both = dyn.hit & hit
    d_err = float((dyn.depth[both] - res.depth[both]).abs().max())
    print(f"pyramid against dynamic: hit masks agree on {agree:.6%}, max |depth diff| "
          f"{d_err:.3e}; bit-equal by field {[torch.equal(a, b) for a, b in zip(res, dyn)]}")
    _check(agree >= 0.998, f"pyramid and dynamic hit masks agree on {agree:.4%}")
    _check(d_err <= 1e-3, f"pyramid and dynamic depths differ by {d_err}")
    del dyn
    # the dynamic frame's split: 8 trips over every ray (and the normals)
    # with and without the beam prepass, the later rounds the rest
    first_ms = _cuda_ms(lambda: trace_octree(sdf, origins, dirs, **dict(kw, max_iters=8)))
    round1_ms = _cuda_ms(lambda: trace_octree(sdf, origins, dirs, beam=None,
                                              **dict(kw, max_iters=8)))
    print(f"dynamic frame split: beam prepass {first_ms - round1_ms:.4f} ms; the first round "
          f"(8 trips over all {R} rays) and the normals {round1_ms:.4f} ms; the later "
          f"rounds {frame_ms['dynamic'] - first_ms:.4f} ms")

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
    print(f"trace without the beam: {nob_s * 1e3:.4f} ms (host clock, its graphs captured), "
          f"ray-trips "
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
    print(f"camera frame 512^2 (sdf_render defaults): {cam_s * 1e3:.3f} ms (host clock, its "
          f"graphs captured), "
          f"hits {int(cres.hit.sum())}, ray-trips {int(cres.iterations.sum(dtype=torch.int64))}; "
          f"shaded and written: {sizes}")
    print(f"plane cut 512^2: {cut_s * 1e3:.3f} ms (host clock, image to numpy included)")
    del sdf, res, cres, images, oracle
    torch.cuda.empty_cache()
    return launches, segments


# A beam trip of K15 counted as a K12 trip (the walk, the value, the step)
# and the radius, the division and the tests: ~320 flops.
FLOPS_WALK_BEAM_TRIP = 320


def _eager_parent_frame(sdf, origins, dirs, kw):
    """One frame on the parent commit's walk route, patched in: torch trips
    over K10's distance (one K10 launch, ~10 elementwise kernels and a host
    sync every 16 trips), so the frame runs eagerly, keyed apart. Returns
    (result, ms by CUDA events, stats)."""
    import importlib
    from functools import partial

    import torch

    from sdflib_tpu_torch.ops import walk as ow

    st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
    real, stats = st._route, {}

    def parent_route(octree, eps):
        r = real(octree, eps)
        if r.march.func is not ow.walk_segment:
            return r
        w = r.march.args[0]
        return r._replace(march=partial(ow.walk_segment_plain, w, query=ow.walk_query),
                          beam=partial(ow.walk_beam_plain, w, query=ow.walk_query),
                          kernel=False, key=r.key + ("parent",))

    st._route = parent_route
    try:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = st.trace_octree(sdf, origins, dirs, stats_out=stats, **kw)
        end.record()
        end.synchronize()
    finally:
        st._route = real
    return res, start.elapsed_time(end), stats


def _same_but_infinite(a, b) -> tuple[bool, int]:
    """Whether two traces are bit-equal on every field at the rays whose
    positions are finite in both, and how many rays are not."""
    import torch

    ok = torch.isfinite(a.position).all(-1) & torch.isfinite(b.position).all(-1)
    same = all(torch.equal(x[ok], y[ok]) for x, y in zip(a, b))
    return same, int((~ok).sum())


def walk_segments_vs_plain(sdf, origins, dirs, kw):
    """K15 and K14 against their plain versions in the frame's forms on
    the walk: the beam prepass (its 256 trips of every beam) in one K15
    launch from the frame's setup, then the first round's 8 trips of every
    ray in one K14 launch from its start. Each is held bit-equal to its
    plain version over K10's distance (the parent's eager trips), but for
    rays whose position turns infinite, and to its plain version over the
    plain walk, all torch (active flags and trip counts agree on >= 99.9%,
    q99 of |depth diff| <= 1e-4 of the box, as K12 is held), and timed from
    the same start state beside the latter and its bound: the state read
    and written once, the words and rows the live rays touch, trip by trip,
    each once, and ~310 flops a useful trip. Returns {"walk_beam": ...,
    "walk_segment": ...}, each (max |depth diff| against the all-torch
    plain version on the rays with finite positions, ms, plain ms,
    bound), and "touched": the larger of the two's bytes of words and rows
    touched."""
    import importlib

    import torch

    from sdflib_tpu_torch.ops import walk as ow

    st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
    R = origins.shape[0] * origins.shape[1]
    frame = st._Frame(sdf, origins.shape, R, R, R, beam=4, graphs=False, **kw)
    frame.o_in.copy_(origins.reshape(-1, 3))
    frame.d_in.copy_(dirs.reshape(-1, 3))
    frame.live_in.fill_(1.0)
    frame._setup()
    walk = sdf._walk()
    box = float(np.float32(sdf.box.size[0]))

    def restorer(bufs, start):
        def restore():
            for b, x in zip(bufs, start):
                b.copy_(x)
        return restore

    def run(name, kernel, plain, bufs, consts, trips, state_bytes, flops, act):
        start = [b.clone() for b in bufs]
        ref = [b.clone() for b in start]
        live_pts, useful = [], 0
        for _ in range(trips):       # the parent's trips one by one: the touched walks
            live = ref[act] > 0
            if not bool(live.any()):
                break
            live_pts.append(ref[0][live])
            useful += int(live.sum())
            plain(walk, *ref, *consts, 1, query=ow.walk_query)
        got = [b.clone() for b in start]
        kernel(walk, *got, *consts, trips)
        ok = torch.isfinite(got[0]).all(-1) & torch.isfinite(ref[0]).all(-1)
        same = all(torch.equal(a[ok], b[ok]) for a, b in zip(got, ref))
        _check(same, f"{name} departs from its plain version over K10's distance")
        restore = restorer(bufs, start)
        ms = _cuda_ms_prep(restore, lambda: kernel(walk, *bufs, *consts, trips))
        # the plain version over the plain walk, all torch, from the start
        plain_ms = _cuda_ms_prep(restore, lambda: plain(walk, *bufs, *consts, trips), reps=1)
        fin = torch.isfinite(got[0]).all(-1) & torch.isfinite(bufs[0]).all(-1)
        dd = (got[1][fin] - bufs[1][fin]).abs()
        d_err, q99 = float(dd.max()), float(torch.quantile(dd, 0.99))
        agree = float((got[act][fin] == bufs[act][fin]).float().mean())
        its_eq = float((got[4] == bufs[4]).float().mean()) if len(bufs) == 5 else 1.0
        _check(agree >= 0.999 and its_eq >= 0.999,
               f"{name}: active flags agree with the all-torch plain version on {agree:.4%}, "
               f"trip counts on {its_eq:.4%}")
        _check(q99 <= 1e-4 * box, f"{name}: q99 |depth diff| {q99} against the all-torch plain "
               f"version above 1e-4 of the box")
        n = bufs[0].shape[0]
        words, rows = _walk_touched(walk, torch.cat(live_pts))
        touched = 4 * words + 4 * walk.num_coeff * rows
        bound = _bound(n * state_bytes + touched, useful * flops)
        print(f"{name} vs plain ({n} rays, {trips} trips in one launch, {useful} useful trips, "
              f"{touched} B of words and rows touched): bit-equal to the parent's trips over "
              f"K10 on the {int(ok.sum())} rays with finite positions ({int((~ok).sum())} "
              f"not); against the all-torch plain version on the {int(fin.sum())} rays with "
              f"finite positions: active flags agree on {agree:.6%}, trip counts on "
              f"{its_eq:.6%}, |depth diff| q99 {q99:.3e} (allowance {1e-4 * box:.3e}), max "
              f"{d_err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms "
              f"({bound[1]}) = {bound[0] / ms:.1%} of the kernel's time")
        restore()
        kernel(walk, *bufs, *consts, trips)
        touched_all.append(touched)
        return d_err, ms, plain_ms, bound

    touched_all = []

    beam_bufs = [frame.b_pos, frame.b_acc, frame.b_active]
    beam_consts = (frame.b_dirs, frame.b_r0, frame.b_rd, frame.route.margin, frame.beam_far)
    out = {"walk_beam": run("K15 walk_beam", ow.walk_beam, ow.walk_beam_plain, beam_bufs,
                            beam_consts, st._BEAM_ITERS, BEAM_STATE_BYTES,
                            FLOPS_WALK_BEAM_TRIP, 2)}
    frame._start()
    bufs = [frame.pos, frame.acc, frame.last_d, frame.active, frame.its]
    consts = (frame.dirs, frame.eps_w, frame.far_w)
    first = frame.schedule[0][0]
    out["walk_segment"] = run("K14 walk_segment", ow.walk_segment, ow.walk_segment_plain, bufs,
                              consts, first, MARCH_STATE_BYTES, FLOPS_WALK_TRIP, 3)
    out["touched"] = max(touched_all)
    del frame
    return out


def walk_frame_profile(path: str, n_rays: int) -> None:
    """The walk frame's busy share, host syncs and graph launches under the
    profiler, in a process of its own (``approx_profile``'s): the
    container at ``path`` loaded with no grid, ``n_rays``^2 rays."""
    import torch

    from sdflib_tpu_torch import SdfFunction
    from sdflib_tpu_torch.render import trace_octree

    dev = torch.device("cuda", 0)
    sdf = SdfFunction.load(path, device=dev)
    origins, dirs = _ortho_rays(n_rays, dev)
    kw = dict(eps=1e-5, far=4.0, max_iters=1024)
    trace_octree(sdf, origins, dirs, **kw)           # captures the frame's graph
    counts = {SYNC_EVENTS: 0, GRAPH_LAUNCH_EVENTS: 0}
    kernel_ms = {"walk_segment": 0.0, "walk_beam": 0.0, "walk_query": 0.0}
    ev_ms, busy_ms, acts = breakdown(lambda: trace_octree(sdf, origins, dirs, **kw),
                                     f"walk frame d6 {n_rays}^2 rays, a graph (a process of "
                                     f"its own)", top=8, counts=counts, device_ms=kernel_ms)
    _check(acts > 0 and busy_ms > 0.0, "the profiler saw no device activity (walk frame)")
    print(f"walk frame under the profiler: {ev_ms:.4f} ms a frame, busy {busy_ms:.4f} ms "
          f"({busy_ms / ev_ms:.1%}); host syncs {counts[SYNC_EVENTS]:.0f}, graph launches "
          f"{counts[GRAPH_LAUNCH_EVENTS]:.0f} a frame; device ms a frame: K14 "
          f"{kernel_ms['walk_segment']:.4f}, K15 {kernel_ms['walk_beam']:.4f}, K10 (normals) "
          f"{kernel_ms['walk_query']:.4f}")
    _check(counts[SYNC_EVENTS] == 0 and counts[GRAPH_LAUNCH_EVENTS] == 1,
           f"the profiler saw {counts[SYNC_EVENTS]} host syncs and "
           f"{counts[GRAPH_LAUNCH_EVENTS]} graph launches a walk frame")


def walk_frame_path(dev, root: str, n_rays: int):
    """Path D on the walk: path C's d6 no_continuity octree saved to an
    ``.npz`` and loaded with no query grid, as ``sdf_render`` loads a
    container, traced at bench.py's n_rays^2 rays (beam 4, eps 1e-5, far
    4, 1,024 trips). The counts run from the load to the first frame,
    which captures the frame's one CUDA graph; a second frame replays it
    with one launch, no host sync. The frame is held to the parent's route
    (torch trips over K10, eager, once) bit for bit but for rays whose
    position turns infinite, and timed (CUDA events, best of 3) beside it,
    and to the all-torch plain frame (``_plain``: hit masks on >= 99.9%,
    q99 of |depth diff| <= 1e-4 of the box); K15 and K14 against their plain
    versions in the frame's forms (``walk_segments_vs_plain``) (its busy
    share: ``walk_frame_profile``, in path C's profiler process); then the C++
    SdfLib's ``octree_torus_cpp.bin`` (aligned) and its builder's
    ``builders_octree_nc.bin`` (rows at any word) at 512^2 camera rays,
    each graph frame against the parent's eager frame. Returns (the path's launch
    counts, the segments' checks)."""
    import importlib
    import shutil
    import tempfile

    import torch

    from sdflib_tpu_torch import OctreeSdf, SdfFunction
    from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin
    from sdflib_tpu_torch.render import Camera, trace_octree
    from sdflib_tpu_torch.render.sphere_trace import _trace
    from sdflib_tpu_torch.utils.primitives import make_torus

    st = importlib.import_module("sdflib_tpu_torch.render.sphere_trace")
    t_path = time.perf_counter()
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_walk_")
    path = os.path.join(tmp, "approx_d6.npz")
    OctreeSdf(mesh, box, max_depth=6, start_depth=2, termination_threshold=1e-3,
              init_algorithm="no_continuity", device=dev).save(path)
    origins, dirs = _ortho_rays(n_rays, dev)
    R = n_rays * n_rays
    kw = dict(eps=1e-5, far=4.0, max_iters=1024)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdf = SdfFunction.load(path, device=dev)
    _check(sdf._query_grid is None and sdf._fat_grid is None and sdf._fast_layout,
           "the loaded container has a query grid or a foreign layout")
    stats = {}
    res = trace_octree(sdf, origins, dirs, stats_out=stats, **kw)     # captures the graph
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    print(f"walk frame path: the .npz loaded and the first frame traced in {first_s:.3f} s "
          f"(host clock, the warm-up run and the capture included); launches: {launches}")
    for name in ("walk_segment", "walk_beam", "walk_query"):
        _check(launches[name] > 0, f"{name} was not launched on the walk frame path")
    for name in ("march", "beam", "octree_query"):
        _check(launches[name] == 0, f"{name} was launched on the walk route")
    _check(stats["graphs_captured"] == 1 and stats["host_syncs"] == 0,
           f"the walk frame captured {stats['graphs_captured']} graphs with "
           f"{stats['host_syncs']} host syncs")
    again = {}
    res2 = trace_octree(sdf, origins, dirs, stats_out=again, **kw)
    _check(again["graphs_captured"] == 0 and again["graphs_replayed"] == 1
           and again["host_syncs"] == 0, f"the second walk frame did not replay: {again}")
    eager = _trace(sdf, origins, dirs, block_size=None, beam=4, pyramid=True, stats_out=None,
                   active=None, graphs=False, **kw)
    same = [torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(res, res2, eager)]
    _check(all(same), f"the walk graph frame departs from its eager schedule: {same}")
    hit = res.hit
    n_hit, trips = int(hit.sum()), int(res.iterations.sum(dtype=torch.int64))
    _check(res.depth.shape == (n_rays, n_rays) and bool(torch.isfinite(res.depth).all())
           and bool(torch.isfinite(res.normal[hit]).all()) and 0 < n_hit < R,
           f"walk frame outputs: {n_hit} hits of {R}, not all finite")
    graph_ms = _cuda_ms(lambda: trace_octree(sdf, origins, dirs, **kw))

    parent, parent_ms, pstats = _eager_parent_frame(sdf, origins, dirs, kw)
    ok, bad = _same_but_infinite(res, parent)
    print(f"walk frame d6 {n_rays}^2 rays (beam 4, no grid): graph {graph_ms:.4f} ms a frame "
          f"(CUDA events, best of 3), {again['host_syncs']} host syncs, "
          f"{again['graphs_replayed']} graph launch, {stats['marched_ray_trips']} ray-trips "
          f"offered, {trips} useful; the parent's route (torch trips over K10, eager, once) "
          f"{parent_ms:.4f} ms, {pstats['host_syncs']} host syncs, "
          f"{pstats['graphs_replayed']} graph launches, {pstats['marched_ray_trips']} "
          f"ray-trips offered ({parent_ms / graph_ms:.1f}x); hits {n_hit}; the two bit-equal "
          f"by field but for {bad} rays whose position turns infinite: {ok}")
    _check(ok, "the walk graph frame departs from the parent's eager frame")
    del res2, eager, parent

    # the frame on the plain versions over the plain walk, all torch
    # (eager, once), held as K12 is: hit masks on >= 99.9%, q99 of |depth
    # diff| on common hits <= 1e-4 of the box
    box = float(np.float32(sdf.box.size[0]))
    sdf._plain = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = trace_octree(sdf, origins, dirs, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        sdf._plain = False
    agree = float((plain.hit == hit).float().mean())
    both = plain.hit & hit
    dd = (plain.depth[both] - res.depth[both]).abs()
    q99, dmax = float(torch.quantile(dd, 0.99)), float(dd.max())
    print(f"walk graph frame against the all-torch plain frame ({plain_s * 1e3:.3f} ms, host "
          f"clock, eager, once): hit masks agree on {agree:.6%}, |depth diff| on "
          f"{int(both.sum())} common hits q99 {q99:.3e} (allowance {1e-4 * box:.3e}), max "
          f"{dmax:.3e}; iterations equal on "
          f"{float((plain.iterations == res.iterations).float().mean()):.6%}")
    _check(agree >= 0.999, f"walk graph and all-torch plain frames' hit masks agree on "
           f"{agree:.4%}")
    _check(q99 <= 1e-4 * box, f"walk graph and all-torch plain frames' depths differ, q99 {q99}")
    del plain, dd
    torch.cuda.synchronize(dev)
    st._FRAMES.frames.clear()

    t0 = time.perf_counter()
    segments = walk_segments_vs_plain(sdf, origins, dirs, kw)
    t_seg = time.perf_counter() - t0
    # the frame's least time, as path D's: its rays' state in and out once,
    # the words and rows it touches (at least the beams' or the first
    # round's), and its useful trips' flops
    rows_b = segments.pop("touched")
    frame_bound = _bound(R * FRAME_RAY_BYTES + rows_b, trips * FLOPS_WALK_TRIP)
    print(f"walk frame bound ({FRAME_RAY_BYTES} B a ray in and out, as path D's frame, and "
          f"{rows_b} B of words and rows, the larger of the beams' and the first round's, "
          f"each once; {trips} useful trips x {FLOPS_WALK_TRIP} flops): "
          f"{frame_bound[0]:.4f} ms ({frame_bound[1]})")
    t0 = time.perf_counter()

    # the C++ SdfLib's own files: its octree (aligned) and its builder's
    # output (rows at any word)
    layouts = []
    for name in ("octree_torus_cpp.bin", "builders_octree_nc.bin"):
        gold = load_sdflib_bin(os.path.join(root, GOLDEN, name), device=dev)
        layouts.append(gold._fast_layout)
        area = gold.get_sample_area()
        center = np.asarray(area.center, np.float64)
        cam = Camera(position=center + np.array([0.6, 0.45, 0.9])
                     * float(np.linalg.norm(area.size)), target=center, fov_y_deg=45.0)
        co, cd = (torch.as_tensor(a, device=dev) for a in cam.rays(512, 512))
        gstats = {}
        cpp = trace_octree(gold, co, cd, stats_out=gstats, **kw)
        cpp_ms = _cuda_ms(lambda: trace_octree(gold, co, cd, **kw))
        cpp_parent, cpp_parent_ms, _ = _eager_parent_frame(gold, co, cd, kw)
        ok, bad = _same_but_infinite(cpp, cpp_parent)
        share, p_share = float(cpp.hit.float().mean()), float(cpp_parent.hit.float().mean())
        print(f"walk frame, C++ {name} ({'aligned' if gold._fast_layout else 'word by word'}) "
              f"512^2 camera rays: graph {cpp_ms:.4f} ms ({gstats['graphs_captured']} captured, "
              f"{gstats['host_syncs']} host syncs), hit share {share:.6%}; the parent's eager "
              f"frame {cpp_parent_ms:.4f} ms, hit share {p_share:.6%}; bit-equal but for {bad} "
              f"rays whose position turns infinite: {ok}")
        _check(ok and share == p_share and 0.0 < share < 1.0,
               f"the walk frame of {name} departs from the parent's")
    _check(layouts == [True, False], f"the C++ files' layouts {layouts}")
    del sdf, res, gold, cpp, cpp_parent
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize(dev)
    st._FRAMES.frames.clear()
    torch.cuda.empty_cache()
    print(f"walk frame path took {time.perf_counter() - t_path:.1f} s: the segments "
          f"{t_seg:.1f} s, the C++ files {time.perf_counter() - t0:.1f} s (its profile runs "
          f"in path C's profiler process)")
    return launches, segments



WALK_AB_FRAME_REPS = 10
WALK_AB_RENDERS = 3


def walk_frame_ab(parent: str, pairs: int = 2) -> None:
    """The walk frame and ``sdf_render`` timed in two checkouts of the
    port, in turns, on one card: ``python3 -c "import chip_smoke as cs;
    cs.walk_frame_ab('PARENT')"`` from this checkout, PARENT another (for
    example a ``git archive`` of the parent commit, unpacked). A first
    process builds path C's octree (the bench torus, d6, no_continuity)
    and saves it as an ``.npz``, and exports the torus, written as a
    binary PLY, with ``sdf_export`` at the CLI's defaults (path H's
    ``oct.npz``). Each checkout then runs in processes of its own, in
    turns (``pairs`` pairs, the first of a pair taking turns), each
    printing one ``walk_frame_ab`` JSON line (``_walk_ab_probe``)."""
    from sdflib_tpu_torch.tools.exact_ab import _build_all

    root = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)

    def run(call: str, *args: str) -> None:
        out = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                              f" import chip_smoke as cs; cs.{call}(*sys.argv[2:])", root, *args],
                             capture_output=True, text=True, timeout=900)
        print(out.stdout, end="")
        _check(out.returncode == 0, f"{call}{args} failed:\n{out.stderr[-4000:]}")

    work = tempfile.mkdtemp(prefix="chip_smoke_walk_ab_")
    try:
        t0 = time.perf_counter()
        _build_all([parent, root])
        print(f"walk_frame_ab: both checkouts' kernels built in {time.perf_counter() - t0:.1f} s")
        run("_walk_ab_store", work)
        for i in range(pairs):
            for tree in ((parent, root) if i % 2 == 0 else (root, parent)):
                run("_walk_ab_probe", tree, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _walk_ab_store(store: str) -> None:
    """``walk_frame_ab``'s d6 ``.npz`` and CLI export, made by this
    checkout into ``store``."""
    import torch

    from sdflib_tpu_torch import OctreeSdf
    from sdflib_tpu_torch.tools import sdf_export
    from sdflib_tpu_torch.utils.primitives import make_torus

    dev = torch.device("cuda", 0)
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    OctreeSdf(mesh, mesh.bounding_box.add_margin(0.14), max_depth=6, start_depth=2,
              termination_threshold=1e-3, init_algorithm="no_continuity",
              device=dev).save(os.path.join(store, "approx_d6.npz"))
    ply = os.path.join(store, "torus.ply")
    _write_ply(mesh, ply)
    _check(sdf_export.main([ply, os.path.join(store, "oct.npz"), "--device", str(dev)]) == 0,
           "sdf_export failed")


def _walk_ab_probe(tree: str, store: str) -> None:
    """One checkout's walk frame and renders, in a process of its own: the
    package of ``tree`` loads the d6 ``.npz`` with no query grid, traces
    bench.py's 1024^2 frame (beam 4, eps 1e-5, far 4, 1,024 trips) once
    (the capture of its graph where the route has one), then times
    ``WALK_AB_FRAME_REPS`` frames (CUDA events, best and median) and reads
    a frame's stats; then ``sdf_render`` on the export at 1024^2 with AO
    and shadows, in-process, ``WALK_AB_RENDERS`` times (wall seconds, each
    call synchronised; each loads the container anew, so each traces a
    first frame). Prints one ``walk_frame_ab`` JSON line with the card's
    name and power limit."""
    import io

    sys.path.insert(0, tree)
    import torch

    from sdflib_tpu_torch import SdfFunction
    from sdflib_tpu_torch.render import trace_octree
    from sdflib_tpu_torch.tools import sdf_render

    dev = torch.device("cuda", 0)
    origins, dirs = _ortho_rays(1024, dev)
    kw = dict(eps=1e-5, far=4.0, max_iters=1024)
    sdf = SdfFunction.load(os.path.join(store, "approx_d6.npz"), device=dev)

    def frame(stats=None):
        return trace_octree(sdf, origins, dirs, stats_out=stats, **kw)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = frame()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    stats = {}
    frame(stats)
    ms = []
    for _ in range(WALK_AB_FRAME_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frame()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    renders = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(WALK_AB_RENDERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = sdf_render.main([os.path.join(store, "oct.npz"),
                                      os.path.join(tmp, f"render{i}.png"), "--width", "1024",
                                      "--height", "1024", "--ao", "--shadow",
                                      "--device", str(dev)])
            torch.cuda.synchronize()
            renders.append(time.perf_counter() - t0)
            _check(rc == 0, f"sdf_render returned {rc}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print("walk_frame_ab " + json.dumps({
        "tree": tree, "card": smi, "first_frame_s": first_s, "frame_ms_best": min(ms),
        "frame_ms_median": float(np.median(ms)), "host_syncs": stats.get("host_syncs"),
        "graphs_captured": stats.get("graphs_captured"),
        "graphs_replayed": stats.get("graphs_replayed"),
        "ray_trips_offered": stats.get("marched_ray_trips"),
        "useful_ray_trips": int(res.iterations.sum(dtype=torch.int64)),
        "hits": int(res.hit.sum()), "sdf_render_s": renders,
        "depth_sum": float(res.depth.double().sum()),
    }))

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


def _walk_touched(walk, pts) -> tuple[int, int]:
    """(node words, coefficient rows) that the walks of the in-box
    ``pts`` read, each counted once: the word each level reads, by value
    (distinct words sit at distinct indices), and the reached leaves' rows."""
    import torch

    from sdflib_tpu_torch.ops import walk as ow

    words, rows = [], None
    for level in range(walk.levels + 1):
        word, _, in_box, _ = ow._descend(walk.words, pts, walk.box_min, walk.box_size3,
                                         walk.start_grid_size, levels=level, fast=walk.fast)
        words.append(torch.unique(word[in_box]))
        if level == walk.levels:
            rows = torch.unique((word[in_box] & 0x3FFFFFFF) // walk.num_coeff).numel()
    return int(torch.unique(torch.cat(words)).numel()), int(rows)


def _k11_pieces(w, pts, gd, gg, bits: int, nodes: int, touched: int, walk_flops: int):
    """K11's pieces on the aligned layout, each against its plain version
    (the keys and shares equal, the sort equal to ``torch.sort``, the
    reduction bit for bit) and timed: the key launch, the leaf sort of its
    keys beside ``torch.sort``, the reduction, and as the reduction step's
    reference torch's deterministic ``index_put_(accumulate=True)`` of the
    same weights. Returns the three pieces' rows."""
    import torch

    from sdflib_tpu_torch.ops import exact_query as eq
    from sdflib_tpu_torch.ops import walk as ow

    n, nc = pts.shape[0], w.num_coeff
    tag = f"gd{' and gg' if gg is not None else ''}"
    keys, share = ow.walk_keys(w, pts, gd, gg)
    keys_p, share_p = ow.walk_keys_plain(w, pts, gd, gg)
    keys_ok = torch.equal(keys, keys_p) and _bits_equal(share, share_p)
    del keys_p, share_p
    lid_s, order = eq.leaf_sort(keys, None, None, None, 0, bits)
    sort_ok = all(torch.equal(a, b) for a, b in zip((lid_s, order), torch.sort(keys, stable=True)))
    red = ow.walk_reduce(w, lid_s, order, share)
    red_ok = _bits_equal(red, ow.walk_reduce_plain(w, lid_s, order, share))
    print(f"K11 pieces ({tag}): keys and shares equal to plain {keys_ok}, the leaf sort equal "
          f"to torch.sort {sort_ok}, the reduction bit-equal to plain {red_ok}")
    _check(keys_ok and sort_ok and red_ok, f"K11's pieces ({tag}) differ from their plain "
           "versions")
    key_ms = _cuda_ms(lambda: ow.walk_keys(w, pts, gd, gg))
    key_plain = _cuda_ms(lambda: ow.walk_keys_plain(w, pts, gd, gg), reps=2)
    sort_ms, sort_dev = _timed(lambda: eq.leaf_sort(keys, None, None, None, 0, bits), "")
    sort_plain = _cuda_ms(lambda: eq.leaf_sort_plain(keys))
    sort_lib, sort_lib_dev = _timed(lambda: torch.sort(keys, stable=True), "")
    red_ms = _cuda_ms(lambda: ow.walk_reduce(w, lid_s, order, share))
    red_plain = _cuda_ms(lambda: ow.walk_reduce_plain(w, lid_s, order, share), reps=1)
    rows = w.words.numel() // nc
    live = lid_s < rows
    idx = lid_s[live].long()
    s = share[order[live]]
    weights = ow._weights(s[:, :3], s[:, 3], s[:, 4:7] if gg is not None else None,
                          w.interpolation)
    del s

    def put():
        out = torch.zeros(w.words.numel(), dtype=torch.float32, device=pts.device)
        out[: rows * nc].view(rows, nc).index_put_((idx,), weights, accumulate=True)
        return out

    put_err = float((put() - red).abs().max() / red.abs().max())
    put_ms = _cuda_ms(put)
    gg_in = gg is not None
    key_bound = _bound(n * (K11_KEY_BYTES + (K11_GG_KEY_BYTES if gg_in else 0)) + nodes * 4,
                       n * walk_flops)
    sort_bound = _bound(n * K11_SORT_BYTES, 0)
    red_bound = _bound(n * (K11_REDUCE_BYTES + (K11_GG_REDUCE_BYTES if gg_in else 0))
                       + touched * nc * 4, n * (FLOPS_K11_GG if gg_in else FLOPS_K11))
    print(f"K11 pieces ({tag}), {n} points, {bits} bits: key launch {key_ms:.4f} ms (plain "
          f"{key_plain:.4f}, bound {key_bound[0]:.4f}, {key_bound[1]}); leaf sort "
          f"{sort_ms:.4f} ms ({sort_dev:.4f} device; digits {eq._digit_plan(bits)}; plain "
          f"{sort_plain:.4f}, torch.sort(stable=True) {sort_lib:.4f} ({sort_lib_dev:.4f} "
          f"device), bound {sort_bound[0]:.4f}); reduction {red_ms:.4f} ms (plain {red_plain:.4f}, bound "
          f"{red_bound[0]:.4f}, {red_bound[1]}); the reduction step's reference, "
          f"index_put_(accumulate=True) of the same weights: {put_ms:.4f} ms (relative "
          f"difference {put_err:.3e})")
    del keys, share, lid_s, order, red, weights, idx
    return {("walk_keys", gg_in): (0.0, key_ms, key_plain, key_bound),
            ("walk_sort", gg_in): (0.0, sort_ms, sort_plain, sort_bound, sort_lib),
            ("walk_reduce", gg_in): (0.0, red_ms, red_plain, red_bound)}


def _march_readings(its, width: int) -> dict:
    """What a march of one thread a ray leaves idle, from each ray's trips
    (``its``, rays in image order, ``width`` a row): lane use (useful
    trips over 32 x the sum of each warp's longest ray) for warps of 32
    consecutive rays and for warps of 8 x 4 pixel tiles, and the warps of
    32 consecutive rays still live after 8, 16, 32, 64 and 128 trips."""
    t = its.long()
    useful = int(t.sum())
    rows = t.view(-1, 32).amax(1)
    height = t.numel() // width
    tiles = (t.view(height // 4, 4, width // 8, 8).permute(0, 2, 1, 3).reshape(-1, 32)
             .amax(1))
    return {"useful": useful, "warps": rows.numel(),
            "slot_trips_rows": 32 * int(rows.sum()), "slot_trips_tiles": 32 * int(tiles.sum()),
            "lane_use_rows": useful / (32 * int(rows.sum())),
            "lane_use_tiles": useful / (32 * int(tiles.sum())),
            "live_after": {k: int((rows > k).sum()) for k in (8, 16, 32, 64, 128)}}


def _k12_forms(sdf, base, o, d, eps: float, far: float, max_iters: int):
    """K12 on path F's rays ``o``, ``d`` (a square image, flattened): the
    one-thread form's readings (lane use, live warps, registers), the
    persistent warps bit-equal ray for ray to one thread a ray, in 8 x 4
    tiles and in ray order, and to themselves run to run, their hit masks
    and depths held to the plain march (>= 99.9%, q99 <= 1e-4 of the box),
    both forms timed in the same call in turns (one thread, warps, warps,
    one thread) by CUDA events and by the profiler's device time, the
    warps' slot-trips against the useful trips. Returns the JSON row (max
    |depth - plain| on common hits, ms, plain ms, bound) and the march's
    outputs."""
    import torch

    from sdflib_tpu_torch.kernels import build
    from sdflib_tpu_torch.ops import walk as ow

    R = o.shape[0]
    width = int(round(R ** 0.5))
    args = (base, o, d, eps, far, max_iters)
    one = ow.walk_march_one_thread(*args)
    got = ow.walk_march(*args, width=width)
    again = ow.walk_march(*args, width=width)
    flat = ow.walk_march(*args)
    same = all(_bits_equal(a, b) for a, b in zip(got, one))
    stable = all(_bits_equal(a, b) for a, b in zip(got, again))
    same_flat = all(_bits_equal(a, b) for a, b in zip(flat, one))
    print(f"K12 persistent warps against one thread a ray, {R} rays: hit, pos, depth, its "
          f"bit-equal {same} (in ray order {same_flat}); run to run {stable}")
    _check(same and same_flat, "K12's persistent warps differ from one thread a ray")
    _check(stable, "K12's persistent warps changed from run to run")
    del again, flat
    ref = ow.walk_march_plain(*args)
    agree = float((got[0] == ref[0]).float().mean())
    both = got[0] & ref[0]
    dd = (got[2][both] - ref[2][both]).abs()
    q99, dmax = float(torch.quantile(dd, 0.99)), float(dd.max())
    box = float(np.float32(sdf.box.size[0]))
    _check(agree >= 0.999, f"K12 hit masks agree with plain on {agree:.4%}")
    _check(q99 <= 1e-4 * box, f"K12 q99 depth difference {q99} above 1e-4 of the box")
    del ref

    read = _march_readings(one[3], width)
    useful = read["useful"]
    print(f"K12 one thread a ray, {R} rays: {useful} useful trips, the longest "
          f"{int(one[3].max())}; lane use {read['lane_use_rows']:.4f} in warps of 32 "
          f"consecutive rays ({read['slot_trips_rows']} slot-trips), "
          f"{read['lane_use_tiles']:.4f} in warps of 8 x 4 pixel tiles "
          f"({read['slot_trips_tiles']}); of {read['warps']} warps live after 8 / 16 / 32 / 64 "
          f"/ 128 trips: {' / '.join(str(v) for v in read['live_after'].values())}")
    for k, v in build.ptxas_report().items():
        if "walk_march" in k:
            print(f"ptxas {'walk_march_warps_kernel' if 'warps' in k else 'walk_march_kernel'}"
                  f"{_instance(k)}: {v}")
    del one

    def slot_trips(w) -> int:
        stats = torch.zeros(1, dtype=torch.int64, device=o.device)
        ow._launch_march(base, o, d, eps, far, max_iters, 0, w, stats)
        return 32 * int(stats.item())

    def one_thread():
        return ow.walk_march_one_thread(*args)

    def warps():
        return ow.walk_march(*args, width=width)

    # in turns: one thread, warps, warps, one thread; device time as
    # events around replays of a captured graph (the profiler drops
    # launches inside the full smoke), and the profiler's where it records
    ev_one = [_cuda_ms(one_thread)]
    ev_new = [_cuda_ms(warps), _cuda_ms(warps)]
    ev_one.append(_cuda_ms(one_thread))
    gr_one = [_graph_ms(one_thread)]
    gr_new = [_graph_ms(warps), _graph_ms(warps)]
    gr_one.append(_graph_ms(one_thread))
    prof_one = _timed(one_thread, "walk_march_kernel")[1]
    prof_new = _timed(warps, "walk_march_warps")[1]
    gr_flat = _graph_ms(lambda: ow.walk_march(*args))
    slots, slots_flat = slot_trips(width), slot_trips(0)
    # the word-by-word layout (rows read as scalars, c[64]) in both forms
    wbw = (base._replace(fast=False), o, d, eps, far, max_iters)
    wbw_same = all(_bits_equal(a, b) for a, b in zip(ow.walk_march(*wbw, width=width),
                                                       ow.walk_march_one_thread(*wbw)))
    _check(wbw_same, "K12's persistent warps differ from one thread a ray word by word")
    wbw_new = _graph_ms(lambda: ow.walk_march(*wbw, width=width))
    wbw_one = _graph_ms(lambda: ow.walk_march_one_thread(*wbw))
    plain_ms = _cuda_ms(lambda: ow.walk_march_plain(*args), reps=1)
    bound = _bound(R * WALK_RAY_BYTES + base.words.numel() * 4, useful * FLOPS_WALK_TRIP)
    print(f"K12 walk_march {R} rays, {max_iters} trips at most: persistent warps in 8 x 4 "
          f"tiles {ev_new[0]:.4f}, {ev_new[1]:.4f} ms events, {gr_new[0]:.4f}, {gr_new[1]:.4f} "
          f"ms device (graph replays; profiler {prof_new:.4f}), {slots} slot-trips (lane use "
          f"{useful / slots:.4f}); in ray order {gr_flat:.4f} ms device, {slots_flat} "
          f"slot-trips (lane use {useful / slots_flat:.4f}); one thread a ray {ev_one[0]:.4f}, "
          f"{ev_one[1]:.4f} ms events, {gr_one[0]:.4f}, {gr_one[1]:.4f} ms device (profiler "
          f"{prof_one:.4f}); hit masks agree with plain on {agree:.4%}, on {int(both.sum())} "
          f"common hits q99 |depth diff| {q99:.3e} (max {dmax:.3e}; allowance "
          f"{1e-4 * box:.3e}); plain {plain_ms:.4f} ms; library none; bound {bound[0]:.4f} ms "
          f"({bound[1]}) = {bound[0] / min(gr_new):.1%} of the warps' device time; word by "
          f"word, bit-equal, warps {wbw_new:.4f} ms device, one thread {wbw_one:.4f}")
    return (dmax, min(ev_new), plain_ms, bound), got


def walk_kernels_vs_plain(sdf, pts, origins, dirs, eps: float, far: float, max_iters: int):
    """K10-K12 against their plain versions on path F's structure, with
    the trainable copy of its coefficients: K10 on ``pts`` in each mode
    (distance, the normalised gradient, the world gradient), aligned (each
    group size, bit-equal to one lane a row, and its distances bit-equal to
    K12's one trip) and read word by word; K11 with a seeded gd (seed 3),
    with gg as well, with the point gradient, and word by word: on the
    aligned layout bit-equal from run to run, its pieces (the key launch,
    the leaf sort, the reduction) held to their plain versions bit for bit
    and timed each, the reduction beside ``index_put_(accumulate=True)``
    of the same weights; K12 on the rays with ``eps``, ``far`` and
    ``max_iters``, and K10's world gradient at the rays' ends (the
    render's sparse points: most lie outside the box) at each group size,
    the same bits, timed each. Each held to its plain version
    (d within 1e-6, gradients within 1e-5, the world gradient and K11
    relative to the largest; K12's hit masks on >= 99.9% and q99 depth
    difference <= 1e-4 of the box) and timed beside it and its bound.
    Returns {(kernel, case): (max abs error, ms, plain ms, bound)}."""
    import torch

    from sdflib_tpu_torch.diff.query import octree_coefficients
    from sdflib_tpu_torch.ops import exact_query as eq
    from sdflib_tpu_torch.ops import walk as ow

    n, dev = pts.shape[0], pts.device
    levels = sdf.max_depth - sdf.start_depth
    nc = sdf.num_coefficients
    base = ow.Walk(sdf._octree_dev, octree_coefficients(sdf._octree_dev), sdf._box_min,
                   sdf._box_size3, float(sdf.min_border_value), sdf.start_grid_size, levels,
                   nc, sdf.interpolation, True)
    walk_flops = FLOPS_WALK_START + FLOPS_WALK_LEVEL * levels
    nodes, coeff_rows = _walk_touched(base, pts)
    touched_bytes = nodes * 4 + coeff_rows * nc * 4
    print(f"K10/K11 bounds: {n} points touch {nodes} node words and {coeff_rows} coefficient "
          f"rows ({touched_bytes} B), each counted once")
    rows = {}
    for fast, modes in ((True, ow.MODES), (False, ("distance", "world"))):
        w = base._replace(fast=fast)
        for mode in modes:
            ref = ow.walk_query_plain(w, pts, mode)
            ref = ref if mode != "distance" else (ref,)
            groups = (1,) if not fast else (ow.GROUPS[mode], *(g for g in (1, 4, 8)
                                                               if g != ow.GROUPS[mode]))
            first, times = None, {}
            for group in groups:
                got = ow.walk_query(w, pts, mode, group=group)
                got = got if mode != "distance" else (got,)
                if first is None:
                    first = got
                    d_err = float((got[0] - ref[0]).abs().max())
                    g_abs = float((got[1] - ref[1]).abs().max()) if mode != "distance" else 0.0
                    g_err = g_abs / (float(ref[1].abs().max()) if mode == "world" else 1.0)
                else:
                    same = all(_bits_equal(a, b) for a, b in zip(got, first))
                    _check(same, f"K10 ({mode}) with {group} lanes a row differs from "
                           f"{groups[0]} lanes")
                del got
                times[group] = _cuda_ms(lambda: ow.walk_query(w, pts, mode, group=group))
            del first, ref
            ms = times[groups[0]]
            plain_ms = _cuda_ms(lambda: ow.walk_query_plain(w, pts, mode), reps=2)
            grad = mode != "distance"
            bound = _bound(n * (16 + (12 if grad else 0)) + touched_bytes,
                           n * (walk_flops + (FLOPS_K4_GRAD if grad else FLOPS_K4)))
            layout = "aligned" if fast else "word by word"
            others = ", ".join(f"lanes a row {g}: {t:.4f} ms" for g, t in times.items()
                               if g != groups[0])
            print(f"K10 walk_query {n} points, {mode}, {layout}, lanes a row {groups[0]}: max "
                  f"|d - plain| {d_err:.3e}, gradient {g_err:.3e}"
                  f"{' (relative)' if mode == 'world' else ''}; {ms:.4f} ms"
                  f"{f' ({others}, the same bits)' if others else ''}, plain {plain_ms:.4f} ms, "
                  f"bound {bound[0]:.4f} ms ({bound[1]}) = {bound[0] / ms:.1%}")
            _check(d_err <= 1e-6, f"K10 ({mode}, {layout}) d differs from plain by {d_err}")
            _check(g_err <= 1e-5, f"K10 ({mode}, {layout}) gradient differs from plain by {g_err}")
            rows[("walk_query", fast, mode)] = (max(d_err, g_abs), ms, plain_ms, bound)
            torch.cuda.empty_cache()

    # K10's distances against K12's one trip (the one-thread walk): its
    # depth is max(d, 0), so d itself wherever d >= 0
    d = ow.walk_query(base, pts, "distance")
    up = torch.zeros_like(pts)
    up[:, 2] = 1.0
    depth = ow.walk_march(base, pts, up, 0.0, 1e30, 1)[2]
    keep = d >= 0
    same = _bits_equal(depth[keep], d[keep])
    print(f"K10 (8 lanes a row) against K12's one trip on the {int(keep.sum())} of {n} points "
          f"with d >= 0: bit-equal {same}")
    _check(same, "K10's distances differ from K12's one trip")
    del d, up, depth, keep

    rng = np.random.default_rng(3)
    gd = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    gg = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device=dev)
    bits = eq.sort_bits(base.words.numel() // nc + 1)
    for fast, with_gg, points in ((True, False, False), (True, True, False), (True, False, True),
                                  (False, False, False)):
        w = base._replace(fast=fast)
        g2 = gg if with_gg else None
        got_c, got_p = ow.walk_backward(w, pts, gd, g2, True, points)
        ref_c, ref_p = ow.walk_backward_plain(w, pts, gd, g2, True, points)
        c_abs = float((got_c - ref_c).abs().max())
        c_err = c_abs / float(ref_c.abs().max())
        touched = int((ref_c.view(-1, nc) != 0).any(1).sum())
        p_err = 0.0
        if points:
            p_err = float((got_p - ref_p).abs().max() / ref_p.abs().max())
        same = "fp32 atomics"
        if fast:
            ok = all(_bits_equal(ow.walk_backward(w, pts, gd, g2, True, points)[0], got_c)
                     for _ in range(2))
            same = f"bit-equal run to run: {ok}"
            _check(ok, f"K11 (aligned, gd{' and gg' if with_gg else ''}) changed from run to run")
        del got_c, got_p, ref_c, ref_p
        ms = _cuda_ms(lambda: ow.walk_backward(w, pts, gd, g2, True, points))
        plain_ms = _cuda_ms(lambda: ow.walk_backward_plain(w, pts, gd, g2, True, points),
                            reps=2)
        nbytes = (n * (16 + (12 if with_gg else 0) + (12 if points else 0)) + nodes * 4
                  + base.words.numel() * 4
                  + (coeff_rows * nc * 4 if points else 0))
        flops = n * (walk_flops + (FLOPS_K11_GG if with_gg else FLOPS_K11)
                     + (FLOPS_K4_GRAD if points else 0))
        bound = _bound(nbytes, flops)
        case = (f"{'aligned' if fast else 'word by word'}, gd{' and gg' if with_gg else ''}"
                f"{', point gradient' if points else ''}")
        print(f"K11 walk_backward {n} points, {case}: coefficient gradient max |diff| "
              f"{c_abs:.3e} ({c_err:.3e} of the largest; {touched} rows touched, "
              f"{n / max(touched, 1):.1f} points a row), point gradient {p_err:.3e} (relative), "
              f"{same}; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}) = {bound[0] / ms:.1%}")
        _check(c_err <= 1e-5, f"K11 ({case}) coefficient gradient off plain by {c_err}")
        _check(p_err <= 1e-5, f"K11 ({case}) point gradient off plain by {p_err}")
        rows[("walk_backward", fast, with_gg, points)] = (c_abs, ms, plain_ms, bound)
        if fast and not points:
            rows.update(_k11_pieces(w, pts, gd, g2, bits, nodes, touched, walk_flops))
        torch.cuda.empty_cache()

    o, d = origins.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous()
    R = o.shape[0]
    rows[("walk_march",)], got = _k12_forms(sdf, base, o, d, eps, far, max_iters)

    # K10 where the render runs it: the world gradient at the rays' ends
    ends = got[1]
    inside = int(((ends >= base.box_min) & (ends < base.box_min + base.box_size3)).all(1).sum())
    first, times = ow.walk_query(base, ends, "world"), {}
    for group in (ow.GROUPS["world"], 1, 8):
        got_e = ow.walk_query(base, ends, "world", group=group)
        _check(all(_bits_equal(a, b) for a, b in zip(got_e, first)),
               f"K10 at the rays' ends with {group} lanes a row differs from the default group")
        times[group] = _cuda_ms(lambda: ow.walk_query(base, ends, "world", group=group))
    ends_plain = _cuda_ms(lambda: ow.walk_query_plain(base, ends, "world"), reps=2)
    # moved once: each end in, d and the gradient out, the node words and
    # rows the in-box ends touch; the walk and the polynomial with its
    # gradient at the in-box ends
    e_nodes, e_rows = _walk_touched(base, ends)
    ends_bound = _bound(R * 28 + e_nodes * 4 + e_rows * nc * 4,
                        inside * (walk_flops + FLOPS_K4_GRAD))
    print(f"K10 walk_query at the render's {R} ray ends ({inside} in the box), world gradient: "
          + ", ".join(f"lanes a row {g}: {t:.4f} ms" for g, t in times.items())
          + f" (the same bits); plain {ends_plain:.4f} ms, bound {ends_bound[0]:.4f} ms "
          f"({ends_bound[1]}; {e_nodes} node words, {e_rows} rows touched)")
    del got, first, got_e, ends
    return rows


def diff_path(dev, n_query: int, n_rays: int, fit_steps: int):
    """Path F, differentiable queries at full width: path C's no_continuity
    octree (built here, its seed lattice through K2; the counts run from
    the build to the last fit step). ``octree_query_diff`` (K10, K11) on
    ``n_query`` points (seed 1) held bit-equal to the walk route (K10 too)
    and within 1e-6 of the grid route; the coefficient gradient of
    mean((d - t)^2) timed beside its bound, K11's pieces' device time and
    launches by the profiler, one entry's ``data_parallel_fit_step`` held
    bit-equal to ``fit_step``, the gradient held to the same code on the
    CPU on 2^16 points and to central differences; the point gradient held to
    ``get_distance_and_gradient``; ``render_depth_diff`` (K12, then K10
    and K11) on n_rays^2 of bench.py's rays beside path D's trace; and
    ``fit_steps`` Adam steps of ``depth_fit_loss``. Then, outside the
    counts, K10-K12 against their plain versions
    (``walk_kernels_vs_plain``). Returns the path's launch counts and the
    comparison's rows."""
    import torch

    from sdflib_tpu_torch import OctreeSdf
    from sdflib_tpu_torch.diff.query import _walk, octree_coefficients, octree_query_diff
    from sdflib_tpu_torch.diff.render import depth_fit_loss, render_depth_diff
    from sdflib_tpu_torch.render import trace_octree
    from sdflib_tpu_torch.sdf import octree as oq
    from sdflib_tpu_torch.utils.primitives import make_torus

    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    pts = _uniform(box, n_query, 1, dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdf = OctreeSdf(mesh, box, max_depth=6, start_depth=2, termination_threshold=1e-3,
                    init_algorithm="no_continuity", device=dev)
    torch.cuda.synchronize()
    print(f"diff path F: octree built in {time.perf_counter() - t0:.3f} s, "
          f"{sdf.octree_data.shape[0]} words")
    words = sdf._octree_dev
    before = words.clone()
    levels = sdf.max_depth - sdf.start_depth
    args = (sdf.box.min, sdf.box.size[0], sdf.start_grid_size, sdf.min_border_value)
    q = dict(levels=levels)
    n = pts.shape[0]
    sub = pts[: 1 << 16]

    # 1. forward: the walk route bit for bit, the grid route within 1e-6
    coeffs = octree_coefficients(words)
    d = octree_query_diff(words, coeffs, pts, *args, **q)
    walk = oq._octree_query(words, pts, sdf._box_min, sdf._box_size3, sdf.start_grid_size,
                            sdf.min_border_value, levels=levels, num_coeff=64,
                            interpolation="tricubic", with_gradient=False)
    d_walk_g, g_walk = sdf.get_distance_and_gradient(sub)     # the walk route
    sdf.build_query_grid()
    grid_err = float((d - sdf.get_distance(pts)).abs().max())
    bit_equal = torch.equal(d, walk)
    print(f"diff forward {n} points: bit-equal to the walk route {bit_equal}, max |d - grid "
          f"route| {grid_err:.3e}")
    _check(bit_equal, "octree_query_diff differs from the walk route")
    _check(grid_err <= 1e-6, f"octree_query_diff differs from the grid route by {grid_err}")

    # 2. the coefficient gradient of mean((d - t)^2), t the octree's own
    # values plus a seeded offset
    offset = torch.as_tensor(np.random.default_rng(2).normal(0, 1e-3, n).astype(np.float32),
                             device=dev)
    target = d.detach() + offset
    c = coeffs.clone().requires_grad_(True)

    def loss_of(cc, p, t):
        return (octree_query_diff(words, cc, p, *args, **q) - t).square().mean()

    def fwd():
        return octree_query_diff(words, c, pts, *args, **q)

    def fwd_bwd():
        return torch.autograd.grad(loss_of(c, pts, target), c)[0]

    grad = fwd_bwd()
    fwd_ms = _cuda_ms(fwd)
    fb_ms = _cuda_ms(fwd_bwd)
    # moved once: the points in and d out, the touched node words and rows
    # (K10); gd in, the words again and the whole gradient out (K11)
    nodes, coeff_rows = _walk_touched(_walk(words, c.detach(), *args, num_coeff=64,
                                            interpolation="tricubic", fast=True, **q), pts)
    once_f = n * 16 + nodes * 4 + coeff_rows * 256
    once_fb = once_f + n * 16 + nodes * 4 + words.numel() * 4
    bound_f, bound_fb = (b / PEAK_BYTES * 1e3 for b in (once_f, once_fb))
    reread_f = n * APPROX_POINT_BYTES / PEAK_BYTES * 1e3
    reread_fb = n * (APPROX_POINT_BYTES + DIFF_BACKWARD_BYTES) / PEAK_BYTES * 1e3
    touched = int((grad.view(-1, 64) != 0).any(1).sum())
    print(f"diff forward {n} points (K10, the Function's forward): {fwd_ms:.4f} ms, bound "
          f"{bound_f:.4f} ms (bytes moved once, {once_f} B) = {bound_f / fwd_ms:.1%}; "
          f"forward + backward {fb_ms:.4f} ms (backward {fb_ms - fwd_ms:.4f} ms), bound "
          f"{bound_fb:.4f} ms ({once_fb} B) = {bound_fb / fb_ms:.1%}; every point re-reading "
          f"its row: {reread_f:.4f} ms ({APPROX_POINT_BYTES} B a point) and {reread_fb:.4f} ms "
          f"({APPROX_POINT_BYTES + DIFF_BACKWARD_BYTES} B); {touched} coefficient rows "
          f"touched, {n / max(touched, 1):.0f} points a row")
    k11_parts = ("walk_key", "leaf_sort", "walk_reduce")
    parts, names = dict.fromkeys(("walk_query", "Memset", *k11_parts), 0.0), {}
    ev_ms, busy_ms, acts = breakdown(fwd_bwd, f"diff forward + backward, {n} points", top=10,
                                     device_ms=parts, activities=names)
    k11 = sum(parts[k] for k in k11_parts)
    k11_acts = {k[:40]: c for k, c in names.items() if any(x in k for x in k11_parts)}
    print(f"diff backward: K11 {k11:.4f} ms device (key launch {parts['walk_key']:.4f}, leaf "
          f"sort {parts['leaf_sort']:.4f}, reduction {parts['walk_reduce']:.4f}) of a "
          f"{ev_ms:.4f} ms forward + backward ({k11 / ev_ms:.1%}); its launches a backward "
          f"{k11_acts}, memsets in the step "
          f"{sum(c for k, c in names.items() if 'Memset' in k):.0f} "
          f"({parts['Memset']:.4f} ms); K10 {parts['walk_query']:.4f} ms device; device busy "
          f"{busy_ms / ev_ms:.1%}, {acts} device activities")

    # one entry's data-parallel step is fit_step's bit for bit: K11 sums
    # in one order
    from sdflib_tpu_torch.parallel import data_parallel_fit_step, fit_step

    l_one, c_one = fit_step(words, coeffs, pts, target, torch.ones(n, device=dev), *args[:2],
                            sdf.min_border_value, 0.5, start_grid_size=sdf.start_grid_size,
                            levels=levels)
    l_dp, c_dp = data_parallel_fit_step(sdf, coeffs, pts, target, [dev], lr=0.5)
    same = bool(torch.equal(l_one, l_dp)) and _bits_equal(c_one, c_dp[0])
    print(f"data_parallel_fit_step on one entry ({n} points) against fit_step: loss "
          f"{float(l_dp):.6e}, bit-equal {same}")
    _check(same, "one entry's data_parallel_fit_step differs from fit_step")
    del c_one, c_dp

    # the card's gradient against the same code on the CPU, 2^16 points
    g_card = torch.autograd.grad(loss_of(c, sub, target[: 1 << 16]), c)[0]
    c_cpu = c.detach().cpu().requires_grad_(True)
    g_cpu = torch.autograd.grad(loss_of(c_cpu, sub.cpu(), target[: 1 << 16].cpu()), c_cpu)[0]
    # relative error over the touched rows: the largest difference over
    # the largest gradient (norm-wise); each row's own relative error too,
    # which a row whose points' terms cancel inflates
    rows_k, rows_c = g_card.cpu().view(-1, 64), g_cpu.view(-1, 64)
    live = (rows_c != 0).any(1)
    diff_rows = (rows_k[live] - rows_c[live]).abs()
    rel = float(diff_rows.max() / rows_c[live].abs().max())
    per_row = (diff_rows.amax(1) / rows_c[live].abs().amax(1)).double()
    # central differences on 8 touched coefficients: the loss is quadratic
    # in the coefficients, so they are exact for any step up to rounding
    # (a step of 0.1, f64 sums); the error is relative to the largest of
    # the 8 gradients
    idx = torch.nonzero(g_card)[:, 0]
    pick = idx[torch.linspace(0, idx.numel() - 1, 8).long()].tolist()
    tsub = target[: 1 << 16].double()
    fds = []
    for i in pick:
        h = 0.1
        cp, cm = c.detach().clone(), c.detach().clone()
        cp[i] += h
        cm[i] -= h
        lp = float((octree_query_diff(words, cp, sub, *args, **q).double() - tsub).square().mean())
        lm = float((octree_query_diff(words, cm, sub, *args, **q).double() - tsub).square().mean())
        fds.append((lp - lm) / (2 * h))
    g_pick = g_card[pick].double().cpu().numpy()
    fd_err = float(np.abs(np.array(fds) - g_pick).max() / np.abs(g_pick).max())
    print(f"diff gradient checks (2^16 points): card vs CPU on {int(live.sum())} touched "
          f"rows, relative error {rel:.3e} (each row's own: median "
          f"{float(per_row.median()):.3e}, q99 {float(torch.quantile(per_row, 0.99)):.3e}, max "
          f"{float(per_row.max()):.3e}); central differences on 8 touched coefficients, "
          f"max relative error {fd_err:.3e}")
    _check(rel <= 1e-4, f"card gradient differs from the CPU's by {rel} (relative)")
    _check(fd_err <= 1e-3, f"gradient differs from central differences by {fd_err}")

    # 3. the point gradient: autograd and the analytic one, and the latter
    # normalised against get_distance_and_gradient's (the walk route)
    x = sub.clone().requires_grad_(True)
    gx = torch.autograd.grad(octree_query_diff(words, coeffs, x, *args, **q).sum(), x)[0]
    _, g_an = octree_query_diff(words, coeffs, sub, *args, with_gradient=True, **q)
    g_scale = float(g_an.abs().max())
    auto_err = float((gx - g_an).abs().max()) / g_scale
    g_unit = g_an / g_an.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    unit_err = float((g_unit - g_walk).abs().max())
    print(f"diff point gradient (2^16 points): autograd vs analytic max relative error "
          f"{auto_err:.3e}; normalised vs get_distance_and_gradient {unit_err:.3e}")
    _check(auto_err <= 1e-5, f"autograd point gradient off by {auto_err}")
    _check(unit_err <= 1e-5, f"normalised gradient off get_distance_and_gradient's by {unit_err}")

    # 4. render_depth_diff on bench.py's rays, JAX's defaults, as an image
    # (the march takes them 8 x 4 pixels at a time)
    origins, dirs = _ortho_rays(n_rays, dev)
    o, dr = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    kw = dict(levels=levels, eps=1e-4, far=4.0, max_iters=256)
    depth, hit = render_depth_diff(words, c.detach(), origins, dirs, *args, **kw)
    depth, hit = depth.reshape(-1), hit.reshape(-1)
    r_ms = _cuda_ms(lambda: render_depth_diff(words, c.detach(), origins, dirs, *args, **kw),
                    reps=2)
    rb_ms = _cuda_ms(lambda: torch.autograd.grad(
        render_depth_diff(words, c, origins, dirs, *args, **kw)[0].sum(), c), reps=2)
    # the same rays flattened: the march in ray order
    r_flat_ms = _cuda_ms(lambda: render_depth_diff(words, c.detach(), o, dr, *args, **kw), reps=2)
    rb_flat_ms = _cuda_ms(lambda: torch.autograd.grad(
        render_depth_diff(words, c, o, dr, *args, **kw)[0].sum(), c), reps=2)
    from sdflib_tpu_torch.ops.walk import walk_march

    size = np.float32(sdf.box.size[0])
    eps_w, far_w = float(np.float32(1e-4) * size), float(np.float32(4.0) * size)
    frozen = _walk(words, c.detach(), *args, num_coeff=64, interpolation="tricubic", fast=True,
                   **q)
    trips = walk_march(frozen, o, dr, eps_w, far_w, 256, width=n_rays)[3].max()
    ev_ms, busy_ms, acts = breakdown(
        lambda: render_depth_diff(words, c.detach(), origins, dirs, *args, **kw),
        f"render_depth_diff {n_rays}^2 rays", top=6)
    ref = trace_octree(sdf, origins, dirs, eps=1e-5, far=4.0, max_iters=1024)
    rh, rd = ref.hit.reshape(-1), ref.depth.reshape(-1)
    agree = float((rh == hit).float().mean())
    both = rh & hit
    diff = (depth.detach()[both] - rd[both]).abs()
    # a hit within eps of the surface lies up to eps / |cos| from it along
    # the ray (cos between the ray and the surface normal): grazing rays
    # get that allowance, the others 1e-3
    _, g_hit = octree_query_diff(words, coeffs, ref.position.reshape(-1, 3)[both], *args,
                                 with_gradient=True, **q)
    cos = (g_hit * dr[both]).sum(-1).abs() / g_hit.norm(dim=-1).clamp_min(1e-30)
    eps_world = float(np.float32(1e-4) * np.float32(sdf.box.size[0]))
    allow = (2 * eps_world / cos.clamp_min(1e-30)).clamp_min(1e-3)
    over = diff > 1e-3
    bad = int((diff > allow).sum())
    print(f"render_depth_diff {n_rays}^2 rays: forward {r_ms:.4f} ms, forward + backward "
          f"{rb_ms:.4f} ms (the rays flattened: {r_flat_ms:.4f}, {rb_flat_ms:.4f}); march trips {int(trips)} (the longest ray's); device busy "
          f"{busy_ms / ev_ms:.1%}, {acts} device activities; hits {int(hit.sum())}, masks "
          f"agree with path D's trace on {agree:.4%}; on {int(both.sum())} common hits max "
          f"|depth diff| {float(diff.max()):.3e}, {int(over.sum())} above 1e-3 (largest "
          f"|cos| among them {float(cos[over].max()) if bool(over.any()) else 0.0:.4f}), "
          f"{bad} beyond max(1e-3, 2 eps / |cos|)")
    _check(agree > 0.998, f"render_depth_diff hit masks agree with the trace on {agree:.4%}")
    _check(bad == 0, f"{bad} render_depth_diff depths differ from the trace's beyond "
           f"max(1e-3, 2 eps / |cos|)")

    # 5. depth_fit_loss: tests/test_diff.py's recipe at full width
    target_d, target_h = render_depth_diff(words, coeffs, origins, dirs, *args, **kw)
    noise = torch.as_tensor(
        np.random.default_rng(1).normal(0, 1e-3, coeffs.shape).astype(np.float32), device=dev)
    cf = (coeffs + noise).requires_grad_(True)
    opt = torch.optim.Adam([cf], lr=2e-4, betas=(0.9, 0.999), eps=1e-9)
    losses, step_ms = [], []
    for i in range(fit_steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = depth_fit_loss(words, cf, origins, dirs, target_d, target_h, *args, **kw)
        loss.backward()
        if i < fit_steps:
            opt.step()
        losses.append(float(loss.detach()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i % 5 == 0:
            print(f"depth fit step {i}: loss {losses[-1]:.6e}, {step_ms[-1]:.1f} ms (host clock)")
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"depth fit {n_rays}^2 rays: loss {losses[0]:.6e} -> {losses[-1]:.6e} "
          f"({losses[-1] / losses[0]:.4f} of the first) in {fit_steps} Adam steps, "
          f"median step {float(np.median(step_ms)):.1f} ms; launches on path F: {launches}")
    _check(losses[-1] < 0.5 * losses[0], f"the fit's last loss {losses[-1]} is not below half "
           f"the first {losses[0]}")
    _check(torch.equal(words, before), "the fit changed the octree's words")
    for name in ("nearest", "walk_query", "walk_backward", "walk_keys", "walk_sort",
                 "walk_reduce", "walk_march"):
        _check(launches[name] > 0, f"{name} was not launched on path F")
    # the render and its coefficient gradient, outside the counts, with
    # K12's persistent warps and with one thread a ray: the same bits
    import sdflib_tpu_torch.diff.render as diff_render
    from sdflib_tpu_torch.ops import walk as ow

    def render_grad():
        cc = coeffs.clone().requires_grad_(True)
        dep, hh = render_depth_diff(words, cc, origins, dirs, *args, **kw)
        return dep.detach(), hh, torch.autograd.grad(dep.sum(), cc)[0]

    warps_out = render_grad()
    diff_render.walk_march = lambda *a, width=0: ow.walk_march_one_thread(*a)
    try:
        one_out = render_grad()
    finally:
        diff_render.walk_march = ow.walk_march
    same = all(_bits_equal(a, b) for a, b in zip(warps_out, one_out))
    print(f"render_depth_diff {n_rays}^2 rays over K12's persistent warps against one thread a "
          f"ray: depth, hit and coefficient gradient bit-equal {same}")
    _check(same, "render_depth_diff changed with K12's persistent warps")
    del warps_out, one_out
    del coeffs, c, cf, opt, ref
    torch.cuda.empty_cache()
    rows = walk_kernels_vs_plain(sdf, pts, o, dr, eps_w, far_w, 256)
    del sdf, pts
    torch.cuda.empty_cache()
    return launches, rows


def _device_ms(fn, keys) -> float:
    """Device time a call (ms, over 3 profiled calls) of the kernels whose
    name holds one of ``keys``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(k in e.key.lower() for k in keys)) / 3e3


def leftovers_path(dev, root: str):
    """Path G, the exact path's leftovers at path A's configuration (the
    bench torus, d6, start depth 2, 32 triangles a node); the counts run
    over the whole path. The region build to an EXACT_OCTREE .bin and back
    on the card (the 10k oracle gate through K1), the compiled reference's
    ``builders_exact.bin``, the copied native library on the port's file;
    the frame19 and id-only tiers of the same structure (2^21 points and
    the oracle gate, each timed beside K1, pinning K1 raises); the scan
    chunk at 16 and 128; and the lattice, basic, precise and per_vertex
    builds with their oracle gates and JAX's leaf counts, and the
    approximate d6 build with the lattice cull. Returns the path's launch
    counts."""
    import tempfile

    import torch

    from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf
    from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin, save_sdflib_bin
    from sdflib_tpu_torch.native import NativeSdf
    from sdflib_tpu_torch.utils.primitives import make_torus

    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    cfg = dict(max_depth=6, start_depth=2, min_triangles_per_node=32)
    opts = _uniform(box, 10_000, 7, dev)
    pts = _uniform(box, 1 << 21, 0, dev)
    reset_counts()
    oracle = RealSdf(mesh, device=dev)
    d_ref = oracle.get_distance(opts)

    def gate(sdf, label):
        err = float((sdf.get_distance(opts) - d_ref).abs().max())
        _check(err <= ORACLE_TOL, f"oracle max error {err} > {ORACLE_TOL} ({label})")
        return err

    # 1. the EXACT_OCTREE .bin both ways, on the card
    sdf = ExactOctreeSdf(mesh, box, **cfg, device=dev)
    d_k1 = sdf.get_distance(pts)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "d6.bin")
        t0 = time.perf_counter()
        save_sdflib_bin(sdf, path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_sdflib_bin(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        native = NativeSdf.load(path)
        d_nat = native.get_distance(opts.cpu().numpy())
        native.close()
    _check(not loaded._sorted_lists and loaded.num_leaves == sdf.num_leaves,
           "the loaded structure's lists or leaves differ")
    errs = {}
    for impl in ("xla", "xla_window"):
        loaded.set_scan_impl(impl)
        errs[impl] = gate(loaded, f".bin-loaded, {impl}")
    nat_err = float(np.abs(d_nat - sdf.get_distance(opts).cpu().numpy()).max())
    g = np.load(os.path.join(root, GOLDEN, "builders_torus.npz"))
    gold = load_sdflib_bin(os.path.join(root, GOLDEN, "builders_exact.bin"), device=dev)
    gp = torch.as_tensor(g["points"], device=dev)
    gd = torch.as_tensor(g["exact_dist"], device=dev)
    gg = torch.as_tensor(g["exact_grad"], device=dev)
    gold_err = float((gold.get_distance(gp) - gd).abs().max())
    d2, g2 = gold.get_distance_and_gradient(gp)
    gold_err = max(gold_err, float((d2 - gd).abs().max()))
    g_bad = float(((g2 - gg).norm(dim=-1) > 1e-3).float().mean())
    print(f"exact .bin d6: save {save_s:.3f} s, load on the card {load_s:.3f} s, {nbytes} B; "
          f"oracle gate through K1 on the loaded structure: grouped {errs['xla']:.3e}, window "
          f"{errs['xla_window']:.3e}; native decode vs the card {nat_err:.3e} on 10000 points; "
          f"builders_exact.bin ({gold.num_leaves} leaves): max |d - C++| {gold_err:.3e}, "
          f"gradients off by >1e-3 {g_bad:.2e}")
    _check(nat_err <= 1e-5, f"the native decode differs from the card by {nat_err}")
    _check(gold_err <= 2e-5, f"builders_exact.bin differs from the C++ answers by {gold_err}")
    _check(g_bad < 1e-3, f"builders_exact.bin: {g_bad} of gradients off by >1e-3")
    del loaded, gold

    # 2. the tiers of the same structure
    state = sdf._state_arrays()
    k1_ms = _cuda_ms(lambda: sdf.get_distance(pts))
    vertex_bytes = sdf.bucket_bytes
    print(f"tier vertex9 (K1): get_distance 2^21 {k1_ms:.4f} ms, tables {vertex_bytes} B")
    for tier in ("frame19", "id_only"):
        st = dict(state)
        if tier == "id_only":
            st["bucket_byte_budget"] = np.int64(sdf.bucket_fields.numel() * 4 - 1)
        other = ExactOctreeSdf.from_jax_state(
            st, device=dev, bucket_format="frame19" if tier == "frame19" else "auto")
        _check(other.bucket_tier == tier, f"{other.bucket_tier} taken for {tier}")
        d = other.get_distance(pts)
        diff = float((d - d_k1).abs().max())
        err = gate(other, tier)
        ms = _cuda_ms(lambda: other.get_distance(pts), reps=1)
        for impl in ("pallas", "pallas_window"):
            try:
                other.set_scan_impl(impl)
            except ValueError:
                continue
            raise RuntimeError(f"chip_smoke: pinning K1 ({impl}) on {tier} did not raise")
        print(f"tier {tier}: get_distance 2^21 {ms:.4f} ms ({ms / k1_ms:.1f}x K1's), tables "
              f"{other.bucket_bytes} B, max |d - K1's| {diff:.3e}, oracle gate {err:.3e}, "
              f"scan {other.last_scan_stats['scan']}; pinning K1 raises")
        _check(diff <= 1e-6, f"{tier} differs from K1's answers by {diff}")
        del other

    # 3. the scan chunk: answers unchanged
    base = sdf.get_distance(opts)
    for chunk in (16, 128):
        sdf.set_scan_chunk(chunk)
        diff = float((sdf.get_distance(opts) - base).abs().max())
        print(f"set_scan_chunk({chunk}): {sdf.bucket_ids.shape[0]} rows, max |d - chunk 64's| "
              f"{diff:.3e} on 10000 points")
        _check(diff <= 1e-6, f"scan chunk {chunk} changed the answers by {diff}")
    sdf.set_scan_chunk(64)
    del sdf, state

    # 4. the other strategies
    for strategy, depth in STRATEGY_DEPTH.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        other = ExactOctreeSdf(mesh, box, **dict(cfg, max_depth=depth), strategy=strategy,
                               device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        err = gate(other, strategy)
        ref = STRATEGY_REF[(strategy, depth)]
        print(f"strategy {strategy} d{depth}: build {build_s:.3f} s, leaves {other.num_leaves} "
              f"(JAX {ref['leaves']}), mean list {other.leaf_count.mean():.4f} (JAX "
              f"{ref['mean']}), buckets {other.bucket_bytes} B, oracle gate {err:.3e} "
              f"({other.last_scan_stats['scan']} scan)")
        if strategy != "precise":
            _check(abs(other.num_leaves - ref["leaves"]) <= 0.05 * ref["leaves"],
                   f"{strategy}: {other.num_leaves} leaves, >5% from JAX's {ref['leaves']}")
        del other
        torch.cuda.empty_cache()
    ref = APPROX_REF["no_continuity"]
    t0 = time.perf_counter()
    approx = OctreeSdf(mesh, box, max_depth=6, start_depth=2, termination_threshold=1e-3,
                       init_algorithm="no_continuity", strategy="lattice", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    leaves = {int(k): int(v) for k, v in sorted(approx.build_stats["leaves_per_depth"].items())}
    words = int(approx.octree_data.shape[0])
    total, ref_total = sum(leaves.values()), sum(ref["leaves"].values())
    print(f"approx build no_continuity d6, lattice cull: {build_s:.3f} s, words {words} (JAX "
          f"{ref['words']}), leaves {leaves} (JAX {ref['leaves']})")
    _check(abs(words - ref["words"]) <= 0.01 * ref["words"], f"lattice approx: {words} words")
    _check(abs(total - ref_total) <= 0.01 * ref_total, f"lattice approx: {total} leaves")
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"launches on path G (exact leftovers): {launches}")
    for name in ("nearest", "scan_window", "scan_grouped", *EXACT_KERNELS):
        _check(launches[name] > 0, f"{name} was not launched on path G")
    del approx, oracle, pts
    torch.cuda.empty_cache()
    return launches


# Path H sizes: FULL on the card (what `python3 chip_smoke.py` runs), SMALL for a CPU
# rehearsal of the same code.
TOOLS_FULL = dict(
    oct=[], ex=["-d", "6"], m_err="4.194304", m_cmp="1", frame=1024, view=512,
    sweep=4, iqt=1024, preview=512, scaling=[], n_oct=1 << 22, n_ex=1 << 21,
    n_grad=1 << 20, rays=1024, n_fit=1 << 20, fit_steps=10,
)
TOOLS_SMALL = dict(
    oct=["-d", "4"], ex=["-d", "4"], m_err="0.01", m_cmp="0.01", frame=64, view=64,
    sweep=2, iqt=64, preview=48,
    scaling=["-m", "0.01", "--rays", "4096", "--depth", "4"], n_oct=4096, n_ex=4096,
    n_grad=4096, rays=64, n_fit=4096, fit_steps=3,
)


def _write_ply(mesh, path: str) -> None:
    """A binary little-endian PLY of ``mesh``."""
    import struct

    with open(path, "wb") as f:
        f.write((
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {mesh.num_vertices}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {mesh.num_triangles}\n"
            "property list uchar int vertex_indices\nend_header\n"
        ).encode())
        f.write(np.asarray(mesh.vertices, "<f4").tobytes())
        f.write(b"".join(struct.pack("<B3i", 3, *t) for t in np.asarray(mesh.indices)))


def tools_path(dev, root: str, sizes=None):
    """Path H, the CLI tools and ``parallel`` at full size (``sizes``:
    ``TOOLS_FULL``; ``TOOLS_SMALL`` rehearses the same code on the CPU).
    bench.py's torus is written as a binary PLY and every tool runs
    in-process through its ``main(argv)`` with ``--device`` ``dev``: three
    exports at the CLI's defaults (approximate d7, exact d6 with the
    lattice cull, grid), ``sdf_error`` on 2^22 samples (RMSE below 4e-3;
    the exact export's max error <= 1e-5), ``sdf_error_compare`` (the
    .bin row equal to the .npz row within 1e-6), ``sdf_render`` at 1024^2
    from the .npz and the .bin (equal hit shares), ``sdf_light``,
    ``sdf_view`` (a sweep and a pick inside the tube: a non-empty list,
    max error <= 1e-5), ``image_query_time``, ``exact_mean_triangles``
    (its leaves the structure's), ``interp_params``, ``mesh_preview``
    (K2 on every trip) and ``scaling_bench``; then ``parallel`` on
    ``default_mesh()`` and on four entries of ``dev``, in one call and in
    four, bit-equal to the single-device calls, and ten fit steps whose
    loss falls, the first within 1e-6 of the one-entry step; then the
    tiled exact octree (8 entries) against the replicated one and its
    round trip, and the tiled approximate octree against its grid route;
    then, after the path's launch counts are read, K2 against its plain
    version at the tools' shapes (2^22 and 262,144 points). Every tool's
    wall seconds print on a line of their own. Returns the path's launch
    counts and K2's largest difference from its plain version."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf, SdfFunction, parallel
    from sdflib_tpu_torch.diff.query import octree_coefficients
    from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin
    from sdflib_tpu_torch.ops import nearest
    from sdflib_tpu_torch.parallel.tiles import TiledExactOctreeSdf, TiledOctreeSdf
    from sdflib_tpu_torch.render import trace_octree
    from sdflib_tpu_torch.tools import (
        exact_mean_triangles,
        image_query_time,
        interp_params,
        mesh_preview,
        scaling_bench,
        sdf_error,
        sdf_error_compare,
        sdf_export,
        sdf_light,
        sdf_render,
        sdf_view,
    )
    from sdflib_tpu_torch.tools.common import prepare_box
    from sdflib_tpu_torch.utils.primitives import make_torus

    sz = TOOLS_FULL if sizes is None else sizes
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t_path = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_h_")
    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    ply = os.path.join(tmp, "torus.ply")
    _write_ply(mesh, ply)

    def f(name):
        return os.path.join(tmp, name)

    def tool(mod, argv, show=8):
        """Run a tool's main in-process on ``dev``; print its wall seconds
        and the first ``show`` lines of its output (160 characters each)."""
        buf = io.StringIO()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([*argv, "--device", str(dev)])
        sync()
        secs = time.perf_counter() - t0
        name = mod.__name__.rsplit(".", 1)[1]
        print(f"tool {name}: {secs:.3f} s, rc {rc}")
        _check(rc == 0, f"{name} {' '.join(argv)} returned {rc}")
        out = buf.getvalue()
        for ln in out.splitlines()[:show]:
            print(f"  | {ln[:160]}")
        return out

    def number(out, key):
        return float([ln for ln in out.splitlines() if ln.startswith(key)][0].split(":")[1])

    def last_json(out):
        return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])

    reset_counts()
    # -- exports at the CLI's defaults ------------------------------------
    for out_name in ("oct.npz", "oct.bin"):
        tool(sdf_export, [ply, f(out_name), *sz["oct"]])
    for out_name in ("ex.npz", "ex.bin"):
        tool(sdf_export, [ply, f(out_name), "--sdf_format", "exact_octree", *sz["ex"]])
    tool(sdf_export, [ply, f("grid.npz"), "--sdf_format", "grid"])

    # -- error tools --------------------------------------------------------
    res = last_json(tool(sdf_error, [f("oct.npz"), ply, "-m", sz["m_err"], "--json"]))
    _check(res["rmse"] < 4e-3, f"sdf_error: the approximate export's RMSE {res['rmse']}")
    res = last_json(tool(sdf_error, [f("ex.npz"), ply, "-m", sz["m_err"], "--json"]))
    _check(res["max_error"] <= ORACLE_TOL,
           f"sdf_error: the exact export's max error {res['max_error']}")
    rows = last_json(tool(sdf_error_compare, [
        ply, f("oct.npz"), f("oct.bin"), f("ex.npz"), "-m", sz["m_cmp"], "--json"],
        show=3))["results"]
    for key in ("rmse", "mae", "max_error"):
        _check(abs(rows[0][key] - rows[1][key]) <= 1e-6,
               f"sdf_error_compare: .bin {key} {rows[1][key]} vs .npz {rows[0][key]}")
    print(f"sdf_error_compare: RMSE .npz {rows[0]['rmse']:.4e}, .bin {rows[1]['rmse']:.4e}, "
          f"exact {rows[2]['rmse']:.4e}; max .npz {rows[0]['max_error']:.4e}, exact "
          f"{rows[2]['max_error']:.4e}")

    # -- renders --------------------------------------------------------------
    frame = ["--width", str(sz["frame"]), "--height", str(sz["frame"])]
    hits = []
    for src, extra in (("oct.npz", ["--ao", "--shadow"]), ("oct.bin", ["--mode", "normal"])):
        out = tool(sdf_render, [f(src), f(f"render_{src}.png"), *frame, *extra])
        hits.append(out.split("% hit")[0].rsplit(" ", 1)[1])
    _check(hits[0] == hits[1], f"sdf_render: hit shares {hits} of the .npz and the .bin")
    tool(sdf_light, [f("oct.npz"), f("light.png")])
    tool(sdf_view, [f("oct.npz"), f("view.png"), "--resolution", str(sz["view"]),
                    "--sweep", str(sz["sweep"]), "--error_vs", ply])
    out = tool(sdf_view, [f("ex.npz"), "--pick=0.3,0.01,0.013", "--pick_region",
                          f("region.obj"), "--error_vs", ply])
    lines = out.splitlines()
    tris = lines[[i for i, ln in enumerate(lines) if "influence triangles" in ln][0] + 1].split()
    pick_err = number(out, "Picked-cell max|err|")
    _check(len(tris) > 0 and pick_err <= ORACLE_TOL,
           f"sdf_view --pick: {len(tris)} triangles, cell max error {pick_err}")
    for src in ("oct.npz", "ex.npz"):
        tool(image_query_time, [f(src), f(f"iqt_{src}"), "-w", str(sz["iqt"]), "--json"])
    stats = last_json(tool(exact_mean_triangles, [f("ex.npz"), f("emt.png"), "--json"]))
    ex = SdfFunction.load(f("ex.npz"), device=dev)
    _check(stats["leaves"] == ex.num_leaves,
           f"exact_mean_triangles: {stats['leaves']} leaves, the structure {ex.num_leaves}")
    tool(interp_params, ["--print_c"], show=2)
    k2_before = nearest.launch_count
    tool(mesh_preview, [ply, f("preview.png"), "--width", str(sz["preview"]),
                        "--height", str(sz["preview"])])
    k2 = nearest.launch_count - k2_before
    print(f"mesh_preview: {k2 - 1} march trips ({k2} K2 launches: one a trip, one for "
          "the normals)")
    tool(scaling_bench, ["--json", *sz["scaling"]])
    print(f"path H tools: {time.perf_counter() - t_path:.1f} s")

    # -- parallel on one card and on four entries of it -------------------------
    t_par = time.perf_counter()
    box = prepare_box(mesh)
    oct_ = SdfFunction.load(f("oct.npz"), device=dev)
    t0 = time.perf_counter()
    oct_.build_query_grid()
    sync()
    print(f"parallel: d{oct_.max_depth} octree's build_query_grid {time.perf_counter() - t0:.3f} s")
    real = RealSdf(mesh, device=dev)
    bench_box = mesh.bounding_box.add_margin(0.14)
    p_oct = _uniform(oct_.box, sz["n_oct"], 1, dev)
    p_ex = _uniform(ex.box, sz["n_ex"], 0, dev)
    p_orc = _uniform(bench_box, 10_000, 7, dev)
    p_grad = p_oct[: sz["n_grad"]]
    o, d = _ortho_rays(sz["rays"], dev)
    ref = {
        "oct": oct_.get_distance(p_oct), "ex": ex.get_distance(p_ex),
        "real": real.get_distance(p_orc), "grad": oct_.get_distance_and_gradient(p_grad),
        "trace": trace_octree(oct_, o, d, eps=1e-5, far=4.0, max_iters=1024, beam=None),
    }
    fit_pts = p_oct[: sz["n_fit"]]
    fit_tgt = real.get_distance(fit_pts)
    # "cuda:0" and "cuda" name one card as two torch devices, so the last
    # list runs every shard as its own call on two workers of the card
    # (the per-shard split, the gather, twin frames of one shape and the
    # fit step's gradient sum across blocks); the first two run one call
    # on the card
    split4 = [torch.device(dev.type, 0), torch.device(dev.type)] * 2
    first_step = None
    for label, devs in (("default_mesh()", parallel.default_mesh([dev]) if not cuda
                         else parallel.default_mesh()), ("4 entries", [dev] * 4),
                        ("4 entries in 4 calls", split4)):
        eq = {
            "oct": torch.equal(parallel.sharded_distance(oct_, p_oct, devs), ref["oct"]),
            "ex": torch.equal(parallel.sharded_distance(ex, p_ex, devs), ref["ex"]),
            "real": torch.equal(parallel.sharded_distance(real, p_orc, devs), ref["real"]),
        }
        dg = parallel.sharded_distance_and_gradient(oct_, p_grad, devs)
        eq["grad"] = torch.equal(dg[0], ref["grad"][0]) and torch.equal(dg[1], ref["grad"][1])
        t_tr = []
        for _ in range(2):     # the first call of a shard shape captures its graphs
            sync()
            t0 = time.perf_counter()
            tr = parallel.sharded_trace(oct_, o, d, devs, eps=1e-5, far=4.0, max_iters=1024)
            sync()
            t_tr.append(time.perf_counter() - t0)
            eq["trace"] = all(torch.equal(a, b) for a, b in zip(tr, ref["trace"]))
        c = octree_coefficients(oct_._octree_dev)
        losses = []
        sync()
        t0 = time.perf_counter()
        for step in range(sz["fit_steps"]):
            loss, c = parallel.data_parallel_fit_step(oct_, c, fit_pts, fit_tgt, devs, lr=0.5)
            losses.append(float(loss))
            if step == 0:
                step1 = (float(loss), c[0].to(dev))
        t_fit = (time.perf_counter() - t0) / sz["fit_steps"]
        # the first step against the one-entry list's: the loss within 1e-6
        # relative, the coefficients within 1e-6 of the largest (the blocks'
        # sums run in another order)
        first_step = first_step or step1
        loss_rel = abs(step1[0] - first_step[0]) / abs(first_step[0])
        coef_rel = float((step1[1] - first_step[1]).abs().max() / first_step[1].abs().max())
        print(f"parallel on {label} ({len(devs)} entries, {len(set(devs))} devices): "
              f"bit-equal to the single-device calls {eq}; sharded_trace {sz['rays']}^2 "
              f"{t_tr[0]:.3f} s, again {t_tr[1]:.3f} s, hits {int(tr.hit.sum())}; fit loss "
              f"{losses[0]:.6e} -> "
              f"{losses[-1]:.6e} in {sz['fit_steps']} steps, {t_fit * 1e3:.1f} ms a step; "
              f"first step against one entry's: loss {loss_rel:.3e} relative, "
              f"coefficients {coef_rel:.3e} of the largest")
        _check(all(eq.values()), f"parallel on {label}: not bit-equal {eq}")
        _check(losses[-1] < losses[0], f"parallel on {label}: fit loss {losses}")
        _check(loss_rel <= 1e-6 and coef_rel <= 1e-6,
               f"parallel on {label}: the first fit step departs from one entry's")
    print(f"path H parallel: {time.perf_counter() - t_par:.1f} s")

    # -- tiles on eight entries ------------------------------------------------
    t_tiles = time.perf_counter()
    eight = [dev] * 8
    sync()
    t0 = time.perf_counter()
    tiled = TiledExactOctreeSdf(mesh, box, max_depth=ex.max_depth, start_depth=2,
                                min_triangles_per_node=32, strategy="lattice",
                                device_mesh=eight)
    sync()
    t_build = time.perf_counter() - t0
    lo, hi = np.asarray(ex.box.min) - 0.1, np.asarray(ex.box.max) + 0.1
    p_out = torch.as_tensor(np.random.default_rng(3).uniform(lo, hi, (sz["n_ex"], 3))
                            .astype(np.float32), device=dev)
    d_rep, d_til = ex.get_distance(p_out), tiled.get_distance(p_out)
    tile_ms = _cuda_ms(lambda: tiled.get_distance(p_out)) if cuda else float("nan")
    rep_ms = _cuda_ms(lambda: ex.get_distance(p_out)) if cuda else float("nan")
    err = (d_til - d_rep).abs()
    within = bool((err <= 1e-7 + 1e-6 * d_rep.abs()).all())
    shard_bytes = tiled.per_chip_bucket_bytes()
    print(f"TiledExactOctreeSdf on 8 entries: built in {t_build:.3f} s; {sz['n_ex']} points "
          f"(0.1 beyond the box): max |tiled - replicated| {float(err.max()):.3e}, within "
          f"rtol 1e-6 atol 1e-7 {within}; {tile_ms:.4f} ms vs replicated {rep_ms:.4f} ms; "
          f"shard bucket bytes {shard_bytes} (replicated {ex.bucket_bytes})")
    _check(within, "the tiled exact octree departs from the replicated one")
    _check(max(shard_bytes) < ex.bucket_bytes, "a shard's buckets are not below the replicated")
    t0 = time.perf_counter()
    tiled.save(f("tiled.npz"))
    back = SdfFunction.load(f("tiled.npz"), device=dev, device_mesh=eight)
    same = torch.equal(back.get_distance(p_out), d_til)
    print(f"tiled exact save + load {time.perf_counter() - t0:.3f} s "
          f"({os.path.getsize(f('tiled.npz'))} B), answers equal {same}")
    _check(same, "the tiled exact octree's round trip changed its answers")
    del tiled, back
    t_oct = TiledOctreeSdf(_octree=oct_, device_mesh=eight)
    lo, hi = np.asarray(oct_.box.min) - 0.1, np.asarray(oct_.box.max) + 0.1
    p_out = torch.as_tensor(np.random.default_rng(4).uniform(lo, hi, (sz["n_oct"], 3))
                            .astype(np.float32), device=dev)
    dr, gr = oct_.get_distance_and_gradient(p_out)
    dt, gt = t_oct.get_distance_and_gradient(p_out)
    d_ok = bool((( t_oct.get_distance(p_out) - oct_.get_distance(p_out)).abs()
                 <= 1e-7 + 1e-6 * dr.abs()).all())
    g_ok = bool(((gt - gr).abs() <= 1e-5 + 1e-5 * gr.abs()).all())
    print(f"TiledOctreeSdf on 8 entries (d{oct_.max_depth} fused rows): {sz['n_oct']} points, "
          f"distances within rtol 1e-6 atol 1e-7 of the grid route {d_ok} (max "
          f"{float((dt - dr).abs().max()):.3e}), gradients within 1e-5 {g_ok}; slab bytes "
          f"{t_oct.per_chip_grid_bytes()}")
    _check(d_ok and g_ok, "the tiled octree departs from its grid route")
    print(f"path H tiles: {time.perf_counter() - t_tiles:.1f} s")
    sync()
    launches = read_counts()
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"path H took {time.perf_counter() - t_path:.1f} s; launches on path H: {launches}")
    for name in ("nearest", "scan_window", "scan_grouped", *EXACT_KERNELS):
        _check(launches[name] > 0 or not cuda, f"{name} was not launched on path H")
    # K2 alone at the tools' two shapes, after the path's counts were read:
    # sdf_error's RealSdf (2^22 samples) and one mesh_preview trip
    # (262,144 points), each x the torus's 9,216 triangles
    k2_err = 0.0
    if cuda:
        samples = _uniform(bench_box, 1 << 22, 5, dev)
        for pts, label in ((samples, "sdf_error's RealSdf, 2^22 samples"),
                           (samples[: 1 << 18], "a mesh_preview trip, 262,144 points")):
            err = k2_vs_plain(pts, real.fields, real.triangles, f"{label}, checked on 2^16",
                              n_check=1 << 16)[0]
            k2_err = max(k2_err, err)
        del samples
    return launches, k2_err


MULTI_FULL = dict(n_approx=1 << 22, n_exact=1 << 21, n_real=10_000, rays=1024, depth=6)
MULTI_SMALL = dict(n_approx=4096, n_exact=4096, n_real=512, rays=64, depth=4)


def _devices_ms(fn, devs, reps: int = 3, warm: int = 1) -> float:
    """Best of ``reps`` calls (after ``warm`` calls), ms on the host
    clock, each call ended by a synchronise of every card of ``devs``."""
    import torch

    cards = sorted({torch.device("cuda", d.index or 0) for d in devs if d.type == "cuda"},
                   key=str)

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    for _ in range(warm):
        fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def card_timeline(fn, label):
    """One call of ``fn`` (after a warm call) under torch.profiler, its
    device activities split by card: each card's first start and last
    end, in ms from the call's first device activity, and its busy time
    (the union of its activities); then the time during which at least k
    cards were busy at once, k = 1 .. cards. Returns ({card: (start, end,
    busy)}, {k: ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    fn()
    sync()
    # device activities only: recording the host's ops would slow the
    # workers' launches and stagger the cards
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    spans: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            spans.setdefault(e.device_index(), []).append((e.start_ns(), e.end_ns()))
    _check(len(spans) > 0, f"timeline, {label}: no device activity traced")
    t0 = min(a for iv in spans.values() for a, _ in iv)
    cards, edges = {}, []
    for card, iv in sorted(spans.items()):
        iv.sort()
        busy, (lo, hi) = 0, iv[0]
        for a, b in iv[1:]:
            if a > hi:
                busy += hi - lo
                edges += [(lo, 1), (hi, -1)]
                lo = a
            hi = max(hi, b)
        busy += hi - lo
        edges += [(lo, 1), (hi, -1)]
        cards[card] = ((iv[0][0] - t0) / 1e6, (max(b for _, b in iv) - t0) / 1e6, busy / 1e6)
    at_least = {k: 0.0 for k in range(1, len(cards) + 1)}
    level, last = 0, None
    for t, step in sorted(edges, key=lambda x: (x[0], -x[1])):
        if last is not None and level > 0:
            for k in range(1, level + 1):
                at_least[k] += (t - last) / 1e6
        level, last = level + step, t
    print(f"card timeline, {label}: " + "; ".join(
        f"card {c} busy {b:.4f} ms from {a:.4f} to {z:.4f} ms" for c, (a, z, b) in cards.items()))
    print(f"card timeline, {label}: at least k cards busy at once, ms: " + ", ".join(
        f"k={k} {v:.4f}" for k, v in at_least.items()))
    return cards, at_least


def card_spans(call, devs, label):
    """When each card ran its block of one unprofiled ``call(devs)``
    (after a warm call): CUDA events recorded on each card's stream when
    its worker starts and ends the block, in ms from an event every card
    recorded as the call began (recorded from the host one card after
    another, microseconds apart). Returns {card: (start, end)}."""
    import importlib

    import torch

    from sdflib_tpu_torch.parallel import mesh as pmesh

    mods = [importlib.import_module(f"sdflib_tpu_torch.parallel.{m}") for m in ("query", "render")]
    marks: dict = {}

    def spy(blocks, fn):
        def timed(dev, block):
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(dev, block)
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            marks[dev] = (a, b)
            return out

        return pmesh.run_blocks(blocks, timed)

    call(devs)
    for d in devs:
        torch.cuda.synchronize(d)
    origin = {}
    for d in devs:
        origin[d] = torch.cuda.Event(enable_timing=True)
        origin[d].record(torch.cuda.current_stream(d))
    for m in mods:
        m.run_blocks = spy
    try:
        call(devs)
    finally:
        for m in mods:
            m.run_blocks = pmesh.run_blocks
    for d in devs:
        torch.cuda.synchronize(d)
    spans = {d.index: (origin[d].elapsed_time(a), origin[d].elapsed_time(b))
             for d, (a, b) in marks.items()}
    print(f"card spans, {label}, unprofiled: " + "; ".join(
        f"card {c} {a:.4f} to {b:.4f} ms" for c, (a, b) in sorted(spans.items())))
    return spans


def _multicard_work(dev, sz):
    """``multicard_path``'s calls by name: (count, unit, the call on a
    device list, the single-device call), over structures built on
    ``dev``."""
    from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf, RealSdf, parallel
    from sdflib_tpu_torch.render import trace_octree
    from sdflib_tpu_torch.utils.primitives import make_torus

    mesh = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = mesh.bounding_box.add_margin(0.14)
    oct_ = OctreeSdf(mesh, box, max_depth=sz["depth"], start_depth=2,
                     termination_threshold=1e-3, device=dev)
    oct_.build_query_grid()
    ex = ExactOctreeSdf(mesh, box, max_depth=sz["depth"], start_depth=2,
                        min_triangles_per_node=32, device=dev)
    real = RealSdf(mesh, device=dev)
    o, d = _ortho_rays(sz["rays"], dev)
    work = {
        "sharded_trace": (sz["rays"] ** 2, "rays",
                          lambda m: parallel.sharded_trace(oct_, o, d, m, eps=1e-5, far=4.0,
                                                           max_iters=1024),
                          lambda: trace_octree(oct_, o, d, eps=1e-5, far=4.0, max_iters=1024,
                                               beam=None)),
    }
    for name, sdf, n, seed in (("approximate", oct_, sz["n_approx"], 1),
                               ("exact", ex, sz["n_exact"], 0),
                               ("RealSdf", real, sz["n_real"], 7)):
        pts = _uniform(box if sdf is real else sdf.box, n, seed, dev)
        work[f"sharded_distance {name}"] = (
            n, "points", lambda m, s=sdf, p=pts: parallel.sharded_distance(s, p, m),
            lambda s=sdf, p=pts: s.get_distance(p))
    return work


class _FifoLock:
    """A lock handed to its waiters in the order they asked for it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._held = False

    def acquire(self):
        with self._cond:
            me = object()
            self._queue.append(me)
            while self._held or self._queue[0] is not me:
                self._cond.wait()
            self._queue.popleft()
            self._held = True
        return True

    def release(self):
        with self._cond:
            self._held = False
            self._cond.notify_all()


def runner_probe(devs=None, sizes=None, rounds: int = 2):
    """What holds ``parallel``'s workers back on several cards: peer
    access between the cards; each ``multicard_path`` call on every card
    (best of 3, host clock) from the workers taking turns (as they run),
    taking turns handed over in arrival order (``_FifoLock``), each of
    those with the interpreter's switch interval at 10 us (its default
    is 5 ms), from the workers all issuing at once (the turn lock a
    no-op) at 5 ms, 1 ms and 10 us, and one card after another from the
    caller, every mode ``rounds`` times in turn; ``run_blocks`` of an
    empty function; and the one-card trace's device timeline."""
    import importlib

    import torch

    from sdflib_tpu_torch import parallel
    from sdflib_tpu_torch.parallel import mesh as pmesh

    class NoLock:
        def acquire(self):
            return True

        def release(self):
            pass

    devs = parallel.default_mesh(devs)
    sz = MULTI_FULL if sizes is None else sizes
    cards = [d.index for d in devs if d.type == "cuda"]
    print("peer access: " + ", ".join(
        f"{a}->{b} {torch.cuda.can_device_access_peer(a, b)}"
        for a in cards for b in cards if a != b))
    work = _multicard_work(devs[0], sz)
    mods = [importlib.import_module(f"sdflib_tpu_torch.parallel.{m}") for m in ("query", "render")]
    turn, run = pmesh._TURN, pmesh.run_blocks

    def serial():
        for m in mods:
            m.run_blocks = lambda blocks, fn: [fn(d, b) for d, b in blocks]

    modes = [  # (label, patch, switch interval or None)
        ("the workers taking turns", lambda: None, None),
        ("the workers taking turns", lambda: None, 1e-5),
        ("the workers taking turns in arrival order",
         lambda: setattr(pmesh, "_TURN", _FifoLock()), None),
        ("the workers taking turns in arrival order",
         lambda: setattr(pmesh, "_TURN", _FifoLock()), 1e-5),
        ("the workers all at once", lambda: setattr(pmesh, "_TURN", NoLock()), None),
        ("the workers all at once", lambda: setattr(pmesh, "_TURN", NoLock()), 1e-3),
        ("the workers all at once", lambda: setattr(pmesh, "_TURN", NoLock()), 1e-5),
        ("one card after another from the caller", serial, None),
    ]
    switch = sys.getswitchinterval()
    for r in range(rounds):
        for label, patch, interval in modes:
            patch()
            if interval is not None:
                sys.setswitchinterval(interval)
            try:
                print(f"round {r}, {label}, switch interval "
                      f"{(interval or switch) * 1e6:g} us, {len(devs)} devices: " + "; ".join(
                          f"{name} {_devices_ms(lambda c=call: c(devs), devs):.4f} ms"
                          for name, (_, _, call, _) in work.items()))
            finally:
                sys.setswitchinterval(switch)
                pmesh._TURN = turn
                for m in mods:
                    m.run_blocks = run
    empty = [(d, None) for d in devs]
    print(f"run_blocks of an empty function on {len(devs)} devices: "
          f"{_devices_ms(lambda: pmesh.run_blocks(empty, lambda d, b: None), devs, 20):.4f} ms")
    if devs[0].type == "cuda":
        card_timeline(lambda: work["sharded_trace"][2](devs[:1]),
                      f"sharded_trace {sz['rays']}^2 on one card")


def launch_probe(devs=None, n_ops: int = 55, size: int = 1 << 20):
    """How fast ``n_ops`` small torch launches a card (``x.add_(1)`` on
    ``size`` floats) go out from ``parallel``'s workers, against the same
    launches one card after another from the caller: best of 5, host
    clock, every card synchronised; each worker's median and largest gap
    between launches; the same with torch's intra-op threads at 1; then
    an interpreter-only loop of the same length."""
    import contextlib
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from sdflib_tpu_torch import parallel
    from sdflib_tpu_torch.parallel import mesh as pmesh

    devs = parallel.default_mesh(devs)
    xs = {d: torch.zeros(size, device=d) for d in devs}
    gaps: dict = {}

    def launches(dev, _):
        x, t = xs[dev], [time.perf_counter()]
        for _ in range(n_ops):
            x.add_(1.0)
            t.append(time.perf_counter())
        gaps[dev] = [(b - a) * 1e6 for a, b in zip(t, t[1:])]

    def serial():
        for d in devs:
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                launches(d, None)

    blocks = [(d, None) for d in devs]
    threaded = lambda: pmesh.run_blocks(blocks, launches)   # noqa: E731
    # plain threads that only make their card current: no stream context
    pools = {d: ThreadPoolExecutor(1) for d in devs}

    def on_card(d):
        if d.type == "cuda":
            torch.cuda.set_device(d)
        launches(d, None)

    def bare():
        for f in [pools[d].submit(on_card, d) for d in pools]:
            f.result()

    for threads in (torch.get_num_threads(), 1):
        saved = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            t_ser = _devices_ms(serial, devs, reps=5)
            ser_gaps = {d: list(g) for d, g in gaps.items()}
            t_bare = _devices_ms(bare, devs, reps=5)
            t_thr = _devices_ms(threaded, devs, reps=5)
        finally:
            torch.set_num_threads(saved)
        print(f"launch probe, intra-op threads {threads}: {n_ops} launches a card on "
              f"{len(devs)} cards: one card after another {t_ser:.4f} ms (gaps median "
              f"{statistics.median(ser_gaps[devs[0]]):.1f} us), plain threads "
              f"{t_bare:.4f} ms, the workers {t_thr:.4f} ms; worker gaps (median, max, "
              "us): " + ", ".join(f"{d} {statistics.median(g):.1f} {max(g):.1f}"
                                  for d, g in gaps.items()))
    for pool in pools.values():
        pool.shutdown()

    def spin(dev, _):
        return sum(i * i for i in range(n_ops * 200))

    t_ser = _devices_ms(lambda: [spin(d, None) for d in devs], devs, reps=5)
    t_thr = _devices_ms(lambda: pmesh.run_blocks(blocks, spin), devs, reps=5)
    print(f"launch probe, interpreter only: one after another {t_ser:.4f} ms, "
          f"from the workers {t_thr:.4f} ms")


def multicard_path(devs=None, sizes=None):
    """``parallel`` over several cards: bench.py's 1024^2 ``sharded_trace``
    (beam off, max_iters 1024) and the 2^22-point ``sharded_distance`` on
    the d6 approximate octree after ``build_query_grid``, the 2^21-point
    d6 exact ``sharded_distance`` (K1w) and the 10k-point ``RealSdf`` (K2),
    on the first card alone, on two cards where there are four or more,
    and on every card of ``devs`` (default: every card). Each list's
    answers are bit-equal to the single-device call; each is timed (best
    of 5 after 3 warm calls, the host clock, every card synchronised) with
    its rate and its efficiency against the first card's (rate over
    cards x the one-card rate). Then one every-card call of each with
    each card's span from CUDA events (``card_spans``), and one under the
    profiler, split by card (``card_timeline``). With one card
    it prints that and returns None; else the rows."""
    import torch

    from sdflib_tpu_torch import parallel

    devs = parallel.default_mesh(devs)
    sz = MULTI_FULL if sizes is None else sizes
    if len(set(devs)) < 2:
        print(f"multi-card rows: {len(devs)} entry on one device ({devs[0]}"
              + (f", {torch.cuda.get_device_name(devs[0])}" if devs[0].type == "cuda" else "")
              + "): not run")
        return None
    t_path = time.perf_counter()
    work = _multicard_work(devs[0], sz)
    lists = [devs[:1]] + ([devs[:2]] if len(devs) >= 4 else []) + [devs]
    rows = []
    for name, (n, unit, call, single) in work.items():
        ref = single()
        base = None
        for m in lists:
            out = call(m)
            same = (all(torch.equal(a, b) for a, b in zip(out, ref)) if name == "sharded_trace"
                    else torch.equal(out, ref))
            _check(same, f"{name} on {len(m)} cards differs from the single-device call")
            # the first calls of a new list capture and upload its frames
            ms = _devices_ms(lambda: call(m), m, reps=5, warm=3)
            rate = n / ms * 1e3
            base = base or rate
            eff = rate / (base * len(m))
            rows.append(dict(work=name, cards=len(m), ms=ms, rate=rate, efficiency=eff))
            print(f"multi-card {name}, {n} {unit} on {len(m)} card(s) {[str(x) for x in m]}: "
                  f"{ms:.4f} ms, {rate:.6e} {unit}/s, {rate / base:.4f}x one card, "
                  f"efficiency {eff:.4f}; bit-equal to the single-device call")
    if devs[0].type == "cuda":
        for name, (n, _, call, _) in work.items():
            card_spans(call, devs, f"{name}, {n} on {len(devs)} cards")
            card_timeline(lambda: call(devs), f"{name}, {n} on {len(devs)} cards")
    print(f"multi-card path: {time.perf_counter() - t_path:.1f} s")
    return rows


PROC = dict(n_exact=1 << 21, n_real=10_000, n_approx=1 << 22, n_grad=1 << 20, rays=1024,
            n_fit=1 << 20, n_tiles=1 << 21, depth=6)
PROC_DEADLINE = 600.0


def _process_rank(rank, world, backend, tmp):
    """One rank of ``process_path``: its group (``file://`` rendezvous in
    ``tmp``), the structures the parent saved, every sharded call on a
    ``ProcessMesh`` of one entry a rank (the tiles: two) with its rate,
    then the same calls on this rank's one device, each held bit-equal.
    Writes ``rank<r>.json``: the rates, the one-device times (rank 0
    alone, the others waiting), the checks and the kernels' launch counts
    of the sharded calls."""
    import datetime

    import torch
    import torch.distributed as dist

    from sdflib_tpu_torch import RealSdf, SdfFunction, parallel
    from sdflib_tpu_torch.diff.query import octree_coefficients
    from sdflib_tpu_torch.render import trace_octree
    from sdflib_tpu_torch.utils.primitives import make_torus

    sz = PROC
    card = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        geo = make_torus(R=0.3, r=0.12, nu=96, nv=48)
        box = geo.bounding_box.add_margin(0.14)
        ex = SdfFunction.load(os.path.join(tmp, "exact.npz"), device=card)
        oct_ = SdfFunction.load(os.path.join(tmp, "octree.npz"), device=card)
        oct_.build_query_grid()
        real = RealSdf(geo, device=card)
        one = parallel.process_mesh([card])
        two = parallel.process_mesh([card, card])
        tiled = SdfFunction.load(os.path.join(tmp, "tiled.npz"), device=card, device_mesh=two)
        tiled_one = SdfFunction.load(os.path.join(tmp, "tiled.npz"), device=card,
                                     device_mesh=[card] * len(two))
        p_ex = _uniform(ex.box, sz["n_exact"], 0, card)
        p_orc = _uniform(box, sz["n_real"], 7, card)
        p_oct = _uniform(oct_.box, sz["n_approx"], 1, card)
        p_grad, p_fit = p_oct[: sz["n_grad"]], p_oct[: sz["n_fit"]]
        t_fit = real.get_distance(p_fit)
        o, d = _ortho_rays(sz["rays"], card)
        lo, hi = np.asarray(ex.box.min) - 0.1, np.asarray(ex.box.max) + 0.1
        p_tile = torch.as_tensor(np.random.default_rng(3).uniform(lo, hi, (sz["n_tiles"], 3))
                                 .astype(np.float32), device=card)
        c0 = octree_coefficients(oct_._octree_dev)
        trace_kw = dict(eps=1e-5, far=4.0, max_iters=1024)
        # name: (count, unit, the call over the processes, the call on this rank's device)
        work = {
            "sharded_distance exact": (
                sz["n_exact"], "points", lambda: parallel.sharded_distance(ex, p_ex, one),
                lambda: ex.get_distance(p_ex)),
            "sharded_distance exact, oracle points": (
                sz["n_real"], "points", lambda: parallel.sharded_distance(ex, p_orc, one),
                lambda: ex.get_distance(p_orc)),
            "sharded_distance RealSdf": (
                sz["n_real"], "points", lambda: parallel.sharded_distance(real, p_orc, one),
                lambda: real.get_distance(p_orc)),
            "sharded_distance approximate": (
                sz["n_approx"], "points", lambda: parallel.sharded_distance(oct_, p_oct, one),
                lambda: oct_.get_distance(p_oct)),
            "sharded_distance_and_gradient": (
                sz["n_grad"], "points",
                lambda: parallel.sharded_distance_and_gradient(oct_, p_grad, one),
                lambda: oct_.get_distance_and_gradient(p_grad)),
            "sharded_trace": (
                sz["rays"] ** 2, "rays",
                lambda: parallel.sharded_trace(oct_, o, d, one, **trace_kw),
                lambda: trace_octree(oct_, o, d, beam=None, **trace_kw)),
            "data_parallel_fit_step": (
                sz["n_fit"], "points",
                lambda: parallel.data_parallel_fit_step(oct_, c0, p_fit, t_fit, one, lr=0.5),
                lambda: parallel.data_parallel_fit_step(oct_, c0, p_fit, t_fit, [card], lr=0.5)),
            "tiled exact": (
                sz["n_tiles"], "points", lambda: tiled.get_distance(p_tile),
                lambda: tiled_one.get_distance(p_tile)),
        }

        def settle():
            torch.cuda.synchronize(card)
            dist.barrier()

        def best_ms(fn, sync):
            fn()
            sync()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                sync()
                best = min(best, time.perf_counter() - t0)
            return best * 1e3

        reset_counts()
        outs, rows = {}, {}
        for name, (n, unit, call, _) in work.items():
            outs[name] = call()
            rows[name] = dict(n=n, unit=unit, ms=best_ms(call, settle))
        counts = read_counts()
        # the fit: three steps from c0, the loss falling
        losses, c = [], c0
        for _ in range(3):
            loss, c = parallel.data_parallel_fit_step(oct_, c, p_fit, t_fit, one, lr=0.5)
            losses.append(float(loss))
        same = {}
        for name, (_, _, _, single) in work.items():
            ref, out = single(), outs[name]
            if name == "data_parallel_fit_step":
                # one entry's step: the loss and the new coefficients within 1e-6
                # relative (the blocks' sums run in another order)
                fit_coeffs = float((out[1][0] - ref[1][0]).abs().max() / ref[1][0].abs().max())
                same[name] = (abs(float(out[0]) - float(ref[0])) <= 1e-6 * abs(float(ref[0]))
                              and fit_coeffs <= 1e-6)
            elif isinstance(out, tuple):
                same[name] = all(torch.equal(a, b) for a, b in zip(out, ref))
            else:
                same[name] = torch.equal(out, ref)
            if rank == 0:
                rows[name]["one_device_ms"] = best_ms(single,
                                                      lambda: torch.cuda.synchronize(card))
            dist.barrier()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, device=str(card), rows=rows, same=same, counts=counts,
                           fit_losses=losses, fit_coefficients=fit_coeffs), f)
    finally:
        dist.destroy_process_group()


def process_path(dev, tmp: str, threaded=None):
    """``parallel`` across processes: on one card two ranks on it under
    gloo, on two cards or more one rank a card under NCCL. The parent saves the d6
    exact structure (``exact.npz`` in ``tmp``, path A's where main saved
    it, else built here), path C's d6 no_continuity octree and a tiled
    exact octree of two shards a rank (built on ``dev``), then spawns the
    ranks (``torch.multiprocessing``, spawn). Each rank runs the
    2^21-point exact ``sharded_distance`` (K1w), the exact query and
    ``RealSdf`` (K2) on the 10k oracle points (K1g), the 2^22-point
    approximate query after ``build_query_grid``,
    ``sharded_distance_and_gradient`` on 2^20 points, bench.py's 1024^2
    ``sharded_trace`` (beam off), the fit step on 2^20 points (three
    steps, the loss falling) and the tiled exact octree (2^21 points up
    to 0.1 beyond the box), each on a ``ProcessMesh``, timed on the host
    clock between barriers (best of 3 after a warm call), and holds each
    bit-equal to its call on the rank's one device (the fit step's loss
    and new coefficients within 1e-6 of one entry's, max |d| / max |c|). Prints every rank's rates beside the
    one-device times and ``threaded`` (``multicard_path``'s rows). A rank
    that fails fails the path. Returns the ranks' summed launch counts."""
    import torch
    import torch.multiprocessing as mp

    from sdflib_tpu_torch import ExactOctreeSdf, OctreeSdf
    from sdflib_tpu_torch.parallel.tiles import TiledExactOctreeSdf
    from sdflib_tpu_torch.utils.primitives import make_torus

    sz = PROC
    t_path = time.perf_counter()
    cards = torch.cuda.device_count()
    world, backend = (cards, "nccl") if cards >= 2 else (2, "gloo")
    geo = make_torus(R=0.3, r=0.12, nu=96, nv=48)
    box = geo.bounding_box.add_margin(0.14)
    kw = dict(max_depth=sz["depth"], start_depth=2)
    if not os.path.exists(os.path.join(tmp, "exact.npz")):
        ExactOctreeSdf(geo, box, **kw, min_triangles_per_node=32, device=dev).save(
            os.path.join(tmp, "exact.npz"))
    OctreeSdf(geo, box, **kw, termination_threshold=1e-3, device=dev).save(
        os.path.join(tmp, "octree.npz"))
    TiledExactOctreeSdf(geo, box, **kw, min_triangles_per_node=32,
                        device_mesh=[dev] * (2 * world)).save(os.path.join(tmp, "tiled.npz"))
    print(f"process path: {world} ranks under {backend} on "
          f"{'cuda:0' if backend == 'gloo' else f'{world} cards'}; structures saved in "
          f"{time.perf_counter() - t_path:.1f} s")
    t_spawn = time.perf_counter()
    ctx = mp.start_processes(_process_rank, args=(world, backend, tmp),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            _check(time.perf_counter() - t_spawn < PROC_DEADLINE,
                   f"process path: the ranks were not done in {PROC_DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    widest: dict = {}          # multicard_path's every-card row of each call
    for row in threaded or []:
        if row["cards"] >= widest.get(row["work"], {}).get("cards", 0):
            widest[row["work"]] = row
    for name, row0 in ranks[0]["rows"].items():
        n, unit = row0["n"], row0["unit"]
        per = "; ".join(f"rank {rk['rank']} ({rk['device']}) {rk['rows'][name]['ms']:.4f} ms, "
                        f"{n / rk['rows'][name]['ms'] * 1e3:.6e} {unit}/s" for rk in ranks)
        one_ms = row0["one_device_ms"]
        slowest = max(rk["rows"][name]["ms"] for rk in ranks)
        line = (f"process rows, {name}, {n} {unit} over {world} ranks: {per}; one device "
                f"alone {one_ms:.4f} ms ({one_ms / slowest:.4f}x)")
        if name in widest:
            t = widest[name]
            line += f"; threaded on {t['cards']} cards {t['ms']:.4f} ms"
        print(line)
    for rk in ranks:
        print(f"process rank {rk['rank']}: bit-equal to its one-device calls {rk['same']}; "
              f"fit losses {rk['fit_losses']}, coefficients max |d| / max |c| "
              f"{rk['fit_coefficients']:.3e}; launches {rk['counts']}")
        _check(all(rk["same"].values()), f"process rank {rk['rank']}: not equal {rk['same']}")
        losses = rk["fit_losses"]
        _check(losses[-1] < losses[0], f"process rank {rk['rank']}: fit loss {losses}")
    counts = {k: sum(rk["counts"][k] for rk in ranks) for k in ranks[0]["counts"]}
    print(f"process path took {time.perf_counter() - t_path:.1f} s; launches in the ranks: "
          f"{counts}")
    for name in ("nearest", "scan_window", "scan_grouped", *EXACT_KERNELS):
        _check(counts[name] > 0, f"{name} was not launched in the process path's ranks")
    return counts


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
    from sdflib_tpu_torch.ops import exact_query, nearest, row_gather, scan
    from sdflib_tpu_torch.sdf.exact_octree import prepare_cull_inputs
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
    for short in ("nearest_kernel", "merge_kernel", "morton_order_kernel", "morton_box_kernel",
                  "morton_codes_kernel", "scan_window_kernel",
                  "scan_grouped_kernel", "row_min_block_kernel", "row_min_tile_kernel",
                  "octree_query_kernel", "march_kernel", "beam_kernel", "exact_descend_kernel",
                  "leaf_sort_keys_kernel", "leaf_sort_pass_kernel",
                  "exact_sorted_gather_kernel", "exact_finish_kernel", "walk_query_kernel",
                  "walk_key_kernel", "walk_reduce_kernel", "walk_reduce_span_kernel",
                  "walk_backward_kernel", "walk_march_kernel", "walk_march_warps_kernel",
                  "walk_segment_kernel", "walk_beam_kernel",
                  "region_cull_warp_kernel", "region_cull_block_kernel"):
        lines = [(_instance(k), v) for k, v in report.items()
                 if short in k and (short.startswith("walk") or "walk_" not in k)]
        for tag, line in lines or [("", "not reported")]:
            print(f"ptxas {short}{tag}: {line}")
    print(f"SASS {_sass_branches(build.library_path(), 'nearest_kernel')}")
    print(f"SASS {_sass_branches(build.library_path(), 'scan_grouped_kernel')}")
    print(f"SASS {_sass_branches(build.library_path(), 'scan_window_kernel')}")
    print(f"SASS {_sass_branches(build.library_path(), 'exact_finish_kernel')}")
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
        """K2's point order against its plain version (bit-equal), in one
        launch up to the cutoff (counted), else the box and code kernels
        and the sort; then both timed. (max |order diff|, kernel ms, plain
        ms, bound)."""
        P, cut = pts.shape[0], nearest.morton_order_max(dev)
        before = nearest.morton_launch_count
        got = nearest.morton_order(pts)
        torch.cuda.synchronize()
        launched = nearest.morton_launch_count - before
        _check(launched == (1 if P <= cut else 2),
               f"K2's point order took {launched} launches at {P} points (cutoff {cut})")
        _check(torch.equal(got, nearest.morton_order_plain(pts)),
               f"K2's point order differs from the plain order ({label})")
        ms = _cuda_ms(lambda: nearest.morton_order(pts))
        plain_ms = _cuda_ms(lambda: nearest.morton_order_plain(pts))
        bound = _bound(P * 12 + P * 8, P * 9)
        print(f"K2 Morton order vs plain ({label}, P={P}, one-launch cutoff {cut}): bit-equal; "
              f"{launched} launch(es); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bound[0]:.6f} ms ({bound[1]})")
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

    def exact_breakdown(fn, label, most):
        """``breakdown`` of one exact query over the leaf grid, with the
        device ms a call of the leaf sort (its kernels and its memset),
        K9, K1 and K7, no torch sort kernel among its activities, and at
        most ``most`` (and EXACT_MAX_ACTIVITIES) device activities a
        call."""
        parts, named = dict.fromkeys(EXACT_PARTS), {}
        _, _, acts = breakdown(fn, label, top=8, device_ms=parts, activities=named, warm=True)
        print(f"    {label}, by kernel: " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
              + f"; {acts} device activities a call: "
              + "; ".join(f"{n:g} x {k[:60]}" for k, n in sorted(named.items())))
        sorts = [k for k in named if _torch_sort_kernel(k)]
        _check(not sorts, f"the query ran torch's sort ({label}): {sorts}")
        most = min(most, EXACT_MAX_ACTIVITIES)
        _check(acts <= most, f"{acts} device activities a call ({label}), above {most}")

    def query_rows(sdf, q, label):
        """``get_distance`` (the leaf sort, K9, K1, K7; the sort launched
        once), the same with the plain versions of the sort, K9 and K7
        (``_query(plain_glue=True)``: K8's plain keys and ``torch.sort``)
        and with every step's (``plain=True``), each timed, their answers
        equal; with the gradient, the distances equal and the gradients
        within 1e-6."""
        before = exact_query.sort_launch_count
        d = sdf.get_distance(q)
        sorts = exact_query.sort_launch_count - before
        _check(sorts == 1, f"the query launched the leaf sort {sorts} times ({label})")
        _check(torch.equal(d, sdf._query(q, False, plain_glue=True)),
               f"the query with K7-K9 differs from the one with their plain versions ({label})")
        dg, g = sdf.get_distance_and_gradient(q)
        dg_p, g_p = sdf._query(q, True, plain_glue=True)
        g_err = float((g - g_p).abs().max())
        _check(torch.equal(dg, dg_p) and g_err <= 1e-6,
               f"the gradient query with K7-K9 differs from the plain versions' ({label}): "
               f"gradients by {g_err}")
        ms = [_cuda_ms(lambda: sdf.get_distance(q)),
              _cuda_ms(lambda: sdf._query(q, False, plain_glue=True)),
              _cuda_ms(lambda: sdf._query(q, False, plain=True))]
        n = q.shape[0]
        print(f"get_distance {label}: K7-K9 and K1 {ms[0]:.4f} ms ({n / ms[0] * 1e3:.4e} q/s), "
              f"K1 with K7-K9 plain {ms[1]:.4f} ms ({n / ms[1] * 1e3:.4e} q/s), all plain "
              f"{ms[2]:.3f} ms ({n / ms[2] * 1e3:.4e} q/s); the first two equal, with the "
              f"gradient too (max |gradient diff| {g_err:.3e})")

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
    with CullLog() as log_a:
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
    # K8 alone: the first grouped query of a padded size descends the origin
    for name in ("nearest", "scan_window", "scan_grouped", "exact_descend", "region_cull",
                 *EXACT_KERNELS):
        _check(launches["d6"][name] > 0, f"{name} was not launched on path A")
    _check(launches["d6"]["region_cull"] == log_a.groups and log_a.plain_calls == 0,
           f"the d6 build launched K13 {launches['d6']['region_cull']} times for "
           f"{log_a.groups} groups and the plain cull {log_a.plain_calls} times")
    print(f"K13 on path A's build: one launch a group ({log_a.groups}), no plain cull")

    # -- K13 against its plain version: the d6 build both ways, every group,
    # each form at each width ------------------------------------------------
    both6 = build_both_ways(dev, 6, sdf)
    for K, group in sorted(both6["kept"].items()):
        cull_vs_plain(both6["tables"], group, f"d6, the widest group of width {K}",
                      plain_reps=1)
    del both6

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

    # -- K7-K9 against their plain versions, d6 2^21 (window) and 2^16 ------
    ek = exact_kernels_vs_plain(sdf, pts, "d6 2^21", sweep=True)
    for name in ("exact_descend", *EXACT_KERNELS):
        kernels[name] = dict(ek[name])
    # K9's grouped mode: the same kernel and counter as its window mode
    kernels["exact_sorted_gather_grouped"] = dict(ek["exact_sorted_gather_grouped"],
                                                  counter="exact_sorted_gather")
    for res in (exact_kernels_vs_plain(sdf, pts[: 1 << 16], "d6 2^16"), ek):
        kernels["exact_finish"]["err"] = max(kernels["exact_finish"]["err"],
                                             res["exact_finish_grad"]["err"])

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
    exact_breakdown(lambda: sdf.get_distance(pts), "d6 2^21 points (auto: window)",
                    EXACT_ACTIVITIES["window"])
    sdf.set_scan_impl("xla")
    exact_breakdown(lambda: sdf.get_distance(pts[:n]), "d6 2^21 points, grouped scan pinned",
                    EXACT_ACTIVITIES["grouped"])
    sdf._default_scan_impl()
    exact_breakdown(lambda: sdf.get_distance(pts[: 1 << 16]), "d6 2^16 points (auto: grouped)",
                    EXACT_ACTIVITIES["grouped"])

    # -- end-to-end query timing: K7-K9 and K1, K1 with K7-K9's plain
    # versions (``_query(plain_glue=True)``), every step plain -------------
    query_rows(sdf, pts, "d6 2^21 points (auto: window)")
    query_rows(sdf, pts[: 1 << 16], "d6 2^16 points (auto: grouped)")

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
    # path A's structure for the process path's ranks
    proc_tmp = tempfile.mkdtemp(prefix="sdf_proc_")
    sdf.save(os.path.join(proc_tmp, "exact.npz"))
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
    big_kw = dict(max_depth=7, start_depth=3, min_triangles_per_node=32,
                  bucket_byte_budget=8 << 30, device=dev)
    with CullLog() as log_b:
        bsdf = ExactOctreeSdf(big, big_box, **big_kw)
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
    _check(launches["d7"]["region_cull"] == log_b.groups and log_b.plain_calls == 0,
           f"the d7 build launched K13 {launches['d7']['region_cull']} times for "
           f"{log_b.groups} groups and the plain cull {log_b.plain_calls} times")
    print(f"K13 on path B's build: one launch a group ({log_b.groups}), no plain cull")
    # K13 against the plain route on the top group and the most populous one
    # of 128 slots, the narrowest width of a build that stops at 32, kept
    # (~0.1 GB) from a build of their own, after path B's peak was read
    top_width = 1 << (big.indices.size // 3 - 1).bit_length()     # the start level's padded lists
    with CullLog(widths=(top_width, 128)) as log_b:
        ExactOctreeSdf(big, big_box, **big_kw)
    big_tables = prepare_cull_inputs(bsdf.triangles, "region")
    _check(set(log_b.kept) == {top_width, 128}, f"d7 kept groups of widths {sorted(log_b.kept)}")
    kernels["region_cull"] = cull_vs_plain(big_tables, log_b.kept[top_width],
                                           "d7, the top group")
    narrow = log_b.kept[128]
    depth = round(np.log2(float(big_box.cubified().size[0]) / (2 * narrow[3])))
    cull_vs_plain(big_tables, narrow, f"d7, the most populous group of 128 slots, depth {depth}")
    del big_tables, log_b
    profiled = subprocess.run([sys.executable, "-c", "import chip_smoke as cs; "
                               "cs.build_profile_alone(7)"],
                              cwd=root, capture_output=True, text=True, timeout=900)
    print(profiled.stdout, end="")
    _check(profiled.returncode == 0,
           f"the d7 build's profiler process failed:\n{profiled.stderr[-4000:]}")
    big_tris = big_oracle.triangles
    k2_err7, _, _, _ = k2_vs_plain(bopts, big_oracle.fields, big_tris, "d7 oracle")
    kernels["nearest"]["err"] = max(kernels["nearest"]["err"], k2_err7)
    m_err, m_ms, m_plain_ms, m_bound = morton_vs_plain(bopts, "d7 oracle")
    kernels["nearest_morton"] = dict(err=m_err, ms=m_ms, plain_ms=m_plain_ms, bound=m_bound)
    morton_vs_plain(uniform(big_box, 262_144, 3), "mesh_preview's 262,144 points")
    cut = nearest.morton_order_max(dev)
    for n in (cut, cut + 1):
        edge = uniform(big_box, n, 4)
        edge[n // 2, 0] = float("nan")
        edge[:, 2] = 0.0
        _check(torch.equal(nearest.morton_order(edge), nearest.morton_order_plain(edge)),
               f"K2's point order differs from the plain order at {n} points, a NaN and a "
               f"flat axis among them")
    print(f"K2's point order at the cutoff {cut} and one past it, a NaN and a flat axis among "
          f"the points: bit-equal to the plain order")
    for n, seed in ((10_000, 7), (262_144, 3)):      # bopts and the 262,144 above
        profiled = subprocess.run([sys.executable, "-c", "import sys, chip_smoke as cs; "
                                   "cs.morton_profile_alone(*map(int, sys.argv[1:]))",
                                   str(n), str(seed)],
                                  cwd=root, capture_output=True, text=True, timeout=600)
        print(profiled.stdout, end="")
        _check(profiled.returncode == 0,
               f"the order's profiler process failed:\n{profiled.stderr[-4000:]}")
    for name in ("nearest", "nearest_morton", "scan_grouped", "region_cull", *EXACT_KERNELS):
        _check(launches["d7"][name] > 0, f"{name} was not launched on path B")
    row = []
    for impl, name in (("xla", "grouped"), ("xla_window", "window")):
        bsdf.set_scan_impl(impl)
        ms = _cuda_ms(lambda: bsdf.get_distance(bpts))
        row.append(f"{name} {ms:.4f} ms ({bpts.shape[0] / ms * 1e3:.4e} q/s)")
    bsdf._default_scan_impl()
    print("get_distance d7 2^20 points, scan pinned: " + ", ".join(row))
    exact_breakdown(lambda: bsdf.get_distance(bpts), "d7 2^20 points (auto: grouped)",
                    EXACT_ACTIVITIES["grouped"])
    query_rows(bsdf, bpts, "d7 2^20 points (auto: grouped)")
    ek7 = exact_kernels_vs_plain(bsdf, bpts, "d7 2^20")
    kernels["exact_finish"]["err"] = max(kernels["exact_finish"]["err"],
                                         ek7["exact_finish_grad"]["err"])
    g_err7, g_ms7, g_plain7 = grouped_vs_plain(bsdf, bpts, "d7, 2^20 points")
    grouped_work(bsdf, bpts, g_ms7, "d7 2^20")
    w_err7, w_ms7, _, _ = window_vs_plain(bsdf, bpts, "d7 2^20, checked on 2^16",
                                          n_check=1 << 16)
    print(f"K1w on the same d7 2^20 points: {w_ms7:.4f} ms ({w_ms7 / g_ms7:.2f}x K1g)")
    kernels["scan_grouped"]["err"] = max(g_err6, g_err7)
    kernels["scan_window"]["err"] = max(kernels["scan_window"]["err"], w_err7)
    # path G's grid knob on this structure: the node walk, then the public
    # build_query_grid, the 2^20-point answers unchanged
    bsdf._leaf_grid = None
    d_walk = bsdf.get_distance(bpts)
    t0 = time.perf_counter()
    bsdf.build_query_grid()
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    d_again = bsdf.get_distance(bpts)
    walk_err = float((d_walk - d).abs().max())
    print(f"build_query_grid on the d7 structure (path G's knob): {grid_s:.3f} s; 2^20 "
          f"answers after it equal the first {torch.equal(d_again, d)}, the node walk's "
          f"within {walk_err:.3e}")
    _check(torch.equal(d_again, d), "build_query_grid changed the d7 answers")
    _check(walk_err <= 1e-6, f"the d7 node walk differs from the grid descent by {walk_err}")
    del bsdf, big_oracle, big_tris, bpts, bopts, d_walk, d_again
    torch.cuda.empty_cache()

    # -- main path C, the approximate octree at bench.py's configuration ----
    launches["approx"], k2c, k4 = approx_path(dev, root, 1 << 22)
    kernels["nearest"]["err"] = max(kernels["nearest"]["err"], k2c[0])
    _, k4_ms, k4_plain_ms, k4_bound = k4[(False, False)]     # get_distance's route
    kernels["octree_query"] = dict(err=max(e for e, _, _, _ in k4.values()), ms=k4_ms,
                                   plain_ms=k4_plain_ms, bound=k4_bound)

    # -- main path D, the sphere tracer at bench.py's configuration --------
    launches["trace"], segments = trace_path(dev, 1024)
    for name in ("march", "beam"):
        err, ms, plain_ms, bound = segments[name]
        kernels[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound)

    # -- path D on the walk: a container with no query grid ------------------
    launches["walk_frame"], segments = walk_frame_path(dev, root, 1024)
    for name in ("walk_segment", "walk_beam"):
        err, ms, plain_ms, bound = segments[name]
        kernels[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound)

    # -- main path E, the uniform grid at depth 7 ---------------------------
    launches["grid"], k2e = grid_path(dev)
    kernels["nearest"]["err"] = max(kernels["nearest"]["err"], k2e[0])

    # -- main path F, differentiable queries at full width -------------------
    t0 = time.perf_counter()
    launches["diff"], walk_rows = diff_path(dev, 1 << 22, 1024, 30)
    print(f"path F took {time.perf_counter() - t0:.1f} s")
    # the rows of the forms the main path runs most: the distance forward
    # on the aligned layout; K11 as a whole from gd alone, and its key
    # launch, leaf sort and reduction from gd alone; errors the largest
    # over every form
    for name, key in (("walk_query", ("walk_query", True, "distance")),
                      ("walk_backward", ("walk_backward", True, False, False)),
                      ("walk_keys", ("walk_keys", False)), ("walk_sort", ("walk_sort", False)),
                      ("walk_reduce", ("walk_reduce", False)), ("walk_march", ("walk_march",))):
        _, ms, plain_ms, bound, *lib = walk_rows[key]
        err = max(r[0] for k, r in walk_rows.items() if k[0] == name)
        kernels[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                             library_ms=lib[0] if lib else None)

    # -- main path G, the exact path's leftovers at full width --------------
    t0 = time.perf_counter()
    launches["leftovers"] = leftovers_path(dev, root)
    print(f"path G took {time.perf_counter() - t0:.1f} s")

    # -- main path H, the CLI tools and parallel at full size ---------------
    launches["tools"], k2h = tools_path(dev, root)
    kernels["nearest"]["err"] = max(kernels["nearest"]["err"], k2h)

    # -- parallel over every card, where there are several ------------------
    reset_counts()
    threaded = multicard_path()
    if threaded is not None:
        launches["multi"] = read_counts()

    # -- parallel across processes: two ranks on one card, or one a card ---
    try:
        launches["process"] = process_path(dev, proc_tmp, threaded=threaded)
    finally:
        shutil.rmtree(proc_tmp, ignore_errors=True)

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
        # kernels for XLA-fused code (no pl.pallas_call): the JAX functions
        "exact_descend": ("sdflib_tpu_torch/csrc/exact_descend.cu",
                          "sdflib_tpu/sdf/exact_octree.py:567"),
        "leaf_sort": ("sdflib_tpu_torch/csrc/exact_descend.cu",
                      "sdflib_tpu/sdf/exact_octree.py:939"),
        "exact_sorted_gather": ("sdflib_tpu_torch/csrc/exact_descend.cu",
                                "sdflib_tpu/sdf/exact_octree.py:934"),
        "exact_sorted_gather_grouped": ("sdflib_tpu_torch/csrc/exact_descend.cu",
                                        "sdflib_tpu/sdf/exact_octree.py:934"),
        "exact_finish": ("sdflib_tpu_torch/csrc/exact_finish.cu",
                         "sdflib_tpu/sdf/exact_octree.py:1144"),
        "octree_query": ("sdflib_tpu_torch/csrc/octree_query.cu",
                         "sdflib_tpu/sdf/octree.py:183"),
        "march": ("sdflib_tpu_torch/csrc/march.cu",
                  "sdflib_tpu/render/sphere_trace.py:411"),
        "beam": ("sdflib_tpu_torch/csrc/march.cu",
                 "sdflib_tpu/render/sphere_trace.py:541"),
        "walk_query": ("sdflib_tpu_torch/csrc/octree_walk.cu",
                       "sdflib_tpu/sdf/octree.py:56"),
        "walk_backward": ("sdflib_tpu_torch/csrc/octree_walk.cu",
                          "sdflib_tpu/diff/query.py:108"),
        "walk_keys": ("sdflib_tpu_torch/csrc/octree_walk.cu",
                      "sdflib_tpu/diff/query.py:108"),
        "walk_sort": ("sdflib_tpu_torch/csrc/exact_descend.cu",
                      "sdflib_tpu/diff/query.py:108"),
        "walk_reduce": ("sdflib_tpu_torch/csrc/octree_walk.cu",
                        "sdflib_tpu/diff/query.py:108"),
        "walk_march": ("sdflib_tpu_torch/csrc/octree_walk.cu",
                       "sdflib_tpu/render/sphere_trace.py:251"),
        "walk_segment": ("sdflib_tpu_torch/csrc/octree_walk.cu",
                         "sdflib_tpu/render/sphere_trace.py:411"),
        "walk_beam": ("sdflib_tpu_torch/csrc/octree_walk.cu",
                      "sdflib_tpu/render/sphere_trace.py:541"),
        "region_cull": ("sdflib_tpu_torch/csrc/region_cull.cu",
                        "sdflib_tpu/sdf/exact_octree.py:160"),
    }
    print(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(counts[k.get("counter", name)] for counts in launches.values()),
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
