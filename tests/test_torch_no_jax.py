"""The port runs where JAX is absent, as on the GPU machine: a fresh
interpreter with ``sys.modules["jax"] = None`` (any ``import jax`` then
raises) imports sdflib_tpu_torch and runs the exact-octree slice on the
CPU at test size, through the window and the grouped scan, exact against
the port's own RealSdf within 1e-5, the sorted gather and the finish of
``ops/exact_query.py`` (K7-K9's plain versions, no launch counted), and
the row-fetch probes; then both
approximate builders (rms error against RealSdf below the JAX tests'
4e-3), the walk against the grid route within 1e-6, and a reference
``.bin`` golden through the port's io within 5e-5 of the C++ walk; then
a 32^2 ``trace_octree`` (grid route, beam on: the plain versions of
K5 and K6) whose hits lie within 1e-3 of the octree's surface, K4's
fused-row route within 1e-6 of the thin grid's with no launch counted,
one shading call, a 32^2 plane cut, and a depth-3
``UniformGridSdf`` with its ``.bin`` round trip, bit-equal; then one
``octree_query_diff`` backward (a finite coefficient gradient that leaves
the words unchanged), an EXACT_OCTREE ``.bin`` round trip with the same
answers, and a ``lattice`` exact build within 1e-5 of RealSdf; then
every module of ``tools/`` and ``parallel/`` imports, ``sharded_distance``
on ``[cpu, cpu:0] * 2`` (two workers) and on a ``ProcessMesh`` of a
one-rank gloo group equals the one call, and ``sdf_export``
writes an exact octree of an ASCII PLY that ``sdf_error`` holds within
1e-5 of the mesh's ``RealSdf``, end to end on the CPU."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import sdflib_tpu_torch
    from sdflib_tpu_torch import ExactOctreeSdf, RealSdf
    from sdflib_tpu_torch.utils.primitives import make_torus

    mesh = make_torus(R=0.3, r=0.12, nu=20, nv=12)
    box = mesh.bounding_box.add_margin(0.1)
    sdf = ExactOctreeSdf(mesh, box, max_depth=4, start_depth=1,
                         min_triangles_per_node=16, device="cpu")
    pts = np.random.default_rng(0).uniform(-0.6, 0.6, (500, 3)).astype(np.float32)
    inside = np.all((pts >= sdf.box.min) & (pts < sdf.box.max), axis=1)
    ref = RealSdf(mesh, device="cpu").get_distance(pts)
    from sdflib_tpu_torch.ops import exact_query
    for impl, scan in (("xla", "grouped"), ("xla_window", "window")):
        sdf.set_scan_impl(impl)
        err = (sdf.get_distance(pts) - ref).abs()
        assert sdf.last_scan_stats["scan"] == scan
        assert float(err[torch.as_tensor(inside)].max()) <= 1e-5
        # K7-K9's plain versions, called as the query calls them
        flat = torch.as_tensor(pts)
        pts_s, b0, nc, order = sdf._sorted_windows(flat, size=len(pts))
        assert torch.equal(pts_s, flat[order]) and bool((nc[torch.as_tensor(
            inside)[order]] > 0).all())
        win = torch.zeros(len(pts), dtype=torch.int32)
        d0 = exact_query.exact_finish(pts_s, win, order, sdf._finish_table, sdf._box_min,
                                      sdf._box_size3, sdf._fallback)
        assert d0.shape == (len(pts),) and bool(torch.isfinite(d0).all())
    assert exact_query.finish_launch_count == exact_query.descend_launch_count == 0

    from sdflib_tpu_torch.ops import row_gather
    table = torch.randn(64, 12, generator=torch.Generator().manual_seed(1))
    rows = torch.randint(0, 64, (32,), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    ref_min = row_gather.row_min_plain(table, rows)
    assert torch.equal(row_gather.row_min_block(table, rows), ref_min)
    assert torch.equal(row_gather.row_min_tile(table, rows, tile=8), ref_min)

    from sdflib_tpu_torch import OctreeSdf
    from sdflib_tpu_torch.io.sdflib_binary import load_sdflib_bin
    for alg in ("no_continuity", "continuity"):
        approx = OctreeSdf(mesh, box, max_depth=4, start_depth=2, init_algorithm=alg,
                           device="cpu")
        q = pts[inside]
        walk = approx.get_distance(q)
        assert float((walk - ref[torch.as_tensor(inside)]).square().mean().sqrt()) < 4e-3
        approx.build_query_grid()
        assert float((approx.get_distance(q) - walk).abs().max()) <= 1e-6
    gold = np.load("tests/golden/data/octree_walk.npz")
    bin_sdf = load_sdflib_bin("tests/golden/data/octree_torus.bin", device="cpu")
    d = bin_sdf.get_distance(gold["points"][:2000]).numpy()
    assert np.abs(d - gold["dist"][:2000]).max() <= 5e-5

    from sdflib_tpu_torch.render import (Camera, normal_color, render_plane_cut,
                                         trace_octree)
    o, d = Camera(position=(0.3, 0.0, 1.2), target=(0.3, 0, 0), fov_y_deg=50).rays(32, 32)
    res = trace_octree(approx, o, d, eps=1e-4, beam=4)   # grid route, beam on
    hit = res.hit.numpy()
    assert 0 < hit.sum() < hit.size and hit[16, 16]
    # the hits lie on the octree's own surface
    assert float(approx.get_distance(res.position[res.hit]).abs().max()) <= 1e-3
    from sdflib_tpu_torch.ops import march as om
    from sdflib_tpu_torch.ops import octree_query as oq
    qt = torch.as_tensor(q)
    fat = oq.grid_query(approx._leaf_grid(True), qt, False)
    assert float((fat - approx.get_distance(q)).abs().max()) <= 1e-6
    assert oq.launch_count == om.launch_count == om.beam_launch_count == 0
    img = normal_color(res.normal, res.hit).numpy()
    assert img.shape == (32, 32, 3) and 0.0 <= img.min() and img.max() <= 1.0
    cut = render_plane_cut(approx, resolution=32)
    assert cut.shape == (32, 32, 3) and np.isfinite(cut).all()

    from sdflib_tpu_torch import UniformGridSdf
    from sdflib_tpu_torch.io.sdflib_binary import save_sdflib_bin
    import os
    import tempfile
    grid = UniformGridSdf(mesh, box, depth=3, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        save_sdflib_bin(grid, os.path.join(tmp, "g.bin"))
        back = load_sdflib_bin(os.path.join(tmp, "g.bin"), device="cpu")
    assert torch.equal(back.grid, grid.grid) and back.grid_size == (8, 8, 8)
    assert torch.equal(back.get_distance(pts), grid.get_distance(pts))
    from sdflib_tpu_torch.diff.query import octree_coefficients, octree_query_diff
    words = approx._octree_dev.clone()
    c = octree_coefficients(approx._octree_dev).requires_grad_(True)
    dq = octree_query_diff(approx._octree_dev, c, q, approx.box.min, approx.box.size[0],
                           approx.start_grid_size, approx.min_border_value,
                           levels=approx.max_depth - approx.start_depth)
    assert float((dq - approx.get_distance(q)).abs().max()) <= 1e-6
    dq.square().sum().backward()
    assert bool(torch.isfinite(c.grad).all()) and float(c.grad.abs().sum()) > 0
    assert torch.equal(approx._octree_dev, words)

    with tempfile.TemporaryDirectory() as tmp:
        save_sdflib_bin(sdf, os.path.join(tmp, "e.bin"))
        ebin = load_sdflib_bin(os.path.join(tmp, "e.bin"), device="cpu")
    assert ebin.num_leaves == sdf.num_leaves and not ebin._sorted_lists
    assert float((ebin.get_distance(pts) - sdf.get_distance(pts)).abs().max()) <= 1e-6

    lat = ExactOctreeSdf(mesh, box, max_depth=3, start_depth=1, min_triangles_per_node=16,
                         strategy="lattice", device="cpu")
    err = (lat.get_distance(pts) - ref).abs()
    assert float(err[torch.as_tensor(inside)].max()) <= 1e-5
    import importlib
    import io
    import contextlib
    import pkgutil
    import sdflib_tpu_torch.parallel
    import sdflib_tpu_torch.tools
    for pkg in (sdflib_tpu_torch.tools, sdflib_tpu_torch.parallel):
        names = [m.name for m in pkgutil.iter_modules(pkg.__path__)]
        assert len(names) == {"sdflib_tpu_torch.tools": 14,
                              "sdflib_tpu_torch.parallel": 5}[pkg.__name__], names
        for name in names:
            importlib.import_module(f"{pkg.__name__}.{name}")
    from sdflib_tpu_torch.tools import sdf_error, sdf_export
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "torus.ply")
        with open(ply, "w") as f:
            f.write("ply\\nformat ascii 1.0\\nelement vertex %d\\nproperty float x\\n"
                    "property float y\\nproperty float z\\nelement face %d\\n"
                    "property list uchar int vertex_indices\\nend_header\\n"
                    % (mesh.num_vertices, mesh.num_triangles))
            f.writelines("%r %r %r\\n" % tuple(map(float, v)) for v in mesh.vertices)
            f.writelines("3 %d %d %d\\n" % tuple(t) for t in mesh.indices)
        out = os.path.join(tmp, "e.npz")
        assert sdf_export.main([ply, out, "--sdf_format", "exact_octree", "-d", "3",
                                "--start_depth", "1", "--device", "cpu"]) == 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert sdf_error.main([out, ply, "-m", "0.002", "--device", "cpu"]) == 0
        assert float(buf.getvalue().split("Max error:")[1]) <= 1e-5, buf.getvalue()
    # the workers of parallel/ on two devices, bit-equal to one call
    mixed = [torch.device("cpu"), torch.device("cpu", 0)] * 2
    assert torch.equal(sdflib_tpu_torch.parallel.sharded_distance(sdf, pts, mixed),
                       sdf.get_distance(pts))
    import torch.distributed as dist
    from sdflib_tpu_torch.parallel import ProcessMesh, gather_blocks, process_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rdv"),
                                rank=0, world_size=1)
        try:
            pm = process_mesh(mixed[:2])
            assert isinstance(pm, ProcessMesh) and [e.rank for e in pm] == [0, 0]
            assert torch.equal(sdflib_tpu_torch.parallel.sharded_distance(sdf, pts, pm),
                               sdf.get_distance(pts))
            assert torch.equal(gather_blocks(pm, [torch.ones(2), torch.zeros(2)]),
                               torch.tensor([1.0, 1.0, 0.0, 0.0]))
        finally:
            dist.destroy_process_group()
    assert not any(m == "jax" or m.startswith(("jax.", "sdflib_tpu."))
                   for m in sys.modules if sys.modules[m] is not None)
    print("NO_JAX_OK", sdf.num_leaves)
    """
)


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
