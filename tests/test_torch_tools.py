"""The port's CLI tools against the JAX package's, one test per tool, on
the binary PLY of tests/test_tools_io.py (an icosphere, subdivisions 2,
radius 0.4) and the containers its exports write (depth 4). Each tool
runs in both packages with the same arguments and seeds, the port's with
``--device cpu``; the containers cross packages both ways (the port's
tools read the JAX exports, the JAX tools read the port's).

* Printed RMSE / MAE / max errors and the ``--json`` numbers within 1e-6
  (time fields excluded); printed lines without numbers equal.
* PNGs of the same shape, at least 99% of the pixels within 1/255; the
  traced renders' hit masks (background pixels) agree on >= 99.8%.
* ``interp_params --print_c`` byte-equal.
* ``exact_mean_triangles``'s statistics equal on a plane that avoids the
  node midpoints (the JAX tool walks with ``_exact_descent``, which lands
  a point at exactly 0.5 of a node in a leaf that need not contain it;
  ROADMAP.md, Queue 3).
* ``sdf_view --pick``: the same leaf depth and box, the same triangle
  set, the same influence-region OBJ faces.
* Exit codes: 1 for an unknown termination rule, ``SystemExit`` for a
  container of the wrong kind.
"""
import json
import os
import struct
import zlib

import numpy as np
import pytest

from sdflib_tpu.tools import (
    exact_mean_triangles as j_emt,
    image_query_time as j_iqt,
    interp_params as j_interp,
    mesh_preview as j_preview,
    scaling_bench as j_scaling,
    sdf_error as j_error,
    sdf_error_compare as j_compare,
    sdf_export as j_export,
    sdf_light as j_light,
    sdf_render as j_render,
    sdf_view as j_view,
)
from sdflib_tpu.utils.primitives import make_icosphere as j_icosphere
from sdflib_tpu_torch.tools import (
    exact_mean_triangles as p_emt,
    image_query_time as p_iqt,
    interp_params as p_interp,
    mesh_preview as p_preview,
    scaling_bench as p_scaling,
    sdf_error as p_error,
    sdf_error_compare as p_compare,
    sdf_export as p_export,
    sdf_light as p_light,
    sdf_render as p_render,
    sdf_view as p_view,
)

CPU = ["--device", "cpu"]
TOL = 1e-6


def read_png(path) -> np.ndarray:
    """The (H, W, C) uint8 pixels of a PNG written by ``write_png``
    (8-bit, filter type 0 on every row)."""
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    w = h = c = None
    while pos < len(raw):
        n = struct.unpack(">I", raw[pos : pos + 4])[0]
        tag, body = raw[pos + 4 : pos + 8], raw[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
            c = {0: 1, 2: 3, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c)


def png_close(a_path, b_path, share=0.99):
    a, b = read_png(a_path), read_png(b_path)
    assert a.shape == b.shape
    close = (np.abs(a.astype(int) - b.astype(int)) <= 1).all(-1).mean()
    assert close >= share, f"{close:.4f} of the pixels within 1/255"
    return a, b


def run(tool, argv, capsys):
    capsys.readouterr()
    rc = tool.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def numbers(out: str, key: str) -> float:
    return float([ln for ln in out.splitlines() if ln.startswith(key)][0].split(":")[1])


def json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def close_json(a, b, path=""):
    """Equal structure and keys, numbers within TOL, time fields and
    paths excluded."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            if "per_query" in k or "per_s" in k or k == "path":
                continue
            close_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= TOL * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def mesh_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("assets") / "sphere.ply"
    mesh = j_icosphere(subdivisions=2, radius=0.4)
    with open(path, "wb") as f:
        f.write((
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {mesh.num_vertices}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {mesh.num_triangles}\n"
            "property list uchar int vertex_indices\nend_header\n"
        ).encode())
        f.write(mesh.vertices.astype("<f4").tobytes())
        for tri in mesh.indices:
            f.write(struct.pack("<B3i", 3, *tri))
    return str(path)


EXPORTS = {
    "oct.npz": ["-d", "4", "--start_depth", "1"],
    "oct.bin": ["-d", "4", "--start_depth", "1"],
    "ex.npz": ["--sdf_format", "exact_octree", "-d", "4", "--start_depth", "1",
               "--min_triangles_per_node", "16"],
    "grid.npz": ["--sdf_format", "grid", "-d", "3"],
}


@pytest.fixture(scope="module")
def exports(mesh_file, tmp_path_factory):
    """Each export written by both packages: {name: (jax path, port path)}."""
    d = tmp_path_factory.mktemp("exports")
    out = {}
    for name, flags in EXPORTS.items():
        jp, pp = str(d / f"jax_{name}"), str(d / f"port_{name}")
        assert j_export.main([mesh_file, jp, *flags]) == 0
        assert p_export.main([mesh_file, pp, *flags, *CPU]) == 0
        out[name] = (jp, pp)
    return out


def test_sdf_export(mesh_file, exports, tmp_path, capsys):
    """The same printed lines (build time aside); each port container,
    read by the JAX loader, answers like the JAX one: the exact octree and
    the grid within 1e-6 everywhere, the approximate octree within 1e-6
    on >= 99% of the points and 1e-3 on all (last-ulp nearest-triangle
    ties end a few leaves at another depth: PERF.md, PR 5); the exit code
    1 and message of an unknown rule."""
    from sdflib_tpu.io.sdflib_binary import load_sdflib_bin
    from sdflib_tpu.sdf import SdfFunction

    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
    for name, (jp, pp) in exports.items():
        load = load_sdflib_bin if name.endswith(".bin") else SdfFunction.load
        a, b = load(jp), load(pp)
        assert type(a) is type(b)
        err = np.abs(np.asarray(b.get_distance(pts)) - np.asarray(a.get_distance(pts)))
        if name in ("ex.npz", "grid.npz"):
            assert err.max() <= TOL, (name, err.max())
        else:
            assert (err <= TOL).mean() >= 0.99 and err.max() <= 1e-3, (name, err.max())
    outs = []
    for tool, extra in ((j_export, []), (p_export, CPU)):
        rc, out, _ = run(tool, [mesh_file, str(tmp_path / "g.npz"), "--sdf_format",
                                "grid", "-d", "3", *extra], capsys)
        assert rc == 0
        outs.append([ln for ln in out.splitlines() if not ln.startswith("Build time")])
    assert outs[0] == outs[1]
    errs = []
    for tool, extra in ((j_export, []), (p_export, CPU)):
        rc, _, err = run(tool, [mesh_file, str(tmp_path / "x.npz"),
                                "--termination_rule", "bogus", *extra], capsys)
        assert rc == 1
        errs.append(err)
    assert errs[0] == errs[1] and "unknown termination_rule" in errs[0]


@pytest.mark.parametrize("name", ["oct.npz", "ex.npz"])
def test_sdf_error(mesh_file, exports, name, capsys):
    """Each tool on the JAX export against the mesh: RMSE, MAE and max
    within 1e-6; then the JAX tool on the port's export."""
    jp, pp = exports[name]
    argv = [jp, mesh_file, "-m", "0.01", "--json"]
    rc_j, out_j, _ = run(j_error, argv, capsys)
    rc_p, out_p, _ = run(p_error, argv + CPU, capsys)
    assert rc_j == rc_p == 0
    for key in ("RMSE", "MAE", "Max error"):
        assert abs(numbers(out_j, key) - numbers(out_p, key)) <= TOL
    close_json(json_line(out_j), json_line(out_p))
    rc, out_x, _ = run(j_error, [pp, mesh_file, "-m", "0.01", "--json"], capsys)
    assert rc == 0
    if name == "ex.npz":
        assert numbers(out_x, "Max error") <= 1e-5
    else:   # another build of the same configuration: RMSE within 10%
        assert abs(numbers(out_x, "RMSE") / numbers(out_j, "RMSE") - 1) <= 0.1


def test_sdf_error_compare(mesh_file, exports, capsys):
    """The mesh against the JAX octree, its .bin and the JAX exact
    export: every histogram row and overall number within 1e-6."""
    argv = [mesh_file, exports["oct.npz"][0], exports["oct.bin"][0], exports["ex.npz"][0],
            "-m", "0.01", "--histogram_bins", "5", "--json"]
    rc_j, out_j, _ = run(j_compare, argv, capsys)
    rc_p, out_p, _ = run(p_compare, argv + CPU, capsys)
    assert rc_j == rc_p == 0
    close_json(json_line(out_j), json_line(out_p))


def test_interp_params(capsys):
    """--print_c byte-equal but for the round-trip line, whose error
    each package's own fit arithmetic sets (the tool asserts it below
    1e-4 in both)."""
    outs = []
    for tool, extra in ((j_interp, []), (p_interp, CPU)):
        rc, out, _ = run(tool, ["--print_c", *extra], capsys)
        assert rc == 0 and "OK" in out and "round-trip" in out
        outs.append([ln for ln in out.splitlines(keepends=True)
                     if not ln.startswith("corner round-trip")])
    assert outs[0] == outs[1] and "kTricubicMatrix[64][64]" in "".join(outs[1])


def test_image_query_time(exports, tmp_path, capsys):
    """Value and cost PNGs of the JAX octree and exact containers."""
    for name in ("oct.npz", "ex.npz"):
        prefs = []
        for tool, extra, tag in ((j_iqt, [], "j"), (p_iqt, CPU, "p")):
            pref = str(tmp_path / f"{tag}_{name}")
            rc, out, _ = run(tool, [exports[name][0], pref, "-w", "64", "--json", *extra],
                             capsys)
            assert rc == 0 and json_line(out)["width"] == 64
            prefs.append(pref)
        for suffix in ("_value.png", "_cost.png"):
            png_close(prefs[0] + suffix, prefs[1] + suffix)


def test_exact_mean_triangles(exports, tmp_path, capsys):
    """Statistics equal and the heatmaps within 1/255 on a plane off the
    node midpoints (offset 0.47: no multiple of 1/32); the wrong kind of
    container is refused in both."""
    jp = exports["ex.npz"][0]
    stats, pngs = [], []
    for tool, extra, tag in ((j_emt, [], "j"), (p_emt, CPU, "p")):
        png = str(tmp_path / f"{tag}.png")
        rc, out, _ = run(tool, [jp, png, "-w", "64", "--offset", "0.47", "--json",
                                *extra], capsys)
        assert rc == 0
        stats.append(json_line(out))
        pngs.append(png)
    assert stats[0] == stats[1]
    png_close(*pngs, share=1.0)
    for tool, extra in ((j_emt, []), (p_emt, CPU)):
        with pytest.raises(SystemExit):
            tool.main([exports["oct.npz"][0], str(tmp_path / "x.png"), *extra])


def test_exact_mean_triangles_on_a_node_midpoint(exports, tmp_path, capsys):
    """On the plane at 0.25 of the box (the midpoint of the lower start
    cells) each pixel's leaf in the port's tool holds the pixel's point
    (closed boxes); the JAX tool's walk puts every such point at the lower
    face of the lower child, so its leaves lie off the plane and its
    heatmap differs (ROADMAP.md, Queue 3)."""
    import torch

    from sdflib_tpu_torch import SdfFunction
    from sdflib_tpu_torch.render.image import to_u8
    from sdflib_tpu_torch.sdf.octree_builder import CHILDREN_INDEX_MASK, IS_LEAF_MASK

    jp = exports["ex.npz"][0]
    pngs = []
    for tool, extra, tag in ((j_emt, [], "j"), (p_emt, CPU, "p")):
        png = str(tmp_path / f"{tag}.png")
        rc, _, _ = run(tool, [jp, png, "-w", "64", "--offset", "0.25", *extra], capsys)
        assert rc == 0
        pngs.append(read_png(png))
    assert (pngs[0] != pngs[1]).any(-1).sum() > 0
    sdf = SdfFunction.load(jp, device="cpu")
    u = (np.arange(64, dtype=np.float32) + 0.5) / 64
    gu, gv = np.meshgrid(u, u, indexing="xy")
    unit = np.stack([gu, gv, np.full_like(gu, 0.25)], -1).reshape(-1, 3)
    pts = (sdf.box.min + unit * sdf.box.size).astype(np.float32)
    leaf = sdf._descend(torch.as_tensor(pts)).numpy()
    data, s = np.asarray(sdf.octree_data, np.uint32), sdf.start_grid_size
    depth = np.zeros(sdf.num_leaves, int)
    stack = [(k, int(np.log2(s))) for k in range(s ** 3)]
    while stack:
        w, d = stack.pop()
        word = int(data[w])
        if word & int(IS_LEAF_MASK):
            depth[word & int(CHILDREN_INDEX_MASK)] = d
        else:
            stack += [((word & int(CHILDREN_INDEX_MASK)) + c, d + 1) for c in range(8)]
    half = 0.5 * float(sdf.box.size[0]) / 2.0 ** depth[leaf]
    off = np.abs(np.asarray(sdf.leaf_centers)[leaf] - pts).max(-1)
    assert (off <= half * (1 + 1e-6)).all()
    t = np.asarray(sdf.leaf_count)[leaf].reshape(64, 64).astype(np.float32)
    assert (pngs[1][..., 2] == to_u8(np.clip(1 - 3 * t / t.max(), 0, 1))).all()


def _pick_report(out: str):
    lines = out.splitlines()
    leaf = [ln for ln in lines if ln.startswith("Picked leaf")][0]
    i = [k for k, ln in enumerate(lines) if "influence triangles" in ln][0]
    return leaf, set(int(t) for t in lines[i + 1].split())


def test_sdf_view(mesh_file, exports, tmp_path, capsys):
    """A two-plane sweep with --error_vs (PNGs, plane RMSE/MAE within
    1e-6); --pick on the exact export: the same leaf line, triangle set,
    picked-cell errors and OBJ faces."""
    jp = exports["oct.npz"][0]
    outs = []
    for tool, extra, tag in ((j_view, [], "j"), (p_view, CPU, "p")):
        rc, out, _ = run(tool, [jp, str(tmp_path / f"{tag}.png"), "--resolution", "64",
                                "--sweep", "2", "--error_vs", mesh_file, *extra], capsys)
        assert rc == 0
        outs.append(out)
    for i in range(2):
        png_close(str(tmp_path / f"j_{i:03d}.png"), str(tmp_path / f"p_{i:03d}.png"))
    for key in ("Plane RMSE", "Plane MAE"):
        assert abs(numbers(outs[0], key) - numbers(outs[1], key)) <= TOL

    picks, objs = [], []
    for tool, extra, tag in ((j_view, [], "j"), (p_view, CPU, "p")):
        obj = str(tmp_path / f"{tag}.obj")
        rc, out, _ = run(tool, [exports["ex.npz"][0], "--pick=0.3,0.05,0.1",
                                "--pick_region", obj, "--error_vs", mesh_file,
                                "--pick_samples", "512", *extra], capsys)
        assert rc == 0
        picks.append((out, _pick_report(out)))
        with open(obj) as f:
            objs.append(sorted(ln for ln in f if ln.startswith(("f ", "l "))))
    (out_j, (leaf_j, tris_j)), (out_p, (leaf_p, tris_p)) = picks
    assert leaf_j == leaf_p and tris_j == tris_p and tris_j
    for key in ("Picked-cell RMSE", "Picked-cell MAE", "Picked-cell max|err|"):
        assert abs(numbers(out_j, key) - numbers(out_p, key)) <= TOL
    assert numbers(out_p, "Picked-cell max|err|") <= 1e-5
    assert objs[0] == objs[1]


def _hit_mask(img):
    return ~(img == 230).all(-1)     # write_png's 0.9 background


@pytest.mark.parametrize("mode", ["normal", "lit"])
def test_sdf_render(exports, tmp_path, capsys, mode):
    """64^2 renders of the JAX octree: hit masks agree on >= 99.8%, the
    PNGs on >= 99% of the pixels; the port also renders its own .bin."""
    flags = ["--width", "64", "--height", "64", "--max_iters", "128", "--mode", mode]
    if mode == "lit":
        flags += ["--ao", "--shadow"]
    pngs = []
    for tool, extra, tag in ((j_render, [], "j"), (p_render, CPU, "p")):
        png = str(tmp_path / f"{tag}.png")
        rc, out, _ = run(tool, [exports["oct.npz"][0], png, *flags, *extra], capsys)
        assert rc == 0 and "% hit" in out
        pngs.append(png)
    a, b = png_close(*pngs)
    assert (_hit_mask(a) == _hit_mask(b)).mean() >= 0.998
    png = str(tmp_path / "p_bin.png")
    rc, _, _ = run(p_render, [exports["oct.bin"][1], png, *flags, *CPU], capsys)
    assert rc == 0 and read_png(png).shape == a.shape
    with pytest.raises(SystemExit):
        p_render.main([exports["ex.npz"][0], png, *CPU])


def test_sdf_light(exports, tmp_path, capsys):
    flags = ["--width", "64", "--height", "64", "--max_iters", "96"]
    pngs, hits = [], []
    for tool, extra, tag in ((j_light, [], "j"), (p_light, CPU, "p")):
        png = str(tmp_path / f"{tag}.png")
        rc, out, _ = run(tool, [exports["oct.npz"][0], png, *flags, *extra], capsys)
        assert rc == 0
        pngs.append(png)
        hits.append(int(out.split("(")[1].split()[0]))
    a, b = png_close(*pngs)
    assert abs(hits[0] - hits[1]) <= 0.002 * 64 * 64
    assert (_hit_mask(a) == _hit_mask(b)).mean() >= 0.998


@pytest.mark.parametrize("mode", ["normal", "lit", "flat"])
def test_mesh_preview(mesh_file, tmp_path, capsys, mode):
    """The mesh drawn through RealSdf in both packages."""
    flags = ["--width", "48", "--height", "48", "--mode", mode, "--max_iters", "64"]
    pngs, outs = [], []
    for tool, extra, tag in ((j_preview, [], "j"), (p_preview, CPU, "p")):
        png = str(tmp_path / f"{tag}.png")
        rc, out, _ = run(tool, [mesh_file, png, *flags, *extra], capsys)
        assert rc == 0
        pngs.append(png)
        outs.append(out.replace(png, ""))
    a, b = png_close(*pngs)
    assert (_hit_mask(a) == _hit_mask(b)).mean() >= 0.998
    assert outs[0] == outs[1]


def test_scaling_bench(capsys):
    """One row a device count, the same table and JSON keys; the port's
    CPU list is the CPU once, JAX's the eight virtual devices."""
    flags = ["-m", "0.004", "--rays", "1024", "--depth", "3", "--json"]
    rc_j, out_j, _ = run(j_scaling, flags, capsys)
    rc_p, out_p, _ = run(p_scaling, flags + CPU, capsys)
    assert rc_j == rc_p == 0
    j, p = json_line(out_j), json_line(out_p)
    assert p["platform"] == "cpu" and j["platform"] == "cpu"
    assert [r["devices"] for r in p["rows"]] == [1]
    assert p["rows"][0].keys() == j["rows"][0].keys()
    assert p["rows"][0]["query_efficiency"] == 1.0 and p["rows"][0]["rays_per_s"] > 0
    assert out_p.splitlines()[0] == out_j.splitlines()[0]


@pytest.mark.parametrize("name", [
    "sdf_export", "sdf_error", "sdf_error_compare", "interp_params", "image_query_time",
    "exact_mean_triangles", "sdf_view", "sdf_render", "sdf_light", "mesh_preview",
    "scaling_bench",
])
def test_tools_need_a_card_by_default(mesh_file, exports, tmp_path, name):
    """Without ``--device`` every tool runs on the card, so without one it
    raises before it computes anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    oct_path, ex_path = exports["oct.npz"][0], exports["ex.npz"][0]
    png = str(tmp_path / "x.png")
    tool, argv = {
        "sdf_export": (p_export, [mesh_file, str(tmp_path / "x.npz")]),
        "sdf_error": (p_error, [oct_path, mesh_file]),
        "sdf_error_compare": (p_compare, [mesh_file, oct_path]),
        "interp_params": (p_interp, []),
        "image_query_time": (p_iqt, [oct_path, str(tmp_path / "x")]),
        "exact_mean_triangles": (p_emt, [ex_path, png]),
        "sdf_view": (p_view, [oct_path, png]),
        "sdf_render": (p_render, [oct_path, png]),
        "sdf_light": (p_light, [oct_path, png]),
        "mesh_preview": (p_preview, [mesh_file, png]),
        "scaling_bench": (p_scaling, []),
    }[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
    assert not os.path.exists(png)
