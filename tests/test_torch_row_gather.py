"""K3a/K3b (row-fetch probes): the plain version against the probe
script's ``xla_gather_min`` (scripts/perf_pallas_gather.py, loaded by
path), the wrappers' rejections, and, on a CUDA device, both kernels
against the plain version. A minimum is exact, so results are compared
for equality (NaN included).

JAX is imported inside the fixture: the GPU machine has no JAX and runs
only the cuda-marked cases (``pytest --noconftest -m cuda``).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from sdflib_tpu_torch.ops import row_gather

torch.set_num_threads(1)
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "perf_pallas_gather.py")


@pytest.fixture(scope="module")
def probe_script():
    spec = importlib.util.spec_from_file_location("perf_pallas_gather", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(nb, w, n, seed=0, nan_row=None):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((nb, w), dtype=np.float32)
    if nan_row is not None:
        table[nan_row, w // 3] = np.nan
    rows = rng.integers(0, nb, n).astype(np.int32)
    rows[: n // 4] = rows[n // 4 : 2 * (n // 4)]        # repeated row ids
    return table, rows


@pytest.mark.parametrize("nb,w,n", [(64, 512, 256), (300, 36, 1000)])
def test_plain_matches_script_gather(probe_script, nb, w, n):
    table, rows = _data(nb, w, n, seed=nb)
    ref = np.asarray(probe_script.xla_gather_min(table, rows))
    t, r = torch.as_tensor(table), torch.as_tensor(rows)
    got = row_gather.row_min_plain(t, r)
    np.testing.assert_array_equal(got.numpy(), ref)
    # on CPU tensors both wrappers take the plain version
    np.testing.assert_array_equal(row_gather.row_min_block(t, r).numpy(), ref)
    np.testing.assert_array_equal(row_gather.row_min_tile(t, r, tile=n // 4).numpy(), ref)


def test_wrappers_reject_bad_input():
    table, rows = _data(32, 16, 100)
    t, r = torch.as_tensor(table), torch.as_tensor(rows)
    with pytest.raises(ValueError, match="multiple of tile"):    # ragged tail
        row_gather.row_min_tile(t, r, tile=64)
    with pytest.raises(ValueError):
        row_gather.row_min_tile(t, r, tile=0)
    for fn in (row_gather.row_min_block, row_gather.row_min_tile):
        with pytest.raises(ValueError):
            fn(t, r.long())
        with pytest.raises(ValueError):
            fn(t.double(), r)
        with pytest.raises(ValueError):
            fn(t[0], r)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,w,n,tile", [
    (1 << 12, 512, 1 << 12, 512),     # the script's shape, smaller
    (5000, 576, 3000, 100),           # the field table's width; tile off the 8 warps
    (777, 4, 1003, 17),               # ragged per CTA and per warp
])
def test_kernels_match_plain(cuda, nb, w, n, tile):
    table, rows = _data(nb, w, n, nan_row=3)
    rows[5] = 3                                        # a NaN row is fetched
    t = torch.as_tensor(table, device=cuda)
    r = torch.as_tensor(rows, device=cuda)
    ref = row_gather.row_min_plain(t, r).cpu().numpy()
    b0, t0 = row_gather.block_launch_count, row_gather.tile_launch_count
    got_b = row_gather.row_min_block(t, r).cpu().numpy()
    got_t = row_gather.row_min_tile(t, r, tile=tile).cpu().numpy()
    assert (row_gather.block_launch_count, row_gather.tile_launch_count) == (b0 + 1, t0 + 1)
    assert np.isnan(ref[5])
    np.testing.assert_array_equal(got_b, ref)
    np.testing.assert_array_equal(got_t, ref)
    with pytest.raises(ValueError, match="multiple of tile"):
        row_gather.row_min_tile(t, r[:-1], tile=tile)
