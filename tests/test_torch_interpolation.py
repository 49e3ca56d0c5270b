"""The port's interpolation layer against the JAX package's, on the same
inputs from numpy seeds, and against the compiled reference's golden.

``TRICUBIC_MATRIX``, the midpoint positions and the rule weights are
equal. Fits, interpolations, gradients and the four error rules agree
within rtol 1e-5 / atol 1e-6 (the port sums over the last axis in
another order than XLA's einsum and reductions; fp32). The
``tricubic.npz`` golden passes at the JAX test's tolerances
(test_reference_parity.py:123-144).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdflib_tpu.ops.interpolation as J
import sdflib_tpu_torch.ops.interpolation as P

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


def test_tables_equal_jax():
    np.testing.assert_array_equal(P.TRICUBIC_MATRIX, J.TRICUBIC_MATRIX)
    assert P.TRICUBIC_MATRIX.dtype == J.TRICUBIC_MATRIX.dtype
    for name in ("MIDPOINT_POSITIONS", "TRAPEZOID_WEIGHTS", "SIMPSON_WEIGHTS"):
        np.testing.assert_array_equal(getattr(P, name), getattr(J, name))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    n = 256
    return dict(
        corners=rng.standard_normal((n, 8, 8)).astype(np.float32),
        sizes=rng.uniform(0.01, 0.5, n).astype(np.float32),
        coeffs=rng.standard_normal((n, 64)).astype(np.float32),
        lin=rng.standard_normal((n, 8)).astype(np.float32),
        frac=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        mids=rng.standard_normal((n, 19)).astype(np.float32),
    )


def _both(name, *args):
    j = getattr(J, name)(*(jnp.asarray(a) for a in args))
    p = getattr(P, name)(*(torch.as_tensor(a) for a in args))
    return np.asarray(j), p.numpy()


@pytest.mark.parametrize("name, keys", [
    ("trilinear_fit", ("lin",)),
    ("trilinear_interpolate", ("lin", "frac")),
    ("trilinear_gradient", ("lin", "frac")),
    ("tricubic_interpolate", ("coeffs", "frac")),
    ("tricubic_gradient", ("coeffs", "frac")),
])
def test_eval_matches_jax(inputs, name, keys):
    j, p = _both(name, *(inputs[k] for k in keys))
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, **TOL)


def test_tricubic_fit_matches_jax(inputs):
    """Fit at per-node sizes and at one scalar size; coefficients reach
    ~1e2, so the tolerance is relative to each row's largest."""
    for size in (inputs["sizes"], np.float32(0.25)):
        j = np.asarray(J.tricubic_fit(jnp.asarray(inputs["corners"]), jnp.asarray(size)))
        p = P.tricubic_fit(torch.as_tensor(inputs["corners"]), torch.as_tensor(size)).numpy()
        scale = np.maximum(1.0, np.abs(j).max(axis=1, keepdims=True))
        np.testing.assert_allclose(p / scale, j / scale, **TOL)


@pytest.mark.parametrize("interp", ["tricubic", "trilinear"])
@pytest.mark.parametrize("rule", ["trapezoid", "simpson", "by_distance", "max"])
def test_error_rules_match_jax(inputs, rule, interp):
    coeffs = inputs["coeffs"] if interp == "tricubic" else inputs["lin"]
    c, m = coeffs, inputs["mids"]
    if rule == "by_distance":
        j = J.estimate_error_by_distance(jnp.asarray(c), jnp.asarray(m), 0.1, interp)
        p = P.estimate_error_by_distance(torch.as_tensor(c), torch.as_tensor(m), 0.1, interp)
    else:
        fn = {"trapezoid": "estimate_error_trapezoid", "simpson": "estimate_error_simpson",
              "max": "estimate_max_error"}[rule]
        j = getattr(J, fn)(jnp.asarray(c), jnp.asarray(m), interp)
        p = getattr(P, fn)(torch.as_tensor(c), torch.as_tensor(m), interp)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


def test_tricubic_matches_cpp_golden():
    """Fit -> eval parity with InterpolationMethods.h:292-455 at the JAX
    test's tolerances."""
    g = np.load(os.path.join(DATA, "tricubic.npz"))
    coeffs = P.tricubic_fit(torch.as_tensor(g["corners"]), torch.as_tensor(g["node_sizes"]))
    scale = np.maximum(1.0, np.abs(g["coeffs"]).max(axis=1, keepdims=True))
    np.testing.assert_allclose(coeffs.numpy() / scale, g["coeffs"] / scale, atol=2e-4)
    c = torch.as_tensor(g["coeffs"])
    f = torch.as_tensor(g["fracs"])
    np.testing.assert_allclose(P.tricubic_interpolate(c, f).numpy(), g["value"], atol=1e-4)
    np.testing.assert_allclose(P.tricubic_gradient(c, f).numpy(), g["grad"], atol=2e-3)
