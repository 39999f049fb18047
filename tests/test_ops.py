"""Kernel-level golden tests: jnp ops vs the native C++ oracle and dense math.

These replace the reference's print-and-eyeball unit programs
(prolrestest.cpp, resnormtest.cpp — SURVEY §4.1) with real assertions.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import native
from hpcmg.core.problem import cn_coefficients
from hpcmg.mg.levels import Level, build_hierarchy, dense_interior_matrix
from hpcmg.ops import (
    apply_A,
    compute_rhs,
    interior_norm,
    prolong_bilinear,
    residual,
    restrict_full_weighting,
    restrict_inject,
    rb_gauss_seidel,
    weighted_jacobi,
)

N = 16
H = 1.0 / N
DT = H / 10
NU = -4e-4
RNG = np.random.default_rng(0)


def _rand_fields():
    shape = (N + 1, N + 1)
    u = RNG.standard_normal(shape)
    u[0, :] = u[-1, :] = u[:, 0] = u[:, -1] = 0.0
    v1 = RNG.standard_normal(shape)
    v2 = RNG.standard_normal(shape)
    return u, v1, v2


def _coef(v1, v2):
    return cn_coefficients(jnp.asarray(v1), jnp.asarray(v2), DT, NU, H)


def test_compute_rhs_matches_native():
    u, v1, v2 = _rand_fields()
    got = np.asarray(compute_rhs(_coef(v1, v2), jnp.asarray(u)))
    want = native.compute_rhs(u, v1, v2, H, DT, NU)
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1], rtol=1e-13)
    assert np.all(got[0] == 0) and np.all(got[:, 0] == 0)


def test_residual_matches_native():
    u, v1, v2 = _rand_fields()
    rhs = RNG.standard_normal(u.shape)
    got = np.asarray(residual(_coef(v1, v2), jnp.asarray(u), jnp.asarray(rhs)))
    want = native.residual(u, rhs, v1, v2, H, DT, NU)
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1], rtol=1e-12)


def test_norm_matches_native():
    res = RNG.standard_normal((N + 1, N + 1))
    got = float(interior_norm(jnp.asarray(res)))
    assert got == pytest.approx(native.norm(res), rel=1e-13)


def test_rb_gauss_seidel_matches_native():
    u, v1, v2 = _rand_fields()
    rhs = RNG.standard_normal(u.shape)
    rhs[0, :] = rhs[-1, :] = rhs[:, 0] = rhs[:, -1] = 0.0
    coef = _coef(v1, v2)
    got = np.asarray(jnp.asarray(u))
    got_j = jnp.asarray(u)
    for _ in range(3):
        got_j = rb_gauss_seidel(coef, got_j, jnp.asarray(rhs))
    want = native.gs_sweep(u, rhs, v1, v2, H, DT, NU, nsweeps=3)
    np.testing.assert_allclose(np.asarray(got_j), want, rtol=0, atol=1e-13)


def test_apply_A_matches_dense_matrix():
    from hpcmg.core.layout import crop_field, pad_field
    from hpcmg.ops import padded as pops

    u, v1, v2 = _rand_fields()
    levels = build_hierarchy(jnp.asarray(v1), jnp.asarray(v2), DT, NU, 1,
                             dtype=jnp.float64)
    A = dense_interior_matrix(levels[0])
    got_p = pops.apply_A(levels[0], pad_field(jnp.asarray(u)))
    got = np.asarray(crop_field(got_p, N))[1:-1, 1:-1].ravel()
    want = A @ u[1:-1, 1:-1].ravel()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_jacobi_fixed_point_is_solution():
    """A weighted-Jacobi sweep leaves the exact solution unchanged."""
    u, v1, v2 = _rand_fields()
    coef = _coef(v1, v2)
    rhs = np.asarray(apply_A(coef, jnp.asarray(u)))
    out = weighted_jacobi(coef, jnp.asarray(u), jnp.asarray(rhs), 1.0)
    np.testing.assert_allclose(np.asarray(out), u, atol=1e-12)


def test_prolong_matches_native():
    nc = 5  # the reference's prolrestest grid size (prolrestest.cpp:64)
    coarse = RNG.standard_normal((nc + 1, nc + 1))
    got = np.asarray(prolong_bilinear(jnp.asarray(coarse)))
    want = native.prolong(coarse)
    np.testing.assert_allclose(got, want, rtol=1e-15)


def test_restrict_inject_matches_native():
    nf = 10
    fine = RNG.standard_normal((nf + 1, nf + 1))
    got = np.asarray(restrict_inject(jnp.asarray(fine)))
    want = native.restrict(fine)
    np.testing.assert_allclose(got, want, rtol=0)


def test_restrict_prolong_roundtrip():
    """Injection of a prolonged field recovers it exactly (prolrestest.cpp)."""
    coarse = RNG.standard_normal((6, 6))
    fine = prolong_bilinear(jnp.asarray(coarse))
    back = restrict_inject(fine)
    np.testing.assert_allclose(np.asarray(back), coarse, rtol=0)


def test_restrict_full_weighting_oracle():
    nf = 8
    fine = RNG.standard_normal((nf + 1, nf + 1))
    got = np.asarray(restrict_full_weighting(jnp.asarray(fine)))
    nc = nf // 2
    want = fine[::2, ::2].copy()
    for i in range(1, nc):
        for j in range(1, nc):
            fi, fj = 2 * i, 2 * j
            want[i, j] = (
                4 * fine[fi, fj]
                + 2 * (fine[fi - 1, fj] + fine[fi + 1, fj]
                       + fine[fi, fj - 1] + fine[fi, fj + 1])
                + fine[fi - 1, fj - 1] + fine[fi - 1, fj + 1]
                + fine[fi + 1, fj - 1] + fine[fi + 1, fj + 1]
            ) / 16.0
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_full_weighting_preserves_constants_interior():
    fine = np.ones((17, 17))
    got = np.asarray(restrict_full_weighting(jnp.asarray(fine)))
    np.testing.assert_allclose(got, 1.0)
