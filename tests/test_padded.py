"""Equivalence suite: padded-layout kernels (ops/padded.py) vs the
logical-shape oracle kernels (ops/stencil.py etc.).

The padded layout is the production path; these tests pin that it is
*numerically identical* to the oracle path on every kernel, including the
invariants (zeros outside the interior).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg.core.layout import (
    crop_field,
    interior_mask,
    pad_field,
    padded_shape,
    shift,
)
from hpcmg.core.problem import (
    cn_coefficients,
    cn_coefficients_padded,
)
from hpcmg.ops import padded as pops
from hpcmg.ops import smoothers, stencil, transfer

N = 20
H = 1.0 / N
DT = H / 10
NU = -4e-4
RNG = np.random.default_rng(7)


def _fields():
    shape = (N + 1, N + 1)
    u = RNG.standard_normal(shape)
    u[0, :] = u[-1, :] = u[:, 0] = u[:, -1] = 0.0
    rhs = RNG.standard_normal(shape)
    rhs[0, :] = rhs[-1, :] = rhs[:, 0] = rhs[:, -1] = 0.0
    v1 = RNG.standard_normal(shape)
    v2 = RNG.standard_normal(shape)
    return (jnp.asarray(a) for a in (u, rhs, v1, v2))


def _both_coefs(v1, v2):
    logical = cn_coefficients(v1, v2, DT, NU, H)
    padded = cn_coefficients_padded(pad_field(v1), pad_field(v2), N, DT, NU, H)
    return logical, padded


def test_padded_shape_tiles():
    assert padded_shape(64) == (72, 128)
    assert padded_shape(1024) == (1032, 1152)
    assert padded_shape(7) == (8, 128)


def test_pad_crop_roundtrip():
    u = jnp.arange(65 * 65, dtype=jnp.float64).reshape(65, 65)
    assert np.array_equal(np.asarray(crop_field(pad_field(u), 64)), np.asarray(u))


def test_shift_semantics():
    u = jnp.arange(16.0).reshape(4, 4)
    up = np.asarray(shift(u, -1, 0))   # out[i,j] = u[i-1,j]
    assert np.all(up[0] == 0) and np.array_equal(up[1:], np.asarray(u)[:-1])
    dn = np.asarray(shift(u, 1, 0))
    assert np.all(dn[-1] == 0) and np.array_equal(dn[:-1], np.asarray(u)[1:])
    lf = np.asarray(shift(u, 0, -1))
    assert np.all(lf[:, 0] == 0) and np.array_equal(lf[:, 1:], np.asarray(u)[:, :-1])


def test_coefficients_match_and_masked():
    _, _, v1, v2 = _fields()
    lg, pd = _both_coefs(v1, v2)
    for name in ("aa", "bb", "cc", "dd"):
        lgc = np.asarray(getattr(lg, name))           # (N-1, N-1) interior
        pdc = np.asarray(getattr(pd, name))           # padded
        np.testing.assert_allclose(pdc[1:N, 1:N], lgc, rtol=0)
        mask = np.asarray(interior_mask(N, pdc.shape, dtype=jnp.float64))
        assert np.all(pdc * (1 - mask) == 0)
    assert lg.diag_a == pd.diag_a and lg.diag_b == pd.diag_b


@pytest.mark.parametrize("op", ["apply_A", "apply_B", "compute_rhs"])
def test_stencil_ops_equal(op):
    u, _, v1, v2 = _fields()
    lg, pd = _both_coefs(v1, v2)
    want = np.asarray(getattr(stencil, op)(lg, u))
    got_p = getattr(pops, op)(pd, pad_field(u))
    np.testing.assert_allclose(np.asarray(crop_field(got_p, N)), want, rtol=0, atol=1e-14)
    # invariant: zero outside the logical grid
    full = np.asarray(got_p)
    assert np.all(full[N + 1:, :] == 0) and np.all(full[:, N + 1:] == 0)


def test_residual_and_norm_equal():
    u, rhs, v1, v2 = _fields()
    lg, pd = _both_coefs(v1, v2)
    want = np.asarray(stencil.residual(lg, u, rhs))
    got = pops.residual(pd, pad_field(u), pad_field(rhs))
    np.testing.assert_allclose(np.asarray(crop_field(got, N)), want, rtol=0, atol=1e-14)
    assert float(pops.interior_norm(got)) == pytest.approx(
        float(stencil.interior_norm(want)), rel=1e-14
    )


def test_rb_gauss_seidel_equal():
    u, rhs, v1, v2 = _fields()
    lg, pd = _both_coefs(v1, v2)
    want, got = u, pad_field(u)
    for _ in range(3):
        want = smoothers.rb_gauss_seidel(lg, want, rhs)
        got = pops.rb_gauss_seidel(pd, got, pad_field(rhs))
    np.testing.assert_allclose(
        np.asarray(crop_field(got, N)), np.asarray(want), rtol=0, atol=1e-13
    )


def test_weighted_jacobi_equal():
    u, rhs, v1, v2 = _fields()
    lg, pd = _both_coefs(v1, v2)
    want = smoothers.weighted_jacobi(lg, u, rhs, 0.8)
    got = pops.weighted_jacobi(pd, pad_field(u), pad_field(rhs), 0.8)
    np.testing.assert_allclose(
        np.asarray(crop_field(got, N)), np.asarray(want), rtol=0, atol=1e-14
    )


def test_restrict_inject_equal():
    u, _, _, _ = _fields()
    nc = N // 2
    want = np.asarray(transfer.restrict_inject(u))
    got = pops.restrict_inject(pad_field(u), padded_shape(nc))
    np.testing.assert_allclose(np.asarray(crop_field(got, nc)), want, rtol=0)


def test_restrict_full_weighting_equal():
    u, _, _, _ = _fields()
    nc = N // 2
    want = np.asarray(transfer.restrict_full_weighting(u))
    got = pops.restrict_full_weighting(pad_field(u), padded_shape(nc), nc)
    # the padded version zeroes the coarse boundary (fields it is applied to
    # are zero there anyway); compare interiors and check the zero ring
    np.testing.assert_allclose(
        np.asarray(crop_field(got, nc))[1:-1, 1:-1], want[1:-1, 1:-1], rtol=0,
        atol=1e-14,
    )
    g = np.asarray(crop_field(got, nc))
    assert np.all(g[0] == 0) and np.all(g[-1] == 0)


def test_prolong_bilinear_equal():
    u, _, _, _ = _fields()
    nc = N // 2
    coarse = jnp.asarray(np.asarray(u)[: nc + 1, : nc + 1])
    coarse = coarse.at[0, :].set(0).at[-1, :].set(0).at[:, 0].set(0).at[:, -1].set(0)
    want = np.asarray(transfer.prolong_bilinear(coarse))
    got = pops.prolong_bilinear(pad_field(coarse), padded_shape(N))
    np.testing.assert_allclose(
        np.asarray(crop_field(got, N)), want, rtol=0, atol=1e-14
    )


def test_from_v_variants_match_precomputed():
    """The recomputed-coefficient (from_v) kernels are bit-identical to the
    precomputed-field kernels in IEEE f64 — the expressions mirror
    mg/levels.py::_np_cn_coefficients exactly (production opening of the
    refined timestep)."""
    import jax.numpy as jnp
    import numpy as np

    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion
    from hpcmg.ops import padded as pops

    m = AdvectionDiffusion(ProblemConfig(n=64), SolverConfig(dtype=jnp.float64))
    level, u = m.levels[0], m.u0
    rhs0, r00 = pops.rhs_and_residual0(level, u)
    rhs1, r01 = pops.rhs_and_residual0_from_v(level, u)
    np.testing.assert_array_equal(np.asarray(rhs0), np.asarray(rhs1))
    np.testing.assert_array_equal(np.asarray(r00), np.asarray(r01))
    res0 = pops.residual(level, u, rhs0)
    res1 = pops.residual_from_v(level, u, rhs0)
    np.testing.assert_array_equal(np.asarray(res0), np.asarray(res1))
