"""Explicit BCOO/BCSR operator path vs the DIA stencil path."""

import jax.numpy as jnp
import numpy as np

from hpcmg.core.layout import interior_mask, pad_field, padded_shape
from hpcmg.mg.levels import build_hierarchy
from hpcmg.ops import padded as pops
from hpcmg.sparse.galerkin import galerkin_coarse_level
from hpcmg.sparse.matrix import (
    level_to_bcoo,
    level_to_bcsr,
    spmv_apply,
    spmv_residual,
)

RNG = np.random.default_rng(5)
N = 32


def _level():
    shape = (N + 1, N + 1)
    v1 = jnp.asarray(RNG.standard_normal(shape))
    v2 = jnp.asarray(RNG.standard_normal(shape))
    return build_hierarchy(v1, v2, (1.0 / N) / 10, -4e-4, 1, dtype=jnp.float64)[0]


def _field(n=N):
    x = RNG.standard_normal(padded_shape(n))
    return jnp.asarray(x) * interior_mask(n, padded_shape(n), dtype=jnp.float64)


def test_bcoo_apply_equals_stencil():
    level = _level()
    mat = level_to_bcoo(level)
    u = _field()
    want = pops.apply_A(level, u)
    got = spmv_apply(mat, level, u)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)


def test_bcsr_apply_equals_stencil():
    level = _level()
    mat = level_to_bcsr(level)
    u = _field()
    want = pops.apply_A(level, u)
    got = spmv_apply(mat, level, u)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)


def test_spmv_residual_equals_stencil():
    level = _level()
    mat = level_to_bcoo(level)
    u, rhs = _field(), _field()
    want = pops.residual(level, u, rhs)
    got = spmv_residual(mat, level, u, rhs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)


def test_bcoo_of_galerkin_9pt_level():
    fine = _level()
    coarse = galerkin_coarse_level(fine, "full", fine.v1, fine.v2)
    mat = level_to_bcoo(coarse)
    u = _field(N // 2)
    want = pops.apply_A(coarse, u)
    got = spmv_apply(mat, coarse, u)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)
