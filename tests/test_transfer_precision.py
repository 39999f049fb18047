"""Restriction by strided slicing, and the precision pins of the dense
products.

The injection restriction used to decimate columns with a 0/1 matrix
product at HIGHEST precision; it is now a stride-2 slice.  The old definition
is re-expressed here in numpy and the two must agree bit for bit (injection)
or to rounding (full weighting, whose 9-point smooth is computed here in
numpy).  The dense coarse solve and the dense SpMV must carry HIGHEST
precision in their programs: on GPUs a float32 product may otherwise run in
TF32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg.core.layout import pad_field, padded_shape
from hpcmg.ops import padded as pops

CASES = [(kind, dtype, n) for kind in ("inject", "full")
         for dtype in ("float32", "float64") for n in (16, 32, 64, 128)]


def _old_decimate(fine, coarse_shape):
    """The former definition: rows by stride-2 slice, columns by a 0/1
    decimation matrix D with (x @ D)[:, J] = x[:, 2J]."""
    rows = fine[::2, :][: coarse_shape[0]]
    rows = np.pad(rows, ((0, coarse_shape[0] - rows.shape[0]), (0, 0)))
    d = np.zeros((fine.shape[1], coarse_shape[1]), fine.dtype)
    j = np.arange(coarse_shape[1])
    ok = 2 * j < fine.shape[1]
    d[2 * j[ok], j[ok]] = 1.0
    return rows @ d


def _np_full_weighting_smooth(f):
    p = np.pad(f, 1)
    c = p[1:-1, 1:-1]
    edges = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
    corners = p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]
    return (4.0 * c + 2.0 * edges + corners) * (1.0 / 16.0)


@pytest.mark.parametrize("kind,dtype,n", CASES)
def test_strided_restriction_matches_matmul_definition(kind, dtype, n):
    rng = np.random.default_rng(n)
    f = rng.standard_normal((n + 1, n + 1)).astype(dtype)
    f[0, :] = f[-1, :] = f[:, 0] = f[:, -1] = 0
    fine = np.asarray(pad_field(jnp.asarray(f)))
    nc = n // 2
    cshape = padded_shape(nc)
    if kind == "inject":
        got = np.asarray(jax.jit(pops.restrict_inject, static_argnums=1)(
            jnp.asarray(fine), cshape))
        want = _old_decimate(fine, cshape)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        got = np.asarray(jax.jit(pops.restrict_full_weighting,
                                 static_argnums=(1, 2))(
            jnp.asarray(fine), cshape, nc))
        mask = np.zeros(cshape, dtype)
        mask[1:nc, 1:nc] = 1
        want = _old_decimate(_np_full_weighting_smooth(fine), cshape) * mask
        eps = float(np.finfo(dtype).eps)
        np.testing.assert_allclose(got, want, rtol=0, atol=8 * eps)
    # both leave the coarse padding zero
    assert np.all(got[nc + 1:, :] == 0) and np.all(got[:, nc + 1:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_restrict_inject_is_a_strided_slice(dtype):
    """Injection lowers to one strided slice, not a gather: XLA fuses a
    gather with its producer differently, which changed the last bit of the
    refined stepper's recomputed f64 residual (see
    test_refine.py::test_fused_stepper_matches_per_step_refined)."""
    fine = jnp.zeros(padded_shape(64), dtype)
    jaxpr = jax.make_jaxpr(pops.restrict_inject, static_argnums=1)(
        fine, padded_shape(32)).jaxpr
    prims = [e.primitive.name for e in jaxpr.eqns]
    assert "gather" not in prims and "dot_general" not in prims, prims
    (sl,) = [e for e in jaxpr.eqns if e.params.get("strides")]
    assert tuple(sl.params["strides"]) == (2, 2)


def _dot_precisions(jaxpr):
    """Precision configs of every dot_general in a (nested) jaxpr."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found.extend(_dot_precisions(sub))
    return found


def _highest(prec):
    hi = jax.lax.Precision.HIGHEST
    return prec == hi or (isinstance(prec, tuple)
                          and all(p == hi for p in prec))


def test_coarse_solve_dense_pins_highest_precision():
    from hpcmg.core.problem import rotating_velocity
    from hpcmg.mg.cycle import coarse_solve_dense
    from hpcmg.mg.levels import build_fine_level
    from hpcmg.sparse.galerkin import attach_dense_inverse

    n = 16
    v1, v2 = rotating_velocity(n, dtype=jnp.float32)
    level = attach_dense_inverse(build_fine_level(v1, v2, 1e-3, -4e-4,
                                                  dtype=jnp.float32))
    rhs = jnp.ones(level.padded, jnp.float32)
    jaxpr = jax.make_jaxpr(coarse_solve_dense)(level, rhs, rhs).jaxpr
    precs = _dot_precisions(jaxpr)
    assert precs and all(_highest(p) for p in precs), precs


def test_dense_spmv_pins_highest_precision():
    from hpcmg.core.problem import rotating_velocity
    from hpcmg.mg.levels import build_fine_level, dense_interior_matrix
    from hpcmg.sparse.matrix import level_to_bcoo, spmv_apply

    n = 16
    v1, v2 = rotating_velocity(n, dtype=jnp.float32)
    level = build_fine_level(v1, v2, 1e-3, -4e-4, dtype=jnp.float32)
    dense = jnp.asarray(dense_interior_matrix(level), jnp.float32)
    u = jnp.ones(level.padded, jnp.float32)
    precs = _dot_precisions(
        jax.make_jaxpr(lambda m, x: spmv_apply(m, level, x))(dense, u).jaxpr)
    assert precs and all(_highest(p) for p in precs), precs
    # the dense and the BCOO products agree
    got = spmv_apply(dense, level, u)
    want = spmv_apply(level_to_bcoo(level), level, u)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
