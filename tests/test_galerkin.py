"""Galerkin RAP coarse-operator tests (sparse/galerkin.py).

The extraction contract: the DIA bands must reproduce R·A_f·P *exactly* for
the production restrict/prolong kernels — asserted by applying both to random
fields.  Plus solver-level convergence with Galerkin hierarchies, which the
reference never had (SURVEY §7.4 north-star capability).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import ProblemConfig, SolverConfig
from hpcmg.core.layout import (
    interior_mask,
    pad_field,
    padded_shape,
)
from hpcmg.models import AdvectionDiffusion
from hpcmg.mg.levels import build_hierarchy
from hpcmg.ops.padded import (
    apply_A,
    prolong_bilinear,
    restrict_full_weighting,
    restrict_inject,
)
from hpcmg.sparse.galerkin import (
    dense_interior_matrix_9pt,
    galerkin_coarse_level,
)

RNG = np.random.default_rng(11)
N = 32
DT = (1.0 / N) / 10
NU = -4e-4


def _fine_level():
    shape = (N + 1, N + 1)
    v1 = jnp.asarray(RNG.standard_normal(shape))
    v2 = jnp.asarray(RNG.standard_normal(shape))
    return build_hierarchy(v1, v2, DT, NU, 1, dtype=jnp.float64)[0]


def _rand_coarse_field(nc):
    x = RNG.standard_normal(padded_shape(nc))
    return jnp.asarray(x) * interior_mask(nc, padded_shape(nc), dtype=jnp.float64)


@pytest.mark.parametrize("restriction", ["inject", "full"])
def test_rap_extraction_exact(restriction):
    """DIA bands applied via apply_A == literal R(A(P(x))) for random x."""
    fine = _fine_level()
    nc = N // 2
    coarse = galerkin_coarse_level(fine, restriction, fine.v1, fine.v2)
    assert coarse.ne is not None and coarse.diag is not None

    if restriction == "inject":
        restrict = lambda y: restrict_inject(y, padded_shape(nc))
    else:
        restrict = lambda y: restrict_full_weighting(y, padded_shape(nc), nc)

    for _ in range(3):
        x = _rand_coarse_field(nc)
        want = restrict(apply_A(fine, prolong_bilinear(x, fine.padded)))
        # literal RAP output can be nonzero on the coarse boundary ring for
        # restriction="full"-adjacent sampling; the operator contract only
        # covers interior rows (Dirichlet elsewhere)
        m = interior_mask(nc, padded_shape(nc), dtype=jnp.float64)
        got = apply_A(coarse, x)
        np.testing.assert_allclose(
            np.asarray(got * m), np.asarray(want * m), atol=1e-13
        )


def test_rap_dense_matrix_matches_explicit_product():
    """Dense assembly of the Galerkin level == R_mat @ A_mat @ P_mat."""
    fine = _fine_level()
    nc = N // 2
    coarse = galerkin_coarse_level(fine, "inject", fine.v1, fine.v2)
    A9 = dense_interior_matrix_9pt(coarse)

    # build the explicit product by probing every interior coarse basis vector
    m = nc - 1
    cols = []
    for p in range(m * m):
        x = np.zeros(padded_shape(nc))
        x[1 + p // m, 1 + p % m] = 1.0
        y = restrict_inject(
            apply_A(fine, prolong_bilinear(jnp.asarray(x), fine.padded)),
            padded_shape(nc),
        )
        cols.append(np.asarray(y)[1:nc, 1:nc].ravel())
    want = np.stack(cols, axis=1)
    np.testing.assert_allclose(A9, want, atol=1e-13)


def test_galerkin_hierarchy_solver_converges():
    p = ProblemConfig(n=64, num_steps=10)
    m = AdvectionDiffusion(
        p,
        SolverConfig(
            dtype=jnp.float64, coarse_operator="galerkin", restriction="full"
        ),
    )
    assert m.levels[1].ne is not None  # really a Galerkin level
    uT, stats = m.run()
    assert bool(np.asarray(stats["converged"]).all())
    assert float(np.asarray(stats["rel_residual"]).max()) <= 1e-6


def test_galerkin_dense_coarse_solve():
    p = ProblemConfig(n=64, num_steps=5)
    m = AdvectionDiffusion(
        p,
        SolverConfig(
            dtype=jnp.float64,
            coarse_operator="galerkin",
            restriction="full",
            coarse_mode="dense",
            cycle_mode="fixed",
            num_cycles=2,
        ),
    )
    uT, stats = m.run()
    assert float(np.asarray(stats["rel_residual"]).max()) < 1e-8


def test_galerkin_solution_matches_rediscretized():
    """Both hierarchies solve the same fine-grid system, so converged
    solutions agree to solver tolerance."""
    p = ProblemConfig(n=64, num_steps=10)
    m_r = AdvectionDiffusion(p, SolverConfig(dtype=jnp.float64))
    m_g = AdvectionDiffusion(
        p,
        SolverConfig(
            dtype=jnp.float64, coarse_operator="galerkin", restriction="full"
        ),
    )
    uT_r, _ = m_r.run()
    uT_g, _ = m_g.run()
    np.testing.assert_allclose(
        np.asarray(uT_g), np.asarray(uT_r), atol=1e-8
    )
