"""Poisson model family (gs2D-omp.cpp / gs2D-omp-Sonia.c precursor
capability, SURVEY §2.6) built on the production MG machinery."""

import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import SolverConfig
from hpcmg.models import Poisson
from hpcmg.sparse.galerkin import dense_interior_matrix_9pt


def _dense_solution(model):
    n = model.n
    A = dense_interior_matrix_9pt(model.levels[0])
    f = np.asarray(model.rhs)[1:n, 1:n].ravel()
    u = np.zeros((n + 1, n + 1))
    u[1:-1, 1:-1] = np.linalg.solve(A, f).reshape(n - 1, n - 1)
    return u


def test_mg_matches_dense_solve():
    m = Poisson(n=32, solver=SolverConfig(dtype=jnp.float64, tol=1e-10, num_levels=2,
                                           restriction="full", coarse_mode="dense"))
    u, stats = m.solve()
    want = _dense_solution(m)
    np.testing.assert_allclose(np.asarray(u), want, atol=1e-9)
    assert bool(stats["converged"])


def test_gs_matches_mg():
    s = SolverConfig(dtype=jnp.float64, tol=1e-10, num_levels=2,
                     restriction="full", coarse_mode="dense")
    m = Poisson(n=32, solver=s)
    u_mg, _ = m.solve("mg")
    u_gs, stats = m.solve("gs")
    assert float(stats["rel_residual"]) <= 1e-10
    np.testing.assert_allclose(np.asarray(u_gs), np.asarray(u_mg), atol=1e-8)


def test_mg_beats_gs_iterations():
    """The point of multigrid: cycles needed is O(1), GS sweeps are O(n^2)."""
    s = SolverConfig(dtype=jnp.float64, tol=1e-8, restriction="full", coarse_mode="dense")
    m = Poisson(n=64, solver=s)
    _, mg_stats = m.solve("mg")
    _, gs_stats = m.solve("gs")
    assert int(mg_stats["cycles"]) <= 10
    assert int(gs_stats["iters"]) > 100


@pytest.mark.slow
def test_manufactured_solution_convergence():
    """u* = sin(pi x) sin(pi y): discretization error shrinks ~4x per
    refinement (2nd-order central differences)."""
    import math

    errs = []
    for n in (16, 32, 64):
        f = lambda x, y: 2 * math.pi**2 * jnp.sin(math.pi * x) * jnp.sin(math.pi * y)
        m = Poisson(n=n, f=f, solver=SolverConfig(dtype=jnp.float64, tol=1e-10, num_levels=2,
                                                  restriction="full", coarse_mode="dense"))
        u, _ = m.solve()
        idx = np.arange(n + 1) / n
        x = idx[:, None]
        y = idx[None, :]
        exact = np.sin(np.pi * x) * np.sin(np.pi * y)
        errs.append(np.max(np.abs(np.asarray(u) - exact)))
    assert errs[0] / errs[1] == pytest.approx(4.0, rel=0.2)
    assert errs[1] / errs[2] == pytest.approx(4.0, rel=0.2)


@pytest.mark.slow
def test_fmg_mode():
    """cycle_mode='fmg' is wired (not a silent fallback to mg_solve —
    ADVICE r1); FMG with one cycle per level reaches near-discretization
    residual on the Laplacian."""
    m = Poisson(
        n=64,
        solver=SolverConfig(
            dtype=jnp.float64, coarse_mode="dense", cycle_mode="fmg",
            num_cycles=4, num_levels=3, restriction="full",
        ),
    )
    u, stats = m.solve()
    assert float(stats["rel_residual"]) < 1e-6
    # fmg stats report TOTAL cycles: num_cycles per non-coarsest level
    assert int(stats["cycles"]) == 4 * 2


@pytest.mark.slow
def test_dense_coarse_and_fixed_mode():
    m = Poisson(
        n=64,
        solver=SolverConfig(
            dtype=jnp.float64, coarse_mode="dense", cycle_mode="fixed",
            num_cycles=12, num_levels=3, restriction="full",
        ),
    )
    u, stats = m.solve()
    assert float(stats["rel_residual"]) < 1e-8
