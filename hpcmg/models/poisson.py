"""Poisson model family: −∆u = f on [0,1]² with homogeneous Dirichlet BCs.

The reference's precursor programs (gs2D-omp.cpp:1-124, gs2D-omp-Sonia.c:1-125,
SURVEY §2.6) solve exactly this with red–black Gauss–Seidel only; here it is a
first-class model that reuses every production component — the same padded
kernels, the same V/W-cycle, the same dense coarse solve — by expressing the
5-point Laplacian as a constant-coefficient Level:

    diag = 4/h²,  aa = bb = cc = dd = −1/h²   (gs2D-omp.cpp's update is the
    GS relaxation of exactly this operator)

`method="gs"` reproduces the precursors' smoother-only iteration;
`method="mg"` is the multigrid treatment they were building toward.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hpcmg.config import SolverConfig
from hpcmg.core.layout import (
    crop_field,
    interior_mask,
    pad_field,
    padded_shape,
)
from hpcmg.mg.cycle import fmg_solve, mg_solve, mg_solve_fixed
from hpcmg.mg.levels import Level
from hpcmg.ops.padded import (
    interior_norm,
    rb_gauss_seidel,
    residual,
)


def poisson_level(n: int, h: float, dtype=jnp.float32) -> Level:
    """Constant-coefficient 5-point Laplacian as a Level."""
    shape = padded_shape(n)
    mask = interior_mask(n, shape, dtype=dtype)
    off = (-1.0 / (h * h)) * mask
    zero = jnp.zeros(shape, dtype)
    return Level(
        aa=off, bb=off, cc=off, dd=off,
        v1=zero, v2=zero, a_inv=None,
        n=n, h=h, dt=0.0, nu=0.0,
        diag_a=4.0 / (h * h), diag_b=0.0,
    )


def build_poisson_hierarchy(
    n: int, num_levels: int, dtype=jnp.float32, coarse_mode: str = "gs"
) -> tuple[Level, ...]:
    levels = []
    for lvl in range(num_levels):
        nl = n >> lvl
        if nl < 2:
            raise ValueError(f"num_levels={num_levels} too deep for n={n}")
        levels.append(poisson_level(nl, (1.0 / n) * (1 << lvl), dtype))
    if coarse_mode == "dense":
        from hpcmg.sparse.galerkin import attach_dense_inverse

        levels[-1] = attach_dense_inverse(levels[-1])
    return tuple(levels)


class Poisson:
    """−∆u = f solver.

    >>> m = Poisson(n=128, f=lambda x, y: jnp.ones_like(x))
    >>> u, stats = m.solve()            # multigrid
    >>> u, stats = m.solve(method="gs") # the gs2D-omp.cpp iteration
    """

    # Defaults differ from the reference-parity SolverConfig defaults:
    # unscaled injection restriction stalls on the pure Laplacian (it only
    # works for the reference's diagonally-dominant CN operator), and the
    # reference's ABSOLUTE coarse tolerance 1e-5 (multigrid.cpp:60) is
    # instantly satisfied by the tiny correction-equation residuals, turning
    # the coarse solve into a no-op — full-weighting + exact (dense)
    # coarse solve restore the textbook ~0.02/cycle contraction.
    DEFAULT_SOLVER = SolverConfig(restriction="full", coarse_mode="dense")

    def __init__(
        self,
        n: int,
        f=None,
        solver: SolverConfig = DEFAULT_SOLVER,
    ):
        self.n = n
        self.solver = solver
        self.num_levels = solver.resolved_num_levels(n)
        self.levels = build_poisson_hierarchy(
            n, self.num_levels, dtype=solver.dtype, coarse_mode=solver.coarse_mode
        )
        h = 1.0 / n
        idx = jnp.arange(n + 1, dtype=solver.dtype) * h
        x = idx[:, None] * jnp.ones((1, n + 1), solver.dtype)
        y = jnp.ones((n + 1, 1), solver.dtype) * idx[None, :]
        fv = jnp.ones_like(x) if f is None else f(x, y)  # gs2D-omp.cpp uses f≡1
        fv = fv * (
            interior_mask(n, (n + 1, n + 1), dtype=solver.dtype)
        )
        self.rhs = pad_field(fv.astype(solver.dtype))

    @functools.cached_property
    def _jit_mg(self):
        cfg = self.solver

        def run(levels, rhs):
            u0 = jnp.zeros_like(rhs)
            solve = {
                "fixed": mg_solve_fixed,
                "fmg": fmg_solve,
                "adaptive": mg_solve,
            }[cfg.cycle_mode]
            return solve(levels, u0, rhs, cfg)

        return jax.jit(run)

    @functools.cached_property
    def _jit_gs(self):
        cfg = self.solver
        fine = self.levels[0]

        def run(rhs, max_iters, check_every):
            """RB-GS iteration with periodic residual checks — the
            gs2D-omp.cpp:80-113 loop (it checks every 100 sweeps)."""
            u0 = jnp.zeros_like(rhs)
            res0 = interior_norm(residual(fine, u0, rhs))

            def cond(carry):
                _, res, it = carry
                return (it < max_iters) & (res / res0 > cfg.tol)

            def body(carry):
                u, res, it = carry

                def sweep(u, _):
                    return rb_gauss_seidel(fine, u, rhs), None

                u, _ = jax.lax.scan(sweep, u, None, length=check_every)
                res = interior_norm(residual(fine, u, rhs))
                return u, res, it + check_every

            u, res, iters = jax.lax.while_loop(
                cond, body, (u0, res0, jnp.int32(0))
            )
            return u, {"iters": iters, "rel_residual": res / res0}

        return jax.jit(run, static_argnums=(1, 2))

    def solve(self, method: str = "mg", max_iters: int = 100_000, check_every: int = 100):
        if method == "mg":
            u, stats = self._jit_mg(self.levels, self.rhs)
        elif method == "gs":
            u, stats = self._jit_gs(self.rhs, max_iters, check_every)
        else:
            raise ValueError(f"unknown method {method!r}")
        return crop_field(u, self.n), stats
