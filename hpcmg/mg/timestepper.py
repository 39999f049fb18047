"""Crank–Nicolson timestepping: rhs = B·u^n, then solve A·u^{n+1} = rhs.

The reference's `timestepper` (multigrid.cpp:124-186) is a host loop; here it
is a `lax.scan` so the full run is one XLA program with zero host round-trips.

Solve-path dispatch (all combinations share the same cycle kernels):

  cycle_mode   refine_dtype   solver
  adaptive     None           mg_solve          (reference mg_outer semantics)
  fixed        None           mg_solve_fixed    (scan-only program)
  fmg          None           fmg_solve         (full-multigrid opening)
  adaptive     float64        refined_solve     (mixed-precision refinement)
  fixed        float64        refined_solve     (fast path + f64 certificate)
  fmg          float64        refined_solve     (FMG first correction)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hpcmg.config import SolverConfig
from hpcmg.mg.cycle import fmg_solve, mg_solve, mg_solve_fixed
from hpcmg.mg.levels import Level
from hpcmg.mg.refine import refined_solve
from hpcmg.ops.padded import (
    compute_rhs,
    rhs_and_residual0_auto,
)


def timestep(
    levels: tuple[Level, ...],
    u,
    cfg: SolverConfig,
    fine_hi: Level | None = None,
    shardings=None,
):
    """One CN step: compute_rhs (multigrid.cpp:167) + mg_outer (:169).

    With `fine_hi` (the finest operator in `cfg.refine_dtype`), the rhs and
    the solve run under mixed-precision iterative refinement (mg/refine.py);
    with cfg.delta_form, one step of the delta stepper (mg/delta.py).
    """
    if fine_hi is not None and cfg.delta_form:
        import jax as _jax

        from hpcmg.mg.delta import timestepper_delta

        u_next, stats = timestepper_delta(
            levels, fine_hi, u, 1, cfg, shardings=shardings
        )
        return u_next, _jax.tree.map(
            lambda x: x[0] if getattr(x, "ndim", 0) >= 1 and x.shape[0] == 1 else x,
            stats,
        )
    if fine_hi is not None:
        # precomputed coefficients when stored; SLIM levels (aa=None, auto
        # at n>=8192) dispatch to the from_v form — bit-identical in f64
        rhs, r0 = rhs_and_residual0_auto(fine_hi, u)
        return refined_solve(
            levels, fine_hi, u, rhs, cfg, shardings=shardings, r0=r0
        )
    rhs = compute_rhs(levels[0], u)
    if cfg.cycle_mode == "fixed":
        return mg_solve_fixed(levels, u, rhs, cfg, shardings=shardings)
    if cfg.cycle_mode == "fmg":
        return fmg_solve(levels, u, rhs, cfg, shardings=shardings)
    return mg_solve(levels, u, rhs, cfg, shardings=shardings)


def timestepper(
    levels: tuple[Level, ...],
    u0: jnp.ndarray,
    num_steps: int,
    cfg: SolverConfig,
    fine_hi: Level | None = None,
    shardings=None,
):
    """Run `num_steps` CN steps; returns (uT, per-step stats pytree).

    The refined fixed-cycle configuration routes through the cross-step
    fused stepper (mg/refine.py::timestepper_refined_fused): the step-t
    closing certificate residual and the step-(t+1) CN opening share one
    high-precision fine-grid stencil pass, halving the f64 stencil work of
    the refined step.  Identical stats semantics (asserted
    against the per-step path by tests/test_refine.py).

    With cfg.delta_form, the delta (incremental) stepper (mg/delta.py)
    replaces it: the step increment is solved entirely in cfg.dtype and
    only the state accumulation runs in refine_dtype."""
    if fine_hi is not None and cfg.delta_form:
        from hpcmg.mg.delta import timestepper_delta

        return timestepper_delta(
            levels, fine_hi, u0, num_steps, cfg, shardings=shardings
        )
    if fine_hi is not None and cfg.cycle_mode == "fixed":
        from hpcmg.mg.refine import timestepper_refined_fused

        return timestepper_refined_fused(
            levels, fine_hi, u0, num_steps, cfg, shardings=shardings
        )

    def step(u, _):
        u, stats = timestep(levels, u, cfg, fine_hi=fine_hi, shardings=shardings)
        return u, stats

    return jax.lax.scan(step, u0, None, length=num_steps)
