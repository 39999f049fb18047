"""Multigrid cycling: V/W-cycles, coarse solves, and the outer solver loop.

Design notes:
  * The level count is static, so the reference's recursive `mg_inner`
    (multigrid.cpp:17-92) unrolls at trace time into a flat XLA program —
    no dynamic control flow across levels.
  * The outer convergence loop (`mg_outer`, multigrid.cpp:97-120) and the
    coarsest-level iterated-GS solve (multigrid.cpp:55-65) are
    `lax.while_loop`s: the norms never leave the device (the reference CUDA
    version copies *every* norm to the host, up to 1000 times per coarse
    visit, multigrid.cu:64-69).
  * The optional "dense" coarse solve replaces up to 1000 GS sweeps with one
    precomputed-inverse matrix–vector product (the exact solve the reference
    abandoned, exact_solve.cpp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hpcmg.config import SolverConfig
from hpcmg.mg.levels import Level
from hpcmg.ops.padded import (
    chebyshev_smooth,
    interior_norm,
    prolong_bilinear,
    rb_gauss_seidel,
    residual,
    restrict_full_weighting,
    restrict_inject,
    weighted_jacobi,
)


def _get_smoother(cfg: SolverConfig):
    if cfg.smoother == "rbgs":
        return rb_gauss_seidel
    if cfg.smoother == "jacobi":
        return lambda level, u, rhs: weighted_jacobi(level, u, rhs, cfg.jacobi_omega)
    if cfg.smoother == "chebyshev":
        return lambda level, u, rhs: chebyshev_smooth(
            level, u, rhs, cfg.cheby_degree, cfg.cheby_lower, cfg.cheby_upper
        )
    raise ValueError(f"unknown smoother {cfg.smoother!r}")


def _smooth_block(cfg: SolverConfig, level: Level, u, rhs, nsweeps: int,
                  want_residual: bool, corr=None):
    """`nsweeps` smoother sweeps, optionally followed by the residual.

    `corr` (post-smooth after a coarse correction) is added to `u` first.
    Sharded levels run the same jnp ops under GSPMD, which inserts the halo
    exchanges (parallel/sharding.py).
    """
    if corr is not None:
        u = u + corr
    smoother = _get_smoother(cfg)
    for _ in range(nsweeps):
        u = smoother(level, u, rhs)
    return u, (residual(level, u, rhs) if want_residual else None)


def _restrict(cfg: SolverConfig, res, coarse_level: Level):
    shape = coarse_level.padded
    if cfg.restriction == "inject":
        return restrict_inject(res, shape)
    if cfg.restriction == "full":
        return restrict_full_weighting(res, shape, coarse_level.n)
    raise ValueError(f"unknown restriction {cfg.restriction!r}")


def coarse_solve_gs(level: Level, u, rhs, cfg: SolverConfig, smoother):
    """Coarsest-level solve by smoothing to absolute residual `coarse_tol`
    (≤ `coarse_maxiter` sweeps) — multigrid.cpp:55-65 semantics exactly:
    check-before-sweep with an initial placeholder residual of 1.0."""
    norm_dtype = jnp.promote_types(u.dtype, jnp.float32)
    one = jnp.asarray(1.0, dtype=norm_dtype)

    def cond(carry):
        _, res, it = carry
        return (it < cfg.coarse_maxiter) & (res > cfg.coarse_tol)

    def body(carry):
        u, _, it = carry
        u = smoother(level, u, rhs)
        res = interior_norm(residual(level, u, rhs))
        return u, res, it + 1

    u, _, _ = jax.lax.while_loop(cond, body, (u, one, jnp.int32(0)))
    return u


def coarse_solve_dense(level: Level, u, rhs):
    """Exact coarse solve: one matrix–vector product with the precomputed
    interior inverse (the solve exact_solve.cpp abandoned).  The initial
    guess is irrelevant (the solve is exact).

    The product is pinned to HIGHEST precision: a float32 product may
    otherwise run in TF32 on GPUs (about three decimal digits), which would
    silently weaken every f32 cycle's coarse correction."""
    n, m = level.n, level.n - 1
    flat = rhs[1:n, 1:n].reshape(m * m)
    sol = jnp.matmul(level.a_inv, flat, precision=jax.lax.Precision.HIGHEST)
    return jnp.zeros_like(rhs).at[1:n, 1:n].set(sol.reshape(m, m))


def _constrain(x, sharding):
    if sharding is None:
        return x
    return jax.lax.with_sharding_constraint(x, sharding)


def mg_cycle(
    levels: tuple[Level, ...],
    u,
    rhs,
    cfg: SolverConfig,
    lvl: int = 0,
    shardings=None,
    want_final_residual: bool = False,
):
    """One V- or W-cycle starting at `lvl` (multigrid.cpp:17-92).

    cycle_shape=1 → V, 2 → W; the shape loop wraps the whole level body
    including the coarsest solve, exactly as the reference's `for sh` loop
    (multigrid.cpp:52).

    `shardings` (optional, one per level) places sharding constraints at the
    level transitions — the restrict/prolong boundaries are where GSPMD
    reshards, implementing coarse-level agglomeration (parallel/sharding.py).

    `want_final_residual` (top level only): also return rhs − A·u of the
    returned iterate, computed after the last post-smooth block — returns
    (u, res) instead of u.
    """
    level = levels[lvl]
    smoother = _get_smoother(cfg)
    shard = None if shardings is None else shardings[lvl]
    shard_c = None if shardings is None else shardings[lvl + 1] if lvl + 1 < len(levels) else None
    res = None

    for sh in range(cfg.cycle_shape):
        last_pass = sh == cfg.cycle_shape - 1
        if lvl == len(levels) - 1:
            if cfg.coarse_mode == "dense" and level.a_inv is not None:
                u = coarse_solve_dense(level, u, rhs)
            else:
                u = coarse_solve_gs(level, u, rhs, cfg, smoother)
            if want_final_residual and last_pass:
                res = residual(level, u, rhs)
        else:
            u, r0 = _smooth_block(cfg, level, u, rhs, cfg.niter, True)
            rhs_c = _constrain(_restrict(cfg, r0, levels[lvl + 1]), shard_c)
            u_c = jnp.zeros_like(rhs_c)
            u_c = mg_cycle(levels, u_c, rhs_c, cfg, lvl + 1, shardings)
            corr = _constrain(prolong_bilinear(u_c, level.padded), shard)
            u, res = _smooth_block(
                cfg, level, u, rhs, cfg.niter,
                want_final_residual and last_pass, corr=corr,
            )
    if want_final_residual:
        return u, res
    return u


def mg_solve(levels: tuple[Level, ...], u, rhs, cfg: SolverConfig, shardings=None):
    """Solve A u = rhs by repeated cycles until rel. residual ≤ tol or
    `max_cycles` cycles (multigrid.cpp:97-120).

    Returns (u, stats) with stats = {"cycles", "rel_residual", "converged"}.

    The tol comparison runs in the norm's accumulation dtype (f32 for f32
    fields, f64 under x64) — never downcast, so tolerances below the f32
    resolution (~1e-7 relative) remain meaningful in f64 mode.
    """
    fine = levels[0]
    res0 = interior_norm(residual(fine, u, rhs))
    res0_safe = jnp.maximum(res0, jnp.finfo(res0.dtype).tiny)

    def cond(carry):
        _, res, it = carry
        return (it < cfg.max_cycles) & (res / res0_safe > cfg.tol)

    def body(carry):
        u, _, it = carry
        u = mg_cycle(levels, u, rhs, cfg, shardings=shardings)
        res = interior_norm(residual(fine, u, rhs))
        return u, res, it + 1

    u, res, cycles = jax.lax.while_loop(cond, body, (u, res0, jnp.int32(0)))
    rel = res / res0_safe
    stats = {
        "cycles": cycles,
        "rel_residual": rel,
        # the reference's warning check is off by one (== MAX_CYCLE-1,
        # multigrid.cpp:117, SURVEY §2.9.5); this is the intended test
        "converged": rel <= cfg.tol,
    }
    return u, stats


def mg_solve_fixed(
    levels: tuple[Level, ...], u, rhs, cfg: SolverConfig, shardings=None
):
    """Solve A u = rhs with exactly `cfg.num_cycles` cycles: no
    data-dependent control flow, so the whole solve is one straight XLA
    program with no per-iteration predicate on the host (1 cycle suffices at
    the reference's default parameters anyway — SURVEY §0 "convergence is
    instant").

    The relative-residual certificate is still computed and returned in
    stats, so callers can verify the reference tolerance was met.  Like
    mg_solve, the certificate stays in the norm's accumulation dtype.
    """
    fine = levels[0]
    res0 = interior_norm(residual(fine, u, rhs))
    res0_safe = jnp.maximum(res0, jnp.finfo(res0.dtype).tiny)
    for _ in range(cfg.num_cycles):
        u = mg_cycle(levels, u, rhs, cfg, shardings=shardings)
    rel = interior_norm(residual(fine, u, rhs)) / res0_safe
    stats = {
        "cycles": jnp.int32(cfg.num_cycles),
        "rel_residual": rel,
        "converged": rel <= cfg.tol,
    }
    return u, stats


def fmg_iterate(levels: tuple[Level, ...], rhs, cfg: SolverConfig, shardings=None):
    """The FMG ascent itself (no certificate): restrict `rhs` down the tower,
    solve the coarsest level, prolong upward running `cfg.num_cycles` cycles
    per level.  Shared by `fmg_solve` and the refined path's FMG opening
    (mg/refine.py)."""
    # restrict the rhs to every level (injection or full weighting, per cfg)
    rhs_l = [rhs]
    for lvl in range(1, len(levels)):
        rhs_l.append(_constrain(
            _restrict(cfg, rhs_l[-1], levels[lvl]),
            None if shardings is None else shardings[lvl],
        ))

    # coarsest solve
    bottom = levels[-1]
    smoother = _get_smoother(cfg)
    if cfg.coarse_mode == "dense" and bottom.a_inv is not None:
        v = coarse_solve_dense(bottom, jnp.zeros_like(rhs_l[-1]), rhs_l[-1])
    else:
        v = coarse_solve_gs(bottom, jnp.zeros_like(rhs_l[-1]), rhs_l[-1], cfg, smoother)

    # ascend: prolong the solution, then cycle at that level
    for lvl in range(len(levels) - 2, -1, -1):
        shard = None if shardings is None else shardings[lvl]
        v = _constrain(prolong_bilinear(v, levels[lvl].padded), shard)
        for _ in range(cfg.num_cycles):
            v = mg_cycle(levels, v, rhs_l[lvl], cfg, lvl=lvl, shardings=shardings)
    return v


def fmg_solve(
    levels: tuple[Level, ...], u, rhs, cfg: SolverConfig, shardings=None
):
    """Full multigrid (FMG / nested iteration): restrict the rhs down the
    tower, solve the coarsest level, then work back up — at each level the
    prolonged coarse solution seeds `cfg.num_cycles` cycles.

    New capability beyond the reference (which always starts cycles from the
    previous timestep's fine-grid state, multigrid.cpp:108-114).  FMG costs
    ~4/3 of one fine V-cycle yet delivers a discretization-accuracy first
    iterate, making it the right opening move for cold starts (t = 0, or
    checkpoint-restart with no history).  The initial guess `u` only
    contributes via the residual-norm baseline of the certificate; the FMG
    iterate replaces it.

    Like `mg_solve_fixed` this is a scan-only (while_loop-free) program; the
    relative-residual certificate is computed against `u`'s initial residual
    and returned in stats.
    """
    fine = levels[0]
    res0 = interior_norm(residual(fine, u, rhs))
    res0_safe = jnp.maximum(res0, jnp.finfo(res0.dtype).tiny)
    v = fmg_iterate(levels, rhs, cfg, shardings=shardings)
    rel = interior_norm(residual(fine, v, rhs)) / res0_safe
    stats = {
        # total cycles performed across the ascent: num_cycles at each of the
        # (num_levels - 1) non-coarsest levels (the coarsest direct solve is
        # not a cycle)
        "cycles": jnp.int32(cfg.num_cycles * (len(levels) - 1)),
        "rel_residual": rel,
        "converged": rel <= cfg.tol,
    }
    return v, stats
