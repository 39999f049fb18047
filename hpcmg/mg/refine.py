"""Mixed-precision iterative refinement — an f32-compute answer to the
reference's pure-double solve (multigrid.cpp:138 `double` everywhere).

f64 moves twice the bytes of f32 and runs at a fraction of its rate, and the
CN system is strongly diagonally dominant (SURVEY §0: one V-cycle reaches ~7e-15 relative residual
in double), which is the ideal regime for classic iterative refinement:

    r   = rhs − A·u            computed in `refine_dtype` (f64)
    e   ≈ A⁻¹ r                one multigrid cycle, all in `dtype` (f32)
    u  += e                    accumulated in `refine_dtype`

The heavy work (all smoothing sweeps on every level) runs in f32; only ~two
fine-grid stencil passes per cycle (residual) plus the axpy run in f64.  Because the contraction per refinement step is
≈ eps_f32·κ(A) ≈ 1e-7, a single cycle certifies the reference tolerance of
1e-6 (multigrid.cpp:240) that a pure-f32 solver can never certify (the f32
residual floor at N=1024 is ~1.5e-5 relative).

No reference counterpart: the reference has no mixed precision anywhere; this
is a new capability required to match its double-precision convergence
contract on hardware whose fast path is f32/bf16.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hpcmg.config import SolverConfig
from hpcmg.mg.cycle import fmg_iterate, mg_cycle
from hpcmg.mg.levels import Level
from hpcmg.ops.padded import (
    _diag,
    interior_norm,
    neighbor_sum_auto,
    residual_auto,
)


def _hi_residual(fine_hi, u, rhs):
    """High-precision residual: precomputed coefficient fields by default;
    slim levels (aa is None, the n>=8192 memory-saving form) recompute them
    via the *_auto dispatch."""
    return residual_auto(fine_hi, u, rhs)


def _correction(levels, r_lo, cfg, shardings):
    """Solve A e = r approximately with one cycle tower pass in low precision."""
    e = jnp.zeros_like(r_lo)
    return mg_cycle(levels, e, r_lo, cfg, shardings=shardings)


def refined_solve(
    levels: tuple[Level, ...],
    fine_hi: Level,
    u,
    rhs,
    cfg: SolverConfig,
    shardings=None,
    r0=None,
):
    """Solve A u = rhs with u/rhs/residuals in `fine_hi`'s dtype and cycle
    corrections in `cfg.dtype`.

    `fine_hi` is the finest level's operator in the high precision
    (coefficients only; same grid).  cycle_mode "adaptive" reproduces the
    reference outer-loop semantics (multigrid.cpp:97-120) on the refined
    iteration; "fixed" runs exactly `cfg.num_cycles` refinement cycles
    (scan-only program, residual certificate in stats); "fmg" is "fixed"
    with a full-multigrid ascent as the first correction (cold-start
    opening).

    `r0` optionally supplies the precomputed initial residual rhs − A·u
    (the CN opening computes it fused with the rhs, ops/padded.py::
    rhs_and_residual0 — saves one f64 fine-grid stencil).

    Certificate norms run on the residual's `cfg.dtype` downcast — the cast
    is needed anyway to feed the correction cycle, so the norm costs no extra
    high-precision pass; a relative residual measured at ~1e-7 accuracy is
    ample for the reference's 1e-6 tolerance (achieved: ~5e-8).
    """
    r = _hi_residual(fine_hi, u, rhs) if r0 is None else r0
    r_lo = r.astype(cfg.dtype)
    res0 = interior_norm(r_lo)
    res0_safe = jnp.maximum(res0, jnp.finfo(res0.dtype).tiny)

    if cfg.cycle_mode in ("fixed", "fmg"):
        # "fmg": the FIRST correction is a full-multigrid ascent (nested
        # iteration on the error equation A e = r — the right cold-start
        # move), subsequent corrections are plain cycles.  "fixed": all
        # corrections are plain cycles.  Both are scan-only programs.
        for k in range(cfg.num_cycles):
            if cfg.cycle_mode == "fmg" and k == 0:
                e = fmg_iterate(levels, r_lo, cfg, shardings=shardings)
            else:
                e = _correction(levels, r_lo, cfg, shardings)
            u = u + e.astype(u.dtype)
            r_lo = _hi_residual(fine_hi, u, rhs).astype(cfg.dtype)
        rel = interior_norm(r_lo) / res0_safe
        cycles = jnp.int32(cfg.num_cycles)
    else:

        def cond(carry):
            _, _, res, it = carry
            return (it < cfg.max_cycles) & (res / res0_safe > cfg.tol)

        def body(carry):
            u, r_lo, _, it = carry
            u = u + _correction(levels, r_lo, cfg, shardings).astype(u.dtype)
            r_lo = _hi_residual(fine_hi, u, rhs).astype(cfg.dtype)
            return u, r_lo, interior_norm(r_lo), it + 1

        u, r_lo, res, cycles = jax.lax.while_loop(
            cond, body, (u, r_lo, res0, jnp.int32(0))
        )
        rel = res / res0_safe

    stats = {
        "cycles": cycles,
        "rel_residual": rel.astype(jnp.float32),
        "converged": rel <= cfg.tol,
    }
    return u, stats


def timestepper_refined_fused(
    levels: tuple[Level, ...],
    fine_hi: Level,
    u0: jnp.ndarray,
    num_steps: int,
    cfg: SolverConfig,
    shardings=None,
):
    """Refined fixed-cycle timestepping with cross-step stencil fusion.

    The step-t closing certificate residual (rhs_t − A·u_{t+1}) and the
    step-(t+1) CN opening (rhs = B·u, r0 = rhs − A·u) all need the same
    neighbor sum of the current state, so one f64 fine-grid stencil
    pass per step serves all three — half the high-precision stencil work of
    calling `refined_solve` per step (each closing pass becomes the next
    opening pass).  The last step's certificate is one epilogue pass.

    Per-step stats are identical in meaning to refined_solve's; requires
    num_cycles fixed (cfg.cycle_mode == "fixed") so the scan body is static.
    """
    tiny = jnp.finfo(jnp.float32).tiny
    d_a = _diag(fine_hi)

    def cert(rhs, au):
        return interior_norm((rhs - au).astype(cfg.dtype)).astype(jnp.float32)

    def step(carry, _):
        u, rhs_prev, res0_prev = carry
        ns = neighbor_sum_auto(fine_hi, u)         # the one f64 stencil pass
        au = d_a * u + ns
        rel_prev = cert(rhs_prev, au) / res0_prev  # step t-1 certificate
        rhs = fine_hi.diag_b * u - ns
        r_lo = (rhs - au).astype(cfg.dtype)        # r0 of step t
        res0 = jnp.maximum(interior_norm(r_lo).astype(jnp.float32), tiny)
        for k in range(cfg.num_cycles):
            u = u + _correction(levels, r_lo, cfg, shardings).astype(u.dtype)
            if k + 1 < cfg.num_cycles:
                r_lo = _hi_residual(fine_hi, u, rhs).astype(cfg.dtype)
        return (u, rhs, res0), rel_prev

    carry0 = (u0, jnp.zeros_like(u0), jnp.float32(1.0))
    (uT, rhs_last, res0_last), rels = jax.lax.scan(
        step, carry0, None, length=num_steps
    )
    rel_last = (
        interior_norm(_hi_residual(fine_hi, uT, rhs_last).astype(cfg.dtype))
        .astype(jnp.float32) / res0_last
    )
    rel = jnp.concatenate([rels[1:], rel_last[None]])
    stats = {
        "cycles": jnp.full((num_steps,), cfg.num_cycles, jnp.int32),
        "rel_residual": rel,
        "converged": rel <= cfg.tol,
    }
    return uT, stats
