"""Delta (incremental) Crank–Nicolson stepping — f32 compute/storage, f64
accuracy.

The direct CN step solves A u^{n+1} = B u^n, whose right-hand side is O(u):
computing it to double accuracy costs one f64 fine-grid stencil per step.

Algebraically the same step is

    A δ = (B − A) u^n = dt·L u^n,      u^{n+1} = u^n + δ

(A = I − (dt/2)L, B = I + (dt/2)L, multigrid.cpp:1-2 discretization).  The
increment δ is O(dt·u) ≈ 3e-3·u at the reference defaults, so the delta
system can be computed and solved in f32 — IF the right-hand side is
evaluated without catastrophic cancellation.  Three ingredients:

1. **Difference-form rhs** (`delta_rhs`).  The naive coefficient form
   8rν·u − 2Σc·u sums O(0.1·u) terms that cancel to O(3e-3·u); its f32
   rounding (~1e-8·u ≈ 3e-6 of the result) BLOWS the 1e-6 contract (measured
   5.9e-6 at N=1024).  Rewriting per axis with aa+bb = 2rν, bb−aa = r·h·v:

       (B−A)u = −2·[ rν·Σ(u_nb − u)  +  (r·h/2)·(v1·(u_S−u_N) + v2·(u_E−u_W)) ]

   every subtraction is between NEIGHBORING node values (Sterbenz-exact or
   ε-relative-to-the-difference), so the f32 evaluation carries ~1e-7
   RELATIVE error — certificate floor ~2e-7, meeting tol = 1e-6.

2. **f32-pair state** (u ≈ hi + lo, |lo| ≤ ε|hi|).  HBM only ever moves f32
   arrays; the pair represents u to ~2^-47 relative.  The rhs needs the lo
   part's contribution too ((B−A)·lo ~ 6e-6·rhs-scale): evaluated with the
   same difference form and added.

3. **Exact accumulation**: u^{n+1} = (hi + lo + δ) is accumulated by an
   error-free TwoSum in f32 (`_accumulate`), which agrees with summing in
   f64 and splitting back into (hi, lo) (`_accumulate_via_hi`, the
   reference accumulator) to f64 rounding.  Reads and writes stay f32.

Certificate semantics: the per-step relative residual is
||rhs_δ − A δ|| / ||rhs_δ|| — exactly the reference's mg_outer ratio
(multigrid.cpp:104-113: the initial iterate u^n has residual B u^n − A u^n),
measured in f32 at delta scale.  The epilogue recomputes the LAST step's
residual entirely in the high dtype from the reconstructed states and
returns it as stats["final_rel_residual_hi"] — the rigorous certificate.

No reference counterpart (the reference is uniformly double); gated by
SolverConfig.delta_form.  This is the stencil-world analog of
mixed-precision training's master-weights pattern, with the master itself
kept as an f32 pair.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hpcmg.config import SolverConfig
from hpcmg.core.layout import interior_mask, shift
from hpcmg.mg.cycle import mg_cycle
from hpcmg.mg.levels import Level
from hpcmg.ops.padded import (
    interior_norm,
    neighbor_sum_auto,
    residual_auto,
)

def _dform(x):
    """Cancellation-free building blocks of (B−A)x: the 5-point Laplacian
    sum Σ(x_nb − x) and the two centered differences, every subtraction
    between neighboring values."""
    up, dn = shift(x, -1, 0), shift(x, 1, 0)     # x[i−1,j], x[i+1,j]
    lf, rt = shift(x, 0, -1), shift(x, 0, 1)     # x[i,j−1], x[i,j+1]
    lap = (up - x) + (dn - x) + (lf - x) + (rt - x)
    return lap, dn - up, rt - lf                 # lap, Δ_i x, Δ_j x


def delta_rhs(level: Level, u_hi, u_lo=None):
    """(B − A)(hi + lo) in difference form, f32 throughout.

    coefficient identities (gs.cpp:9-20): aa+bb = 2rν, bb−aa = r·h·v2,
    cc+dd = 2rν, dd−cc = r·h·v1 ⇒
    (B−A)u = −2rν·lap(u) − r·h·(v1·Δ_i u + v2·Δ_j u).
    Masked to the open interior (the difference form, unlike the zero-
    coefficient form, is nonzero at boundary/padding nodes).
    """
    rr = 0.5 * level.dt / (level.h * level.h)
    dtype = u_hi.dtype
    two_rnu = dtype.type(2.0 * rr * level.nu)
    r_h = dtype.type(rr * level.h)

    lap, di, dj = _dform(u_hi)
    if u_lo is not None:
        lap_l, di_l, dj_l = _dform(u_lo)
        lap, di, dj = lap + lap_l, di + di_l, dj + dj_l
    out = -(two_rnu * lap) - r_h * (level.v1 * di + level.v2 * dj)
    return out * interior_mask(level.n, u_hi.shape, dtype=dtype)


def _split_hi_lo(x64, dtype):
    """x64 ≈ hi + lo in `dtype`, hi = x64 rounded to `dtype`.

    The rounding is taken by `reduce_precision` in x64's own dtype, so the
    subtraction is exact and no pass can drop it: XLA's GPU backend removes
    a convert to f32 and back (it allows excess precision), which would make
    lo zero."""
    info = jnp.finfo(dtype)
    hi = jax.lax.reduce_precision(x64, exponent_bits=info.nexp,
                                  mantissa_bits=info.nmant)
    return hi.astype(dtype), (x64 - hi).astype(dtype)


def _accumulate_via_hi(hi, lo, d, acc_dtype):
    """Reference accumulator: (hi + lo + d) summed in `acc_dtype` built
    inline from f32 operands, split back to an (hi, lo) pair."""
    s = hi.astype(acc_dtype) + lo.astype(acc_dtype) + d.astype(acc_dtype)
    return _split_hi_lo(s, hi.dtype)


def _accumulate(hi, lo, d, acc_dtype):
    """Production accumulator: TwoSum + renormalization, pure f32 — no f64
    ops at all.  Agrees with `_accumulate_via_hi` (hi bit for bit, hi + lo
    to f64 rounding); pinned by tests/test_refine.py on the CPU and by its
    `gpu` twin on the card.

    TwoSum (Knuth) is branch-free and exact in IEEE f32 provided the
    compiler neither reassociates nor contracts it: t + err == hi + d
    exactly.  The err folds into lo, and a Fast2Sum renormalizes so |lo|
    stays ≤ ulp(hi).  (acc_dtype unused — kept for signature parity.)
    """
    t = hi + d
    bv = t - hi
    err = (hi - (t - bv)) + (d - bv)
    lo2 = lo + err
    hi2 = t + lo2
    lo3 = lo2 - (hi2 - t)
    return hi2, lo3


def timestepper_delta(
    levels: tuple[Level, ...],
    fine_hi: Level,
    u0: jnp.ndarray,
    num_steps: int,
    cfg: SolverConfig,
    shardings=None,
):
    """`num_steps` delta-form CN steps; returns (uT, per-step stats).

    `u0` is in the high dtype; uT is returned in the high dtype.  Stats
    match the refined stepper's, plus `final_rel_residual_hi` (the last
    step's residual recomputed entirely in the high dtype).
    """
    fine = levels[0]
    tiny = jnp.finfo(jnp.float32).tiny
    acc_dtype = u0.dtype
    hi0, lo0 = _split_hi_lo(u0, cfg.dtype)

    def constrain(x):
        if shardings is None:
            return x
        return jax.lax.with_sharding_constraint(x, shardings[0])

    def _certify_hi(hi2, lo2, d):
        """The step's TRUE relative residual, entirely in the high dtype,
        via the exact delta identity: the reference's mg_outer ratio
        (multigrid.cpp:104-113) is ||rhs − A·u^{n+1}|| / ||rhs − A·u^n||
        with rhs = B·u^n, and algebraically

            rhs − A·u^n     = (B−A)·u^n           (the delta rhs)
            rhs − A·u^{n+1} = (B−A)·u^n − A·δ

        so the certificate needs TWO high-dtype stencils (difference-form
        (B−A)·u^n and A·δ) instead of the three of the
        reconstruct-B-then-two-residuals route.  The epilogue keeps the independent three-stencil form, so the two
        derivations cross-check each other at the final step."""
        u_prev = hi2.astype(acc_dtype) + lo2.astype(acc_dtype)
        rhs_d_hi = delta_rhs(fine_hi, u_prev)
        res_hi = rhs_d_hi - (
            fine_hi.diag_a * d.astype(acc_dtype)
            + neighbor_sum_auto(fine_hi, d.astype(acc_dtype))
        )
        rel = interior_norm(res_hi) / jnp.maximum(
            interior_norm(rhs_d_hi), jnp.finfo(rhs_d_hi.dtype).tiny
        )
        return rel.astype(jnp.float32)

    def step(carry, _):
        # carry invariant: u_t = hi + lo + d_pend (the correction computed
        # by the previous iteration is folded in here, fused with the
        # opening)
        hi, lo, d_pend = carry
        hi2, lo2 = _accumulate(hi, lo, d_pend, acc_dtype)
        rhs_d = delta_rhs(fine, hi2, lo2)
        hi2, lo2, rhs_d = constrain(hi2), constrain(lo2), constrain(rhs_d)
        res0 = jnp.maximum(interior_norm(rhs_d), tiny)
        d = jnp.zeros_like(rhs_d)
        for k in range(cfg.num_cycles):
            # the last cycle also returns the certificate residual
            if k == cfg.num_cycles - 1:
                d, r = mg_cycle(levels, d, rhs_d, cfg, shardings=shardings,
                                want_final_residual=True)
            else:
                d = mg_cycle(levels, d, rhs_d, cfg, shardings=shardings)
        rel = interior_norm(r) / res0
        return (hi2, lo2, constrain(d)), (
            rel.astype(jnp.float32), rel <= cfg.tol,
        )

    init = (hi0, lo0, jnp.zeros_like(hi0))
    seg = cfg.certify_every
    if seg and num_steps >= seg:
        # rigorous per-k-step certification as a
        # SEGMENTED scan: `num_steps//seg` outer iterations of a seg-step
        # inner scan, with the high-dtype certificate computed BETWEEN
        # segments (steps seg-1, 2seg-1, ... — the same cadence a
        # `t % seg == seg-1` cond would fire on), then a plain scan over
        # the remainder steps.  A lax.cond inside the hot body would bloat
        # the loop body even when never taken; between-segment placement
        # makes the certificates cost only their own ~2 stencils each.  The segment-end carry is
        # (hi, lo, d_pend) = the last step's pre-accumulation state + its
        # correction — exactly the state _certify_hi certifies.
        nseg = num_steps // seg
        rem = num_steps - nseg * seg

        def seg_body(carry, _):
            carry, ys = jax.lax.scan(step, carry, None, length=seg)
            hi, lo, d_pend = carry
            return carry, (ys, _certify_hi(hi, lo, d_pend))

        # UNROLL the segment loop in chunks of 16 instead of wrapping every
        # segment in an outer lax.scan (a nested-scan entry per segment).
        # Chunking keeps that flat at ANY step count: high segment counts
        # pay the nested-scan entry once per 16 segments, and trace size
        # stays bounded by the 16-segment body.
        chunk = 16

        def run_segments(carry, count):
            parts = []
            for _ in range(count):
                carry, ys = seg_body(carry, None)
                parts.append(ys)
            return carry, parts

        if nseg <= chunk:
            carry, parts = run_segments(init, nseg)
        else:
            n_chunks, rem_seg = divmod(nseg, chunk)

            def chunk_body(carry, _):
                carry, parts = run_segments(carry, chunk)
                return carry, (
                    jnp.concatenate([p[0][0] for p in parts]),
                    jnp.concatenate([p[0][1] for p in parts]),
                    jnp.stack([p[1] for p in parts]),
                )

            carry, (rels_c, conv_c, hi_c) = jax.lax.scan(
                chunk_body, init, None, length=n_chunks
            )
            parts = [((rels_c.reshape(-1), conv_c.reshape(-1)),
                      hi_c.reshape(-1))]
            carry, tail = run_segments(carry, rem_seg)
            parts.extend(tail)
        rels = jnp.concatenate([p[0][0] for p in parts])
        conv = jnp.concatenate([p[0][1] for p in parts])
        rels_hi_seg = jnp.concatenate(
            [jnp.atleast_1d(p[1]) for p in parts]
        )
        if rem:
            carry, (rels_r, conv_r) = jax.lax.scan(
                step, carry, None, length=rem
            )
            rels = jnp.concatenate([rels, rels_r])
            conv = jnp.concatenate([conv, conv_r])
        hi_p, lo_p, d_last = carry
        rels_hi = jnp.full((num_steps,), -1.0, jnp.float32)
        rels_hi = rels_hi.at[
            jnp.arange(nseg, dtype=jnp.int32) * seg + (seg - 1)
        ].set(rels_hi_seg)
    else:
        (hi_p, lo_p, d_last), (rels, conv) = jax.lax.scan(
            step, init, None, length=num_steps
        )
        rels_hi = jnp.full((num_steps,), -1.0, jnp.float32)

    # epilogue: the final pending correction folds in high precision, and
    # the last step's residual is recomputed entirely in the high dtype —
    # the rigorous certificate (hi_p + lo_p = u^{T-1} by the carry invariant)
    u_prev = hi_p.astype(acc_dtype) + lo_p.astype(acc_dtype)
    uT = u_prev + d_last.astype(acc_dtype)
    rhs_hi = fine_hi.diag_b * u_prev - neighbor_sum_auto(fine_hi, u_prev)
    r_hi = residual_auto(fine_hi, uT, rhs_hi)
    res0_hi = interior_norm(residual_auto(fine_hi, u_prev, rhs_hi))
    rel_hi = interior_norm(r_hi) / jnp.maximum(
        res0_hi, jnp.finfo(res0_hi.dtype).tiny
    )

    stats = {
        "cycles": jnp.full((num_steps,), cfg.num_cycles, jnp.int32),
        "rel_residual": rels,
        "converged": conv,
        "final_rel_residual_hi": rel_hi.astype(jnp.float32),
    }
    if cfg.certify_every:
        # per-step rigorous certificates; -1 marks uncertified steps
        stats["rel_residual_hi_steps"] = rels_hi
        checked = rels_hi >= 0
        stats["certified"] = jnp.where(checked, rels_hi <= cfg.tol, True)
    return uT, stats
