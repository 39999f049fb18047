"""Production kernels on the padded layout (core/layout.py).

Numerically identical to the logical-shape oracle kernels in ops/stencil.py /
ops/smoothers.py / ops/transfer.py (asserted by tests/test_padded.py); the
difference is purely layout: all fields and coefficient arrays share one
(8,128)-tile-aligned shape, every hot op is a same-shape elementwise
expression over fused zero-filled shifts, and nothing in the cycle ever
slices an odd extent.

Coefficient conventions (reference formulas at gs.cpp:9-20, SURVEY §0):
  aa → u[i,j−1], bb → u[i,j+1], cc → u[i−1,j], dd → u[i+1,j],
  (A u) = diag_a·u + Σ, (B u) = diag_b·u − Σ.
Coefficient arrays are ZERO outside the open interior, which makes boundary
handling free (see core/layout.py invariants).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from hpcmg.core.layout import color_mask, shift


def neighbor_sum(coef, u: jnp.ndarray) -> jnp.ndarray:
    """Σ = cc·u[i−1,j] + dd·u[i+1,j] + aa·u[i,j−1] + bb·u[i,j+1] (gs.cpp:44,75).

    Levels carrying a Galerkin 9-point operator (sparse/galerkin.py) add the
    four corner couplings ne/nw/se/sw.
    """
    s = (
        coef.cc * shift(u, -1, 0)
        + coef.dd * shift(u, 1, 0)
        + coef.aa * shift(u, 0, -1)
        + coef.bb * shift(u, 0, 1)
    )
    ne = getattr(coef, "ne", None)
    if ne is not None:
        s = (
            s
            + ne * shift(u, -1, 1)      # couples u[i-1, j+1]
            + coef.nw * shift(u, -1, -1)
            + coef.se * shift(u, 1, 1)
            + coef.sw * shift(u, 1, -1)
        )
    return s


def _diag(coef):
    """Diagonal of A: the spatially-varying array for Galerkin operators
    (stored with ONES outside the interior so reciprocals stay finite), the
    compile-time scalar 1−4rν otherwise."""
    d = getattr(coef, "diag", None)
    return coef.diag_a if d is None else d


def apply_A(coef, u: jnp.ndarray) -> jnp.ndarray:
    """Implicit CN operator (gs.cpp:75).  Valid because u is zero outside the
    interior, so the diagonal term needs no mask."""
    return _diag(coef) * u + neighbor_sum(coef, u)


def apply_B(coef, u: jnp.ndarray) -> jnp.ndarray:
    """Explicit CN operator (gs.cpp:44)."""
    return coef.diag_b * u - neighbor_sum(coef, u)


def compute_rhs(coef, u: jnp.ndarray) -> jnp.ndarray:
    """rhs = B·u^n (gs.cpp:24-53)."""
    return apply_B(coef, u)


def rhs_and_residual0(coef, u: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """CN step opening, fused: rhs = B·u^n and r0 = rhs − A·u^n share one
    neighbor-sum pass (B = diag_b·u − Σ, A = diag_a·u + Σ ⇒ r0 = rhs −
    diag_a·u − Σ).  One fine-grid stencil instead of two — this is the
    high-precision (f64) opening of every refined timestep."""
    ns = neighbor_sum(coef, u)
    rhs = coef.diag_b * u - ns
    r0 = rhs - _diag(coef) * u - ns
    return rhs, r0


def _coefs_from_v(level):
    """Recompute (aa, bb, cc, dd) from the velocity fields on the fly —
    the reference's own per-point strategy (gs.cpp:126-129): a memory-bound
    stencil reads 2 velocity arrays instead of 4 precomputed coefficient
    arrays, and the coefficient arithmetic is cheap beside the reads.

    Expression shape mirrors mg/levels.py::_np_cn_coefficients exactly, so
    in IEEE f64 the values are bit-identical to the precomputed fields
    (given the same FMA contraction of the two expressions).
    """
    rr = 0.5 * level.dt / (level.h * level.h)
    half_h = 0.5 * level.h
    nu = level.nu
    from hpcmg.core.layout import interior_mask

    mask = interior_mask(level.n, level.padded, dtype=level.v1.dtype)
    aa = rr * (-level.v2 * half_h + nu) * mask
    bb = rr * (level.v2 * half_h + nu) * mask
    cc = rr * (-level.v1 * half_h + nu) * mask
    dd = rr * (level.v1 * half_h + nu) * mask
    return aa, bb, cc, dd


def neighbor_sum_from_v(level, u: jnp.ndarray) -> jnp.ndarray:
    """`neighbor_sum` with coefficients recomputed from (v1, v2): reads two
    arrays instead of four.  5-point rediscretized levels only (Galerkin
    levels carry no velocity-consistent bands)."""
    aa, bb, cc, dd = _coefs_from_v(level)
    return (
        cc * shift(u, -1, 0)
        + dd * shift(u, 1, 0)
        + aa * shift(u, 0, -1)
        + bb * shift(u, 0, 1)
    )


def rhs_and_residual0_from_v(level, u: jnp.ndarray):
    """`rhs_and_residual0` on the recomputed-coefficient path — the
    opening of the refined timestep on slim levels (mg/refine.py)."""
    ns = neighbor_sum_from_v(level, u)
    rhs = level.diag_b * u - ns
    r0 = rhs - level.diag_a * u - ns
    return rhs, r0


def residual_from_v(level, u: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """`residual` on the recomputed-coefficient path (5-point levels with a
    scalar diagonal only)."""
    return rhs - level.diag_a * u - neighbor_sum_from_v(level, u)


def neighbor_sum_auto(level, u: jnp.ndarray) -> jnp.ndarray:
    """`neighbor_sum` that tolerates SLIM levels (aa is None — the
    velocities-only high-precision operator used at n>=8192, where storing
    six f64 coefficient arrays would cost 3.3 GB at n=8192 / 13 GB at
    n=16384 of HBM; mg/levels.py::build_fine_level store_coefficients).
    Bit-identical to the precomputed form in IEEE f64 (the from_v
    expressions mirror _np_cn_coefficients exactly)."""
    if level.aa is None:
        return neighbor_sum_from_v(level, u)
    return neighbor_sum(level, u)


def residual_auto(level, u: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """`residual` via `neighbor_sum_auto` (slim-level tolerant)."""
    if level.aa is None:
        return residual_from_v(level, u, rhs)
    return residual(level, u, rhs)


def rhs_and_residual0_auto(level, u: jnp.ndarray):
    """`rhs_and_residual0` that tolerates SLIM levels (aa is None), routing
    them through the from_v form — bit-identical in IEEE f64, like
    `neighbor_sum_auto`.  The non-delta refined opening (mg/timestepper.py)
    must use this dispatch: models auto-build a slim high-precision operator
    at n >= 8192 (models/advection_diffusion.py), where the precomputed form
    would dereference aa=None at trace time."""
    if level.aa is None:
        return rhs_and_residual0_from_v(level, u)
    return rhs_and_residual0(level, u)


def residual(coef, u: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """res = rhs − A·u (gs.cpp:55-83); zero outside the interior by the
    coefficient-masking invariant (the Galerkin diag is 1 outside the
    interior but u is 0 there, so the product still vanishes)."""
    return rhs - _diag(coef) * u - neighbor_sum(coef, u)


def interior_norm(res: jnp.ndarray) -> jnp.ndarray:
    """l2 norm over interior nodes (gs.cpp:86-107).  The padding and boundary
    are exact zeros, so a full-array reduction equals the interior norm."""
    acc = res.astype(jnp.promote_types(res.dtype, jnp.float32))
    return jnp.sqrt(jnp.sum(acc * acc))


def rb_gauss_seidel(coef, u: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """One red–black Gauss–Seidel sweep: red = (i+j) even first, then black
    reading fresh red values (gs.cpp:109-189, gs.cu:378-392).

    Each color pass: upd = (rhs − Σ)/diag_a is zero outside the interior
    (rhs and the coefficients are), so `where(color, upd, u)` preserves the
    zero margin with no interior mask.
    """
    inv_diag = 1.0 / _diag(coef)
    red = color_mask(u.shape, 0)
    u = jnp.where(red, (rhs - neighbor_sum(coef, u)) * inv_diag, u)
    black = jnp.logical_not(red)
    u = jnp.where(black, (rhs - neighbor_sum(coef, u)) * inv_diag, u)
    return u


def weighted_jacobi(coef, u: jnp.ndarray, rhs: jnp.ndarray, omega: float = 1.0) -> jnp.ndarray:
    """Weighted-Jacobi sweep (the gs.cu:244-305 alternative smoother, ω=1
    there)."""
    jac = (rhs - neighbor_sum(coef, u)) * (1.0 / _diag(coef))
    return (1.0 - omega) * u + omega * jac


def gershgorin_bound(coef) -> jnp.ndarray:
    """Gershgorin upper bound on the spectrum of D⁻¹A: 1 + max_i Σ_j|a_ij|/d_i.

    One reduction over the (loop-invariant) coefficient fields; XLA hoists it
    out of scan/while bodies, so smoothers may call it per sweep for free.
    """
    rowsum = jnp.abs(coef.aa) + jnp.abs(coef.bb) + jnp.abs(coef.cc) + jnp.abs(coef.dd)
    ne = getattr(coef, "ne", None)
    if ne is not None:
        rowsum = rowsum + jnp.abs(ne) + jnp.abs(coef.nw) + jnp.abs(coef.se) + jnp.abs(coef.sw)
    # |diag|: the CN convention keeps diag_a = 1 - 4rν > 0 (ν negative,
    # multigrid.cpp:235), but a user passing physical ν > 0 would flip the
    # sign and silently poison the spectrum bound without the abs
    return 1.0 + jnp.max(rowsum / jnp.abs(_diag(coef)))


def chebyshev_smooth(
    coef,
    u: jnp.ndarray,
    rhs: jnp.ndarray,
    degree: int = 3,
    lower_frac: float = 1.0 / 30.0,
    upper_frac: float = 1.1,
) -> jnp.ndarray:
    """Degree-`degree` Chebyshev polynomial smoother on the Jacobi-
    preconditioned system D⁻¹A, targeting the upper spectrum
    [lower_frac·λ̂, upper_frac·λ̂] with λ̂ the Gershgorin bound.

    New capability beyond the reference (its smoothers are red–black GS,
    gs.cpp:109-189, and ω-Jacobi, gs.cu:244-305).  Chebyshev is the most
    data-parallel smoother of the three: each iteration is one full stencil
    apply + axpys — no color masks, no `where` selects, and (unlike GS) it is
    decomposition-invariant, so the distributed solver smooths identically
    regardless of how the mesh shards the grid.  Three-term recurrence as in
    standard AMG practice (classic Chebyshev iteration on the residual).
    """
    lam = gershgorin_bound(coef).astype(u.dtype)
    lmax = upper_frac * lam
    # Gershgorin also lower-bounds the spectrum: λ ≥ 2 − λ̂ (= 1 − max row
    # sum/diag).  For diagonally dominant operators (the CN system: SURVEY §0)
    # that bound is positive and MUCH tighter than the generic AMG band
    # λ̂/30, so the polynomial covers the whole spectrum and the smoother
    # becomes a solver-grade contraction; for non-dominant operators the
    # bound goes ≤ 0 and the generic band takes over.
    lmin = jnp.maximum(lower_frac * lam, 2.0 - lam)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    inv_diag = 1.0 / _diag(coef)

    r = residual(coef, u, rhs)
    d = (inv_diag / theta) * r
    u = u + d
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = residual(coef, u, rhs)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (inv_diag * r)
        u = u + d
        rho = rho_new
    return u


# ---------------------------------------------------------------------------
# transfers: the only stride-touching ops; run once per level per cycle
# ---------------------------------------------------------------------------


def _fit(x: jnp.ndarray, shape: tuple[int, int]) -> jnp.ndarray:
    """Crop/zero-pad a 2-D array to `shape` (top-left anchored)."""
    x = x[: shape[0], : shape[1]]
    return jnp.pad(x, ((0, shape[0] - x.shape[0]), (0, shape[1] - x.shape[1])))


def restrict_inject(fine: jnp.ndarray, coarse_shape: tuple[int, int]) -> jnp.ndarray:
    """Injection: coarse[I,J] = fine[2I,2J] (gs.cpp:283), a stride-2 slice
    cropped/zero-padded to the coarse padded shape — a copy, so it is
    bit-identical on every backend.

    `lax.slice` with strides, not `fine[::2, ::2]`: jnp lowers the latter
    to a gather, and XLA's CPU gather fusion, which recomputes the fused
    producer (the refined stepper's f64 residual) per element, rounds that
    producer differently in the last bit from the loop fusions that
    recompute it elsewhere in the same step.

    Rows/cols beyond the coarse logical grid read the fine padding (zeros),
    so the invariant holds without masking.
    """
    return _fit(lax.slice(fine, (0, 0), fine.shape, (2, 2)), coarse_shape)


def restrict_full_weighting(
    fine: jnp.ndarray, coarse_shape: tuple[int, int], n_coarse: int
) -> jnp.ndarray:
    """Full-weighting 1/16·[1 2 1; 2 4 2; 1 2 1] restriction (the variant the
    reference left commented out, gs.cpp:277-280).

    Computed as a 9-point smooth (pure elementwise over shifts) followed by
    injection; coarse boundary nodes are masked back to zero (they would
    otherwise pick up interior fine values).
    """
    sm = (
        4.0 * fine
        + 2.0 * (shift(fine, -1, 0) + shift(fine, 1, 0) + shift(fine, 0, -1) + shift(fine, 0, 1))
        + shift(fine, -1, -1)
        + shift(fine, -1, 1)
        + shift(fine, 1, -1)
        + shift(fine, 1, 1)
    ) * (1.0 / 16.0)
    coarse = restrict_inject(sm, coarse_shape)
    from hpcmg.core.layout import interior_mask

    return coarse * interior_mask(n_coarse, coarse_shape, dtype=coarse.dtype)


def prolong_bilinear(coarse: jnp.ndarray, fine_shape: tuple[int, int]) -> jnp.ndarray:
    """Bilinear prolongation (gs.cpp:228-266, gs.cu:63-81) via row/col
    interleaving: fine[2I,2J]=c, edge midpoints average 2, centers average 4.

    Requires the input's logical boundary ring to be zero (true for error/
    correction fields) so the interpolated values just outside the fine
    logical grid are zero and the padding invariant survives.
    """
    rows_odd = 0.5 * (coarse + shift(coarse, 1, 0))
    x = jnp.stack([coarse, rows_odd], axis=1).reshape(
        2 * coarse.shape[0], coarse.shape[1]
    )
    cols_odd = 0.5 * (x + shift(x, 0, 1))
    y = jnp.stack([x, cols_odd], axis=2).reshape(x.shape[0], 2 * x.shape[1])
    return _fit(y, fine_shape)
