"""Smoothers: red–black Gauss–Seidel and weighted Jacobi (jnp reference path).

Red–black ordering matches the reference: red = nodes with (i+j) even, updated
first; black = (i+j) odd, updated second and *reading the freshly updated red
values* (the CPU taskwait barrier at gs.cpp:152 / the CUDA kernel-launch
barrier between gs_ker(rb=0) and gs_ker(rb=1) at gs.cu:389-391).  Each color
pass here is a masked vector update over the whole interior — the
data-parallel formulation of one color of the sweep.
"""

from __future__ import annotations

import jax.numpy as jnp


def checkerboard(shape: tuple[int, int], parity: int, dtype=bool) -> jnp.ndarray:
    """Interior-node color mask.  parity=0 → red ((i+j) even), 1 → black.

    Interior array index (r, c) corresponds to global node (i, j) = (r+1, c+1),
    so (i+j) % 2 == (r+c) % 2.
    """
    r = jnp.arange(shape[0], dtype=jnp.int32)[:, None]
    c = jnp.arange(shape[1], dtype=jnp.int32)[None, :]
    return jnp.asarray((r + c) % 2 == parity, dtype=dtype)


def _color_pass(coef, u, rhs, mask):
    """One Gauss–Seidel half-sweep on the masked color (gs.cpp:130)."""
    nb = (
        coef.cc * u[:-2, 1:-1]
        + coef.dd * u[2:, 1:-1]
        + coef.aa * u[1:-1, :-2]
        + coef.bb * u[1:-1, 2:]
    )
    update = (rhs[1:-1, 1:-1] - nb) * (1.0 / coef.diag_a)
    interior = jnp.where(mask, update, u[1:-1, 1:-1])
    return u.at[1:-1, 1:-1].set(interior)


def rb_gauss_seidel(coef, u: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """One full red–black Gauss–Seidel sweep (red pass then black pass).

    Equivalent to the reference `gauss_seidel` (gs.cpp:109-189) and the CUDA
    host sweep (gs.cu:378-392).
    """
    shape = (u.shape[0] - 2, u.shape[1] - 2)
    u = _color_pass(coef, u, rhs, checkerboard(shape, 0))
    u = _color_pass(coef, u, rhs, checkerboard(shape, 1))
    return u


def weighted_jacobi(
    coef, u: jnp.ndarray, rhs: jnp.ndarray, omega: float = 1.0
) -> jnp.ndarray:
    """Weighted-Jacobi sweep — the alternative smoother of gs.cu:244-305
    (which uses omega = 1, gs.cu:268)."""
    nb = (
        coef.cc * u[:-2, 1:-1]
        + coef.dd * u[2:, 1:-1]
        + coef.aa * u[1:-1, :-2]
        + coef.bb * u[1:-1, 2:]
    )
    jac = (rhs[1:-1, 1:-1] - nb) * (1.0 / coef.diag_a)
    interior = (1.0 - omega) * u[1:-1, 1:-1] + omega * jac
    return u.at[1:-1, 1:-1].set(interior)
