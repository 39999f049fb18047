"""Padded field layout.

The reference stores (N+1)x(N+1) node fields (multigrid.cpp:194); N+1 is odd.
Every field here lives instead on a padded array of shape
    (R, C) = (ceil((n+1)/8)·8, ceil((n+1)/128)·128)
with the logical grid occupying [0:n+1, 0:n+1] and ZEROS everywhere else.
Invariants maintained by every kernel in ops/padded.py:

  * u / rhs / res fields: zero on the Dirichlet boundary ring AND in the
    padding margin.  (The two zero regions merge: everything outside the
    open interior [1:n, 1:n] is zero.)
  * coefficient fields (aa/bb/cc/dd): zero outside the open interior —
    this single property makes every stencil op a same-shape elementwise
    expression with zero masking cost (a neighbor-sum against zero-padded
    coefficients cannot leak padding values into the interior, and cannot
    produce nonzeros outside it).

With those invariants, smoothing / residual / rhs are same-shape
elementwise code, norms are plain full-array reductions, and transfers are
the only places that touch strides.  (The (8, 128) tile sizes were chosen for
the accelerator the solver was first built for; whether the GPU wants other
padding is an open question, ROADMAP Design 3.)
"""

from __future__ import annotations

import jax.numpy as jnp

ROW_TILE = 8     # row padding multiple
COL_TILE = 128   # column padding multiple


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_shape(n: int) -> tuple[int, int]:
    """Padded array shape for an (n+1)x(n+1) node grid."""
    return _ceil_to(n + 1, ROW_TILE), _ceil_to(n + 1, COL_TILE)


def pad_field(u: jnp.ndarray) -> jnp.ndarray:
    """Embed a logical (n+1)x(n+1) field into its padded array."""
    n = u.shape[0] - 1
    r, c = padded_shape(n)
    return jnp.pad(u, ((0, r - u.shape[0]), (0, c - u.shape[1])))


def crop_field(u_p: jnp.ndarray, n: int) -> jnp.ndarray:
    """Extract the logical (n+1)x(n+1) field from a padded array."""
    return u_p[: n + 1, : n + 1]


def shift(u: jnp.ndarray, di: int, dj: int) -> jnp.ndarray:
    """Same-shape shifted view with zero fill: out[i, j] = u[i+di, j+dj].

    Implemented as slice+pad so XLA fuses it into the consuming elementwise
    op (no materialized temporary, no roll).
    Only |di|,|dj| ≤ 1 are used by the 5/9-point kernels.
    """
    if di == 1:
        u = jnp.pad(u[1:, :], ((0, 1), (0, 0)))
    elif di == -1:
        u = jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
    if dj == 1:
        u = jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
    elif dj == -1:
        u = jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
    return u


def interior_mask(n: int, shape: tuple[int, int], dtype=jnp.bool_) -> jnp.ndarray:
    """Mask of the open interior [1:n, 1:n] inside a padded array.

    Index arithmetic is pinned to i32: under jax_enable_x64 a default arange
    would be i64, doubling the index work of the all-f32 V-cycle.
    """
    r = jnp.arange(shape[0], dtype=jnp.int32)[:, None]
    c = jnp.arange(shape[1], dtype=jnp.int32)[None, :]
    return (((r >= 1) & (r <= n - 1)) & ((c >= 1) & (c <= n - 1))).astype(dtype)


def color_mask(shape: tuple[int, int], parity: int) -> jnp.ndarray:
    """Red–black mask over the padded array: (i+j) % 2 == parity.

    Padded index equals global node index, so this matches the reference's
    red = (i+j) even convention (gs.cu:343).  i32 + bitwise parity, as in
    interior_mask.
    """
    r = jnp.arange(shape[0], dtype=jnp.int32)[:, None]
    c = jnp.arange(shape[1], dtype=jnp.int32)[None, :]
    return ((r + c) & 1) == parity
