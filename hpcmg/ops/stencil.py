"""Variable-coefficient 5-point stencil kernels — jnp reference implementations.

These are the framework's logical-shape oracle kernels; the production
padded-layout kernels in ops/padded.py must match them (tests/test_padded.py).

Conventions (shared with core.problem.CNCoefficients):
  * fields u, rhs, res: shape (n+1, n+1), u[i, j], Dirichlet boundary ring
  * coefficient arrays aa/bb/cc/dd: interior shape (n-1, n-1)
  * all kernels touch interior nodes only and leave/emit a zero boundary ring,
    mirroring the reference kernels' `for i in 1..n-1` loops (gs.cpp:35-44).

Everything is expressed as interior-slice arithmetic (no masks, no rolls): XLA
fuses the shifted slices of `u` into a single pass over the array, which
is exactly the fusion a hand-written stencil kernel would do.
"""

from __future__ import annotations

import jax.numpy as jnp


def _pad1(interior: jnp.ndarray) -> jnp.ndarray:
    """Embed an (n-1, n-1) interior field into (n+1, n+1) with a zero ring."""
    return jnp.pad(interior, 1)


def neighbor_sum(coef, u: jnp.ndarray) -> jnp.ndarray:
    """Interior-shaped sum  cc·u[i−1,j] + dd·u[i+1,j] + aa·u[i,j−1] + bb·u[i,j+1].

    This is the off-diagonal part shared by A, B, the residual and the GS
    update (gs.cpp:44,75,130).
    """
    return (
        coef.cc * u[:-2, 1:-1]
        + coef.dd * u[2:, 1:-1]
        + coef.aa * u[1:-1, :-2]
        + coef.bb * u[1:-1, 2:]
    )


def apply_A(coef, u: jnp.ndarray) -> jnp.ndarray:
    """Implicit CN operator: (A u)_ij = diag_a·u_ij + neighbor_sum (gs.cpp:75)."""
    return _pad1(coef.diag_a * u[1:-1, 1:-1] + neighbor_sum(coef, u))


def apply_B(coef, u: jnp.ndarray) -> jnp.ndarray:
    """Explicit CN operator: (B u)_ij = diag_b·u_ij − neighbor_sum (gs.cpp:44)."""
    return _pad1(coef.diag_b * u[1:-1, 1:-1] - neighbor_sum(coef, u))


def compute_rhs(coef, u: jnp.ndarray) -> jnp.ndarray:
    """Per-timestep right-hand side rhs = B·u^n (gs.cpp:24-53)."""
    return apply_B(coef, u)


def residual(coef, u: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """res = rhs − A·u on the interior, zero ring (gs.cpp:55-83)."""
    return _pad1(
        rhs[1:-1, 1:-1] - coef.diag_a * u[1:-1, 1:-1] - neighbor_sum(coef, u)
    )


def interior_norm(res: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized l2 norm over interior nodes (gs.cpp:86-107).

    The reference accumulates in double; in low-precision modes we accumulate
    the sum of squares in float32 regardless of field dtype.
    """
    inner = res[1:-1, 1:-1].astype(jnp.promote_types(res.dtype, jnp.float32))
    return jnp.sqrt(jnp.sum(inner * inner))
