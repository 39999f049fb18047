"""Problem setup: initial condition, velocity field, Crank–Nicolson coefficients.

Fields live on the (n+1)x(n+1) node grid of [0,1]^2, h = 1/n, stored as 2-D
arrays u[i, j] where i is the x/row direction and j is y/col — the same
convention as the reference's row-major u[i*(N+1)+j] (multigrid.cpp:194,219).

The CN discretization of u_t + v·∇u + ν∇²u = 0 solves A u^{n+1} = B u^n per
step with A = I − (dt/2)L, B = I + (dt/2)L, where L is the 2nd-order central
5-point discretization of ν∇² − v·∇ under the repo's sign convention
(gs.cpp:9-20,44,75; SURVEY §0).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


def _node_coords(n: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """x[i,j] = i*h, y[i,j] = j*h on the (n+1)^2 node grid (numpy, setup-time)."""
    h = 1.0 / n
    idx = np.arange(n + 1, dtype=np.float64) * h
    x = idx[:, None] * np.ones((1, n + 1))
    y = np.ones((n + 1, 1)) * idx[None, :]
    return x.astype(dtype), y.astype(dtype)


def gaussian_u0(
    n: int,
    x0: float = 0.2,
    y0: float = 0.4,
    sigma: float = 100.0,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Gaussian initial condition, boundary forced to 0.

    Reference: multigrid.cpp:219 (interior values) and :227-233 (boundary
    zeroing).  Unlike the CUDA init (gs.cu:225-229) this writes the *entire*
    boundary — the reference CUDA kernel leaves most of the i==n / j==n edges
    uninitialized (SURVEY §2.9.4); we implement the intended behavior.
    """
    x, y = _node_coords(n, np.float64)
    u0 = np.exp(-sigma * ((x - x0) ** 2 + (y - y0) ** 2))
    u0[0, :] = 0.0
    u0[-1, :] = 0.0
    u0[:, 0] = 0.0
    u0[:, -1] = 0.0
    return jnp.asarray(u0, dtype=dtype)


def rotating_velocity(
    n: int,
    kx: float = np.pi,
    ky: float = np.pi,
    dtype=jnp.float32,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Rotating velocity field (multigrid.cpp:222-223):

    v1 = -ky*sin(kx*x)*cos(ky*y)   (x/row component, couples i±1)
    v2 =  kx*cos(kx*x)*sin(ky*y)   (y/col component, couples j±1)
    """
    x, y = _node_coords(n, np.float64)
    v1 = -ky * np.sin(kx * x) * np.cos(ky * y)
    v2 = kx * np.cos(kx * x) * np.sin(ky * y)
    return jnp.asarray(v1, dtype=dtype), jnp.asarray(v2, dtype=dtype)


# ---------------------------------------------------------------------------
# device-side (iota) field generation — the shard-aware construction path
#
# The analytic problem fields (multigrid.cpp:219-223) are pure formulas of
# the node coordinates, so they can be generated ON DEVICE from
# broadcasted_iota with zero host↔device transfer — and, generated under a
# jit with out_shardings, each device/process materializes ONLY its own
# shard (`make_global` needs the full array on every host — ~2.2 GB per f64
# array at n=16384).  These are trace-time builders
# meant to be called INSIDE a jitted constructor (mg/levels.py::
# build_hierarchy_device); the numpy twins above remain the x64 oracle
# (agreement is ulp-level, not bit-exact: XLA's sin/cos vs libm).
# ---------------------------------------------------------------------------


def _iota_coords(n: int, shape: tuple[int, int], compute_dtype):
    """x[i,j] = i*h, y[i,j] = j*h on the padded grid, plus the row/col index
    planes — the device twin of `_node_coords` (the same correctly-rounded
    i*h products when compute_dtype is f64; under a no-x64 runtime the
    build computes in f32 and drifts multiple ulps from the host oracle —
    the model warns, models/advection_diffusion.py)."""
    import jax

    r = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    c = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    h = jnp.asarray(1.0 / n, compute_dtype)
    return r, c, r.astype(compute_dtype) * h, c.astype(compute_dtype) * h


def rotating_velocity_trace(n, kx, ky, shape, compute_dtype, out_dtype):
    """Trace-time padded rotating-velocity fields (multigrid.cpp:222-223):
    zero outside the logical (n+1)² node grid (the padded-layout invariant
    `_np_pad_field` establishes by zero-padding)."""
    r, c, x, y = _iota_coords(n, shape, compute_dtype)
    inside = (r <= n) & (c <= n)
    zero = jnp.asarray(0, compute_dtype)
    v1 = jnp.where(inside, -ky * jnp.sin(kx * x) * jnp.cos(ky * y), zero)
    v2 = jnp.where(inside, kx * jnp.cos(kx * x) * jnp.sin(ky * y), zero)
    return v1.astype(out_dtype), v2.astype(out_dtype)


def gaussian_u0_trace(n, x0, y0, sigma, shape, compute_dtype, out_dtype):
    """Trace-time padded Gaussian IC (multigrid.cpp:219 + full boundary
    zeroing, SURVEY §2.9.4): zero on the boundary ring AND outside the
    logical grid."""
    r, c, x, y = _iota_coords(n, shape, compute_dtype)
    interior = (r >= 1) & (r <= n - 1) & (c >= 1) & (c <= n - 1)
    u0 = jnp.exp(-sigma * ((x - x0) ** 2 + (y - y0) ** 2))
    return jnp.where(interior, u0, jnp.asarray(0, compute_dtype)).astype(
        out_dtype
    )


def gaussian_u0_padded_device(
    n: int,
    x0: float = 0.2,
    y0: float = 0.4,
    sigma: float = 100.0,
    dtype=jnp.float32,
    sharding=None,
) -> jnp.ndarray:
    """Padded-layout Gaussian IC generated on device (one jitted iota
    program — the device twin of pad_field(gaussian_u0(...))); with
    `sharding`, born sharded with no host materialization anywhere."""
    import jax

    from hpcmg.core.layout import padded_shape

    cdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    shape = padded_shape(n)

    def build():
        return gaussian_u0_trace(n, x0, y0, sigma, shape, cdtype, dtype)

    return jax.jit(build, out_shardings=sharding)()


class CNCoefficients(NamedTuple):
    """Interior-node coefficient fields of the CN 5-point operators.

    All arrays have shape (n-1, n-1): value at interior node (i, j) =
    array[i-1, j-1].  Coefficient formulas from gs.cpp:9-20 with
    r = dt/(2h^2):

      aa = r(−v2·h/2 + ν)  → couples u[i, j−1]
      bb = r(+v2·h/2 + ν)  → couples u[i, j+1]
      cc = r(−v1·h/2 + ν)  → couples u[i−1, j]
      dd = r(+v1·h/2 + ν)  → couples u[i+1, j]

    Implicit operator  (A u)_ij = (1 − 4rν) u_ij + cc·u_{i−1,j} + dd·u_{i+1,j}
                                  + aa·u_{i,j−1} + bb·u_{i,j+1}   (gs.cpp:75)
    Explicit operator  (B u)_ij = (1 + 4rν) u_ij − (same neighbor sum)
                                  (gs.cpp:44)
    """

    aa: jnp.ndarray   # west  (j-1) coefficient
    bb: jnp.ndarray   # east  (j+1)
    cc: jnp.ndarray   # north (i-1)
    dd: jnp.ndarray   # south (i+1)
    diag_a: float     # A diagonal: 1 - 4 r nu
    diag_b: float     # B diagonal: 1 + 4 r nu


def cn_coefficients(
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    dt: float,
    nu: float,
    h: float,
) -> CNCoefficients:
    """Precompute interior coefficient fields for one grid level.

    The reference recomputes these per point inside every kernel
    (gs.cpp:126-129); here they are precomputed once per level so the hot kernels
    are pure stencil applies.
    """
    rr = 0.5 * dt / (h * h)
    v1i = v1[1:-1, 1:-1]
    v2i = v2[1:-1, 1:-1]
    half_h = 0.5 * h
    aa = rr * (-v2i * half_h + nu)
    bb = rr * (v2i * half_h + nu)
    cc = rr * (-v1i * half_h + nu)
    dd = rr * (v1i * half_h + nu)
    return CNCoefficients(aa, bb, cc, dd, 1.0 - 4.0 * rr * nu, 1.0 + 4.0 * rr * nu)


def cn_coefficients_padded(
    v1_p: jnp.ndarray,
    v2_p: jnp.ndarray,
    n: int,
    dt: float,
    nu: float,
    h: float,
) -> CNCoefficients:
    """Padded-layout variant of `cn_coefficients` (core/layout.py).

    Inputs are padded velocity fields; outputs are full padded-shape
    coefficient arrays that are ZERO outside the open interior — the masking
    invariant that makes every padded kernel mask-free (ops/padded.py).
    """
    from hpcmg.core.layout import interior_mask

    rr = 0.5 * dt / (h * h)
    half_h = 0.5 * h
    mask = interior_mask(n, v1_p.shape, dtype=v1_p.dtype)
    aa = rr * (-v2_p * half_h + nu) * mask
    bb = rr * (v2_p * half_h + nu) * mask
    cc = rr * (-v1_p * half_h + nu) * mask
    dd = rr * (v1_p * half_h + nu) * mask
    return CNCoefficients(aa, bb, cc, dd, 1.0 - 4.0 * rr * nu, 1.0 + 4.0 * rr * nu)
