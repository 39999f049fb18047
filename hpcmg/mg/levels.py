"""Grid-level hierarchy: the Level pytree and its constructor.

The reference builds "towers" of raw pointers per level inside `timestepper`
(multigrid.cpp:130-160).  Here a level is an immutable pytree holding the
precomputed interior coefficient fields of its CN operator, so the cycle is a
pure function over a tuple of Levels (static depth → the V/W recursion unrolls
at trace time into one XLA program).

Divergence from the reference (intentional, SURVEY §2.9.1): the reference's
velocity restriction uses a loop-invariant size `ni = (n>>1)+1`
(multigrid.cpp:148-157), mis-sampling every level below the second; we restrict
each level from the previous one with the correct per-level size — the
behavior the code intended.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hpcmg.core.layout import padded_shape


def _static(**kw):
    return dataclasses.field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Level:
    """One grid level: (n+1)^2 nodes, h = 2^lvl / n_fine.

    All arrays use the padded layout (core/layout.py): full padded shape
    `padded_shape(n)`, coefficients zero outside the open interior.
    Diagonals are python floats (compile-time constants — they depend only on
    dt, nu, h).
    """

    # data leaves
    aa: jnp.ndarray
    bb: jnp.ndarray
    cc: jnp.ndarray
    dd: jnp.ndarray
    v1: jnp.ndarray            # velocity fields kept for kernels that
    v2: jnp.ndarray            # recompute coefficients on the fly
    a_inv: Optional[jnp.ndarray]  # dense inverse of interior A (coarsest only)
    # Galerkin 9-point extension (sparse/galerkin.py): corner couplings and a
    # spatially-varying diagonal (None -> rediscretized 5-point level whose
    # diagonal is the compile-time scalar diag_a)
    ne: Optional[jnp.ndarray] = None   # couples u[i-1, j+1]
    nw: Optional[jnp.ndarray] = None   # couples u[i-1, j-1]
    se: Optional[jnp.ndarray] = None   # couples u[i+1, j+1]
    sw: Optional[jnp.ndarray] = None   # couples u[i+1, j-1]
    diag: Optional[jnp.ndarray] = None  # diagonal of A (1 outside interior)
    # static metadata
    n: int = _static(default=0)
    h: float = _static(default=0.0)
    dt: float = _static(default=0.0)
    nu: float = _static(default=0.0)
    diag_a: float = _static(default=1.0)
    diag_b: float = _static(default=1.0)

    @property
    def shape(self) -> tuple[int, int]:
        """Logical node-grid shape."""
        return (self.n + 1, self.n + 1)

    @property
    def padded(self) -> tuple[int, int]:
        """Padded storage shape (= the shape of every array in this level)."""
        return (self.aa if self.aa is not None else self.v1).shape


def dense_interior_matrix(level: Level) -> np.ndarray:
    """Assemble the dense interior operator A ((n-1)^2 x (n-1)^2), numpy.

    Row-major interior ordering p = (i-1)*(n-1) + (j-1).  Used for the exact
    coarse solve (the capability the reference abandoned in exact_solve.cpp)
    and as the oracle for the sparse/CSR path tests.
    """
    m = level.n - 1
    # crop the padded coefficient fields to the interior block (node (i,j) at
    # padded index [i,j] -> interior array index [i-1, j-1])
    nn = level.n
    aa = np.asarray(level.aa, dtype=np.float64)[1:nn, 1:nn]
    bb = np.asarray(level.bb, dtype=np.float64)[1:nn, 1:nn]
    cc = np.asarray(level.cc, dtype=np.float64)[1:nn, 1:nn]
    dd = np.asarray(level.dd, dtype=np.float64)[1:nn, 1:nn]
    A = np.zeros((m * m, m * m))
    idx = np.arange(m * m)
    A[idx, idx] = level.diag_a
    ii, jj = np.divmod(idx, m)
    north = ii >= 1          # couples interior (i-1, j)
    A[idx[north], idx[north] - m] = cc[ii[north], jj[north]]
    south = ii <= m - 2
    A[idx[south], idx[south] + m] = dd[ii[south], jj[south]]
    west = jj >= 1
    A[idx[west], idx[west] - 1] = aa[ii[west], jj[west]]
    east = jj <= m - 2
    A[idx[east], idx[east] + 1] = bb[ii[east], jj[east]]
    return A


# ---------------------------------------------------------------------------
# host-side (numpy) construction helpers
#
# Hierarchy construction is SETUP, not compute: doing it with eager jax ops
# would dispatch hundreds of tiny programs.  Everything here runs in float64
# numpy and is cast to the target dtype once, at Level creation.
# ---------------------------------------------------------------------------


def _np_pad_field(u: np.ndarray) -> np.ndarray:
    n = u.shape[0] - 1
    r, c = padded_shape(n)
    return np.pad(u, ((0, r - u.shape[0]), (0, c - u.shape[1])))


def _np_interior_mask(n: int, shape) -> np.ndarray:
    r = np.arange(shape[0])[:, None]
    c = np.arange(shape[1])[None, :]
    return (((r >= 1) & (r <= n - 1)) & ((c >= 1) & (c <= n - 1))).astype(np.float64)


def _np_cn_coefficients(v1p, v2p, n, dt, nu, h):
    """Numpy twin of core.problem.cn_coefficients_padded (same formulas,
    gs.cpp:9-20)."""
    rr = 0.5 * dt / (h * h)
    half_h = 0.5 * h
    mask = _np_interior_mask(n, v1p.shape)
    return {
        "aa": rr * (-v2p * half_h + nu) * mask,
        "bb": rr * (v2p * half_h + nu) * mask,
        "cc": rr * (-v1p * half_h + nu) * mask,
        "dd": rr * (v1p * half_h + nu) * mask,
        "diag_a": 1.0 - 4.0 * rr * nu,
        "diag_b": 1.0 + 4.0 * rr * nu,
    }


def _np_restrict_inject(fine: np.ndarray, coarse_shape) -> np.ndarray:
    s = fine[::2, ::2][: coarse_shape[0], : coarse_shape[1]]
    return np.pad(
        s, ((0, coarse_shape[0] - s.shape[0]), (0, coarse_shape[1] - s.shape[1]))
    )


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("n", "dt", "nu", "h", "dtype"))
def _device_cn_coefficients(v1p, v2p, *, n, dt, nu, h, dtype):
    """Device-side twin of _np_cn_coefficients: one jitted formula pass in
    f64 (correctly-rounded ops → same bits as the numpy build), so level
    construction transfers (v1, v2) instead of six arrays."""
    rr = 0.5 * dt / (h * h)
    half_h = 0.5 * h
    rows, cols = v1p.shape
    r = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 1)
    interior = ((r >= 1) & (r <= n - 1)) & ((c >= 1) & (c <= n - 1))
    mask = interior.astype(v1p.dtype)
    aa = (rr * (-v2p * half_h + nu) * mask).astype(dtype)
    bb = (rr * (v2p * half_h + nu) * mask).astype(dtype)
    cc = (rr * (-v1p * half_h + nu) * mask).astype(dtype)
    dd = (rr * (v1p * half_h + nu) * mask).astype(dtype)
    return aa, bb, cc, dd, v1p.astype(dtype), v2p.astype(dtype)


def _np_level(v1p, v2p, n, h, dt, nu, dtype) -> Level:
    rr = 0.5 * dt / (h * h)
    diag_a = float(1.0 - 4.0 * rr * nu)
    diag_b = float(1.0 + 4.0 * rr * nu)
    if jax.config.jax_enable_x64:
        # transfer the two f64 velocity arrays once; derive the four
        # coefficient arrays on-device (bit-identical: both routes are
        # correctly-rounded f64 evaluations of the same expression)
        aa, bb, cc, dd, v1d, v2d = _device_cn_coefficients(
            jnp.asarray(v1p, jnp.float64), jnp.asarray(v2p, jnp.float64),
            n=n, dt=dt, nu=nu, h=h, dtype=jnp.dtype(dtype),
        )
        return Level(
            aa=aa, bb=bb, cc=cc, dd=dd, v1=v1d, v2=v2d, a_inv=None,
            n=n, h=h, dt=dt, nu=nu,
            diag_a=diag_a, diag_b=diag_b,
        )
    coef = _np_cn_coefficients(v1p, v2p, n, dt, nu, h)
    as_dev = lambda a: jnp.asarray(a, dtype)
    return Level(
        aa=as_dev(coef["aa"]), bb=as_dev(coef["bb"]),
        cc=as_dev(coef["cc"]), dd=as_dev(coef["dd"]),
        v1=as_dev(v1p), v2=as_dev(v2p), a_inv=None,
        n=n, h=h, dt=dt, nu=nu,
        diag_a=float(coef["diag_a"]), diag_b=float(coef["diag_b"]),
    )


def build_fine_level(
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    dt: float,
    nu: float,
    dtype=jnp.float64,
    store_coefficients: bool = True,
) -> Level:
    """Build only the finest level's operator at `dtype` — the high-precision
    operator used by mixed-precision iterative refinement (mg/refine.py) for
    residuals and the CN right-hand side.

    `store_coefficients=False` builds a SLIM level: only (v1, v2) are
    stored and aa..dd are None — consumers recompute coefficients on the
    fly via ops/padded.py::neighbor_sum_auto (bit-identical in IEEE f64).
    At n=8192 the six f64 coefficient arrays cost 3.3 GB of HBM (13 GB at
    n=16384) for a handful of certificate stencils per run; the slim form
    trades those reads for arithmetic."""
    n = v1.shape[0] - 1
    v1p = _np_pad_field(np.asarray(v1, np.float64))
    v2p = _np_pad_field(np.asarray(v2, np.float64))
    if store_coefficients:
        return _np_level(v1p, v2p, n, 1.0 / n, dt, nu, dtype)
    h = 1.0 / n
    rr = 0.5 * dt / (h * h)
    as_dev = lambda a: jnp.asarray(a, dtype)
    return Level(
        aa=None, bb=None, cc=None, dd=None,
        v1=as_dev(v1p), v2=as_dev(v2p), a_inv=None,
        n=n, h=h, dt=dt, nu=nu,
        diag_a=float(1.0 - 4.0 * rr * nu),
        diag_b=float(1.0 + 4.0 * rr * nu),
    )


# ---------------------------------------------------------------------------
# device-side (shard-aware) construction
#
# The host-numpy builders above are the x64 ORACLE and the default at small
# n.  At large n they hit two walls the reference never faces: host→device
# transfer of every level and full-size host materialization
# (parallel/distributed.py::make_global needs the whole array on EVERY
# process — ~2.2 GB per f64 array at n=16384).  The problem fields are
# analytic (core/problem.py), and injection restriction of node-sampled
# analytic fields IS direct sampling at the coarse nodes (the module
# docstring above), so every level can be generated independently on device
# from iota — ONE jitted program, zero transfer, and with `shardings` each
# device/process materializes only its own slab.  Agreement with the numpy
# build is ulp-level (XLA sin/cos vs libm), pinned by tests/test_levels_
# device.py; the numpy path remains the oracle.
# ---------------------------------------------------------------------------


def _hierarchy_meta(n: int, num_levels: int):
    meta = []
    for lvl in range(num_levels):
        nl = n >> lvl
        if nl < 2:
            raise ValueError(
                f"num_levels={num_levels} too deep for n={n} (level {lvl} has n={nl})"
            )
        h = 1.0 / n * (1 << lvl)
        meta.append((nl, h))
    return meta


def build_hierarchy_device(
    n: int,
    kx: float,
    ky: float,
    dt: float,
    nu: float,
    num_levels: int,
    dtype=jnp.float32,
    coarse_mode: str = "gs",
    coarse_operator: str = "rediscretize",
    shardings=None,
) -> tuple[Level, ...]:
    """`build_hierarchy` generated entirely on device: one jitted program
    emits every level's (aa..dd, v1, v2) from iota + the analytic formulas
    (multigrid.cpp:222-223 via core/problem.py::rotating_velocity_trace).

    `shardings` (optional, one per level — parallel/sharding.py::
    level_shardings) become the program's out_shardings: under a mesh, each
    device materializes only its shard of each level, and under a
    multi-process runtime no host ever holds a full-size array (the
    make_global lifting path is bypassed entirely).

    Galerkin coarse operators need the fine operator's RAP product and keep
    the host build (coarse levels are small and agglomerate anyway)."""
    if coarse_operator != "rediscretize":
        raise ValueError(
            "build_hierarchy_device supports coarse_operator='rediscretize' "
            "only (Galerkin RAP levels are built host-side — they are coarse "
            "and replicated under distribution)"
        )
    from hpcmg.core.problem import (
        rotating_velocity_trace,
    )

    meta = _hierarchy_meta(n, num_levels)
    cdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def build():
        out = []
        for nl, h in meta:
            shape = padded_shape(nl)
            v1, v2 = rotating_velocity_trace(nl, kx, ky, shape, cdtype,
                                             cdtype)
            out.append(
                _device_cn_coefficients(
                    v1, v2, n=nl, dt=dt, nu=nu, h=h, dtype=jnp.dtype(dtype)
                )
            )
        return tuple(out)

    out_sh = None
    if shardings is not None:
        out_sh = tuple(tuple([s] * 6) for s in shardings)
    leaves = jax.jit(build, out_shardings=out_sh)()

    levels = []
    for (nl, h), (aa, bb, cc, dd, v1d, v2d) in zip(meta, leaves):
        rr = 0.5 * dt / (h * h)
        levels.append(Level(
            aa=aa, bb=bb, cc=cc, dd=dd, v1=v1d, v2=v2d, a_inv=None,
            n=nl, h=h, dt=dt, nu=nu,
            diag_a=float(1.0 - 4.0 * rr * nu),
            diag_b=float(1.0 + 4.0 * rr * nu),
        ))
    if coarse_mode == "dense":
        # the coarsest level is small (32² at the reference heuristic); the
        # host round-trip for its dense inverse is a few hundred KB.  Under
        # a mesh the coarsest MAY still be partitioned (tiny meshes /
        # min_local), and under a multi-process runtime a partitioned
        # global array cannot be np.asarray'd — allgather the coefficient
        # fields, invert on host, and lift the inverse back replicated.
        bottom = levels[-1]
        if shardings is None:
            from hpcmg.sparse.galerkin import (
                attach_dense_inverse,
            )

            levels[-1] = attach_dense_inverse(bottom)
        else:
            from jax.sharding import NamedSharding, PartitionSpec

            from hpcmg.parallel.distributed import (
                fetch,
                make_global,
            )
            from hpcmg.sparse.galerkin import (
                attach_dense_inverse,
            )

            host = attach_dense_inverse(dataclasses.replace(
                bottom,
                aa=fetch(bottom.aa), bb=fetch(bottom.bb),
                cc=fetch(bottom.cc), dd=fetch(bottom.dd),
                v1=fetch(bottom.v1), v2=fetch(bottom.v2),
            ))
            repl = NamedSharding(shardings[-1].mesh, PartitionSpec())
            levels[-1] = dataclasses.replace(
                bottom, a_inv=make_global(np.asarray(host.a_inv), repl),
            )
    return tuple(levels)


def build_fine_level_device(
    n: int,
    kx: float,
    ky: float,
    dt: float,
    nu: float,
    dtype=jnp.float64,
    store_coefficients: bool = True,
    sharding=None,
) -> Level:
    """`build_fine_level` (the high-precision / slim operator) generated on
    device — see build_hierarchy_device.  With store_coefficients=False only
    (v1, v2) are emitted (the slim n>=8192 form)."""
    from hpcmg.core.problem import (
        rotating_velocity_trace,
    )

    h = 1.0 / n
    rr = 0.5 * dt / (h * h)
    cdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    shape = padded_shape(n)

    def build():
        v1, v2 = rotating_velocity_trace(n, kx, ky, shape, cdtype, cdtype)
        if store_coefficients:
            return _device_cn_coefficients(
                v1, v2, n=n, dt=dt, nu=nu, h=h, dtype=jnp.dtype(dtype)
            )
        return v1.astype(dtype), v2.astype(dtype)

    n_out = 6 if store_coefficients else 2
    out_sh = None if sharding is None else tuple([sharding] * n_out)
    leaves = jax.jit(build, out_shardings=out_sh)()
    if store_coefficients:
        aa, bb, cc, dd, v1d, v2d = leaves
    else:
        aa = bb = cc = dd = None
        v1d, v2d = leaves
    return Level(
        aa=aa, bb=bb, cc=cc, dd=dd, v1=v1d, v2=v2d, a_inv=None,
        n=n, h=h, dt=dt, nu=nu,
        diag_a=float(1.0 - 4.0 * rr * nu),
        diag_b=float(1.0 + 4.0 * rr * nu),
    )


def build_hierarchy(
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    dt: float,
    nu: float,
    num_levels: int,
    dtype=jnp.float32,
    coarse_mode: str = "gs",
    coarse_operator: str = "rediscretize",
    restriction: str = "inject",
) -> tuple[Level, ...]:
    """Build the level tower from the finest velocity fields.

    Velocities are restricted downward once by injection (the reference's
    choice, multigrid.cpp:155-157, with the size bug fixed) — for node-sampled
    analytic fields injection is exact sampling at coarse nodes.

    coarse_operator "rediscretize" re-derives CN coefficients from the
    restricted velocities on every level (the reference's scheme);
    "galerkin" builds each coarse operator as the exact R·A·P product
    (sparse/galerkin.py — 9-point DIA levels; `restriction` selects R).
    """
    n = v1.shape[0] - 1
    levels = []
    v1l = _np_pad_field(np.asarray(v1, np.float64))
    v2l = _np_pad_field(np.asarray(v2, np.float64))
    for lvl in range(num_levels):
        nl = n >> lvl
        if nl < 2:
            raise ValueError(
                f"num_levels={num_levels} too deep for n={n} (level {lvl} has n={nl})"
            )
        h = 1.0 / n * (1 << lvl)
        if lvl > 0 and coarse_operator == "galerkin":
            from hpcmg.sparse.galerkin import (
                galerkin_coarse_level,
            )

            level = galerkin_coarse_level(
                levels[-1], restriction,
                jnp.asarray(v1l, dtype), jnp.asarray(v2l, dtype),
            )
        else:
            level = _np_level(v1l, v2l, nl, h, dt, nu, dtype)
        levels.append(level)
        if lvl + 1 < num_levels:
            shape_c = padded_shape(nl >> 1)
            v1l = _np_restrict_inject(v1l, shape_c)
            v2l = _np_restrict_inject(v2l, shape_c)

    if coarse_mode == "dense":
        from hpcmg.sparse.galerkin import (
            attach_dense_inverse,
        )

        levels[-1] = attach_dense_inverse(levels[-1])
    return tuple(levels)
