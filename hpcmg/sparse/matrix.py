"""Explicit-matrix operator path: BCOO/BCSR assembly + SpMV residuals.

The north-star asks for the stencil "as an implicit CSR/BSR operator" with
SpMV residuals.  The *production* sparse format for a structured grid is DIA — the band arrays of ops/padded.py, whose
SpMV is shift-multiply-add with zero gathers — but the explicit-matrix path
matters for generality (operators that are not 5/9-point stencils, external
matrices, algebraic composition).  This module assembles the interior
operator of any Level (5-point or Galerkin 9-point) into
jax.experimental.sparse BCOO/BCSR and provides SpMV apply/residual that agree
exactly with the stencil path (tests/test_sparse_matrix.py).

Interior ordering matches mg/levels.py::dense_interior_matrix:
row-major p = (i-1)·(n-1) + (j-1).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

from hpcmg.mg.levels import Level

_OFFS_5 = {(0, -1): "aa", (0, 1): "bb", (-1, 0): "cc", (1, 0): "dd"}
_OFFS_9 = {(-1, 1): "ne", (-1, -1): "nw", (1, 1): "se", (1, -1): "sw"}


def _coo_entries(level: Level):
    """(rows, cols, vals) numpy triplets of the interior operator."""
    n = level.n
    m = n - 1
    idx = np.arange(m * m)
    ii, jj = np.divmod(idx, m)

    rows, cols, vals = [idx], [idx], []
    diag = (
        np.full(m * m, level.diag_a)
        if level.diag is None
        else np.asarray(level.diag, np.float64)[1:n, 1:n].ravel()
    )
    vals.append(diag)

    offs = dict(_OFFS_5)
    if level.ne is not None:
        offs.update(_OFFS_9)
    for (di, dj), name in offs.items():
        band = np.asarray(getattr(level, name), np.float64)[1:n, 1:n]
        ok = (
            (ii + di >= 0) & (ii + di <= m - 1) & (jj + dj >= 0) & (jj + dj <= m - 1)
        )
        rows.append(idx[ok])
        cols.append(idx[ok] + di * m + dj)
        vals.append(band[ii[ok], jj[ok]])
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def level_to_bcoo(level: Level, dtype=None) -> jsparse.BCOO:
    """Assemble the interior operator as a BCOO matrix ((n-1)², (n-1)²)."""
    rows, cols, vals = _coo_entries(level)
    dtype = dtype or level.aa.dtype
    m2 = (level.n - 1) ** 2
    mat = jsparse.BCOO(
        (jnp.asarray(vals, dtype), jnp.asarray(np.stack([rows, cols], axis=1))),
        shape=(m2, m2),
    )
    return mat.sort_indices()


def level_to_bcsr(level: Level, dtype=None) -> jsparse.BCSR:
    """CSR variant (BCSR) of the interior operator."""
    return jsparse.BCSR.from_bcoo(level_to_bcoo(level, dtype))


def _matvec(mat, x):
    """mat @ x.  A dense matrix is multiplied at HIGHEST precision: a float32
    product may otherwise run in TF32 on GPUs (about three decimal digits).
    BCOO/BCSR products are gathers and adds, which have no reduced-precision
    mode."""
    if isinstance(mat, jsparse.JAXSparse):
        return mat @ x
    return jnp.matmul(mat, x, precision=jax.lax.Precision.HIGHEST)


def spmv_apply(mat, level: Level, u_padded: jnp.ndarray) -> jnp.ndarray:
    """A·u via SpMV on the explicit matrix; u in padded layout, result in
    padded layout (zero ring/margins)."""
    n = level.n
    m = n - 1
    flat = u_padded[1:n, 1:n].reshape(m * m)
    out = _matvec(mat, flat)
    return jnp.zeros_like(u_padded).at[1:n, 1:n].set(out.reshape(m, m))


def spmv_residual(mat, level: Level, u_padded, rhs_padded) -> jnp.ndarray:
    """res = rhs − A·u via SpMV — the explicit-matrix residual path."""
    return rhs_padded - spmv_apply(mat, level, u_padded)
