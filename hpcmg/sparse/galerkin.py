"""Galerkin coarse operators: A_c = R·A_f·P extracted to DIA stencil bands.

The reference rediscretizes the PDE on every level (multigrid.cpp:149-160 via
the restricted velocity fields); the Galerkin product is the algebraically
consistent alternative it never implemented (the north-star "SpMM Galerkin
RAP" capability, SURVEY §7.4).  The natural sparse format for a
structured-grid operator is DIA — one padded-layout band array per stencil
offset — because SpMV is then exactly the shift-multiply-add pattern of
ops/padded.py (elementwise, no gather).

RAP of the 5-point CN operator under bilinear prolongation is a 9-POINT
coarse operator, so coarse levels built here carry the four corner bands
(Level.ne/nw/se/sw) and a spatially-varying diagonal (Level.diag).

Extraction uses period-3 comb probing: applying C = R∘A_f∘P to the nine comb
indicators e_{k,l}[I,J] = [I≡k (3)]·[J≡l (3)] recovers every stencil entry
exactly — a radius-1 stencil sees exactly one comb point per class in its
neighborhood, so (C e_{k,l})[I,J] equals the single band entry coupling
(I,J) to its neighbor of class (k,l).  Nine operator applications at setup
time, reusing the production transfer/stencil kernels themselves (so the
extracted operator is exact for the operators actually used, asserted by
tests/test_galerkin.py).

Red–black smoothing on a 9-point operator is no longer an exact two-color
Gauss–Seidel (corner neighbors share the node's color and are read at their
pre-sweep values); it remains a valid smoother and is what multigrid
practice uses short of 4-coloring.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from hpcmg.core.layout import interior_mask, padded_shape
from hpcmg.mg.levels import Level
from hpcmg.ops.padded import (
    apply_A,
    prolong_bilinear,
    restrict_full_weighting,
    restrict_inject,
)

# stencil offset -> Level band field name
_BANDS = {
    (0, -1): "aa",
    (0, 1): "bb",
    (-1, 0): "cc",
    (1, 0): "dd",
    (-1, 1): "ne",
    (-1, -1): "nw",
    (1, 1): "se",
    (1, -1): "sw",
}


def _comb(shape, k: int, l: int, n: int, dtype) -> jnp.ndarray:
    r = jnp.arange(shape[0], dtype=jnp.int32)[:, None]
    c = jnp.arange(shape[1], dtype=jnp.int32)[None, :]
    comb = ((r % 3 == k) & (c % 3 == l)).astype(dtype)
    return comb * interior_mask(n, shape, dtype=dtype)


@functools.partial(jax.jit, static_argnames=("restriction", "nc"))
def _extract_bands(fine: Level, restriction: str, nc: int):
    """The full probe-and-extract computation as ONE jitted program instead
    of many eager dispatches."""
    shape_c = padded_shape(nc)
    dtype = fine.aa.dtype

    if restriction == "inject":
        restrict = lambda x: restrict_inject(x, shape_c)
    elif restriction == "full":
        restrict = lambda x: restrict_full_weighting(x, shape_c, nc)
    else:
        raise ValueError(f"unknown restriction {restriction!r}")

    probes = {}
    for k in range(3):
        for l in range(3):
            e = _comb(shape_c, k, l, nc, dtype)
            probes[(k, l)] = restrict(apply_A(fine, prolong_bilinear(e, fine.padded)))

    r = jnp.arange(shape_c[0], dtype=jnp.int32)[:, None]
    c = jnp.arange(shape_c[1], dtype=jnp.int32)[None, :]
    mask_i = interior_mask(nc, shape_c, dtype=dtype)

    def band(di: int, dj: int) -> jnp.ndarray:
        out = jnp.zeros(shape_c, dtype)
        for (k, l), ce in probes.items():
            sel = ((r + di) % 3 == k) & ((c + dj) % 3 == l)
            out = jnp.where(sel, ce, out)
        return out * mask_i

    fields = {name: band(di, dj) for (di, dj), name in _BANDS.items()}
    diag = band(0, 0)
    # ones outside the interior keep 1/diag finite (ops/padded.py::_diag)
    fields["diag"] = jnp.where(mask_i.astype(bool), diag, jnp.ones_like(diag))
    return fields


def galerkin_coarse_level(fine: Level, restriction: str, v1_c, v2_c) -> Level:
    """Build the coarse Level whose operator is R·A_fine·P (exactly, for the
    production restrict/prolong kernels selected by `restriction`)."""
    nc = fine.n >> 1
    fields = _extract_bands(fine, restriction, nc)
    diag = fields.pop("diag")

    return Level(
        v1=v1_c, v2=v2_c, a_inv=None, diag=diag,
        n=nc, h=fine.h * 2, dt=fine.dt, nu=fine.nu,
        diag_a=fine.diag_a, diag_b=fine.diag_b,
        **fields,
    )


def dense_interior_matrix_9pt(level: Level):
    """Dense interior operator for a (possibly 9-point, varying-diagonal)
    level — generalizes mg/levels.py::dense_interior_matrix; used for the
    exact coarse solve and as the test oracle."""
    import numpy as np

    n = level.n
    m = n - 1
    A = np.zeros((m * m, m * m))
    idx = np.arange(m * m)
    ii, jj = np.divmod(idx, m)

    diag = (
        np.full((m, m), level.diag_a)
        if level.diag is None
        else np.asarray(level.diag, np.float64)[1:n, 1:n]
    )
    A[idx, idx] = diag[ii, jj]

    offs = {(0, -1): "aa", (0, 1): "bb", (-1, 0): "cc", (1, 0): "dd"}
    if level.ne is not None:
        offs.update({(-1, 1): "ne", (-1, -1): "nw", (1, 1): "se", (1, -1): "sw"})
    for (di, dj), name in offs.items():
        bandarr = np.asarray(getattr(level, name), np.float64)[1:n, 1:n]
        ok = (
            (ii + di >= 0) & (ii + di <= m - 1) & (jj + dj >= 0) & (jj + dj <= m - 1)
        )
        A[idx[ok], idx[ok] + di * m + dj] = bandarr[ii[ok], jj[ok]]
    return A


def attach_dense_inverse(level: Level) -> Level:
    """Precompute the dense interior inverse for the exact coarse solve."""
    import numpy as np

    a_inv = np.linalg.inv(dense_interior_matrix_9pt(level))
    return dataclasses.replace(
        level, a_inv=jnp.asarray(a_inv, dtype=level.aa.dtype)
    )
