"""Explicit-matrix path: DIA stencil operators + Galerkin RAP coarse
operators (SURVEY §7.4).  For a structured grid the DIA format — one padded
band array per stencil offset — IS the sparse format: SpMV is the
shift-multiply-add of ops/padded.py with no gathers."""

from hpcmg.sparse.galerkin import (
    attach_dense_inverse,
    dense_interior_matrix_9pt,
    galerkin_coarse_level,
)
from hpcmg.sparse.matrix import (
    level_to_bcoo,
    level_to_bcsr,
    spmv_apply,
    spmv_residual,
)

__all__ = [
    "attach_dense_inverse",
    "dense_interior_matrix_9pt",
    "galerkin_coarse_level",
    "level_to_bcoo",
    "level_to_bcsr",
    "spmv_apply",
    "spmv_residual",
]
