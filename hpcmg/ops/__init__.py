from hpcmg.ops.stencil import (
    neighbor_sum,
    apply_A,
    apply_B,
    compute_rhs,
    residual,
    interior_norm,
)
from hpcmg.ops.smoothers import rb_gauss_seidel, weighted_jacobi
from hpcmg.ops.transfer import (
    restrict_inject,
    restrict_full_weighting,
    prolong_bilinear,
)
from hpcmg.ops import padded

__all__ = [
    "padded",
    "neighbor_sum",
    "apply_A",
    "apply_B",
    "compute_rhs",
    "residual",
    "interior_norm",
    "rb_gauss_seidel",
    "weighted_jacobi",
    "restrict_inject",
    "restrict_full_weighting",
    "prolong_bilinear",
]
