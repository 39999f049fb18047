from hpcmg.core.problem import (
    gaussian_u0,
    rotating_velocity,
    cn_coefficients,
)

__all__ = ["gaussian_u0", "rotating_velocity", "cn_coefficients"]
