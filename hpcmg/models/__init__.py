from hpcmg.models.advection_diffusion import AdvectionDiffusion
from hpcmg.models.poisson import (
    Poisson,
    build_poisson_hierarchy,
    poisson_level,
)

__all__ = [
    "AdvectionDiffusion",
    "Poisson",
    "build_poisson_hierarchy",
    "poisson_level",
]
