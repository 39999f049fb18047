from hpcmg.mg.levels import Level, build_fine_level, build_hierarchy
from hpcmg.mg.cycle import (
    fmg_solve,
    mg_cycle,
    mg_solve,
    mg_solve_fixed,
)
from hpcmg.mg.refine import refined_solve
from hpcmg.mg.timestepper import timestepper

__all__ = [
    "Level", "build_fine_level", "build_hierarchy",
    "fmg_solve", "mg_cycle", "mg_solve", "mg_solve_fixed", "refined_solve",
    "timestepper",
]
