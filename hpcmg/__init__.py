"""hpcmg — a geometric-multigrid framework in JAX.

A from-scratch JAX / XLA re-design of the capabilities of
soniareilly/HPCClassMultigridProject (an NYU HPC-class 2-D advection–diffusion
Crank–Nicolson multigrid solver in C++/OpenMP/CUDA; see SURVEY.md).

Layer map:
  core/       grid geometry, problem setup, stencil coefficient fields
  ops/        level kernels (smooth, residual, rhs, transfer) — logical-shape
              jnp oracles and the padded-layout production kernels
  sparse/     explicit-matrix path: CSR/BSR SpMV + Galerkin RAP coarse operators
  mg/         level hierarchy, V/W-cycles, coarse solves, CN timestepper
  parallel/   device-mesh domain decomposition (GSPMD shardings, shard_map halo
              exchange, coarse-level agglomeration)
  models/     problem families (advection–diffusion flagship, Poisson)
  utils/      io / timing / profiling / checkpointing / process set-up
  native/     C++ host runtime: bit-faithful CPU oracle kernels (ctypes)
"""

__version__ = "0.1.0"

from hpcmg.config import ProblemConfig, SolverConfig
from hpcmg.mg.levels import Level, build_hierarchy
from hpcmg.mg.cycle import mg_cycle, mg_solve
from hpcmg.mg.timestepper import timestepper

__all__ = [
    "ProblemConfig",
    "SolverConfig",
    "Level",
    "build_hierarchy",
    "mg_cycle",
    "mg_solve",
    "timestepper",
]
