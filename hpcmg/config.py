"""Configuration dataclasses.

The reference hard-codes every parameter in each `main` (multigrid.cpp:192-241:
N, maxlvl, nu, dt, T, tol, shape; NITER=3 at multigrid.cpp:41; MAX_CYCLE=50 at
:94; coarse-solve 1e-5/1000 at :60).  Here they are all first-class, with the
reference defaults reproduced exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """The 2-D advection–diffusion problem on [0,1]^2 with Dirichlet BCs.

    u_t + v·∇u + ν∇²u = 0 with ν passed negative (multigrid.cpp:235), i.e.
    physical diffusion |ν|.  Defaults reproduce the reference default problem
    (multigrid.cpp:192-241).
    """

    n: int = 256                  # finest grid: (n+1)^2 nodes, h = 1/n; power of 2
    nu: float = -4e-4             # diffusion parameter (negative by convention)
    x0: float = 0.2               # Gaussian IC center x (multigrid.cpp:206)
    y0: float = 0.4               # Gaussian IC center y
    sigma: float = 100.0          # Gaussian IC width
    kx: float = math.pi           # rotating-velocity wavenumbers (multigrid.cpp:208-209)
    ky: float = math.pi
    dt: Optional[float] = None    # default dx/10 (CFL, multigrid.cpp:238)
    num_steps: int = 100          # T = 100*dt (multigrid.cpp:239)

    @property
    def dx(self) -> float:
        return 1.0 / self.n

    @property
    def dt_(self) -> float:
        return self.dt if self.dt is not None else self.dx / 10.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Multigrid solver parameters (reference values cited per field)."""

    num_levels: Optional[int] = None  # default log2(n) - 4 (multigrid.cpp:193)
    cycle_shape: int = 1              # 1 = V-cycle, 2 = W-cycle (multigrid.cpp:35)
    niter: int = 3                    # pre/post smoothing sweeps (multigrid.cpp:41)
    tol: float = 1e-6                 # outer relative-residual tolerance (multigrid.cpp:240)
    max_cycles: int = 50              # MAX_CYCLE (multigrid.cpp:94)
    coarse_tol: float = 1e-5          # coarsest-level absolute residual (multigrid.cpp:60)
    coarse_maxiter: int = 1000        # coarsest-level GS iteration cap (multigrid.cpp:60)
    coarse_mode: str = "gs"           # "gs" (reference parity) | "dense" (precomputed
                                      # inverse, one matrix-vector product — new
                                      # capability, the solve exact_solve.cpp:15 was
                                      # abandoned at)
    smoother: str = "rbgs"            # "rbgs" (red-black GS) | "jacobi" (gs.cu:244
                                      # variant) | "chebyshev" (polynomial smoother —
                                      # new capability; decomposition-invariant, no
                                      # color masks; see ops/padded.py::chebyshev_smooth)
    jacobi_omega: float = 1.0         # weight for the Jacobi smoother (gs.cu:268 uses 1)
    cheby_degree: int = 3             # Chebyshev polynomial degree per "sweep"
    cheby_lower: float = 1.0 / 30.0   # smoothing band [lower, upper]·λ̂(D⁻¹A)
    cheby_upper: float = 1.1
    restriction: str = "inject"       # "inject" (reference, gs.cpp:283) | "full" (the
                                      # full-weighting variant left commented at gs.cpp:277-280)
    coarse_operator: str = "rediscretize"  # "rediscretize" (reference) | "galerkin" (RAP)
    dtype: jnp.dtype = jnp.float32
    cycle_mode: str = "adaptive"      # "adaptive": outer lax.while_loop to tol, the
                                      # reference mg_outer semantics (multigrid.cpp:108).
                                      # "fixed": exactly `num_cycles` cycles per solve
                                      # (scan-only program; the residual certificate
                                      # is still computed in stats).
                                      # "fmg": full multigrid / nested iteration — coarse-
                                      # to-fine opening + `num_cycles` cycles per level
                                      # (mg/cycle.py::fmg_solve; new capability)
    num_cycles: Optional[int] = 2     # cycles per solve in fixed mode;
                                      # None = derive at trace time from the
                                      # diagonal-dominance model
                                      # (resolved_num_cycles — the automatic
                                      # cycle-count safety the adaptive outer
                                      # loop cannot provide in delta mode)
    refine_dtype: Optional[jnp.dtype] = None
                                      # mixed-precision iterative refinement: when set
                                      # (e.g. float64), u/rhs/residuals live in this
                                      # dtype and each cycle solves the error equation
                                      # A e = r in `dtype` — reference-accuracy (1e-6)
                                      # convergence certificates with f32 compute for
                                      # all the heavy smoothing work
    delta_form: bool = False          # delta (incremental) CN stepping (mg/delta.py):
                                      # solve A·δ = dt·L·u in `dtype` (f32) and
                                      # accumulate u += δ in `refine_dtype` — zero
                                      # high-precision stencil work per step; requires
                                      # refine_dtype set and cycle_mode="fixed"
    slim_hi_operator: Optional[bool] = None
                                      # store the high-precision (refine_dtype)
                                      # fine operator as velocities only,
                                      # recomputing coefficients on the fly
                                      # (bit-identical in f64).  None = auto:
                                      # slim at n >= 8192, where the six f64
                                      # coefficient arrays would cost 3.3+ GB
                                      # of HBM for a few certificate stencils
    device_build: Optional[bool] = None
                                      # generate the model (all levels'
                                      # coefficient/velocity fields, the
                                      # high-precision operator and u0) ON
                                      # DEVICE from iota + the analytic
                                      # formulas (mg/levels.py::
                                      # build_hierarchy_device) instead of
                                      # host numpy.  None = auto: device at
                                      # n >= 4096 (where building and
                                      # transferring host arrays dominates
                                      # set-up) when the coarse operator
                                      # permits.  Under a mesh the
                                      # levels are born sharded: no host
                                      # ever materializes a full-size array.
                                      # The numpy build remains the x64
                                      # oracle (agreement is ulp-level:
                                      # XLA sin/cos vs libm).
    certify_every: int = 0            # delta mode: every k-th step additionally
                                      # recomputes the step's TRUE residual in
                                      # refine_dtype inside the scan (two f64
                                      # stencil passes per k steps) — the rigorous
                                      # mid-run certificate (the f32 delta-scale
                                      # certificate alone can stay green while the
                                      # true residual fails).
                                      # 0 = final step only (the f64 epilogue)

    def __post_init__(self):
        _check = {
            "cycle_mode": ("adaptive", "fixed", "fmg"),
            "smoother": ("rbgs", "jacobi", "chebyshev"),
            "restriction": ("inject", "full"),
            "coarse_mode": ("gs", "dense"),
            "coarse_operator": ("rediscretize", "galerkin"),
        }
        for field, allowed in _check.items():
            val = getattr(self, field)
            if val not in allowed:
                raise ValueError(f"{field}={val!r} not in {allowed}")
        if self.delta_form and (
            self.refine_dtype is None or self.cycle_mode != "fixed"
        ):
            raise ValueError(
                "delta_form requires refine_dtype set and cycle_mode='fixed' "
                "(the f64 state accumulator and a static cycle count)"
            )
        if self.num_cycles is not None and self.num_cycles < 1:
            raise ValueError(
                f"num_cycles={self.num_cycles}: need >= 1, or None for the "
                "auto derivation (resolved_num_cycles)"
            )
        if self.certify_every and not self.delta_form:
            # only the delta stepper implements mid-run rigorous
            # certification; silently ignoring the request would let a user
            # believe they got certificates they didn't
            import warnings

            warnings.warn(
                "certify_every is only honored by the delta stepper "
                "(delta_form=True); this configuration will compute no "
                "mid-run rigorous certificates",
                stacklevel=2,
            )

    def resolved_num_cycles(self, dt: float, nu: float, h: float) -> int:
        """Cycle count for fixed/delta modes when `num_cycles` is None (auto):
        the smallest k whose predicted residual clears tol/2, from the
        diagonal-dominance model.

        The CN operator's off-diagonal mass is δ = 4r|ν| with r = dt/(2h²)
        (gs.cpp:9-20; at the reference defaults dt = h/10, δ = 8e-5·n — the
        operator loses diagonal dominance as n grows, and the one-cycle
        residual grows with it).  One-cycle rigorous f64 certificates of the
        delta stepper, taken on the accelerator this solver was first built
        for (numerics, not speed; to be re-anchored on the GPU):

            n=1024  δ=0.082  7.5e-8      n=4096  δ=0.328  7.8e-7
            n=2048  δ=0.164  7.6e-8      n=8192  δ=0.655  8.8e-5 (FAILS 1e-6)

        Power-law fit through the two unfloored anchors: rel1(δ) = A·δ^p with
        p = ln(8.8e-5/7.8e-7)/ln 2 ≈ 6.82, A ≈ 1.58e-3; small-δ floor 1.2e-7
        (the f32-solve resolution, measured 7.5–9.3e-8 across sizes).  A 4×
        safety factor on the power-law term makes the prediction one-sided;
        k cycles contract to max(floor, rel1^k).  Calibrated at niter=3
        (the reference NITER); fewer smoothing sweeps get one extra cycle.

        This reproduces every measured choice: 1 cycle at n≤2048, 2 at
        n=4096 (whose measured 7.8e-7 sits over tol/2 — previously shipped
        uncertified at 1 cycle) and n=8192, and escalates further at
        n=16384 (δ>1: no longer diagonally dominant)."""
        delta_dom = 4.0 * (0.5 * dt / (h * h)) * abs(nu)
        rel1 = max(1.2e-7, 4.0 * 1.58e-3 * delta_dom ** 6.82)
        target = self.tol / 2.0
        if rel1 >= 0.5:
            # far outside the calibrated (diagonally-dominant) regime —
            # cap and let the certificate warnings catch any shortfall
            k = 6
        else:
            k = max(1, math.ceil(math.log(target) / math.log(rel1)))
        if self.niter < 3:
            k += 1
        return min(k, 6)

    def resolved_num_levels(self, n: int) -> int:
        if self.num_levels is not None:
            return self.num_levels
        # reference heuristic: maxlvl = log2(N) - 4 so the coarsest grid is 32^2
        # (multigrid.cpp:193; its comment says 16 but the math gives 32, SURVEY §2.9.6)
        lvl = int(math.log2(n)) - 4
        return max(lvl, 1)
