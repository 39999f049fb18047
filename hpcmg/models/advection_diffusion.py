"""Flagship problem family: 2-D advection–diffusion with CN multigrid.

Bundles problem setup + hierarchy + solver into one object, replacing the
reference driver `main` (multigrid.cpp:188-293).  The default configuration is
the reference default problem (Gaussian IC at (0.2, 0.4), rotating velocity
field, nu = -4e-4, dt = dx/10, 100 steps).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hpcmg.config import ProblemConfig, SolverConfig
from hpcmg.core.layout import crop_field, pad_field
from hpcmg.core.problem import gaussian_u0, rotating_velocity
from hpcmg.mg.levels import (
    Level,
    build_fine_level,
    build_hierarchy,
)
from hpcmg.mg.timestepper import timestep, timestepper


class AdvectionDiffusion:
    """End-to-end advection–diffusion solver.

    >>> model = AdvectionDiffusion(ProblemConfig(n=256), SolverConfig())
    >>> uT, stats = model.run()
    """

    def __init__(
        self,
        problem: ProblemConfig = ProblemConfig(),
        solver: SolverConfig = SolverConfig(),
        mesh=None,
        layout: str = "auto",
        min_local: int = 64,
    ):
        self.problem = problem
        p, s = problem, solver
        if s.num_cycles is None:
            # auto cycle count from the diagonal-dominance model — the
            # trace-time analog of the reference's adaptive outer loop
            # (multigrid.cpp:108), which delta mode's fixed-cycle scan
            # cannot host (config.py::resolved_num_cycles)
            import dataclasses

            s = dataclasses.replace(
                s, num_cycles=s.resolved_num_cycles(p.dt_, p.nu, 1.0 / p.n)
            )
        self.solver = solver = s
        self.num_levels = s.resolved_num_levels(p.n)

        # device (shard-aware) construction: the fields are analytic, so at
        # large n they are generated on device from iota instead of built in
        # host numpy and transferred (mg/levels.py device-construction
        # block).  Auto: device at n >= 4096 — but only
        # under x64, where the device build computes in f64 like the host
        # oracle; without x64 the trace would evaluate sin/cos/iota*h in
        # f32 and silently shift existing f32 configs' results.
        dev = s.device_build
        if dev is None:
            dev = (p.n >= 4096 and s.coarse_operator == "rediscretize"
                   and jax.config.jax_enable_x64)
        elif dev and not jax.config.jax_enable_x64:
            import warnings

            warnings.warn(
                "device_build without jax_enable_x64 constructs the model "
                "in f32 compute (multi-ulp drift vs the f64 host oracle); "
                "enable x64 for oracle-grade construction"
            )

        # optional mesh: construct the model SHARDED — every level is born
        # under its level sharding (fine partitioned, coarse replicated) and
        # no host/device ever materializes a full fine array.  Requires the
        # device build (host numpy arrays are unsharded by nature).
        self.mesh = mesh
        self.shardings = None
        if mesh is not None:
            from hpcmg.parallel.sharding import (
                level_shardings_for_ns,
            )

            if layout == "auto":
                layout = "2d"
            ns = [p.n >> lvl for lvl in range(self.num_levels)]
            self.shardings = level_shardings_for_ns(
                ns, mesh, min_local, layout=layout
            )
            if not dev:
                if s.device_build is False:
                    raise ValueError(
                        "mesh-sharded construction requires the device "
                        "build (device_build=False was forced)"
                    )
                dev = True
        if dev and s.coarse_operator != "rediscretize":
            raise ValueError(
                "device_build supports coarse_operator='rediscretize' only "
                "(Galerkin RAP levels are built host-side)"
            )

        if dev:
            from hpcmg.mg.levels import (
                build_fine_level_device,
                build_hierarchy_device,
            )

            self.levels: tuple[Level, ...] = build_hierarchy_device(
                p.n, p.kx, p.ky, p.dt_, p.nu, self.num_levels,
                dtype=s.dtype, coarse_mode=s.coarse_mode,
                coarse_operator=s.coarse_operator, shardings=self.shardings,
            )
        else:
            v1, v2 = rotating_velocity(p.n, p.kx, p.ky, dtype=s.dtype)
            self.levels = build_hierarchy(
                v1, v2, p.dt_, p.nu, self.num_levels,
                dtype=s.dtype, coarse_mode=s.coarse_mode,
                coarse_operator=s.coarse_operator, restriction=s.restriction,
            )
        sh0 = None if self.shardings is None else self.shardings[0]
        if s.refine_dtype is not None:
            if jnp.dtype(s.refine_dtype).itemsize == 8 and not jax.config.jax_enable_x64:
                raise RuntimeError(
                    "refine_dtype=float64 requires jax.config.update('jax_enable_x64', True) "
                    "before building the model (otherwise JAX silently downcasts to f32)"
                )
            # slim (velocities-only) high-precision operator at large n:
            # six f64 coefficient arrays would cost 3.3 GB at n=8192 /
            # 13 GB at n=16384 for a few certificate stencils per run
            slim = s.slim_hi_operator
            if slim is None:
                slim = p.n >= 8192
            if dev:
                self.fine_hi: Level | None = build_fine_level_device(
                    p.n, p.kx, p.ky, p.dt_, p.nu, dtype=s.refine_dtype,
                    store_coefficients=not slim, sharding=sh0,
                )
            else:
                vh1, vh2 = rotating_velocity(
                    p.n, p.kx, p.ky, dtype=s.refine_dtype
                )
                self.fine_hi = build_fine_level(
                    vh1, vh2, p.dt_, p.nu, dtype=s.refine_dtype,
                    store_coefficients=not slim,
                )
            u0_dtype = s.refine_dtype
        else:
            self.fine_hi = None
            u0_dtype = s.dtype
        if dev:
            from hpcmg.core.problem import (
                gaussian_u0_padded_device,
            )

            self.u0 = gaussian_u0_padded_device(
                p.n, p.x0, p.y0, p.sigma, dtype=u0_dtype, sharding=sh0
            )
        else:
            self.u0 = pad_field(
                gaussian_u0(p.n, p.x0, p.y0, p.sigma, dtype=u0_dtype)
            )

    @functools.cached_property
    def _jit_run(self):
        nsteps, cfg = self.problem.num_steps, self.solver

        n = self.problem.n
        shardings = self.shardings

        def run(levels, fine_hi, u0):
            uT, stats = timestepper(levels, u0, nsteps, cfg,
                                    fine_hi=fine_hi, shardings=shardings)
            return crop_field(uT, n), stats

        return jax.jit(run)

    @functools.cached_property
    def _jit_step(self):
        cfg = self.solver
        shardings = self.shardings

        def step(levels, fine_hi, u):
            return timestep(levels, u, cfg, fine_hi=fine_hi,
                            shardings=shardings)

        return jax.jit(step)

    def run(self, u0: jnp.ndarray | None = None, warn: bool = True):
        """Full timestepped run; returns (uT, per-step stats).

        With `warn`, emits the reference's non-convergence warning
        (multigrid.cpp:117-119, with its off-by-one fixed — SURVEY §2.9.5)
        when any step fails to reach tol.  The check transfers the per-step
        stats to host, so pass warn=False in timing loops.
        """
        uT, stats = self._jit_run(
            self.levels, self.fine_hi, self.u0 if u0 is None else u0
        )
        if warn:
            import warnings

            import numpy as np

            conv = np.asarray(stats["converged"])
            if not conv.all():
                bad = int(np.argmin(conv))
                warnings.warn(
                    f"multigrid did not converge at step {bad}: relative "
                    f"residual {float(np.asarray(stats['rel_residual'])[bad]):.3e}"
                    f" > tol {self.solver.tol:g}"
                )
            if self.solver.delta_form:
                # margin check on the cheap f32 certificate: a max over tol/2 means the fixed cycle count
                # has no safety margin at these parameters — n=4096 at
                # 1 cycle sat at 7.5e-7 against tol=1e-6 with nothing
                # saying so.  num_cycles=None (auto) picks a count that
                # keeps this margin by construction.
                max_rel = float(np.asarray(stats["rel_residual"]).max())
                if max_rel > self.solver.tol / 2:
                    warnings.warn(
                        f"delta-form f32 certificate max {max_rel:.3e} "
                        f"exceeds tol/2 ({self.solver.tol / 2:g}): "
                        f"num_cycles={self.solver.num_cycles} has no safety "
                        "margin at these parameters; use num_cycles=None "
                        "(auto) or increase it"
                    )
            if "certified" in stats:
                cert = np.asarray(stats["certified"])
                if not cert.all():
                    bad = int(np.argmin(cert))
                    warnings.warn(
                        f"delta-form rigorous certificate FAILED at step {bad}:"
                        " true high-dtype relative residual "
                        f"{float(np.asarray(stats['rel_residual_hi_steps'])[bad]):.3e}"
                        f" > tol {self.solver.tol:g} (certify_every="
                        f"{self.solver.certify_every})"
                    )
        return uT, stats

    def compile(self):
        """Compile the full run ahead of time; returns a `jax.stages.Compiled`
        whose `compiled(model.levels, model.fine_hi, u0)` equals
        `run(u0, warn=False)` (its `memory_analysis()` gives the program's
        device-memory figures)."""
        return self._jit_run.lower(self.levels, self.fine_hi, self.u0).compile()

    def step(self, u: jnp.ndarray):
        """A single CN timestep; returns (u_next, stats)."""
        return self._jit_step(self.levels, self.fine_hi, u)

    def _jit_run_chunk(self, nsteps: int):
        cache = self.__dict__.setdefault("_chunk_cache", {})
        if nsteps not in cache:
            cfg = self.solver
            shardings = self.shardings

            def run(levels, fine_hi, u):
                return timestepper(levels, u, nsteps, cfg, fine_hi=fine_hi,
                                   shardings=shardings)

            cache[nsteps] = jax.jit(run)
        return cache[nsteps]

    def run_chunk(self, u_padded: jnp.ndarray, nsteps: int):
        """`nsteps` CN steps from a padded state (checkpoint/resume driver,
        utils/checkpoint.py); returns (u_padded, stats)."""
        return self._jit_run_chunk(nsteps)(self.levels, self.fine_hi, u_padded)

    def pad(self, u_logical: jnp.ndarray) -> jnp.ndarray:
        """Embed a logical (n+1)^2 field into the padded layout."""
        return pad_field(u_logical)

    def crop(self, u_padded: jnp.ndarray) -> jnp.ndarray:
        """Extract the logical (n+1)^2 field from a padded state."""
        return crop_field(u_padded, self.problem.n)

    def center_value(self, uT: jnp.ndarray) -> float:
        """uT[N/2][N/2] — the convergence oracle printed by the CUDA driver
        (multigrid.cu:258); measured reference values in BASELINE.md."""
        return float(uT[self.problem.n // 2, self.problem.n // 2])
