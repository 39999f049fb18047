"""Per-phase profiling and roofline counters.

The reference's only profiling is whole-run wall clocks (omp_get_wtime at
multigrid.cpp:244-246, cudaEvent_t sweeps in mg_timer.cu:213-268) plus a
31 flops/point/sweep hand model (prolrestest.cu:191).  This module is the
upgrade called for in SURVEY §5: each V-cycle phase (smooth,
residual, restrict, prolong, coarse solve, rhs, norm) is timed in isolation
on the model's real per-level arrays, paired with an analytic flop/byte
model, and combined with per-cycle phase counts into a modeled breakdown of
the full step — so "where does the time go" has a quantitative answer
(phase %, achieved DOF/s, achieved bytes/s) instead of one number.

`trace_step` wraps a real step in a `jax.profiler` trace for TensorBoard /
xprof when the modeled breakdown is not enough.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hpcmg.mg.cycle import (
    _restrict,
    _smooth_block,
    coarse_solve_dense,
    coarse_solve_gs,
    _get_smoother,
)
from hpcmg.ops.padded import (
    compute_rhs,
    interior_norm,
    prolong_bilinear,
    residual,
    restrict_inject,
)
from hpcmg.utils.timing import time_run

# Reference flop model: 31 flops/point/sweep for red-black GS
# (prolrestest.cu:191-192).  Residual/rhs are the same 5-point stencil minus
# the division: ~10 flops/point.
FLOPS_PER_POINT = {"smooth": 31.0, "residual": 10.0, "rhs": 10.0,
                   "restrict": 0.0, "prolong": 4.0, "norm": 2.0}


def _elems(level) -> int:
    """Padded element count — what actually moves through HBM."""
    return int(np.prod(level.padded))


def _dof(level) -> int:
    """Interior (true) degrees of freedom."""
    return (level.n - 1) ** 2


def _bytes_model(phase: str, level, itemsize: int, nsweeps: int) -> float:
    """Analytic device-memory traffic model per phase invocation (padded
    elements).

    Red–black GS: two masked passes per sweep, each reading u + rhs + 4
    coefficient fields and writing u -> 14 array passes/sweep.
    """
    e = _elems(level)
    if phase == "smooth":
        return nsweeps * (2 * (6 + 1)) * e * itemsize
    if phase in ("residual", "rhs"):
        return (6 + 1) * e * itemsize
    if phase == "restrict":
        return (e + e // 4) * itemsize
    if phase == "prolong":
        return (e // 4 + 2 * e) * itemsize
    if phase == "norm":
        return e * itemsize
    if phase == "coarse":
        m2 = _dof(level)
        return (m2 * m2 + 2 * m2) * itemsize  # dense inverse matmul
    return 0.0


def _flops_model(phase: str, level, nsweeps: int) -> float:
    dof = _dof(level)
    if phase == "smooth":
        return FLOPS_PER_POINT["smooth"] * dof * nsweeps
    if phase == "coarse":
        return 2.0 * dof * dof  # dense matvec against the precomputed inverse
    return FLOPS_PER_POINT.get(phase, 0.0) * dof


def _phase_counts(cfg, num_levels: int) -> dict[str, dict[int, float]]:
    """How many times each phase runs per *step* (1 rhs + num_cycles cycles).

    In a cycle with shape s (1=V, 2=W) the level-`l` body executes s^(l+1)
    times (the reference's `for sh` loop wraps the whole body,
    multigrid.cpp:52).  Each non-coarsest body does 2*niter smoothing sweeps,
    one residual, one restrict, one prolong.  Fine-level residual+norm run
    once before and once after the cycles (mg_solve_fixed certificate).
    """
    s = cfg.cycle_shape
    cycles = cfg.num_cycles if cfg.cycle_mode == "fixed" else 1
    counts: dict[str, dict[int, float]] = {
        "smooth": {}, "residual": {}, "restrict": {}, "prolong": {},
        "coarse": {}, "rhs": {0: 1.0}, "norm": {0: 2.0},
    }
    for lvl in range(num_levels - 1):
        body = cycles * s ** (lvl + 1)
        counts["smooth"][lvl] = 2.0 * body          # pre+post blocks
        counts["residual"][lvl] = 1.0 * body
        counts["restrict"][lvl] = 1.0 * body
        counts["prolong"][lvl] = 1.0 * body
    counts["coarse"][num_levels - 1] = cycles * float(s ** num_levels)
    counts["residual"][0] = counts["residual"].get(0, 0.0) + 2.0  # certificate
    return counts


def _level_fields(model):
    """Representative (u, rhs) per level at the cycle dtype."""
    cfg = model.solver
    u = jnp.asarray(model.u0, cfg.dtype)
    fields = []
    for lvl, level in enumerate(model.levels):
        if lvl > 0:
            u = restrict_inject(u, level.padded)
        fields.append((u, compute_rhs(level, u)))
    return fields


def _loop_phase(fn, args, carry_idx: int, inner: int, same_shape: bool):
    """Jit `inner` on-device iterations of `fn` chained through argument
    `carry_idx` (lax.scan), so one host dispatch amortizes over `inner`
    kernel executions.

    Isolated one-call timings of small ops measure dispatch latency, not
    kernel time.  Chaining through a carry (or, when the output shape
    differs, a scalar data dependence that float semantics keep XLA from
    folding) prevents the compiler from hoisting the body out of the loop.
    """

    def looped(*a):
        carry0 = a[carry_idx]
        rest = list(a)

        def body(carry, _):
            rest[carry_idx] = carry
            out = fn(*rest)
            if same_shape:
                return out, None
            # shape-changing op: keep a scalar dependence on the output
            return carry * (1.0 + 0.0 * out.ravel()[0]), None

        carry, _ = jax.lax.scan(body, carry0, None, length=inner)
        return carry

    return jax.jit(looped)


def measure_phases(model, reps: int = 5, inner: int = 32) -> list[dict]:
    """Time each cycle phase on the model's real arrays, amortizing host
    dispatch over `inner` chained on-device iterations.

    Returns one record per (phase, level): measured best ms per invocation,
    modeled GB and GFLOP (31 flops/pt/sweep reference model), achieved
    GB/s / GFLOP/s / stencil-GDOF/s.
    """
    cfg = model.solver
    itemsize = jnp.dtype(cfg.dtype).itemsize
    fields = _level_fields(model)
    records = []

    def add(phase, lvl, fn, *args, nsweeps=1, carry_idx=0, same_shape=True):
        level = model.levels[lvl]
        looped = _loop_phase(fn, args, carry_idx, inner, same_shape)
        t = time_run(looped, *args, reps=reps, warmup=1)
        sec = t["best_s"] / inner
        gb = _bytes_model(phase, level, itemsize, nsweeps) / 1e9
        gflop = _flops_model(phase, level, nsweeps) / 1e9
        records.append({
            "phase": phase, "level": lvl, "n": level.n,
            "best_ms": sec * 1e3,
            "gdof_s": _dof(level) * nsweeps / sec / 1e9,
            "model_gb": gb, "achieved_gb_s": gb / sec,
            "model_gflop": gflop, "achieved_gflop_s": gflop / sec,
        })

    last = len(model.levels) - 1
    for lvl, level in enumerate(model.levels):
        u, rhs = fields[lvl]
        if lvl < last:
            add("smooth", lvl,
                lambda l, u, r: _smooth_block(cfg, l, u, r, cfg.niter, False)[0],
                level, u, rhs, nsweeps=cfg.niter, carry_idx=1)
            add("residual", lvl, residual, level, u, rhs, carry_idx=1)
            coarse = model.levels[lvl + 1]
            res = residual(level, u, rhs)
            add("restrict", lvl, lambda r, c=coarse: _restrict(cfg, r, c), res,
                carry_idx=0, same_shape=False)
            u_c = fields[lvl + 1][0]
            add("prolong", lvl,
                lambda uc, uf, p=level.padded: uf + prolong_bilinear(uc, p),
                u_c, u, carry_idx=1)
        else:
            if cfg.coarse_mode == "dense" and level.a_inv is not None:
                add("coarse", lvl, coarse_solve_dense, level, u, rhs,
                    carry_idx=2)
            else:
                smoother = _get_smoother(cfg)
                add("coarse", lvl,
                    lambda l, u, r: coarse_solve_gs(l, u, r, cfg, smoother),
                    level, u, rhs, carry_idx=2)
    u0, _ = fields[0]
    add("rhs", 0, compute_rhs, model.levels[0], u0, carry_idx=1)
    add("norm", 0, lambda x: interior_norm(x), fields[0][1],
        carry_idx=0, same_shape=False)
    return records


def profile_step(model, reps: int = 5, inner: int = 32) -> dict:
    """Full profile: isolated phase timings + modeled per-step breakdown vs
    the measured fused step (timed as a scanned `inner`-step chunk so host
    dispatch is amortized exactly as in production runs).

    `modeled_ms` = sum(phase best-time x per-step count); the gap to
    `step_ms` (`fusion_gain_ms`) is what XLA fusion buys inside the step.
    """
    cfg = model.solver
    phases = measure_phases(model, reps=reps, inner=inner)
    counts = _phase_counts(cfg, len(model.levels))
    by_phase: dict[str, float] = {}
    modeled = 0.0
    for rec in phases:
        cnt = counts.get(rec["phase"], {}).get(rec["level"], 0.0)
        contrib = rec["best_ms"] * cnt
        rec["per_step_count"] = cnt
        rec["per_step_ms"] = contrib
        by_phase[rec["phase"]] = by_phase.get(rec["phase"], 0.0) + contrib
        modeled += contrib

    u = jnp.asarray(model.u0)
    t = time_run(lambda u: model.run_chunk(u, inner)[0], u, reps=reps, warmup=1)
    step_ms = t["best_s"] / inner * 1e3
    total = sum(by_phase.values()) or 1.0
    return {
        "step_ms": step_ms,
        "modeled_ms": modeled,
        "fusion_gain_ms": modeled - step_ms,
        "phase_share": {k: v / total for k, v in sorted(
            by_phase.items(), key=lambda kv: -kv[1])},
        "phase_ms": by_phase,
        "phases": phases,
    }


def trace_step(model, logdir: str, nsteps: int = 3) -> str:
    """Record a jax.profiler trace of `nsteps` real steps (TensorBoard/xprof).

    The reference has no tracer at all; this is the device-timeline view the
    modeled breakdown can't give (SURVEY §5 tracing row).
    """
    from hpcmg.utils.timing import device_sync

    u = jnp.asarray(model.u0)
    u, _ = model.step(u)  # compile outside the trace
    device_sync(u)
    with jax.profiler.trace(logdir):
        for _ in range(nsteps):
            u, _ = model.step(u)
        device_sync(u)
    return logdir
