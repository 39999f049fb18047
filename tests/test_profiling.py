"""Profiling subsystem tests (utils/profiling.py, cli profile).

The reference's profiling was whole-run wall clocks only (multigrid.cpp:
244-246); these verify the per-phase roofline profiler covers every cycle
phase and that the modeled per-step counts reconstruct a sane breakdown.
"""

import jax.numpy as jnp

from hpcmg import ProblemConfig, SolverConfig
from hpcmg.models import AdvectionDiffusion
from hpcmg.utils.profiling import (
    _phase_counts,
    measure_phases,
    profile_step,
)


def _model(**solver_kw):
    solver = SolverConfig(num_levels=2, cycle_mode="fixed", num_cycles=1,
                          coarse_mode="dense", dtype=jnp.float32, **solver_kw)
    return AdvectionDiffusion(ProblemConfig(n=64, num_steps=4), solver)


def test_measure_phases_covers_all_phases():
    recs = measure_phases(_model(), reps=1)
    phases = {r["phase"] for r in recs}
    assert phases == {"smooth", "residual", "restrict", "prolong",
                      "coarse", "rhs", "norm"}
    for r in recs:
        assert r["best_ms"] > 0
        assert r["gdof_s"] > 0
        assert r["achieved_gb_s"] > 0


def test_profile_step_breakdown():
    prof = profile_step(_model(), reps=1)
    assert prof["step_ms"] > 0
    assert prof["modeled_ms"] > 0
    shares = prof["phase_share"]
    assert abs(sum(shares.values()) - 1.0) < 1e-9
    # smoothing is the dominant phase of any multigrid step
    assert max(shares, key=shares.get) in ("smooth", "coarse")
    counted = [r for r in prof["phases"] if r["per_step_count"] > 0]
    assert counted


def test_phase_counts_v_vs_w():
    cfg_v = SolverConfig(cycle_shape=1, cycle_mode="fixed", num_cycles=1)
    cfg_w = SolverConfig(cycle_shape=2, cycle_mode="fixed", num_cycles=1)
    cv, cw = _phase_counts(cfg_v, 3), _phase_counts(cfg_w, 3)
    # V-cycle: level body runs once per level; W: 2^(lvl+1)
    assert cv["smooth"] == {0: 2.0 * 1, 1: 2.0 * 1}
    assert cw["smooth"] == {0: 2.0 * 2, 1: 2.0 * 4}
    assert cv["coarse"] == {2: 1.0}
    assert cw["coarse"] == {2: 8.0}
    # per-step fine-level extras: 1 rhs, 2 certificate residuals + 2 norms
    assert cv["rhs"] == {0: 1.0}
    assert cv["residual"][0] == 1.0 + 2.0


def test_cli_profile_runs(capsys):
    from hpcmg.cli import main

    rc = main(["profile", "--n", "64", "--levels", "2", "--steps", "4",
               "--cycle-mode", "fixed", "--num-cycles", "1",
               "--coarse", "dense", "--reps", "1"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    import json

    summary = json.loads(lines[-1])
    assert "step_ms" in summary and "phase_share" in summary
