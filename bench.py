"""Reference workload on one GPU: N=1024, 100 Crank–Nicolson timesteps,
certified to the reference tolerance 1e-6.

Baseline: the reference's only committed benchmark — 6.57 s for the same
workload at its best OpenMP configuration (8 threads, strong_scale.txt:8;
31.42 s serial).  vs_baseline = baseline_seconds / our_seconds (higher is
better).

Configuration:
  * delta-form stepping (mg/delta.py): the CN step increment A·δ = dt·L·u
    is computed and solved in f32 (cancellation-free difference-form rhs);
    the state lives as an f32 (hi, lo) pair accumulated by error-free
    TwoSum, with per-step f32 certificates and rigorous f64 certificates
    every 10th step and at the last step
  * fixed cycle count (one XLA program, no data-dependent while loops)
  * dense coarse solve (precomputed inverse — the solve the reference
    abandoned in exact_solve.cpp)

Refuses to run without a GPU.  Prints the card's name and power limit, then
ONE JSON line.

    python bench.py
"""

import json
import statistics
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

BASELINE_N1024_S = 6.57  # strong_scale.txt:8 (8-thread OMP, best)
REFERENCE_TOL = 1e-6     # multigrid.cpp:240
REPS = 5


def run_once(model):
    # warn=False: convergence is asserted from stats after the timing loop
    uT, stats = model.run(warn=False)
    jax.block_until_ready((uT, stats))
    return uT, stats


def main():
    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion
    from hpcmg.utils.runtime import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    enable_compile_cache()
    dev = require_gpu()
    card = gpu_name_and_power_limit()[0]
    print(card, flush=True)

    model = AdvectionDiffusion(
        ProblemConfig(n=1024),
        SolverConfig(
            dtype=jnp.float32,
            refine_dtype=jnp.float64,
            tol=REFERENCE_TOL,
            cycle_mode="fixed",
            num_cycles=1,
            coarse_mode="dense",
            delta_form=True,
            certify_every=10,
        ),
    )
    run_once(model)  # compile
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        uT, stats = run_once(model)
        times.append(time.perf_counter() - t0)
    secs = statistics.median(times)
    max_rel = float(np.asarray(stats["rel_residual"]).max())
    # mid-run rigorous certificates: -1 marks uncertified steps
    rels_hi = np.asarray(stats["rel_residual_hi_steps"])
    max_rel_hi = float(rels_hi[rels_hi >= 0].max())
    final_hi = float(np.asarray(stats["final_rel_residual_hi"]))
    result = {
        "metric": "full_run_n1024_100steps",
        "value": secs,
        "unit": "s",
        "vs_baseline": BASELINE_N1024_S / secs,
        "detail": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "rep_times_s": times,
            "config": "delta-form f32 steps + f32-pair state, fixed 1 "
                      "cycle/step, dense coarse, rigorous f64 certificate "
                      "every 10th step",
            "center_uT": float(uT[512, 512]),
            "max_rel_residual": max_rel,
            "max_rel_residual_f64_certified_steps": max_rel_hi,
            "final_rel_residual_f64": final_hi,
            "meets_reference_tol_1e-6": max(max_rel, max_rel_hi,
                                            final_hi) <= REFERENCE_TOL,
            "baseline": "strong_scale.txt:8 (8-thread OMP, 6.57 s)",
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
