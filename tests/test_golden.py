"""End-to-end golden tests against the native C++ oracle and the committed
reference field (tests/golden/uT_n256.npy, generated by the native oracle and
cross-checked against the compiled reference's uT.txt dump to within its %f
print truncation — see SURVEY §0 measured values).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import ProblemConfig, SolverConfig, native
from hpcmg.models import AdvectionDiffusion

GOLDEN = pathlib.Path(__file__).parent / "golden"

# measured reference center values uT[N/2][N/2] (BASELINE.md)
CENTER = {64: 5.708e-5, 128: 5.080e-5, 256: 4.802e-5}


def _run_jax(n, dtype=jnp.float64, **solver_kw):
    model = AdvectionDiffusion(ProblemConfig(n=n), SolverConfig(dtype=dtype, **solver_kw))
    uT, stats = model.run()
    return model, np.asarray(uT), stats


def test_full_run_n64_matches_native_oracle(default_problem):
    model, uT, stats = _run_jax(64)
    u0, v1, v2 = default_problem(64)
    want, cycles = native.run(u0, v1, v2, nu=-4e-4, dt=(1 / 64) / 10,
                              nsteps=100, num_levels=2)
    np.testing.assert_allclose(uT, want, atol=1e-12)
    assert np.array_equal(np.asarray(stats["cycles"]), cycles)


def test_full_run_n64_center_value():
    _, uT, _ = _run_jax(64)
    assert uT[32, 32] == pytest.approx(CENTER[64], abs=5e-9)


@pytest.mark.slow
def test_full_run_n256_matches_golden():
    _, uT, stats = _run_jax(256)
    want = np.load(GOLDEN / "uT_n256.npy")
    np.testing.assert_allclose(uT, want, atol=1e-12)
    assert uT[128, 128] == pytest.approx(CENTER[256], abs=5e-9)
    assert int(np.asarray(stats["cycles"]).max()) == 1


@pytest.mark.slow
def test_delta_form_n256_matches_golden():
    """The production delta-form configuration (bench.py) reproduces the
    committed golden field to increment-rounding accuracy at the reference's
    headline resolution."""
    _, uT, stats = _run_jax(
        256, dtype=jnp.float32, refine_dtype=jnp.float64, tol=1e-6,
        cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
        delta_form=True,
    )
    want = np.load(GOLDEN / "uT_n256.npy")
    np.testing.assert_allclose(uT, want, atol=5e-7)
    assert uT[128, 128] == pytest.approx(CENTER[256], abs=1e-8)
    assert float(np.asarray(stats["final_rel_residual_hi"])) <= 1e-6


def test_float32_run_close_to_oracle():
    """f32 run stays within single-precision accumulation error of
    the double oracle over 100 steps."""
    _, uT, stats = _run_jax(64, dtype=jnp.float32, tol=1e-5)
    assert uT[32, 32] == pytest.approx(CENTER[64], abs=1e-8)


def test_wcycle_full_run_matches_native(default_problem):
    model, uT, _ = _run_jax(64, cycle_shape=2)
    u0, v1, v2 = default_problem(64)
    want, _ = native.run(u0, v1, v2, nu=-4e-4, dt=(1 / 64) / 10,
                         nsteps=100, num_levels=2, shape=2)
    np.testing.assert_allclose(uT, want, atol=1e-12)
