"""Card-only tests: they need a GPU (the `gpu` fixture skips them
elsewhere) and run on the card as `pytest -m gpu tests/`, which
chip_smoke.py does.  Each pins a numeric property that the GPU's compiler
could change: full-f32 dense products (no TF32, with a TF32 control that
must fail the same limit), the exact split and TwoSum
accumulation of the delta stepper's state pair, and f64 parity with the
native oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _coarse_batch(k=64, n=32):
    """The coarsest level of the default n=1024 hierarchy, k seeded
    right-hand sides in the padded layout, and their f64 solutions."""
    from hpcmg.core.problem import rotating_velocity
    from hpcmg.mg.levels import build_fine_level, dense_interior_matrix
    from hpcmg.sparse.galerkin import attach_dense_inverse

    v1, v2 = rotating_velocity(n, dtype=jnp.float32)
    level = attach_dense_inverse(build_fine_level(
        v1, v2, (1.0 / 1024) / 10, -4e-4, dtype=jnp.float32))
    rng = np.random.default_rng(3)
    rhs = np.zeros((k, *level.padded), np.float32)
    rhs[:, 1:n, 1:n] = rng.standard_normal((k, n - 1, n - 1))
    flat = rhs[:, 1:n, 1:n].reshape(k, -1)
    want = np.linalg.solve(dense_interior_matrix(level),
                           flat.astype(np.float64).T)
    return level, rhs, flat, want


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_coarse_solve_dense_is_full_f32_on_gpu(gpu):
    """f32 coarse solves agree with f64 solves to 1e-5 even under a TF32
    default matmul precision: batched by vmap, the product is a
    matrix-matrix product, which the card runs on TF32 tensor cores unless
    the HIGHEST pin in coarse_solve_dense forbids it."""
    from hpcmg.mg.cycle import coarse_solve_dense

    level, rhs, _, want = _coarse_batch()
    n = level.n
    batched = jax.jit(jax.vmap(coarse_solve_dense, in_axes=(None, 0, 0)))
    with jax.default_matmul_precision("tensorfloat32"):
        got = np.asarray(batched(level, jnp.asarray(rhs), jnp.asarray(rhs)))
    sol = got[:, 1:n, 1:n].reshape(len(rhs), -1).astype(np.float64).T
    assert _rel(sol, want) <= 1e-5


def test_tf32_product_fails_the_coarse_solve_limit(gpu):
    """Control for the test above: the same product computed in TF32
    (about three decimal digits) misses the 1e-5 limit, so that limit
    tells full f32 from TF32."""
    level, _, flat, want = _coarse_batch()
    tf32 = jax.jit(lambda a, x: jnp.matmul(
        a, x, precision=jax.lax.DotAlgorithmPreset.TF32_TF32_F32))
    got = np.asarray(tf32(level.a_inv, jnp.asarray(flat.T)), np.float64)
    assert _rel(got, want) > 1e-5


def test_delta_accumulators_exact_on_gpu(gpu):
    """Compiled for the card, the f64 split of the state into an f32 pair
    matches numpy bit for bit, and the f32 TwoSum accumulator matches numpy's
    f64 sum: XLA keeps the rounding and does not reassociate the TwoSum."""
    from hpcmg.mg.delta import _accumulate, _split_hi_lo

    rng = np.random.default_rng(7)
    x = rng.standard_normal((1024, 1152))
    hi, lo = jax.jit(_split_hi_lo, static_argnums=1)(jnp.asarray(x),
                                                     jnp.float32)
    hi_np = x.astype(np.float32)
    np.testing.assert_array_equal(np.asarray(hi), hi_np)
    np.testing.assert_array_equal(
        np.asarray(lo), (x - hi_np.astype(np.float64)).astype(np.float32))
    d = (rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
    h1, l1 = jax.jit(_accumulate, static_argnums=3)(hi, lo, jnp.asarray(d),
                                                   jnp.float64)
    s = np.asarray(hi, np.float64) + np.asarray(lo, np.float64) + d
    np.testing.assert_array_equal(np.asarray(h1), s.astype(np.float32))
    v1 = np.asarray(h1, np.float64) + np.asarray(l1, np.float64)
    np.testing.assert_allclose(v1, s, rtol=0, atol=1e-12)


def test_f64_run_matches_native_oracle_on_gpu(gpu, default_problem):
    """Reference semantics (adaptive outer loop, iterated-GS coarse solve)
    in f64 on the card against the native C++ oracle, as the CPU golden
    test does (tests/test_golden.py)."""
    from hpcmg import ProblemConfig, SolverConfig, native
    from hpcmg.models import AdvectionDiffusion

    model = AdvectionDiffusion(ProblemConfig(n=64),
                               SolverConfig(dtype=jnp.float64))
    uT, stats = model.run()
    u0, v1, v2 = default_problem(64)
    want, cycles = native.run(u0, v1, v2, nu=-4e-4, dt=(1 / 64) / 10,
                              nsteps=100, num_levels=2)
    np.testing.assert_allclose(np.asarray(uT), want, atol=1e-12)
    assert np.array_equal(np.asarray(stats["cycles"]), cycles)


def test_delta_run_certifies_on_gpu(gpu):
    """The production delta form at n=256 on the card: the golden field to
    increment-rounding accuracy and rigorous f64 certificates <= 1e-6."""
    import pathlib

    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion

    model = AdvectionDiffusion(ProblemConfig(n=256), SolverConfig(
        dtype=jnp.float32, refine_dtype=jnp.float64, tol=1e-6,
        cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
        delta_form=True, certify_every=10))
    uT, stats = model.run()
    want = np.load(pathlib.Path(__file__).parent / "golden" / "uT_n256.npy")
    np.testing.assert_allclose(np.asarray(uT), want, atol=5e-7)
    hi = np.asarray(stats["rel_residual_hi_steps"])
    assert hi[hi >= 0].max() <= 1e-6
    assert float(np.asarray(stats["final_rel_residual_hi"])) <= 1e-6
