"""Explicit shard_map halo-exchange smoothing (parallel/halo.py) vs the
single-device padded kernels — on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg.core.layout import pad_field
from hpcmg.mg.levels import build_fine_level
from hpcmg.ops import padded as pops
from hpcmg.parallel import make_mesh
from hpcmg.parallel.halo import smooth_distributed

RNG = np.random.default_rng(21)


def _setup(n=64):
    shape = (n + 1, n + 1)
    v1 = jnp.asarray(RNG.standard_normal(shape))
    v2 = jnp.asarray(RNG.standard_normal(shape))
    level = build_fine_level(v1, v2, (1.0 / n) / 10, -4e-4, dtype=jnp.float64)
    u = RNG.standard_normal(shape)
    u[0, :] = u[-1, :] = u[:, 0] = u[:, -1] = 0.0
    rhs = RNG.standard_normal(shape)
    rhs[0, :] = rhs[-1, :] = rhs[:, 0] = rhs[:, -1] = 0.0
    return level, pad_field(jnp.asarray(u)), pad_field(jnp.asarray(rhs))


@pytest.mark.slow
def test_halo_sweeps_match_single_device():
    level, u, rhs = _setup()
    mesh = make_mesh()  # (2, 4) over 8 virtual devices
    want = u
    for _ in range(3):
        want = pops.rb_gauss_seidel(level, want, rhs)
    got = smooth_distributed(mesh, level, u, rhs, nsweeps=3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=0)


@pytest.mark.slow
def test_halo_residual_and_norm_match():
    level, u, rhs = _setup()
    mesh = make_mesh()
    want_u = pops.rb_gauss_seidel(level, u, rhs)
    want_r = pops.residual(level, want_u, rhs)
    want_n = pops.interior_norm(want_r)
    got_u, got_r, got_n = smooth_distributed(
        mesh, level, u, rhs, nsweeps=1, want_residual=True
    )
    np.testing.assert_allclose(np.asarray(got_u), np.asarray(want_u), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want_r), rtol=0, atol=0)
    assert float(got_n) == pytest.approx(float(want_n), rel=1e-14)


@pytest.mark.slow
def test_halo_overlapped_sweep_matches():
    """The communication/computation-overlapped sweep (ppermutes issued
    before the interior update, border lines patched after — SURVEY §7.6's
    overlap requirement) is numerically identical to the plain halo sweep
    and to the single-device kernels."""
    level, u, rhs = _setup()
    mesh = make_mesh()
    want = u
    for _ in range(2):
        want = pops.rb_gauss_seidel(level, want, rhs)
    got = smooth_distributed(mesh, level, u, rhs, nsweeps=2, overlap=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=0)


def test_halo_rejects_9pt():
    import dataclasses

    level, u, rhs = _setup()
    level9 = dataclasses.replace(level, ne=level.aa, nw=level.aa,
                                 se=level.aa, sw=level.aa)
    with pytest.raises(NotImplementedError):
        smooth_distributed(make_mesh(), level9, u, rhs)


def test_rows_layout_thin_slab_falls_back_to_jnp():
    """n=64 over 8 devices gives 8-row slabs: the rows layout still
    partitions the fine level (min_local=8) and the GSPMD jnp smoother runs
    it with one-row exchanges per color pass; the full timestepped solve
    must match the single-device run."""
    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion
    from hpcmg.parallel import distributed_run
    from hpcmg.parallel.sharding import level_shardings

    p = ProblemConfig(n=64, num_steps=3)
    s = SolverConfig(dtype=jnp.float64, cycle_mode="fixed",
                     num_cycles=1, coarse_mode="dense", num_levels=2)
    model = AdvectionDiffusion(p, s)
    mesh = make_mesh()
    sh = level_shardings(model.levels, mesh, 8, layout="rows")
    assert sh[0].spec == jax.sharding.PartitionSpec(("x", "y"), None)
    uT_single, _ = model.run()
    uT_dist, _ = distributed_run(model, mesh, min_local=8, layout="rows")
    np.testing.assert_allclose(
        np.asarray(uT_dist), np.asarray(uT_single), rtol=0, atol=1e-12
    )
