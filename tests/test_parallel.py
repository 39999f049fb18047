"""Multi-device tests on the 8-virtual-CPU-device mesh (conftest sets
xla_force_host_platform_device_count=8) — the fake-backend analog of SURVEY §4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import ProblemConfig, SolverConfig
from hpcmg.models import AdvectionDiffusion
from hpcmg.parallel import (
    distributed_run,
    factor_2d,
    level_shardings,
    make_mesh,
)


def test_factor_2d():
    assert factor_2d(8) == (2, 4)
    assert factor_2d(4) == (2, 2)
    assert factor_2d(7) == (1, 7)
    assert factor_2d(16) == (4, 4)


def test_make_mesh_uses_all_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("x", "y")


def test_agglomeration_policy():
    model = AdvectionDiffusion(
        ProblemConfig(n=64), SolverConfig(dtype=jnp.float64, num_levels=3)
    )
    mesh = make_mesh()
    sh = level_shardings(model.levels, mesh, min_local=8)
    # fine level 65x65 over (2,4) mesh -> local 32x16 >= 8 -> partitioned
    assert sh[0].spec == jax.sharding.PartitionSpec("x", "y")
    # coarsest 17x17 -> local 8x4 < 8 -> replicated (agglomerated)
    assert sh[2].spec == jax.sharding.PartitionSpec()


def test_distributed_matches_single_device():
    p = ProblemConfig(n=64, num_steps=10)
    s = SolverConfig(dtype=jnp.float64)
    model = AdvectionDiffusion(p, s)
    uT_single, stats_single = model.run()

    mesh = make_mesh()
    uT_dist, stats_dist = distributed_run(model, mesh, min_local=8)
    np.testing.assert_allclose(
        np.asarray(uT_dist), np.asarray(uT_single), atol=1e-12
    )
    assert np.array_equal(
        np.asarray(stats_dist["cycles"]), np.asarray(stats_single["cycles"])
    )


def test_distributed_all_levels_sharded_converges():
    """Even with no agglomeration (min_local=1) results stay correct."""
    p = ProblemConfig(n=64, num_steps=5)
    s = SolverConfig(dtype=jnp.float64)
    model = AdvectionDiffusion(p, s)
    uT_single, _ = model.run()
    mesh = make_mesh()
    uT_dist, stats = distributed_run(model, mesh, min_local=1)
    np.testing.assert_allclose(np.asarray(uT_dist), np.asarray(uT_single), atol=1e-12)
