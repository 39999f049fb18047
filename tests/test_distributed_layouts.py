"""distributed_run over the two partition layouts and two mesh sizes on the
virtual CPU devices, each against the single-device run of the same model
(the CPU rehearsal of chip_smoke.py --four-cards)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import ProblemConfig, SolverConfig
from hpcmg.models import AdvectionDiffusion
from hpcmg.parallel import distributed_run, make_mesh


@pytest.mark.parametrize("layout,ndev", [(layout, ndev)
                                         for layout in ("2d", "rows")
                                         for ndev in (2, 4)])
def test_distributed_layouts_match_single_device(layout, ndev):
    model = AdvectionDiffusion(
        ProblemConfig(n=64, num_steps=3),
        SolverConfig(dtype=jnp.float64, cycle_mode="fixed", num_cycles=1,
                     coarse_mode="dense", num_levels=3),
    )
    uT_single, _ = model.run(warn=False)
    mesh = make_mesh(jax.devices()[:ndev])
    uT, stats = distributed_run(model, mesh, min_local=8, layout=layout)
    # the fine level really is spread over every device of the mesh
    assert len(uT.sharding.device_set) == ndev
    assert float(np.asarray(stats["rel_residual"]).max()) <= 1e-6
    np.testing.assert_allclose(np.asarray(uT), np.asarray(uT_single),
                               rtol=0, atol=1e-12)


def test_distributed_run_reuses_its_compiled_program():
    """A second distributed_run of the same model over the same mesh reuses
    the jitted program (no new trace or compile), and a second layout gets
    its own."""
    model = AdvectionDiffusion(
        ProblemConfig(n=32, num_steps=2),
        SolverConfig(dtype=jnp.float64, cycle_mode="fixed", num_cycles=1,
                     coarse_mode="dense", num_levels=2),
    )
    mesh = make_mesh(jax.devices()[:4])
    first, _ = distributed_run(model, mesh, min_local=8, layout="2d")
    cache = model._distributed_run_cache
    (jitted,) = cache.values()
    again, _ = distributed_run(model, mesh, min_local=8, layout="2d")
    assert list(cache.values()) == [jitted]
    assert jitted._cache_size() == 1
    np.testing.assert_array_equal(np.asarray(again), np.asarray(first))
    distributed_run(model, mesh, min_local=8, layout="rows")
    assert len(cache) == 2
