"""Shard-aware device-side model construction.

The analytic problem fields are generated on device from iota
(core/problem.py::*_trace, mg/levels.py::build_hierarchy_device) instead of
built in host numpy and transferred.  These tests pin:

  * value agreement with the host-numpy oracle build (ulp-level — XLA
    sin/cos vs libm — so tolerance-based, not bit assertions);
  * that the sharded build NEVER materializes a full-size host array
    (the numpy constructors are poisoned and must not be called);
  * that levels are BORN sharded: each device holds only its row slab;
  * end-to-end equivalence of the device-built model, unsharded and
    mesh-sharded, against the host-built model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import ProblemConfig, SolverConfig
from hpcmg.models import AdvectionDiffusion
from hpcmg.core.problem import (
    gaussian_u0,
    gaussian_u0_padded_device,
    rotating_velocity,
)
from hpcmg.core.layout import pad_field
from hpcmg.mg.levels import (
    build_fine_level,
    build_fine_level_device,
    build_hierarchy,
    build_hierarchy_device,
)
from hpcmg.parallel import make_mesh
from hpcmg.parallel.sharding import (
    level_shardings_for_ns,
)


def _host_hierarchy(n, dtype, **kw):
    v1, v2 = rotating_velocity(n, dtype=dtype)
    return build_hierarchy(v1, v2, (1.0 / n) / 10.0, -4e-4, 3, dtype=dtype,
                           **kw)


def test_device_hierarchy_matches_host_oracle():
    n = 64
    host = _host_hierarchy(n, jnp.float32, coarse_mode="dense")
    dev = build_hierarchy_device(
        n, np.pi, np.pi, (1.0 / n) / 10.0, -4e-4, 3, dtype=jnp.float32,
        coarse_mode="dense",
    )
    assert len(dev) == len(host)
    for lh, ld in zip(host, dev):
        assert (ld.n, ld.h, ld.dt, ld.nu) == (lh.n, lh.h, lh.dt, lh.nu)
        assert ld.diag_a == lh.diag_a and ld.diag_b == lh.diag_b
        for f in ("aa", "bb", "cc", "dd", "v1", "v2"):
            np.testing.assert_allclose(
                np.asarray(getattr(ld, f)), np.asarray(getattr(lh, f)),
                rtol=1e-6, atol=1e-7, err_msg=f"level n={lh.n} field {f}",
            )
    np.testing.assert_allclose(np.asarray(dev[-1].a_inv),
                               np.asarray(host[-1].a_inv),
                               rtol=1e-5, atol=1e-6)


def test_device_fine_level_and_u0_match_host_f64():
    n = 64
    v1, v2 = rotating_velocity(n, dtype=jnp.float64)
    host = build_fine_level(v1, v2, (1.0 / n) / 10.0, -4e-4,
                            dtype=jnp.float64)
    dev = build_fine_level_device(n, np.pi, np.pi, (1.0 / n) / 10.0, -4e-4,
                                  dtype=jnp.float64)
    for f in ("aa", "bb", "cc", "dd", "v1", "v2"):
        np.testing.assert_allclose(
            np.asarray(getattr(dev, f)), np.asarray(getattr(host, f)),
            rtol=1e-14, atol=1e-15, err_msg=f,
        )
    slim = build_fine_level_device(n, np.pi, np.pi, (1.0 / n) / 10.0, -4e-4,
                                   dtype=jnp.float64,
                                   store_coefficients=False)
    assert slim.aa is None
    np.testing.assert_allclose(np.asarray(slim.v1), np.asarray(host.v1),
                               rtol=1e-14, atol=1e-15)
    u0_h = pad_field(gaussian_u0(n, dtype=jnp.float64))
    u0_d = gaussian_u0_padded_device(n, dtype=jnp.float64)
    # exp() amplifies argument-ulp differences by |sigma·r²| <= ~70:
    # measured max rel 1.4e-14
    np.testing.assert_allclose(np.asarray(u0_d), np.asarray(u0_h),
                               rtol=1e-13, atol=1e-300)


def test_device_built_model_runs_like_host_built():
    p = ProblemConfig(n=64, num_steps=5)
    s = SolverConfig(dtype=jnp.float32, refine_dtype=jnp.float64,
                     cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
                     delta_form=True)
    import dataclasses

    host = AdvectionDiffusion(p, dataclasses.replace(s, device_build=False))
    dev = AdvectionDiffusion(p, dataclasses.replace(s, device_build=True))
    uT_h, st_h = host.run(warn=False)
    uT_d, st_d = dev.run(warn=False)
    # different operator bits at the sin/cos ulp level -> different exact
    # trajectory, same physics and same certificate contract
    np.testing.assert_allclose(np.asarray(uT_d), np.asarray(uT_h),
                               rtol=1e-5, atol=1e-10)
    assert float(np.asarray(st_d["final_rel_residual_hi"])) <= 1e-6


def test_sharded_build_never_touches_host_constructors(monkeypatch):
    """The whole point of the device build: poison every full-size
    host-numpy constructor and build a mesh-sharded model end to end."""
    import hpcmg.core.problem as prob
    import hpcmg.mg.levels as lv

    def boom(*a, **k):
        raise AssertionError("host-numpy constructor called in device build")

    monkeypatch.setattr(lv, "_np_pad_field", boom)
    monkeypatch.setattr(lv, "_np_level", boom)
    monkeypatch.setattr(prob, "_node_coords", boom)
    mesh = make_mesh()
    p = ProblemConfig(n=128, num_steps=2)
    s = SolverConfig(dtype=jnp.float32, refine_dtype=jnp.float64,
                     cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
                     delta_form=True, device_build=True)
    m = AdvectionDiffusion(p, s, mesh=mesh, layout="rows", min_local=16)
    assert m.shardings is not None
    # fine level born partitioned: each of the 8 devices holds a row slab
    fine = m.levels[0]
    rows = fine.aa.shape[0]
    shard_rows = {sh.data.shape[0] for sh in fine.aa.addressable_shards}
    assert len(fine.aa.addressable_shards) == 8
    assert all(r < rows for r in shard_rows), (
        f"fine level not actually partitioned: shard rows {shard_rows} "
        f"of {rows}"
    )
    # coarse levels agglomerated (replicated)
    assert m.levels[-1].aa.addressable_shards[0].data.shape == \
        m.levels[-1].aa.shape


def test_sharded_device_model_matches_unsharded(monkeypatch):
    """distributed_run on a shard-born model == the unsharded device-built
    model (same construction bits; execution differs only by GSPMD
    reduction/halo scheduling — f32-level agreement)."""
    from hpcmg.parallel import distributed_run

    mesh = make_mesh()
    p = ProblemConfig(n=128, num_steps=3)
    s = SolverConfig(dtype=jnp.float32, refine_dtype=jnp.float64,
                     cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
                     delta_form=True, device_build=True)
    single = AdvectionDiffusion(p, s)
    uT_1, st_1 = single.run(warn=False)
    sharded = AdvectionDiffusion(p, s, mesh=mesh, layout="2d", min_local=16)
    uT_8, st_8 = distributed_run(sharded, mesh, min_local=16)
    np.testing.assert_allclose(np.asarray(uT_8), np.asarray(uT_1),
                               rtol=2e-6, atol=1e-11)
    assert float(np.asarray(st_8["final_rel_residual_hi"])) <= 1e-6


def test_mesh_without_device_build_forced_off_raises():
    mesh = make_mesh()
    with pytest.raises(ValueError, match="device"):
        AdvectionDiffusion(
            ProblemConfig(n=128, num_steps=1),
            SolverConfig(device_build=False),
            mesh=mesh,
        )
