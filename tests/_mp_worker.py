"""Worker process for tests/test_multiprocess.py: one JAX process of a
2-process x 4-virtual-CPU-device distributed run (SURVEY §4's multi-device
CPU strategy extended across process boundaries).  The parent sets
JAX_PLATFORMS=cpu.

Usage: python tests/_mp_worker.py <port> <num_processes> <process_id> <out>
"""

import json
import os
import sys

# Hermetic in an un-installed checkout: the worker is spawned with the repo
# root as neither cwd nor sys.path entry, so bootstrap it from this file's
# location before importing the package.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)


def main():
    port, nproc, pid, outfile = sys.argv[1:5]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    jax.config.update("jax_enable_x64", True)

    from hpcmg.parallel.distributed import (
        fetch,
        initialize,
        is_multiprocess,
    )

    initialize(f"localhost:{port}", int(nproc), int(pid))
    assert jax.process_count() == int(nproc)
    assert jax.device_count() == 4 * int(nproc)
    assert is_multiprocess()

    import jax.numpy as jnp
    import numpy as np

    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion
    from hpcmg.parallel import distributed_run, make_mesh

    model = AdvectionDiffusion(
        ProblemConfig(n=64, num_steps=5),
        SolverConfig(
            dtype=jnp.float32, refine_dtype=jnp.float64, tol=1e-6,
            cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
        ),
    )
    mesh = make_mesh()  # global devices across both processes
    uT, stats = distributed_run(model, mesh, min_local=8)
    uT_np = fetch(uT)
    rel = float(np.asarray(fetch(stats["rel_residual"])).max())

    # shard-aware DEVICE construction under the multi-process runtime: the
    # model is born sharded by one jitted iota program with out_shardings —
    # no process ever lifts (or holds) a full-size array (the make_global
    # path above ships the whole array per host).  Each process must hold
    # only its 4 local slabs of the fine level, and the solve must agree
    # with the lifted host-built run at the construction's ulp-level (XLA
    # sin/cos vs libm under f32).
    model_dev = AdvectionDiffusion(
        ProblemConfig(n=64, num_steps=5),
        SolverConfig(
            dtype=jnp.float32, refine_dtype=jnp.float64, tol=1e-6,
            cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
            device_build=True,
        ),
        mesh=mesh, layout="2d", min_local=8,
    )
    fine = model_dev.levels[0].aa
    local = fine.addressable_shards
    assert len(local) == 4, f"expected 4 local shards, got {len(local)}"
    assert all(s.data.shape[0] < fine.shape[0] for s in local), (
        "fine level not partitioned under the multi-process mesh"
    )
    uT_dev, stats_dev = distributed_run(model_dev, mesh, min_local=8)
    uT_dev_np = fetch(uT_dev)
    rel_dev = float(np.asarray(fetch(stats_dev["rel_residual"])).max())
    assert rel_dev <= 1e-6, rel_dev
    np.testing.assert_allclose(uT_dev_np, uT_np, rtol=1e-4, atol=1e-9)

    # the CLI scaling driver must also work under multi-process launch
    # too: it pins the sweep to the full global mesh
    import contextlib
    import io

    from hpcmg.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([
            "scaling", "--mode", "weak", "--n", "64", "--steps", "2",
            "--dtype", "f64", "--reps", "1",
        ])
    assert rc == 0
    scaling_lines = [l for l in buf.getvalue().splitlines() if l.strip()]
    if int(pid) == 0:
        assert len(scaling_lines) == 1, scaling_lines
        assert json.loads(scaling_lines[0])["devices"] == jax.device_count()
    else:
        assert scaling_lines == []  # only process 0 prints

    if int(pid) == 0:
        np.save(outfile, uT_np)
        with open(outfile + ".json", "w") as f:
            json.dump(
                {
                    "devices": jax.device_count(),
                    "processes": jax.process_count(),
                    "mesh": {k: int(v) for k, v in mesh.shape.items()},
                    "max_rel_residual": rel,
                    "cli_scaling": json.loads(scaling_lines[0]),
                },
                f,
            )


if __name__ == "__main__":
    main()
