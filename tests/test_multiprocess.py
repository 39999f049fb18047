"""Multi-process (multi-host analog) distribution test.

Launches TWO OS processes, each with 4 virtual CPU devices, connected via
`jax.distributed.initialize` (parallel/distributed.py) — the fake-backend
analog of a 2-host cluster.  The flagship mixed-precision configuration
runs block-partitioned over the global 8-device mesh and must match the
single-process 8-device result (which test_refine.py pins against the
single-device run).

No reference counterpart: the reference's parallelism ends at OpenMP
(gs.cpp:37-186); this is SURVEY §2.8 item 5 / §5's required new layer.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

WORKER = os.path.join(os.path.dirname(__file__), "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_flagship_matches_single_process(tmp_path):
    port = _free_port()
    out = str(tmp_path / "uT.npy")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"  # a CPU-mesh test wherever it runs
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), "2", str(pid), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}"

    meta = json.load(open(out + ".json"))
    assert meta["processes"] == 2 and meta["devices"] == 8
    assert meta["max_rel_residual"] <= 1e-6
    uT_mp = np.load(out)

    # single-process reference on the same global problem (8 local devices)
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
    uT_sp, _ = distributed_run(model, make_mesh(jax.devices()), min_local=8)
    np.testing.assert_allclose(uT_mp, np.asarray(uT_sp), rtol=0, atol=1e-12)
