"""Prove the n=16384 born-sharded construction path end-to-end (without
it, the multi-device path rests on `make_global`, which needs ~2.2 GB per
f64 array on EVERY host and tens of GB of host RAM).

Builds the full n=16384 flagship model — f32 hierarchy, slim f64
high-precision operator, u0 — born-sharded over the 8-virtual-device CPU
mesh (rows layout), with the host-numpy constructors POISONED so any
full-size host materialization fails loudly; then runs ONE delta timestep
on the mesh.  Prints one JSON row with the mesh noted in `device`.

This is the fake-backend analog of a multi-card deployment: it checks the
construction path, and its times are CPU times, not device numbers.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python -u scripts/build_16384_cpu_mesh.py
"""

import datetime
import json
import os
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def main():
    assert len(jax.devices()) == 8, jax.devices()

    # poison the host-numpy constructors: the whole point is that the
    # sharded build never touches them
    import hpcmg.core.problem as prob
    import hpcmg.mg.levels as lv

    def boom(*a, **k):
        raise AssertionError("full-size host constructor called")

    lv._np_pad_field = lv._np_level = prob._node_coords = boom

    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion
    from hpcmg.parallel import make_mesh

    mesh = make_mesh()
    n = 16384
    t0 = time.perf_counter()
    m = AdvectionDiffusion(
        ProblemConfig(n=n, num_steps=1),
        SolverConfig(dtype=jnp.float32, refine_dtype=jnp.float64,
                     tol=1e-6, cycle_mode="fixed", num_cycles=None,
                     coarse_mode="dense", delta_form=True,
                     device_build=True),
        mesh=mesh, layout="rows", min_local=16,
    )
    jax.block_until_ready(m.levels[0].aa)
    jax.block_until_ready(m.u0)
    build_s = time.perf_counter() - t0
    fine = m.levels[0].aa
    shard_rows = fine.addressable_shards[0].data.shape[0]
    print(f"built n={n} born-sharded in {build_s:.1f}s: fine level "
          f"{fine.shape} f32 x6 arrays, {len(fine.addressable_shards)} "
          f"shards of {shard_rows} rows; slim f64 operator "
          f"{m.fine_hi.aa is None}; auto num_cycles={m.solver.num_cycles}",
          flush=True)
    assert shard_rows < fine.shape[0]
    assert m.fine_hi.aa is None  # slim auto at n >= 8192

    t0 = time.perf_counter()
    uT, st = m.run_chunk(m.u0, 1)
    jax.block_until_ready(uT)
    step_s = time.perf_counter() - t0
    rel = float(np.asarray(st["rel_residual"]).max())
    print(f"one delta step on the 8-device mesh: {step_s:.1f}s "
          f"(compile+run, CPU), f32 cert {rel:.3e}", flush=True)

    row = {"n": n, "device_build": True, "build_s": round(build_s, 1),
           "num_cycles_auto": m.solver.num_cycles,
           "one_step_compile_run_s": round(step_s, 1),
           "step_f32_cert": rel,
           "born_sharded": {"devices": 8, "layout": "rows",
                            "fine_shard_rows": int(shard_rows)},
           "device": "cpu-mesh-8 (virtual, host constructors poisoned)",
           "timestamp": datetime.datetime.now().isoformat(
               timespec="seconds")}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
