"""Device-count scaling sweeps on the 8-virtual-device CPU mesh — the
fake-backend analog of the reference's thread sweep (multigrid_strongsc.cpp
:251-262).  Prints the `scaling` CLI's JSON lines for the strong and the
weak sweep.

Virtual CPU devices share the host cores, so these numbers pin the
*distribution logic* (shard correctness, reshard/agglomeration overhead
scaling), not device performance.

Run:  python -u scripts/run_scaling_cpu.py
"""

import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from hpcmg.cli import main  # noqa: E402


def run(mode: str, extra=()):
    print(mode, flush=True)
    rc = main([
        "scaling", "--mode", mode, "--n", "256", "--steps", "10",
        "--dtype", "f64", "--max-devices", "8", "--reps", "2", *extra,
    ])
    assert rc == 0


if __name__ == "__main__":
    run("strong")
    run("weak")
    sys.exit(0)
