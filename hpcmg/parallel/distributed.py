"""Multi-process distribution.

The reference's parallelism ends at OpenMP threads in one address space
(gs.cpp:37-186); SURVEY §2.8/§5 names the accelerator equivalent:
`jax.distributed` initialization, a Mesh spanning every process's devices,
psum norms over the interconnect within a host and the network across
hosts.  This module provides:

  * `initialize(...)` — env-driven `jax.distributed.initialize` wiring
    (HPCMG_COORDINATOR / HPCMG_NUM_PROCESSES / HPCMG_PROCESS_ID /
    HPCMG_LOCAL_DEVICE, falling back to JAX's own auto-detection on managed
    clusters),
  * `globalize(tree, sharding_fn)` — lift host-local (numpy-backed) arrays
    into globally-sharded `jax.Array`s via `make_array_from_callback`, so the
    single-controller program written for one process runs unchanged under
    multi-process SPMD (every process holds the same replicated setup data;
    each contributes only its addressable shards),
  * `fetch(x)` — allgather a (possibly non-addressable) global array back to
    host numpy on every process.

Tested by tests/test_multiprocess.py: two local processes x 4 virtual CPU
devices run the flagship solve on a global 8-device mesh and must match the
single-process result bit-for-bit in f64.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    Arguments default to the HPCMG_COORDINATOR / HPCMG_NUM_PROCESSES /
    HPCMG_PROCESS_ID environment variables; with none present,
    `jax.distributed.initialize()` is called bare, which auto-detects on
    managed clusters (SLURM, Kubernetes).

    `local_device_ids` (the GPUs this process opens) defaults to
    HPCMG_LOCAL_DEVICE (comma-separated ids), else — for several processes
    on one host, i.e. a localhost coordinator — to `[process_id]`: one card
    per process, instead of every process opening (and reserving memory on)
    every card of the host.
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    coordinator = coordinator or os.environ.get("HPCMG_COORDINATOR")
    num_processes = num_processes if num_processes is not None else (
        int(os.environ["HPCMG_NUM_PROCESSES"])
        if "HPCMG_NUM_PROCESSES" in os.environ else None
    )
    process_id = process_id if process_id is not None else (
        int(os.environ["HPCMG_PROCESS_ID"])
        if "HPCMG_PROCESS_ID" in os.environ else None
    )
    if local_device_ids is None:
        local_device_ids = default_local_device_ids(coordinator, process_id)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def default_local_device_ids(coordinator: str | None,
                             process_id: int | None):
    """The card ids a process should open (see `initialize`); None = all."""
    env = os.environ.get("HPCMG_LOCAL_DEVICE")
    if env:
        return [int(x) for x in env.split(",")]
    host = (coordinator or "").rsplit(":", 1)[0]
    if process_id is not None and host in ("localhost", "127.0.0.1"):
        return [process_id]
    return None


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def make_global(x, sharding) -> jax.Array:
    """Lift a host-local array (same value on every process) into a global
    jax.Array with `sharding`; each process donates its addressable shards."""
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def globalize(tree, sharding_for_leaf):
    """Map `make_global` over a pytree; `sharding_for_leaf(leaf)` returns the
    sharding for each array leaf."""
    return jax.tree.map(
        lambda a: make_global(a, sharding_for_leaf(a)), tree
    )


def fetch(x) -> np.ndarray:
    """Gather a global (possibly non-addressable) array to numpy on every
    process."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
