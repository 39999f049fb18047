"""Device-mesh construction for 2-D domain decomposition.

The reference has no distributed backend at all (SURVEY §2.8/5: no MPI/NCCL);
this layer is the scaling story: a 2-D device mesh ("x" = grid rows,
"y" = grid cols), block partitioning of every grid level, XLA collectives
inserted by GSPMD or explicitly via shard_map (parallel/halo.py).  The mesh
assumes no topology: the factorization follows the algorithm alone, which
suits cards joined all to all.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh


def factor_2d(n_devices: int) -> tuple[int, int]:
    """Factor a device count into the most-square (rows, cols) grid."""
    best = (1, n_devices)
    for rows in range(1, int(math.isqrt(n_devices)) + 1):
        if n_devices % rows == 0:
            best = (rows, n_devices // rows)
    return best


def make_mesh(
    devices=None,
    shape: tuple[int, int] | None = None,
    axis_names: tuple[str, str] = ("x", "y"),
) -> Mesh:
    """Build a 2-D mesh over `devices` (default: all)."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = factor_2d(len(devices))
    arr = np.asarray(devices[: shape[0] * shape[1]]).reshape(shape)
    return Mesh(arr, axis_names)
