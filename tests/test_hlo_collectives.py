"""Compiled-HLO inspection of the sharded smoothing path's collective
structure.

The GSPMD jnp smoother pays one sequential one-cell exchange round per color
pass — 2·nsweeps (+1 for the trailing residual) latency-bound rounds per
block.  The ROUND COUNT is a property of the compiled program, checkable on
the 8-virtual-device CPU mesh: the test parses the compiled HLO's def-use
graph and measures the longest dependency chain of collective-permute ops.
It is the baseline a deep-halo exchange (one round per smooth block, ROADMAP
Speed 5) would be measured against.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg.core.layout import pad_field
from hpcmg.mg.levels import build_fine_level
from hpcmg.ops import padded as pops
from hpcmg.parallel import make_mesh
from jax.sharding import NamedSharding, PartitionSpec

RNG = np.random.default_rng(4)
NSWEEPS = 3  # NITER, multigrid.cpp:41


def _collective_permute_stats(hlo_text: str) -> tuple[int, int]:
    """(count, longest dependency chain) of collective-permute instructions.

    HLO text lists instructions in def-before-use order per computation, so
    one forward pass over `%name = type op(operands...)` lines propagates
    the max number of collective-permutes on any path into each value.
    Fusion-body computations have no collectives (XLA never fuses them), so
    treating a call's operands as its only dependencies is exact here.
    """
    depth: dict[str, int] = {}
    count = 0
    max_depth = 0
    line_re = re.compile(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\S+\s+([\w\-]+)\((.*)")
    for line in hlo_text.splitlines():
        m = line_re.match(line)
        if not m:
            continue
        name, op, rest = m.groups()
        deps = re.findall(r"%([\w.\-]+)", rest)
        is_coll = op.startswith("collective-permute")
        count += is_coll
        d = (1 if is_coll else 0) + max([depth.get(x, 0) for x in deps] or [0])
        depth[name] = d
        max_depth = max(max_depth, d)
    return count, max_depth


def _setup(n):
    # n = 127: padded rows = 128 divide evenly over the 8 devices, so the
    # compiled program contains ONLY the halo-exchange collectives
    shape = (n + 1, n + 1)
    v1 = jnp.asarray(RNG.standard_normal(shape), jnp.float32)
    v2 = jnp.asarray(RNG.standard_normal(shape), jnp.float32)
    level = build_fine_level(v1, v2, (1.0 / n) / 10, -4e-4, dtype=jnp.float32)
    u = pad_field(jnp.asarray(RNG.standard_normal(shape), jnp.float32))
    rhs = pad_field(jnp.asarray(RNG.standard_normal(shape), jnp.float32))
    return level, u, rhs


def test_gspmd_rows_path_pays_per_color_rounds():
    """The GSPMD jnp smoother under the same rows sharding pays one
    sequential exchange round per color pass plus one for the trailing
    residual: collective chain depth exactly 2*nsweeps + 1.  Pins the
    baseline a deep-halo exchange would be measured against (if GSPMD ever
    learns deep halos, this changes)."""
    level, u, rhs = _setup(127)
    mesh = make_mesh()
    sh = NamedSharding(mesh, PartitionSpec(tuple(mesh.axis_names), None))

    def gspmd(l, a, b):
        a = jax.lax.with_sharding_constraint(a, sh)
        b = jax.lax.with_sharding_constraint(b, sh)
        for _ in range(NSWEEPS):
            a = pops.rb_gauss_seidel(l, a, b)
        r = pops.residual(l, a, b)
        return (
            jax.lax.with_sharding_constraint(a, sh),
            jax.lax.with_sharding_constraint(r, sh),
        )

    text = jax.jit(gspmd).lower(level, u, rhs).compile().as_text()
    count, depth = _collective_permute_stats(text)
    assert depth == 2 * NSWEEPS + 1, (
        f"GSPMD rows smoothing should serialize one exchange round per "
        f"color pass (+1 residual): expected depth {2 * NSWEEPS + 1}, "
        f"got {depth}"
    )
    assert count == 2 * (2 * NSWEEPS + 1), (
        f"expected 2 ppermutes per round, got {count} total"
    )
