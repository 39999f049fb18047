"""GSPMD domain decomposition: sharding specs per level + agglomeration.

Design (SURVEY §2.8 accelerator equivalents): every grid level is
block-partitioned (PartitionSpec("x", "y")) across the 2-D device mesh; XLA's
SPMD partitioner turns the stencil's shifted-slice reads into one-cell halo
exchanges between devices and the norm reductions into psums.  Levels whose
per-device block would fall below `min_local` nodes are *agglomerated* —
replicated on every device (PartitionSpec()) — because coarse grids are latency-bound and cheaper to
compute redundantly than to communicate (the reference's 32^2 coarsest grid
cannot shard meaningfully).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hpcmg.mg.levels import Level


def level_shardings_for_ns(
    ns,
    mesh: Mesh,
    min_local: int = 64,
    layout: str = "2d",
) -> tuple[NamedSharding, ...]:
    """`level_shardings` from the per-level grid extents alone — usable
    BEFORE any Level exists, which the shard-aware device construction
    requires (the levels are born under these shardings,
    mg/levels.py::build_hierarchy_device)."""
    ax_x, ax_y = mesh.axis_names
    nx, ny = mesh.shape[ax_x], mesh.shape[ax_y]
    ndev = nx * ny
    if layout == "rows":
        part = P((ax_x, ax_y), None)
    elif layout == "2d":
        part = P(ax_x, ax_y)
    else:
        raise ValueError(f"unknown layout {layout!r} (want '2d' or 'rows')")
    out = []
    for n in ns:
        if layout == "rows":
            partitioned = (n + 1) // ndev >= min_local
        else:
            local_x = (n + 1) // max(nx, 1)
            local_y = (n + 1) // max(ny, 1)
            partitioned = min(local_x, local_y) >= min_local
        out.append(
            NamedSharding(mesh, part)
            if partitioned and ndev > 1
            else NamedSharding(mesh, P())
        )
    return tuple(out)


def level_shardings(
    levels: tuple[Level, ...],
    mesh: Mesh,
    min_local: int = 64,
    layout: str = "2d",
) -> tuple[NamedSharding, ...]:
    """One NamedSharding per level: partitioned fine levels, replicated
    (agglomerated) coarse levels.

    `min_local`: smallest acceptable per-device block extent (nodes per mesh
    axis) before a level is agglomerated.

    `layout` selects the partition shape of non-agglomerated levels:
      * "2d"   — P(ax_x, ax_y) blocks; GSPMD inserts one-cell halo exchange
        per color pass.  Works for every smoother/operator.
      * "rows" — P((ax_x, ax_y), None): rows sharded over ALL devices, full
        width per block.  GSPMD exchanges one row per color pass, as in
        "2d", but only across one cut per device.

    Agglomeration rationale for "rows": below min_local rows per device
    there is more halo than interior.
    """
    return level_shardings_for_ns(
        [level.n for level in levels], mesh, min_local, layout
    )


def constrain(x, sharding):
    """with_sharding_constraint that tolerates a None sharding."""
    if sharding is None:
        return x
    return jax.lax.with_sharding_constraint(x, sharding)


def shard_level_data(level: Level, sharding: NamedSharding) -> Level:
    """Constrain a level's coefficient fields to the level's sharding.

    Must run under jit: `with_sharding_constraint` (unlike `device_put`)
    supports uneven block sizes, which the odd (n±1) grid extents require.
    Interior arrays (n-1, n-1) and full arrays (n+1, n+1) share the same
    block spec — GSPMD aligns the uneven remainders.
    """
    import dataclasses

    con = lambda a: None if a is None else jax.lax.with_sharding_constraint(a, sharding)
    repl = NamedSharding(sharding.mesh, P())
    return dataclasses.replace(
        level,
        aa=con(level.aa), bb=con(level.bb), cc=con(level.cc), dd=con(level.dd),
        v1=con(level.v1), v2=con(level.v2),
        # the dense coarse inverse lives only on (replicated) coarse levels
        a_inv=None
        if level.a_inv is None
        else jax.lax.with_sharding_constraint(level.a_inv, repl),
    )


def shard_hierarchy(
    levels: tuple[Level, ...],
    mesh: Mesh,
    min_local: int = 64,
):
    """Constrain every level to its sharding (call under jit); returns
    (sharded_levels, shardings)."""
    shardings = level_shardings(levels, mesh, min_local)
    sharded = tuple(shard_level_data(l, s) for l, s in zip(levels, shardings))
    return sharded, shardings
