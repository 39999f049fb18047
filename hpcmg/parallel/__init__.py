from hpcmg.parallel.distributed import (
    fetch,
    initialize,
    is_multiprocess,
    make_global,
)
from hpcmg.parallel.halo import smooth_distributed
from hpcmg.parallel.mesh import factor_2d, make_mesh
from hpcmg.parallel.sharding import (
    level_shardings,
    level_shardings_for_ns,
    shard_hierarchy,
    shard_level_data,
)

import jax

from hpcmg.mg.timestepper import timestepper


def distributed_run(model, mesh, min_local: int = 64, layout: str = "auto"):
    """Run a model's full timestepped solve block-partitioned over `mesh`.

    Fine levels are sharded (halo exchange + psum norms between devices);
    coarse levels agglomerate to replicated.  Returns (uT, stats) with uT
    sharded over the mesh.

    `layout` ("auto" | "2d" | "rows", parallel/sharding.py): "auto" is "2d"
    blocks; "rows" partitions rows only.

    Under a multi-process runtime (jax.distributed initialized,
    parallel/distributed.py) the model's host-local setup arrays are first
    lifted to global jax.Arrays with their level shardings, so the same
    single-controller program runs across hosts (GSPMD inserts the
    collectives within a host and across hosts alike).
    """
    from hpcmg.parallel.sharding import (
        level_shardings,
        shard_level_data,
    )

    if layout == "auto":
        layout = "2d"

    nsteps, cfg = model.problem.num_steps, model.solver

    from hpcmg.core.layout import crop_field

    n = model.problem.n
    levels, fine_hi, u0 = model.levels, model.fine_hi, model.u0
    born_sharded = getattr(model, "shardings", None) is not None
    if born_sharded:
        # shard-aware device construction (AdvectionDiffusion(mesh=...)):
        # the levels are already global jax.Arrays under their level
        # shardings — no host lifting, no full-size materialization
        # anywhere.  The partitioning was fixed at
        # construction: layout/min_local here are ignored, and a different
        # mesh cannot be honored.
        if mesh is not None and mesh != model.mesh:
            raise ValueError(
                "model was constructed sharded over a different mesh; "
                "rebuild it with AdvectionDiffusion(..., mesh=mesh) for "
                "this mesh"
            )
        shardings = model.shardings
    else:
        shardings = level_shardings(model.levels, mesh, min_local,
                                    layout=layout)
    if jax.process_count() > 1 and not born_sharded:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from hpcmg.parallel.distributed import make_global

        repl = NamedSharding(mesh, P())

        def glob_level(level, s):
            # padded-grid fields carry the level sharding; everything else
            # (the dense coarse inverse) is replicated
            pick = lambda a: s if a.shape == level.padded else repl
            return jax.tree.map(lambda a: make_global(a, pick(a)), level)

        levels = tuple(glob_level(l, s) for l, s in zip(levels, shardings))
        if fine_hi is not None:
            fine_hi = glob_level(fine_hi, shardings[0])
        u0 = make_global(u0, shardings[0])

    # one jitted program per (model, shardings): a repeated call reuses it
    # instead of tracing and compiling again
    cache = model.__dict__.setdefault("_distributed_run_cache", {})
    key = tuple(shardings)
    if key not in cache:

        def run(levels, fine_hi, u0):
            levels = tuple(
                shard_level_data(l, s) for l, s in zip(levels, shardings)
            )
            if fine_hi is not None:
                fine_hi = shard_level_data(fine_hi, shardings[0])
            u0 = jax.lax.with_sharding_constraint(u0, shardings[0])
            uT, stats = timestepper(
                levels, u0, nsteps, cfg, fine_hi=fine_hi, shardings=shardings
            )
            return crop_field(uT, n), stats

        cache[key] = jax.jit(run)
    return cache[key](levels, fine_hi, u0)


__all__ = [
    "smooth_distributed",
    "factor_2d",
    "make_mesh",
    "level_shardings",
    "level_shardings_for_ns",
    "shard_hierarchy",
    "shard_level_data",
    "distributed_run",
    "initialize",
    "is_multiprocess",
    "make_global",
    "fetch",
]
