"""Explicit halo-exchange smoothing under shard_map.

The production distributed path (parallel/sharding.py) follows the
scaling-book recipe — annotate shardings, let GSPMD turn the stencil's
shifted reads into halo exchanges.  This module is the EXPLICIT
counterpart: the one-cell halo exchange is written out as `lax.ppermute`
neighbor sends along the mesh axes, and the red–black sweep runs on local
blocks.  It exists because (a) SURVEY §2.8 names neighbor-wise halo exchange
as the accelerator equivalent of the reference's parallelism and an explicit form
makes the communication pattern inspectable/tunable (e.g. for manual
compute/communication overlap), and (b) it pins GSPMD's behavior: the suite
asserts both paths produce identical sweeps on the multi-device CPU mesh.

ppermute fills devices that receive no message with zeros, which exactly
matches the padded layout's zero margins at the grid edges — edge devices
need no special-casing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _from_prev(x, axis: str):
    """Receive from the previous device along `axis` (first device gets 0)."""
    n = jax.lax.axis_size(axis)
    return jax.lax.ppermute(x, axis, [(i, i + 1) for i in range(n - 1)])


def _from_next(x, axis: str):
    """Receive from the next device along `axis` (last device gets 0)."""
    n = jax.lax.axis_size(axis)
    return jax.lax.ppermute(x, axis, [(i + 1, i) for i in range(n - 1)])


def _halo_shifts(u, ax_x: str, ax_y: str):
    """The four one-cell shifted views of the GLOBAL field, built from the
    local block plus ppermute'd halo lines.

    Returns (up, down, left, right) where up[i,j] = u_global[i-1,j] etc.,
    all local-block shaped.
    """
    top = _from_prev(u[-1:, :], ax_x)        # previous block's last row
    bot = _from_next(u[:1, :], ax_x)         # next block's first row
    lef = _from_prev(u[:, -1:], ax_y)
    rig = _from_next(u[:, :1], ax_y)
    up = jnp.concatenate([top, u[:-1, :]], axis=0)
    dn = jnp.concatenate([u[1:, :], bot], axis=0)
    lf = jnp.concatenate([lef, u[:, :-1]], axis=1)
    rt = jnp.concatenate([u[:, 1:], rig], axis=1)
    return up, dn, lf, rt


def _local_color_mask(shape, parity: int, ax_x: str, ax_y: str):
    """Global (i+j) parity mask evaluated on a local block: the block's
    global origin comes from the device's mesh coordinates."""
    ox = jax.lax.axis_index(ax_x) * shape[0]
    oy = jax.lax.axis_index(ax_y) * shape[1]
    r = jnp.arange(shape[0], dtype=jnp.int32)[:, None] + ox
    c = jnp.arange(shape[1], dtype=jnp.int32)[None, :] + oy
    return (r + c) % 2 == parity


def _sweep_local(level_blk, u, rhs, ax_x: str, ax_y: str):
    """One full red–black sweep on a local block with explicit halos.

    Two ppermute rounds per sweep: black must read the freshly updated red
    halo lines (the reference's inter-color barrier, gs.cu:389-391).
    """
    inv_diag = 1.0 / level_blk.diag_a if level_blk.diag is None else 1.0 / level_blk.diag

    def color_pass(u, parity):
        up, dn, lf, rt = _halo_shifts(u, ax_x, ax_y)
        nb = level_blk.cc * up + level_blk.dd * dn + level_blk.aa * lf + level_blk.bb * rt
        mask = _local_color_mask(u.shape, parity, ax_x, ax_y)
        return jnp.where(mask, (rhs - nb) * inv_diag, u)

    u = color_pass(u, 0)
    u = color_pass(u, 1)
    return u


def _residual_local(level_blk, u, rhs, ax_x: str, ax_y: str):
    up, dn, lf, rt = _halo_shifts(u, ax_x, ax_y)
    nb = level_blk.cc * up + level_blk.dd * dn + level_blk.aa * lf + level_blk.bb * rt
    diag = level_blk.diag_a if level_blk.diag is None else level_blk.diag
    return rhs - diag * u - nb


def _sweep_local_overlapped(level_blk, u, rhs, ax_x: str, ax_y: str):
    """One red–black sweep with communication/computation overlap.

    Numerically identical to `_sweep_local` (asserted by tests/test_halo.py),
    but restructured so XLA can hide the exchange latency (SURVEY §7.6 "overlap of
    halo collectives with interior compute"): each color pass issues the four
    ppermute edge sends FIRST, then computes the block-interior update —
    which depends only on local rows/cols — while the collectives are in
    flight, and finally patches the four border lines that need the remote
    halos.  XLA lowers the ppermutes to collective-permute-start/done pairs;
    everything scheduled between start and done (the interior update) rides
    for free.
    """
    inv_diag = 1.0 / level_blk.diag_a if level_blk.diag is None else 1.0 / level_blk.diag
    aa, bb, cc, dd = level_blk.aa, level_blk.bb, level_blk.cc, level_blk.dd
    cat = jnp.concatenate

    def color_pass(u, parity):
        # 1) kick off the halo exchange (ppermutes are independent of the
        #    interior arithmetic below, so XLA schedules the collective
        #    permutes concurrently with step 2)
        top = _from_prev(u[-1:, :], ax_x)
        bot = _from_next(u[:1, :], ax_x)
        lef = _from_prev(u[:, -1:], ax_y)
        rig = _from_next(u[:, :1], ax_y)
        # 2) interior update from purely local shifts (zero-fill at block
        #    edges; border lines rewritten in step 3)
        up_l = jnp.pad(u[:-1, :], ((1, 0), (0, 0)))
        dn_l = jnp.pad(u[1:, :], ((0, 1), (0, 0)))
        lf_l = jnp.pad(u[:, :-1], ((0, 0), (1, 0)))
        rt_l = jnp.pad(u[:, 1:], ((0, 0), (0, 1)))
        nb = cc * up_l + dd * dn_l + aa * lf_l + bb * rt_l
        mask = _local_color_mask(u.shape, parity, ax_x, ax_y)
        u_new = jnp.where(mask, (rhs - nb) * inv_diag, u)

        # 3) border lines: recompute the full neighbor sum with the received
        #    halos, in EXACTLY the term order of _sweep_local (cc, dd, aa,
        #    bb) so the result is bitwise identical to the plain version
        def line(nb_line, sl_r, sl_c, u_line):
            return jnp.where(
                mask[sl_r, sl_c], (rhs[sl_r, sl_c] - nb_line) * inv_diag, u_line
            )

        r0, rN = slice(0, 1), slice(-1, None)
        nb_top = (cc[r0, :] * top + dd[r0, :] * u[1:2, :]
                  + aa[r0, :] * cat([lef[r0, :], u[r0, :-1]], axis=1)
                  + bb[r0, :] * cat([u[r0, 1:], rig[r0, :]], axis=1))
        nb_bot = (cc[rN, :] * u[-2:-1, :] + dd[rN, :] * bot
                  + aa[rN, :] * cat([lef[rN, :], u[rN, :-1]], axis=1)
                  + bb[rN, :] * cat([u[rN, 1:], rig[rN, :]], axis=1))
        nb_lef = (cc[:, r0] * cat([top[:, r0], u[:-1, r0]], axis=0)
                  + dd[:, r0] * cat([u[1:, r0], bot[:, r0]], axis=0)
                  + aa[:, r0] * lef + bb[:, r0] * u[:, 1:2])
        nb_rig = (cc[:, rN] * cat([top[:, rN], u[:-1, rN]], axis=0)
                  + dd[:, rN] * cat([u[1:, rN], bot[:, rN]], axis=0)
                  + aa[:, rN] * u[:, -2:-1] + bb[:, rN] * rig)
        u_new = u_new.at[r0, :].set(line(nb_top, r0, slice(None), u[r0, :]))
        u_new = u_new.at[rN, :].set(line(nb_bot, rN, slice(None), u[rN, :]))
        u_new = u_new.at[:, r0].set(line(nb_lef, slice(None), r0, u[:, r0]))
        u_new = u_new.at[:, rN].set(line(nb_rig, slice(None), rN, u[:, rN]))
        return u_new

    u = color_pass(u, 0)
    u = color_pass(u, 1)
    return u


def smooth_distributed(
    mesh: Mesh,
    level,
    u: jnp.ndarray,
    rhs: jnp.ndarray,
    nsweeps: int = 1,
    want_residual: bool = False,
    overlap: bool = False,
):
    """`nsweeps` red–black sweeps (+ optional residual and its psum'd norm)
    with explicit shard_map halo exchange over `mesh`.

    Equivalent to the jnp padded smoother under GSPMD sharding
    (tests/test_halo.py asserts bitwise agreement); 5-point levels only.

    `overlap=True` uses the communication/computation-overlapped sweep
    (`_sweep_local_overlapped`): edge ppermutes issued before the interior
    update so exchange latency hides behind local compute — same numbers, lower
    multi-chip latency (the interior patch costs a few extra border-line
    updates per pass).
    """
    if level.diag is not None or level.ne is not None:
        raise NotImplementedError(
            "explicit halo smoothing supports 5-point levels only "
            "(Galerkin 9-point levels run under the GSPMD path)"
        )
    ax_x, ax_y = mesh.axis_names
    spec = P(ax_x, ax_y)
    sweep = _sweep_local_overlapped if overlap else _sweep_local

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec),
        out_specs=(spec, spec, P()) if want_residual else spec,
    )
    def run(aa, bb, cc, dd, u, rhs):
        import dataclasses as _dc

        # v1/v2 are dummies on the block (unused by the 5-point sweeps)
        blk = _dc.replace(level, aa=aa, bb=bb, cc=cc, dd=dd,
                          v1=aa, v2=aa, a_inv=None)
        for _ in range(nsweeps):
            u = sweep(blk, u, rhs, ax_x, ax_y)
        if not want_residual:
            return u
        res = _residual_local(blk, u, rhs, ax_x, ax_y)
        acc = res.astype(jnp.promote_types(res.dtype, jnp.float32))
        norm = jnp.sqrt(jax.lax.psum(jnp.sum(acc * acc), (ax_x, ax_y)))
        return u, res, norm

    sharding = NamedSharding(mesh, spec)
    put = lambda a: jax.lax.with_sharding_constraint(a, sharding)
    args = (level.aa, level.bb, level.cc, level.dd, u, rhs)
    return run(*(put(a) for a in args))
