"""The production smooth block (mg/cycle.py::_smooth_block — padded jnp
red–black GS plus residual) and the padded residual/rhs against plain
references: a numpy red–black sweep over the stencil bands written out here,
the logical-shape oracles (ops/stencil.py, ops/smoothers.py) and the native
C++ oracle — for the 5-point operator and the Galerkin nine-band operator,
from a given iterate, from zero and with a correction added first."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import native
from hpcmg.config import SolverConfig
from hpcmg.core.layout import crop_field, interior_mask, pad_field
from hpcmg.core.problem import cn_coefficients
from hpcmg.mg.cycle import _smooth_block
from hpcmg.mg.levels import build_fine_level
from hpcmg.ops import padded as pops
from hpcmg.ops import smoothers, stencil

NU = -4e-4
# band name -> (di, dj): the band couples u[i+di, j+dj]
OFFSETS = {"cc": (-1, 0), "dd": (1, 0), "aa": (0, -1), "bb": (0, 1),
           "ne": (-1, 1), "nw": (-1, -1), "se": (1, 1), "sw": (1, -1)}


def _np_shift(u, di, dj):
    out = np.zeros_like(u)
    r, c = u.shape
    out[max(0, -di):r - max(0, di), max(0, -dj):c - max(0, dj)] = \
        u[max(0, di):r - max(0, -di), max(0, dj):c - max(0, -dj)]
    return out


def _np_bands(level):
    return {k: np.asarray(getattr(level, k)) for k in OFFSETS
            if getattr(level, k, None) is not None}


def _np_nsum(bands, u):
    return sum(b * _np_shift(u, *OFFSETS[k]) for k, b in bands.items())


def _np_diag(level):
    return level.diag_a if level.diag is None else np.asarray(level.diag)


def _np_rbgs(level, u, rhs, nsweeps):
    bands, diag = _np_bands(level), _np_diag(level)
    r = np.arange(u.shape[0])[:, None]
    c = np.arange(u.shape[1])[None, :]
    red = (r + c) % 2 == 0
    for _ in range(nsweeps):
        for color in (red, ~red):
            u = np.where(color, (rhs - _np_nsum(bands, u)) / diag, u)
    return u


def _np_residual(level, u, rhs):
    return rhs - _np_diag(level) * u - _np_nsum(_np_bands(level), u)


def _setup(n, op, seed):
    rng = np.random.default_rng(seed)
    shape = (n + 1, n + 1)
    v1, v2 = rng.standard_normal(shape), rng.standard_normal(shape)
    dt = (1.0 / n) / 10
    level = build_fine_level(jnp.asarray(v1), jnp.asarray(v2), dt, NU,
                             dtype=jnp.float64)
    if op == "9band":
        # a Galerkin-shaped level: four corner bands and a varying diagonal
        # (ONE outside the interior), small enough to stay dominant
        mask = np.asarray(interior_mask(n, level.padded, dtype=jnp.float64))
        extra = {k: jnp.asarray(0.01 * rng.standard_normal(level.padded)
                                * mask) for k in ("ne", "nw", "se", "sw")}
        diag = level.diag_a + 0.05 * rng.standard_normal(level.padded)
        diag = jnp.asarray(np.where(mask > 0, diag, 1.0))
        level = dataclasses.replace(level, diag=diag, **extra)

    def field():
        f = rng.standard_normal(shape)
        f[0, :] = f[-1, :] = f[:, 0] = f[:, -1] = 0.0
        return f

    return level, field(), field(), field(), (v1, v2, 1.0 / n, dt)


CASES = [(n, s, op) for n in (16, 32, 64, 128) for s in (1, 3)
         for op in ("5pt", "9band")]


@pytest.mark.parametrize("n,nsweeps,op", CASES)
def test_smooth_block_matches_references(n, nsweeps, op):
    level, u, rhs, corr, (v1, v2, h, dt) = _setup(n, op, seed=n + nsweeps)
    cfg = SolverConfig(dtype=jnp.float64, niter=nsweeps)
    block = jax.jit(
        lambda lv, a, b, c: _smooth_block(cfg, lv, a, b, nsweeps, True,
                                          corr=c),
    )
    up, rp, cp = (pad_field(jnp.asarray(x)) for x in (u, rhs, corr))
    zero = jnp.zeros_like(up)
    un, rn = np.asarray(up), np.asarray(rp)
    for start, c, start_np in (
        (up, None, un),                               # given iterate
        (zero, None, np.zeros_like(un)),              # zero init
        (up, cp, un + np.asarray(cp)),                # correction added
    ):
        got_u, got_r = block(level, start, rp, c)
        want_u = _np_rbgs(level, start_np, rn, nsweeps)
        want_r = _np_residual(level, want_u, rn)
        np.testing.assert_allclose(np.asarray(got_u), want_u, rtol=0,
                                   atol=1e-13)
        np.testing.assert_allclose(np.asarray(got_r), want_r, rtol=0,
                                   atol=1e-12)
        # the padding invariant survives: zero outside the open interior
        g = np.asarray(got_u)
        assert np.all(g[n:, :] == 0) and np.all(g[:, n:] == 0)
    if op == "5pt":
        # the logical-shape oracle and the native C++ sweep
        coef = cn_coefficients(jnp.asarray(v1), jnp.asarray(v2), dt, NU, h)
        want = jnp.asarray(u)
        for _ in range(nsweeps):
            want = smoothers.rb_gauss_seidel(coef, want, jnp.asarray(rhs))
        got_u, _ = _smooth_block(cfg, level, up, rp, nsweeps, False)
        np.testing.assert_allclose(np.asarray(crop_field(got_u, n)),
                                   np.asarray(want), rtol=0, atol=1e-13)
        nat = native.gs_sweep(u, rhs, v1, v2, h, dt, NU, nsweeps=nsweeps)
        np.testing.assert_allclose(np.asarray(crop_field(got_u, n)), nat,
                                   rtol=0, atol=1e-13)


@pytest.mark.parametrize("n,op", [(n, op) for n in (16, 32, 64, 128)
                                  for op in ("5pt", "9band")])
def test_residual_and_rhs_match_references(n, op):
    level, u, rhs, _, (v1, v2, h, dt) = _setup(n, op, seed=100 + n)
    up, rp = pad_field(jnp.asarray(u)), pad_field(jnp.asarray(rhs))
    un, rn = np.asarray(up), np.asarray(rp)
    res = np.asarray(pops.residual(level, up, rp))
    np.testing.assert_allclose(res, _np_residual(level, un, rn), rtol=0,
                               atol=1e-13)
    b_u = np.asarray(pops.compute_rhs(level, up))
    want_b = level.diag_b * un - _np_nsum(_np_bands(level), un)
    np.testing.assert_allclose(b_u, want_b, rtol=0, atol=1e-13)
    if op == "5pt":
        coef = cn_coefficients(jnp.asarray(v1), jnp.asarray(v2), dt, NU, h)
        np.testing.assert_allclose(
            res[: n + 1, : n + 1],
            np.asarray(stencil.residual(coef, jnp.asarray(u),
                                        jnp.asarray(rhs))),
            rtol=0, atol=1e-13)
        np.testing.assert_allclose(
            res[: n + 1, : n + 1],
            native.residual(u, rhs, v1, v2, h, dt, NU), rtol=0, atol=1e-13)
        np.testing.assert_allclose(
            b_u[: n + 1, : n + 1], native.compute_rhs(u, v1, v2, h, dt, NU),
            rtol=0, atol=1e-13)
