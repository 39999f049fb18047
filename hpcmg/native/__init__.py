"""ctypes bindings for the native host runtime (libmgref).

The shared library is built on demand with g++ (no pip deps).  It provides the
serial double-precision oracle the JAX path is validated against — the same
role the serial C++ implementation plays in the reference (SURVEY §4.2).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "mgref.cpp"
_LIB = _DIR / "libmgref.so"

_lib = None


def build(force: bool = False) -> pathlib.Path:
    """Compile libmgref.so if missing or stale."""
    if force or not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        subprocess.run(
            ["g++", "-O2", "-march=native", "-shared", "-fPIC",
             str(_SRC), "-o", str(_LIB)],
            check=True,
        )
    return _LIB


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        _lib.adr_norm.restype = ctypes.c_double
    return _lib


def _arr(a):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def run(
    u0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    nu: float,
    dt: float,
    nsteps: int,
    num_levels: int,
    tol: float = 1e-6,
    max_cycles: int = 50,
    niter: int = 3,
    shape: int = 1,
    coarse_tol: float = 1e-5,
    coarse_maxiter: int = 1000,
):
    """Full oracle run; returns (uT, cycles_per_step)."""
    n = u0.shape[0] - 1
    u0, p_u0 = _arr(u0)
    v1, p_v1 = _arr(v1)
    v2, p_v2 = _arr(v2)
    uT = np.zeros_like(u0)
    _, p_uT = _arr(uT)
    p_uT = uT.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    cycles = np.zeros(nsteps, dtype=np.int32)
    lib().adr_run(
        n, num_levels, ctypes.c_double(nu), ctypes.c_double(dt), nsteps,
        ctypes.c_double(tol), max_cycles, niter, shape,
        ctypes.c_double(coarse_tol), coarse_maxiter,
        p_u0, p_v1, p_v2, p_uT,
        cycles.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return uT, cycles


def compute_rhs(u, v1, v2, h, dt, nu):
    n = u.shape[0] - 1
    u, p_u = _arr(u)
    v1, p_v1 = _arr(v1)
    v2, p_v2 = _arr(v2)
    out = np.zeros_like(u)
    lib().adr_compute_rhs(
        n, ctypes.c_double(h), ctypes.c_double(dt), ctypes.c_double(nu),
        p_v1, p_v2, p_u, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def residual(u, rhs, v1, v2, h, dt, nu):
    n = u.shape[0] - 1
    u, p_u = _arr(u)
    rhs, p_rhs = _arr(rhs)
    v1, p_v1 = _arr(v1)
    v2, p_v2 = _arr(v2)
    out = np.zeros_like(u)
    lib().adr_residual(
        n, ctypes.c_double(h), ctypes.c_double(dt), ctypes.c_double(nu),
        p_v1, p_v2, p_u, p_rhs,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def norm(res):
    n = res.shape[0] - 1
    res, p_res = _arr(res)
    return lib().adr_norm(n, p_res)


def gs_sweep(u, rhs, v1, v2, h, dt, nu, nsweeps: int = 1):
    n = u.shape[0] - 1
    u = np.ascontiguousarray(u, dtype=np.float64).copy()
    rhs, p_rhs = _arr(rhs)
    v1, p_v1 = _arr(v1)
    v2, p_v2 = _arr(v2)
    lib().adr_gs_sweep(
        n, ctypes.c_double(h), ctypes.c_double(dt), ctypes.c_double(nu),
        p_v1, p_v2, u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        p_rhs, nsweeps)
    return u


def prolong(coarse):
    nc = coarse.shape[0] - 1
    coarse, p_c = _arr(coarse)
    fine = np.zeros((2 * nc + 1, 2 * nc + 1))
    lib().adr_prolong(nc, p_c, fine.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return fine


def restrict(fine):
    nf = fine.shape[0] - 1
    fine, p_f = _arr(fine)
    coarse = np.zeros((nf // 2 + 1, nf // 2 + 1))
    lib().adr_restrict(nf, p_f, coarse.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return coarse
