"""Smoke test of the solver's main path on the GPU, through the entry points
a user calls, with every result checked against a plain reference.

    python chip_smoke.py               # one card: all phases below
    python chip_smoke.py --four-cards  # device phase + the 4-card mesh path

Phases (one JSON line each, in this order; the first failure stops the
script with a non-zero exit before the last line is printed):

  device     JAX's platform must be "gpu" (probed in a child process, so the
             card is free for the next phase); card name and power limit
  gpu_tests  `pytest -m gpu tests/` in a child process (one process on the
             card at a time); fails on a non-zero exit or no test passed
  parity     cli `run --n 256 --dtype f64` (adaptive outer loop, iterated-GS
             coarse solve) against tests/golden/uT_n256.npy at atol 1e-12
  ops        at n=1024 and n=8192, f32 on the card: one smooth block against
             the same block in f64, the injection restriction against numpy
             (bit for bit), the dense coarse solve against an f64 solve
  reference  n=1024 x 100 steps, the bench.py configuration: every
             certificate <= 1e-6, uT against an f64 run at atol 5e-7
  full_size  cli `run --n 8192 --delta ... --device-build` (x 100 steps):
             every certificate <= 1e-6, memory and compile/run seconds
  variants   n=1024: W-cycle, full weighting, Galerkin, FMG, Poisson

--four-cards runs the device phase, then an n=8192 born-sharded delta model
for 10 steps through `distributed_run` on a 2x2 mesh with layout "2d" and
with layout "rows" (4x1), each against the same model on one card.  Each run
is timed twice: the first call (trace and compile included) and a warm call
of the same compiled program.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}, with
`count` the number of cards the run used.
Times are informational, labelled with the card and its power limit; they
are not benchmark numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-6                  # the reference tolerance, multigrid.cpp:240
CENTER_N256 = 4.802e-5      # reference uT[128][128] (BASELINE.md)

ONE_CARD_PHASES = ("device", "gpu_tests", "parity", "ops", "reference",
                   "full_size", "variants")
FOUR_CARD_PHASES = ("device", "four_cards")


class PhaseFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def emit(rec):
    print(json.dumps(rec), flush=True)


def plan(four_cards: bool) -> tuple[str, ...]:
    """The phases a run makes, in order."""
    return FOUR_CARD_PHASES if four_cards else ONE_CARD_PHASES


# ---------------------------------------------------------------------------
# phases that run before this process touches the card
# ---------------------------------------------------------------------------


def phase_device(ctx):
    """Probe JAX's devices in a child process (no memory is reserved here),
    then read the card's name and power limit from nvidia-smi."""
    probe = (
        "import json, jax; d = jax.devices(); "
        "print(json.dumps({'platform': d[0].platform, "
        "'kind': d[0].device_kind, 'count': len(d)}))"
    )
    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, timeout=300)
    check(res.returncode == 0, f"device probe failed: {res.stderr[-2000:]}")
    dev = json.loads(res.stdout.strip().splitlines()[-1])
    check(dev["platform"] == "gpu",
          f"no GPU: JAX's first device is on platform {dev['platform']!r}")
    if ctx["four_cards"]:
        check(dev["count"] >= 4, f"--four-cards needs 4 cards, found "
                                 f"{dev['count']}")
    from hpcmg.utils.runtime import gpu_name_and_power_limit

    cards = gpu_name_and_power_limit()
    ctx["card"] = cards[0]
    print(cards[0], flush=True)
    return {"jax": dev, "nvidia_smi": cards}


def phase_gpu_tests(ctx):
    cmd = [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
           "-p", "no:cacheprovider"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    tail = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    passed = re.search(r"(\d+) passed", tail)
    n_passed = int(passed.group(1)) if passed else 0
    check(res.returncode == 0,
          f"pytest -m gpu exited {res.returncode}: "
          f"{(res.stdout + res.stderr)[-3000:]}")
    check(n_passed > 0, f"pytest -m gpu passed no test: {tail}")
    return {"passed": n_passed, "summary": tail, "card": ctx["card"]}


# ---------------------------------------------------------------------------
# phases on the card, in this process
# ---------------------------------------------------------------------------


def _cli_run(argv):
    """cli.main(argv) in-process; returns its JSON result line."""
    from hpcmg.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"cli {argv} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_parity(ctx):
    """Reference semantics in f64: adaptive outer while_loop, iterated-GS
    coarse solve.  atol 1e-12 is the CPU test's (tests/test_golden.py)."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "uT.npy")
        out = _cli_run(["run", "--n", "256", "--dtype", "f64",
                        "--dump", dump])
        uT = np.load(dump)
    want = np.load(os.path.join(ROOT, "tests", "golden", "uT_n256.npy"))
    err = float(np.abs(uT - want).max())
    check(err <= 1e-12, f"n=256 f64 field differs from golden by {err}")
    check(abs(out["center_uT"] - CENTER_N256) <= 5e-9,
          f"center {out['center_uT']} != {CENTER_N256} +- 5e-9")
    check(out["max_cycles"] == 1, f"{out['max_cycles']} cycles in a step")
    check(out["converged"], "a step did not converge")
    return {"max_abs_err_vs_golden": err, "atol": 1e-12,
            "center_uT": out["center_uT"], "max_cycles": out["max_cycles"],
            "run_s": out["seconds"], "card": ctx["card"]}


def _random_field(rng, n, dtype):
    """Seeded field with a zero boundary ring, in the padded layout."""
    import jax.numpy as jnp
    from hpcmg.core.layout import pad_field

    u = rng.standard_normal((n + 1, n + 1))
    u[0, :] = u[-1, :] = u[:, 0] = u[:, -1] = 0.0
    return pad_field(jnp.asarray(u, dtype))


def check_ops(n, seed=0):
    """The translated ops at grid size n, f32, against plain references.

    Tolerances (f32 unit roundoff 6e-8):
      * smooth block (3 red-black sweeps + residual) vs the same block in
        f64: max|du| <= 1e-5 max|u|, max|dr| <= 1e-5 max|rhs| — a few hundred
        ulps of f32 accumulation; Gauss-Seidel contracts errors;
      * injection restriction vs numpy slicing: bit for bit (a copy);
      * dense coarse solve vs an f64 solve of the same (f32-coefficient)
        system: relative error <= 1e-5, for one right-hand side and for 64
        at once under a TF32 default matmul precision.  Needs full f32
        products: TF32 keeps ~3 digits (2^-11 = 4.9e-4), and a TF32
        control product must fail the limit.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hpcmg.config import SolverConfig
    from hpcmg.core.problem import rotating_velocity
    from hpcmg.mg.cycle import _smooth_block, coarse_solve_dense
    from hpcmg.mg.levels import build_fine_level, dense_interior_matrix
    from hpcmg.ops.padded import restrict_inject
    from hpcmg.core.layout import padded_shape
    from hpcmg.sparse.galerkin import attach_dense_inverse

    rng = np.random.default_rng(seed)
    dt, nu = (1.0 / n) / 10.0, -4e-4
    cfg = SolverConfig()
    rec = {"n": n}

    v1, v2 = rotating_velocity(n, dtype=jnp.float64)
    lvl64 = build_fine_level(v1, v2, dt, nu, dtype=jnp.float64)
    lvl32 = build_fine_level(v1, v2, dt, nu, dtype=jnp.float32)
    u64 = _random_field(rng, n, jnp.float64)
    rhs64 = _random_field(rng, n, jnp.float64)
    u32, rhs32 = u64.astype(jnp.float32), rhs64.astype(jnp.float32)
    block = jax.jit(lambda l, u, r: _smooth_block(cfg, l, u, r, cfg.niter,
                                                  True))
    us, rs = block(lvl32, u32, rhs32)
    ud, rd = block(lvl64, u64, rhs64)
    du = float(jnp.abs(us.astype(jnp.float64) - ud).max())
    dr = float(jnp.abs(rs.astype(jnp.float64) - rd).max())
    u_scale = float(jnp.abs(ud).max())
    r_scale = float(jnp.abs(rhs64).max())
    check(du <= 1e-5 * u_scale, f"n={n} smooth block: max|du| {du}")
    check(dr <= 1e-5 * r_scale, f"n={n} smooth residual: max|dr| {dr}")
    rec["smooth_max_abs_du"], rec["smooth_max_abs_dr"] = du, dr
    rec["smooth_tol"] = {"du": 1e-5 * u_scale, "dr": 1e-5 * r_scale}
    del lvl64, u64, rhs64, ud, rd, us

    cshape = padded_shape(n // 2)
    got = np.asarray(jax.jit(restrict_inject, static_argnums=1)(rs, cshape))
    host = np.asarray(rs)[::2, ::2][: cshape[0], : cshape[1]]
    want = np.zeros(cshape, np.float32)
    want[: host.shape[0], : host.shape[1]] = host
    check(np.array_equal(got, want), f"n={n} injection is not bit-exact")
    rec["restrict_bit_exact"] = True
    del rs

    # the coarsest level of the default hierarchy (n=32, this run's dt)
    nc, k = 32, 64
    c1, c2 = rotating_velocity(nc, dtype=jnp.float32)
    coarse = attach_dense_inverse(
        build_fine_level(c1, c2, dt, nu, dtype=jnp.float32))
    crhs = jnp.stack([_random_field(rng, nc, jnp.float32) for _ in range(k)])
    flat = crhs[:, 1:nc, 1:nc].reshape(k, -1)
    ref = np.linalg.solve(dense_interior_matrix(coarse),
                          np.asarray(flat, np.float64).T)

    def rel_err(x, want):
        x = np.asarray(x, np.float64)
        return float(np.linalg.norm(x - want) / np.linalg.norm(want))

    # the production matrix-vector solve
    one = jax.jit(coarse_solve_dense)(coarse, crhs[0], crhs[0])
    rel = rel_err(one[1:nc, 1:nc].ravel(), ref[:, 0])
    check(rel <= 1e-5, f"n={n} dense coarse solve rel err {rel} > 1e-5")
    # k solves at once (a matrix-matrix product, which tensor cores take)
    # under a TF32 default: the HIGHEST pin must hold
    batched = jax.jit(jax.vmap(coarse_solve_dense, in_axes=(None, 0, 0)))
    with jax.default_matmul_precision("tensorfloat32"):
        many = batched(coarse, crhs, crhs)
    rel_many = rel_err(many[:, 1:nc, 1:nc].reshape(k, -1).T, ref)
    check(rel_many <= 1e-5,
          f"n={n} batched coarse solve rel err {rel_many} > 1e-5")
    # control: the same product in TF32 must fail the limit
    tf32 = jax.jit(lambda a, x: jnp.matmul(
        a, x, precision=jax.lax.DotAlgorithmPreset.TF32_TF32_F32))
    rel_tf32 = rel_err(tf32(coarse.a_inv, flat.T), ref)
    check(rel_tf32 > 1e-5,
          f"n={n} a TF32 product passes the 1e-5 limit ({rel_tf32})")
    rec["coarse_rel_err"] = rel
    rec["coarse_batched_tf32_default_rel_err"] = rel_many
    rec["tf32_control_rel_err"] = rel_tf32
    return rec


def phase_ops(ctx):
    return {"sizes": [check_ops(n) for n in (1024, 8192)],
            "card": ctx["card"]}


def _certificates(stats):
    """Every certificate a delta run reports, as floats."""
    import numpy as np

    hi = np.asarray(stats["rel_residual_hi_steps"])
    return {
        "max_rel_residual_f32": float(np.asarray(stats["rel_residual"]).max()),
        "max_rel_residual_hi_steps": float(hi[hi >= 0].max()),
        "final_rel_residual_hi": float(
            np.asarray(stats["final_rel_residual_hi"])),
    }


def reference_workload(n=1024, steps=100):
    """bench.py's configuration against an f64 run of the same problem."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion

    prob = ProblemConfig(n=n, num_steps=steps)
    model = AdvectionDiffusion(prob, SolverConfig(
        dtype=jnp.float32, refine_dtype=jnp.float64, tol=TOL,
        cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
        delta_form=True, certify_every=10))
    uT, stats = model.run(warn=False)
    jax.block_until_ready(uT)
    t0 = time.perf_counter()
    uT, stats = model.run(warn=False)
    jax.block_until_ready((uT, stats))
    warm_s = time.perf_counter() - t0
    certs = _certificates(stats)
    for key, val in certs.items():
        check(val <= TOL, f"n={n} {key} = {val} > {TOL}")
    ref = AdvectionDiffusion(prob, SolverConfig(
        dtype=jnp.float64, tol=TOL, cycle_mode="fixed", num_cycles=2,
        coarse_mode="dense"))
    uT64, st64 = ref.run(warn=False)
    ref_rel = float(np.asarray(st64["rel_residual"]).max())
    check(ref_rel <= 1e-10, f"f64 reference run only reached {ref_rel}")
    err = float(np.abs(np.asarray(uT) - np.asarray(uT64)).max())
    check(err <= 5e-7, f"n={n} delta uT differs from f64 by {err} > 5e-7")
    return {"n": n, "steps": steps, **certs, "max_abs_err_vs_f64": err,
            "atol": 5e-7, "center_uT": model.center_value(uT),
            "warm_run_s_informational": warm_s}


def phase_reference(ctx):
    rec = reference_workload()
    rec["card"] = ctx["card"]
    return rec


def phase_full_size(ctx):
    out = _cli_run(["run", "--n", "8192", "--delta", "--cycle-mode", "fixed",
                    "--num-cycles", "auto", "--coarse", "dense",
                    "--certify-every", "10", "--device-build"])
    for key in ("max_rel_residual", "max_rel_residual_hi_steps",
                "final_rel_residual_hi"):
        check(out[key] is not None and out[key] <= TOL,
              f"n=8192 {key} = {out[key]} > {TOL}")
    check(out["max_cycles"] == 2, f"auto cycles resolved to "
                                  f"{out['max_cycles']}, expected 2")
    out["card"] = ctx["card"]
    return out


def variants(n=1024, steps=100):
    """W-cycle, full weighting, Galerkin, FMG and Poisson, fixed cycles."""
    import jax.numpy as jnp
    import numpy as np

    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion, Poisson

    prob = ProblemConfig(n=n, num_steps=steps)
    delta = dict(dtype=jnp.float32, refine_dtype=jnp.float64, tol=TOL,
                 cycle_mode="fixed", num_cycles=None, coarse_mode="dense",
                 delta_form=True, certify_every=10)
    recs = []
    for name, kw in (("wcycle", dict(cycle_shape=2)),
                     ("full_weighting", dict(restriction="full")),
                     ("galerkin", dict(coarse_operator="galerkin",
                                       device_build=False))):
        model = AdvectionDiffusion(prob, SolverConfig(**delta, **kw))
        uT, stats = model.run(warn=False)
        certs = _certificates(stats)
        for key, val in certs.items():
            check(val <= TOL, f"{name}: {key} = {val} > {TOL}")
        recs.append({"variant": name, "num_cycles": model.solver.num_cycles,
                     **certs, "center_uT": model.center_value(uT)})

    model = AdvectionDiffusion(prob, SolverConfig(
        dtype=jnp.float32, refine_dtype=jnp.float64, tol=TOL,
        cycle_mode="fmg", num_cycles=1, coarse_mode="dense"))
    uT, stats = model.run(warn=False)
    rel = float(np.asarray(stats["rel_residual"]).max())
    check(rel <= TOL, f"fmg: rel_residual {rel} > {TOL}")
    recs.append({"variant": "fmg", "max_rel_residual": rel,
                 "center_uT": model.center_value(uT)})

    pois = Poisson(n, solver=SolverConfig(
        dtype=jnp.float64, tol=TOL, restriction="full", coarse_mode="dense",
        cycle_mode="fixed", num_cycles=6))
    _, stats = pois.solve("mg")
    rel = float(np.asarray(stats["rel_residual"]))
    check(rel <= TOL, f"poisson: rel_residual {rel} > {TOL}")
    recs.append({"variant": "poisson", "num_cycles": 6,
                 "rel_residual": rel})
    return recs


def phase_variants(ctx):
    return {"n": 1024, "variants": variants(), "card": ctx["card"]}


def four_card_runs(n=8192, steps=10, devices=None):
    """distributed_run of a born-sharded delta model on a 2x2 mesh, layouts
    "2d" and "rows", each against the same model on one device.

    Tolerance on uT: 5e-8, under one f32 ulp of the state (|u| <= 1).  The
    partitioned programs do the same arithmetic per grid point; only XLA's
    fusion — and with it the FMA contraction of the f32 increments —
    differs, worth a few f32 ulps of |increment| (<= 1e-2) per step (2.8e-9
    after 10 steps at n=256 on 4 virtual CPU devices).  A wrong halo or
    partition shows as an error of the increment's own size."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion
    from hpcmg.parallel import distributed_run, make_mesh

    devices = jax.devices()[:4] if devices is None else devices
    prob = ProblemConfig(n=n, num_steps=steps)
    cfg = SolverConfig(dtype=jnp.float32, refine_dtype=jnp.float64, tol=TOL,
                       cycle_mode="fixed", num_cycles=None,
                       coarse_mode="dense", delta_form=True,
                       certify_every=10, device_build=True)

    def timed(call):
        """(first call's seconds, trace and compile included; a second,
        warm call's seconds; the warm call's result)."""
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        t1 = time.perf_counter()
        out = call()
        jax.block_until_ready(out)
        return t1 - t0, time.perf_counter() - t1, out

    with jax.default_device(devices[0]):
        single = AdvectionDiffusion(prob, cfg)
        first1, warm1, (uT1, st1) = timed(lambda: single.run(warn=False))
        uT1 = np.asarray(uT1)
    certs1 = _certificates(st1)
    del single

    mesh = make_mesh(devices)
    recs = [{"layout": "single", "devices": 1, **certs1,
             "first_call_s_with_compile": first1,
             "warm_run_s_informational": warm1}]
    for layout in ("2d", "rows"):
        model = AdvectionDiffusion(prob, cfg, mesh=mesh, layout=layout)
        fine = model.levels[0].aa
        used = {s.device for s in fine.addressable_shards}
        check(len(used) == len(devices),
              f"{layout}: fine level on {len(used)} devices")
        check(fine.addressable_shards[0].data.shape[0] < fine.shape[0],
              f"{layout}: fine level not partitioned")
        first, warm, (uT, stats) = timed(lambda: distributed_run(model,
                                                                 mesh))
        check(len(uT.sharding.device_set) == len(devices),
              f"{layout}: result not spread over the mesh")
        certs = _certificates(stats)
        for key, val in certs.items():
            check(val <= TOL, f"{layout}: {key} = {val} > {TOL}")
        err = float(np.abs(np.asarray(uT) - uT1).max())
        check(err <= 5e-8, f"{layout}: uT differs from one card by {err}")
        recs.append({"layout": layout, "devices": len(devices),
                     "mesh": {k: int(v) for k, v in mesh.shape.items()},
                     "fine_shard_shape": list(
                         fine.addressable_shards[0].data.shape),
                     "max_abs_err_vs_single": err, "atol": 5e-8, **certs,
                     "first_call_s_with_compile": first,
                     "warm_run_s_informational": warm})
        del model, uT, stats
    return recs


def phase_four_cards(ctx):
    runs = four_card_runs()
    ctx["count"] = max(r["devices"] for r in runs)
    return {"n": 8192, "steps": 10, "runs": runs, "card": ctx["card"]}


PHASES = {
    "device": phase_device, "gpu_tests": phase_gpu_tests,
    "parity": phase_parity, "ops": phase_ops, "reference": phase_reference,
    "full_size": phase_full_size, "variants": phase_variants,
    "four_cards": phase_four_cards,
}
# phases that run before this process initializes JAX on the card
_PRE_JAX = ("device", "gpu_tests")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the 4-card distributed path (and the device "
                         "phase) only")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import hpcmg  # noqa: F401  (fails outside a checkout of the repo)

    ctx = {"four_cards": args.four_cards, "card": None, "count": None}
    dev = None
    for name in plan(args.four_cards):
        if name not in _PRE_JAX and dev is None:
            import jax

            from hpcmg.utils.runtime import enable_compile_cache, require_gpu

            enable_compile_cache()
            jax.config.update("jax_enable_x64", True)
            dev = require_gpu()
        t0 = time.perf_counter()
        try:
            rec = PHASES[name](ctx)
        except PhaseFailed as e:
            emit({"phase": name, "ok": False, "error": str(e),
                  "card": ctx["card"]})
            return 1
        emit({"phase": name, "ok": True,
              "phase_s": time.perf_counter() - t0, **rec})
    import jax

    # the cards the run used: all of JAX's devices on one card's plan, the
    # mesh's on the four-card plan
    count = ctx["count"] or len(jax.devices())
    emit({"ok": True, "device": {"platform": dev.platform,
                                 "kind": dev.device_kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
