"""Command-line interface — replaces the reference's four hard-coded `main`
executables (SURVEY §2.4) with one configurable driver.

    python -m hpcmg.cli run --n 256 --dump uT.txt
    python -m hpcmg.cli sweep --sizes 64,128,256,512
    python -m hpcmg.cli scaling --max-devices 8
    python -m hpcmg.cli viz uT.txt --out uT.pdf
    python -m hpcmg.cli diff uT.txt uTother.txt

`run` ≈ ./multigrid (multigrid.cpp:188-293), `sweep` ≈ ./mg_timer
(mg_timer.cu:210-285, which never compiled as committed — SURVEY §2.9.3),
`scaling` ≈ ./multigrid_strongsc (device-count scaling instead of OMP
threads), `viz`/`diff` ≈ uTplot.py / uTerr.py.
"""

from __future__ import annotations

import argparse
import json
import sys


def _solver_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n", type=int, default=256, help="grid size (power of 2)")
    p.add_argument("--steps", type=int, default=100, help="number of CN timesteps")
    p.add_argument("--nu", type=float, default=-4e-4)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--refine", action="store_true",
                   help="mixed-precision refinement (f64 residuals, f32 cycles)")
    p.add_argument("--delta", action="store_true",
                   help="delta-form stepping (f32 increment solve + f32-pair "
                        "state, mg/delta.py); implies --refine, needs "
                        "--cycle-mode fixed")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--cycle-shape", type=int, default=1, help="1=V, 2=W")
    p.add_argument("--niter", type=int, default=3, help="pre/post smoothing sweeps")
    p.add_argument("--levels", type=int, default=None)
    p.add_argument("--smoother", choices=["rbgs", "jacobi", "chebyshev"],
                   default="rbgs")
    p.add_argument("--restriction", choices=["inject", "full"], default="inject")
    p.add_argument("--coarse", choices=["gs", "dense"], default="gs")
    p.add_argument("--coarse-tol", type=float, default=1e-5,
                   help="coarsest-level absolute residual (multigrid.cpp:60)")
    p.add_argument("--coarse-maxiter", type=int, default=1000,
                   help="coarsest-level GS iteration cap (multigrid.cpp:60)")
    p.add_argument("--max-cycles", type=int, default=50,
                   help="outer cycle cap MAX_CYCLE (multigrid.cpp:94)")
    p.add_argument("--coarse-operator", choices=["rediscretize", "galerkin"],
                   default="rediscretize")
    p.add_argument("--cycle-mode", choices=["adaptive", "fixed", "fmg"],
                   default="adaptive")
    p.add_argument("--num-cycles", default=2,
                   type=lambda s: None if s == "auto" else int(s),
                   help="cycles per solve in fixed mode; 'auto' derives the "
                        "count from the diagonal-dominance model "
                        "(config.py::resolved_num_cycles)")
    p.add_argument("--certify-every", type=int, default=0,
                   help="delta mode: rigorous refine-dtype certificate every "
                        "k-th step inside the timed run (0 = final-step "
                        "epilogue only)")
    p.add_argument("--device-build", dest="device_build", default=None,
                   action="store_true",
                   help="generate the model on device from iota (auto at "
                        "n >= 4096; see SolverConfig.device_build)")
    p.add_argument("--host-build", dest="device_build", action="store_false",
                   help="force the host-numpy (oracle) model build")


def _build_model(args, mesh=None, layout="auto"):
    """Build the model from CLI args; with `mesh` (the scaling driver),
    construct it BORN-SHARDED over that mesh when the device build is
    oracle-grade there (x64 + rediscretized operators) — the levels are
    generated under their level shardings and never materialize unsharded
    (mg/levels.py::build_hierarchy_device)."""
    import jax
    import jax.numpy as jnp

    from hpcmg import ProblemConfig, SolverConfig
    from hpcmg.models import AdvectionDiffusion

    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    delta = getattr(args, "delta", False)
    refine = jnp.float64 if (args.refine or delta) else None
    if args.dtype == "f64" or refine is not None:
        jax.config.update("jax_enable_x64", True)
    problem = ProblemConfig(n=args.n, nu=args.nu, num_steps=args.steps)
    solver = SolverConfig(
        num_levels=args.levels,
        cycle_shape=args.cycle_shape,
        niter=args.niter,
        tol=args.tol,
        smoother=args.smoother,
        restriction=args.restriction,
        coarse_mode=args.coarse,
        coarse_tol=args.coarse_tol,
        coarse_maxiter=args.coarse_maxiter,
        max_cycles=args.max_cycles,
        coarse_operator=args.coarse_operator,
        cycle_mode=args.cycle_mode,
        num_cycles=args.num_cycles,
        dtype=dtype,
        refine_dtype=refine,
        delta_form=delta,
        certify_every=getattr(args, "certify_every", 0),
        device_build=getattr(args, "device_build", None),
    )
    if (mesh is not None
            and solver.coarse_operator == "rediscretize"
            and solver.device_build is not False):
        if jax.config.jax_enable_x64 or solver.device_build:
            # explicit --device-build without x64 proceeds (the model
            # constructor warns about f32-compute construction there)
            return AdvectionDiffusion(problem, solver, mesh=mesh,
                                      layout=layout)
        import warnings

        warnings.warn(
            "born-sharded construction skipped (needs x64 for oracle-grade "
            "device build, or explicit --device-build to accept f32 "
            "construction); building unsharded and lifting"
        )
    return AdvectionDiffusion(problem, solver)


def _save_dump(path, field) -> None:
    """`.npy` dumps are lossless; anything else is the reference's `%f`
    text format."""
    from hpcmg.utils.io import save_field, save_field_txt

    (save_field if path.endswith(".npy") else save_field_txt)(path, field)


def _memory_report(compiled) -> dict:
    """Device-memory figures of a compiled program, plus the device's peak
    so far where the backend keeps one."""
    import jax

    rep = {}
    mem = compiled.memory_analysis()
    if mem is not None:
        for key in ("argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes"):
            rep[key] = int(getattr(mem, key))
    stats = jax.devices()[0].memory_stats()
    if stats and "peak_bytes_in_use" in stats:
        rep["peak_bytes_in_use"] = int(stats["peak_bytes_in_use"])
    return rep


def cmd_run(args) -> int:
    import time

    import jax
    import numpy as np

    from hpcmg.utils.io import save_field_txt
    from hpcmg.utils.timing import time_run

    t0 = time.perf_counter()
    model = _build_model(args)
    jax.block_until_ready((model.levels, model.fine_hi, model.u0))
    build_s = time.perf_counter() - t0
    extra = {}

    if args.checkpoint_dir:
        from hpcmg.utils.checkpoint import (
            CheckpointManager,
            run_with_checkpoints,
        )

        mgr = CheckpointManager(args.checkpoint_dir, model.problem)
        uT, steps = run_with_checkpoints(model, mgr, every=args.checkpoint_every)
        stats = None
        timing = {"best_s": None}
    elif args.dump_every:
        # trajectory capture for `viz --animate` (the gs_tester.m:101-129
        # pcolor animation analog): run in dump_every-step chunks, writing a
        # numbered dump series next to --dump
        if not args.dump:
            raise SystemExit("--dump-every requires --dump PREFIX")
        base = args.dump[:-4] if args.dump.endswith((".txt", ".npy")) else args.dump
        u, step = model.u0, 0
        save_field_txt(f"{base}.step0000.txt", model.crop(u))
        while step < model.problem.num_steps:
            chunk = min(args.dump_every, model.problem.num_steps - step)
            u, _ = model.run_chunk(u, chunk)
            step += chunk
            save_field_txt(f"{base}.step{step:04d}.txt", model.crop(u))
        uT, stats = model.crop(u), None
        timing = {"best_s": None}
    else:
        # compile ahead of time so set-up (build + compile) is reported apart
        # from the run; the timed calls are model.run(warn=False) — the
        # warning check copies the per-step stats to the host, so
        # convergence is reported from stats below instead
        t0 = time.perf_counter()
        compiled = model.compile()
        extra["build_s"] = build_s
        extra["compile_s"] = time.perf_counter() - t0
        timing = time_run(
            lambda: compiled(model.levels, model.fine_hi, model.u0),
            reps=args.reps,
        )
        uT, stats = timing.pop("out")
        extra["memory"] = _memory_report(compiled)

    out = {
        "n": args.n,
        "steps": args.steps,
        "seconds": timing["best_s"],
        "center_uT": model.center_value(uT),
    }
    if stats is not None:
        out["max_cycles"] = int(np.asarray(stats["cycles"]).max())
        out["max_rel_residual"] = float(np.asarray(stats["rel_residual"]).max())
        out["converged"] = bool(np.asarray(stats["converged"]).all())
        if "final_rel_residual_hi" in stats:
            # the delta stepper's rigorous high-precision certificates
            out["final_rel_residual_hi"] = float(
                np.asarray(stats["final_rel_residual_hi"])
            )
        if "rel_residual_hi_steps" in stats:
            hi = np.asarray(stats["rel_residual_hi_steps"])
            out["max_rel_residual_hi_steps"] = (
                float(hi[hi >= 0].max()) if (hi >= 0).any() else None
            )
    out.update(extra)
    print(json.dumps(out))
    if args.dump:
        _save_dump(args.dump, uT)
    return 0


def cmd_sweep(args) -> int:
    from hpcmg.utils.timing import time_run

    sizes = [int(s) for s in args.sizes.split(",")]
    for n in sizes:
        args.n = n
        model = _build_model(args)
        timing = time_run(lambda: model.run(warn=False), reps=args.reps)
        uT, stats = timing.pop("out")
        import numpy as np

        # mg_timer.cu:267 printed "Time elapsed for grid size %d: %g ms"
        print(json.dumps({
            "n": n,
            "ms": timing["best_s"] * 1e3,
            "center_uT": model.center_value(uT),
            "max_rel_residual": float(np.asarray(stats["rel_residual"]).max()),
        }), flush=True)
    return 0


def cmd_scaling(args) -> int:
    """Device-count scaling sweeps.

    --mode strong: fixed problem, growing mesh (the multigrid_strongsc.cpp
    :251-262 sweep with chips in place of OMP threads).
    --mode weak: per-device work held constant — the global grid doubles with
    each 4x device count (2-D block decomposition); reports parallel
    efficiency t(1)/t(c) (the north-star weak-scaling metric).

    --distributed: initialize the multi-process runtime first
    (parallel/distributed.py; HPCMG_COORDINATOR / HPCMG_NUM_PROCESSES /
    HPCMG_PROCESS_ID env vars, or auto-detection on managed clusters) and
    scale over the GLOBAL device set; only process 0 prints.
    """
    import jax

    from hpcmg.parallel import distributed_run, make_mesh
    from hpcmg.utils.timing import time_run

    if args.distributed:
        from hpcmg.parallel.distributed import initialize

        initialize()

    emit = print if jax.process_index() == 0 else (lambda *a, **k: None)
    devices = jax.devices()
    limit = min(args.max_devices, len(devices))
    base_t = None
    if jax.process_count() > 1:
        # multi-process SPMD: every process must participate in every
        # program, so only the full global mesh is a valid sweep point
        counts = [len(devices)]
    elif args.mode == "weak":
        counts = [c for c in (1, 4, 16, 64) if c <= limit]
    else:
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= limit]
    base_n = args.n
    for c in counts:
        if args.mode == "weak":
            scale = int(round(c ** 0.5))
            args.n = base_n * scale
        mesh = make_mesh(devices[:c])
        model = _build_model(args, mesh=mesh, layout=args.layout)
        timing = time_run(
            lambda: distributed_run(model, mesh, layout=args.layout),
            reps=args.reps,
        )
        uT, stats = timing.pop("out")
        if base_t is None and len(counts) > 1:
            # single-process sweeps: the first (1-device) point is the ratio
            # baseline.  Under multi-process SPMD only the full global mesh
            # runs (every process must join every program), so there IS no
            # in-run baseline — ratios come from --baseline-seconds (a
            # recorded single-device run) or are omitted entirely rather
            # than printing the degenerate 1.0.
            base_t = timing["best_s"]
        if getattr(args, "baseline_seconds", None):
            base_t = args.baseline_seconds
        rec = {
            "devices": c,
            "n": args.n,
            "mesh": dict(mesh.shape),
            "layout": args.layout,
            "seconds": timing["best_s"],
            "center_uT": model.center_value(uT),
        }
        have_ratio = base_t is not None
        rec["efficiency"] = (
            base_t / timing["best_s"]
            if args.mode == "weak" and have_ratio else None
        )
        if args.mode == "strong" and have_ratio:
            rec["speedup"] = base_t / timing["best_s"]
        emit(json.dumps(rec), flush=True)
    args.n = base_n
    return 0


def cmd_gsbench(args) -> int:
    """Red–black GS throughput microbenchmark — the prolrestest.cu analog
    (500 timed sweeps at N=2048, 31 flops/point/sweep model,
    prolrestest.cu:119-192).  Reports GFLOP/s and stencil-GDOF/s."""
    import jax
    import jax.numpy as jnp

    from hpcmg.core.problem import rotating_velocity
    from hpcmg.core.layout import pad_field
    from hpcmg.mg.levels import build_fine_level
    from hpcmg.ops import padded as pops
    from hpcmg.utils.timing import time_run

    n = args.n
    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    v1, v2 = rotating_velocity(n, dtype=dtype)
    level = build_fine_level(v1, v2, (1.0 / n) / 10, -4e-4, dtype=dtype)
    u = pad_field(jnp.zeros((n + 1, n + 1), dtype).at[1:-1, 1:-1].set(1.0))
    rhs = jnp.zeros_like(u)

    @jax.jit
    def run(u):
        def body(u, _):
            return pops.rb_gauss_seidel(level, u, rhs), None

        return jax.lax.scan(body, u, None, length=args.sweeps)[0]

    t = time_run(run, u, reps=args.reps)
    points = (n - 1) ** 2
    flops = 31.0 * points * args.sweeps          # prolrestest.cu:191 model
    secs = t["best_s"]
    print(json.dumps({
        "n": n,
        "sweeps": args.sweeps,
        "device": str(jax.devices()[0]),
        "seconds": secs,
        "gflops": flops / secs / 1e9,
        "stencil_gdof_s": points * args.sweeps / secs / 1e9,
        "us_per_sweep": secs / args.sweeps * 1e6,
    }))
    return 0


def cmd_viz(args) -> int:
    """pcolormesh render of a dumped field (uTplot.py:1-62 analog); with
    --animate, a time-evolution animation over a dump series (the
    gs_tester.m:101-129 pcolor animation analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from hpcmg.utils.io import load_field_txt

    if args.animate:
        import glob

        from matplotlib.animation import FuncAnimation, PillowWriter

        paths = sorted(glob.glob(args.field))
        if len(paths) < 2:
            raise SystemExit(
                f"--animate needs a dump series (glob {args.field!r} matched "
                f"{len(paths)} files; produce one with `run --dump prefix "
                "--dump-every K`)"
            )
        frames = [load_field_txt(p) for p in paths]
        n = frames[0].shape[0] - 1
        x = np.linspace(0.0, 1.0, n + 1)
        vmax = max(float(np.abs(f).max()) for f in frames) or 1.0
        fig, ax = plt.subplots(figsize=(6, 5))
        pcm = ax.pcolormesh(x, x, frames[0].T, shading="auto",
                            vmin=0.0, vmax=vmax)
        fig.colorbar(pcm, ax=ax)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        title = ax.set_title(paths[0])

        def draw(i):
            pcm.set_array(frames[i].T.ravel())
            title.set_text(paths[i])
            return pcm, title

        anim = FuncAnimation(fig, draw, frames=len(frames))
        out = args.out if args.out.endswith(".gif") else args.out + ".gif"
        anim.save(out, writer=PillowWriter(fps=args.fps))
        print(json.dumps({"out": out, "n": n, "frames": len(frames)}))
        return 0

    field = load_field_txt(args.field)
    n = field.shape[0] - 1
    x = np.linspace(0.0, 1.0, n + 1)
    fig, ax = plt.subplots(figsize=(6, 5))
    pcm = ax.pcolormesh(x, x, field.T, shading="auto")
    fig.colorbar(pcm, ax=ax)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title(args.field)
    fig.savefig(args.out, bbox_inches="tight")
    print(json.dumps({"out": args.out, "n": n}))
    return 0


def cmd_plot_sweep(args) -> int:
    """Log-log runtime-vs-N plot from `sweep` JSON lines — the
    speedupplot.py:1-64 analog (whose input data files were never
    committed to the reference)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = {}
    for path in args.files:
        rows = [json.loads(l) for l in open(path) if l.strip()]
        key = path
        series[key] = ([r["n"] for r in rows],
                       [r.get("ms", r.get("seconds", 0) * 1e3) for r in rows])
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for key, (ns, ms) in series.items():
        ax.loglog(ns, ms, marker="o", label=key)
    ax.set_xlabel("grid size N")
    ax.set_ylabel("runtime [ms]")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.savefig(args.out, bbox_inches="tight")
    print(json.dumps({"out": args.out, "series": list(series)}))
    return 0


def cmd_profile(args) -> int:
    """Per-phase roofline profile of one CN step (SURVEY §5 tracing row —
    the reference only ever timed whole runs, multigrid.cpp:244-246)."""
    from hpcmg.utils.profiling import (
        profile_step,
        trace_step,
    )

    model = _build_model(args)
    prof = profile_step(model, reps=args.reps)
    for rec in prof.pop("phases"):
        print(json.dumps(rec), flush=True)
    print(json.dumps(prof), flush=True)
    if args.trace:
        print(json.dumps({"trace_logdir": trace_step(model, args.trace)}))
    return 0


def cmd_plot_scaling(args) -> int:
    """Runtime-vs-devices plot from `scaling` JSON lines, best point
    highlighted — the strongsc_plot.py:1-111 analog (highlight at :99)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4.5))
    for path in args.files:
        rows = [json.loads(l) for l in open(path) if l.strip()]
        devs = [r.get("devices", r.get("threads")) for r in rows]
        secs = [r.get("seconds", r.get("ms", 0) / 1e3) for r in rows]
        ax.plot(devs, secs, marker="o", label=path)
        best = min(range(len(secs)), key=secs.__getitem__)
        ax.plot([devs[best]], [secs[best]], marker="*", markersize=15,
                color="tab:red", zorder=5)
        ax.annotate(f"best: {devs[best]} @ {secs[best]:.3g}s",
                    (devs[best], secs[best]),
                    textcoords="offset points", xytext=(8, 8))
    ax.set_xlabel("devices")
    ax.set_ylabel("runtime [s]")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.savefig(args.out, bbox_inches="tight")
    print(json.dumps({"out": args.out}))
    return 0


def cmd_diff(args) -> int:
    """Frobenius norm of the difference of two dumps (uTerr.py:58 analog)."""
    from hpcmg.utils.io import (
        field_difference_norm,
        load_field_txt,
    )

    norm = field_difference_norm(load_field_txt(args.a), load_field_txt(args.b))
    print(json.dumps({"frobenius_norm": norm}))
    return 0


def main(argv=None) -> int:
    top = argparse.ArgumentParser(prog="hpcmg")
    sub = top.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="full timestepped solve (multigrid.cpp main)")
    _solver_args(p)
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--dump", default=None,
                   help="write uT: .npy (lossless) or tab-separated text")
    p.add_argument("--dump-every", type=int, default=0,
                   help="also dump every K steps as <dump>.stepNNNN.txt "
                        "(trajectory series for `viz --animate`)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep", help="grid-size timing sweep (mg_timer)")
    _solver_args(p)
    p.add_argument("--sizes", default="32,64,128,256,512,1024")
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("scaling", help="device-count scaling (multigrid_strongsc)")
    _solver_args(p)
    p.add_argument("--max-devices", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--mode", choices=["strong", "weak"], default="strong")
    p.add_argument("--layout", choices=["auto", "2d", "rows"], default="auto",
                   help="level partition layout (parallel/sharding.py): "
                        "'2d' blocks (auto) or 'rows' slabs")
    p.add_argument("--distributed", action="store_true",
                   help="initialize jax.distributed (multi-process) first")
    p.add_argument("--baseline-seconds", type=float, default=None,
                   help="recorded single-device runtime to ratio against "
                        "(required for speedup/efficiency under "
                        "--distributed, where only the full-mesh point runs)")
    p.set_defaults(fn=cmd_scaling)

    p = sub.add_parser("gsbench", help="GS throughput microbench (prolrestest.cu)")
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--sweeps", type=int, default=500)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_gsbench)

    p = sub.add_parser("viz", help="render a field dump (uTplot.py), or an "
                                   "animation of a dump series (gs_tester.m)")
    p.add_argument("field", help="dump file; with --animate, a glob over a "
                                 "dump series (quote it)")
    p.add_argument("--out", default="uT.pdf")
    p.add_argument("--animate", action="store_true")
    p.add_argument("--fps", type=int, default=8)
    p.set_defaults(fn=cmd_viz)

    p = sub.add_parser("plot-sweep", help="log-log runtime plot (speedupplot.py)")
    p.add_argument("files", nargs="+", help="sweep JSON-lines output files")
    p.add_argument("--out", default="sweep.pdf")
    p.set_defaults(fn=cmd_plot_sweep)

    p = sub.add_parser("profile", help="per-phase roofline profile of one step")
    _solver_args(p)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--trace", default=None,
                   help="also record a jax.profiler trace to this logdir")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("plot-scaling",
                       help="runtime-vs-devices plot (strongsc_plot.py)")
    p.add_argument("files", nargs="+", help="scaling JSON-lines output files")
    p.add_argument("--out", default="scaling.pdf")
    p.set_defaults(fn=cmd_plot_scaling)

    p = sub.add_parser("diff", help="compare two field dumps (uTerr.py)")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_diff)

    args = top.parse_args(argv)
    from hpcmg.utils.runtime import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
