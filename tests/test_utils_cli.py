"""utils/ (io, timing, checkpoint) and the CLI driver."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from hpcmg import ProblemConfig, SolverConfig
from hpcmg.cli import main
from hpcmg.models import AdvectionDiffusion
from hpcmg.utils import (
    CheckpointManager,
    field_difference_norm,
    load_field_txt,
    run_with_checkpoints,
    save_field_txt,
    time_run,
)


def test_field_txt_roundtrip(tmp_path):
    f = np.random.default_rng(0).random((17, 17))
    path = tmp_path / "uT.txt"
    save_field_txt(path, f)
    back = load_field_txt(path)
    # reference format is %f — 6 decimal places (multigrid.cpp:272)
    np.testing.assert_allclose(back, f, atol=1e-6)
    assert field_difference_norm(f, f) == 0.0


@pytest.mark.slow
def test_checkpoint_resume_matches_straight_run(tmp_path):
    p = ProblemConfig(n=64, num_steps=20)
    s = SolverConfig(dtype=jnp.float64)
    model = AdvectionDiffusion(p, s)
    uT_straight, _ = model.run()

    mgr = CheckpointManager(tmp_path / "ck", p)
    uT_a, steps = run_with_checkpoints(model, mgr, every=7)
    assert steps == 20
    np.testing.assert_allclose(np.asarray(uT_a), np.asarray(uT_straight), atol=1e-14)

    # simulate a crash after step 14: drop the final checkpoint and resume
    mgr2 = CheckpointManager(tmp_path / "ck2", p)
    u, _ = model.run_chunk(model.u0, 14)
    mgr2.save(14, model.crop(u))
    uT_b, steps = run_with_checkpoints(model, mgr2, every=7)
    assert steps == 20
    np.testing.assert_allclose(np.asarray(uT_b), np.asarray(uT_straight), atol=1e-14)


def test_checkpoint_manager_prune_and_mismatch(tmp_path):
    p = ProblemConfig(n=64, num_steps=10)
    mgr = CheckpointManager(tmp_path / "ck", p, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, np.zeros((65, 65)))
    assert mgr.steps() == [3, 4]
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path / "ck", ProblemConfig(n=128, num_steps=10))


def test_time_run_reports_best():
    model = AdvectionDiffusion(
        ProblemConfig(n=64, num_steps=2), SolverConfig(dtype=jnp.float64)
    )
    t = time_run(lambda: model.run(), reps=2)
    assert t["best_s"] > 0 and len(t["times"]) == 2


def test_cli_run_dump_diff(tmp_path, capsys):
    dump = str(tmp_path / "uT.txt")
    rc = main(["run", "--n", "64", "--steps", "5", "--dtype", "f64", "--dump", dump])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] and out["max_cycles"] == 1
    assert os.path.exists(dump)

    rc = main(["diff", dump, dump])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["frobenius_norm"] == 0.0


def test_cli_run_checkpointed(tmp_path, capsys):
    rc = main([
        "run", "--n", "64", "--steps", "10", "--dtype", "f64",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "4",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["center_uT"] != 0.0


def test_cli_sweep(capsys):
    rc = main(["sweep", "--sizes", "16,32", "--steps", "2", "--dtype", "f64",
               "--reps", "1", "--levels", "1"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [l["n"] for l in lines] == [16, 32]


def test_cli_chebyshev_fmg(capsys):
    """chebyshev + fmg are reachable from the CLI."""
    rc = main(["run", "--n", "64", "--steps", "2", "--dtype", "f64",
               "--smoother", "chebyshev", "--cycle-mode", "fmg",
               "--num-cycles", "1", "--coarse", "dense"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"]


def test_cli_solver_constant_flags(capsys):
    """coarse-tol / coarse-maxiter / max-cycles are surfaced as flags
    (multigrid.cpp:60,94 constants)."""
    rc = main(["run", "--n", "64", "--steps", "2", "--dtype", "f64",
               "--coarse-tol", "1e-7", "--coarse-maxiter", "500",
               "--max-cycles", "10"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"]


def test_cli_delta(capsys):
    """--delta runs the delta-form stepper from the CLI."""
    rc = main(["run", "--n", "64", "--steps", "3", "--delta",
               "--cycle-mode", "fixed", "--num-cycles", "1",
               "--coarse", "dense"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"]


def test_cli_trajectory_dump_and_animation(tmp_path, capsys):
    """run --dump-every writes a numbered dump series; viz --animate renders
    it to a gif (the gs_tester.m:101-129 pcolor animation analog)."""
    import glob as _glob

    dump = str(tmp_path / "uT.txt")
    rc = main(["run", "--n", "32", "--steps", "6", "--dtype", "f64",
               "--dump", dump, "--dump-every", "2"])
    assert rc == 0
    capsys.readouterr()
    series = sorted(_glob.glob(str(tmp_path / "uT.step*.txt")))
    assert len(series) == 4  # steps 0, 2, 4, 6
    # final series entry equals the final dump
    rc = main(["diff", dump, series[-1]])
    assert json.loads(capsys.readouterr().out)["frobenius_norm"] == 0.0

    gif = str(tmp_path / "anim.gif")
    rc = main(["viz", str(tmp_path / "uT.step*.txt"), "--animate",
               "--out", gif])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["frames"] == 4
    assert os.path.getsize(gif) > 1000


def test_cli_run_device_build_and_auto_cycles(capsys):
    """--device-build + --num-cycles auto end to end through the CLI: the
    production flags compose with the delta flagship config."""
    rc = main([
        "run", "--n", "64", "--steps", "5", "--delta", "--cycle-mode",
        "fixed", "--num-cycles", "auto", "--coarse", "dense",
        "--device-build", "--certify-every", "2",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"]
    assert out["max_rel_residual"] <= 1e-6


@pytest.mark.slow
def test_checkpoint_resume_device_built_model(tmp_path):
    """Checkpoint/resume drives a device-built delta model identically to
    its straight run (the construction path must not break the padded-state
    round-trip)."""
    p = ProblemConfig(n=64, num_steps=20)
    s = SolverConfig(dtype=jnp.float32, refine_dtype=jnp.float64,
                     cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
                     delta_form=True, device_build=True)
    model = AdvectionDiffusion(p, s)
    uT_straight, _ = model.run(warn=False)
    mgr = CheckpointManager(tmp_path / "ck", p)
    uT_a, steps = run_with_checkpoints(model, mgr, every=7)
    assert steps == 20
    np.testing.assert_allclose(np.asarray(uT_a), np.asarray(uT_straight),
                               atol=1e-11)
