"""Process set-up and the GPU entry points, as far as the CPU can check them:
the compile-cache helper, the one-card-per-process default of the
distributed runtime, and that chip_smoke.py and bench.py refuse to run (and
report nothing) without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from hpcmg.parallel.distributed import default_local_device_ids
from hpcmg.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache(env_set, monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert runtime.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself: the helper sets nothing
            assert jax.config.jax_compilation_cache_dir == old
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(ROOT, ".jax_cache")
            assert runtime.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
            # a fixed path: calling again changes nothing
            assert runtime.enable_compile_cache() == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_jax_cache_dir_is_ignored_by_git():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env,coordinator,pid,want", [
    ("2,3", "localhost:1234", 1, [2, 3]),     # explicit ids win
    (None, "localhost:1234", 3, [3]),         # one card per local process
    (None, "127.0.0.1:99", 0, [0]),
    (None, "node7:1234", 1, None),            # other hosts: JAX decides
    (None, None, None, None),                 # managed-cluster autodetect
])
def test_default_local_device_ids(env, coordinator, pid, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("HPCMG_LOCAL_DEVICE", raising=False)
    else:
        monkeypatch.setenv("HPCMG_LOCAL_DEVICE", env)
    assert default_local_device_ids(coordinator, pid) == want


def test_require_gpu_refuses_the_cpu():
    assert jax.devices()[0].platform != "gpu"
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


def _run(argv, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _reports_ok(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_chip_smoke_fails_without_gpu():
    res = _run(["chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert not _reports_ok(res.stdout), res.stdout
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["phase"] == "device" and last["ok"] is False


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert not _reports_ok(res.stdout)


@pytest.mark.parametrize("four_cards", [False, True])
def test_chip_smoke_plan(four_cards):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    phases = chip_smoke.plan(four_cards)
    assert phases[0] == "device"
    assert set(phases) <= set(chip_smoke.PHASES)
    if four_cards:
        # the four-card option runs its path and nothing else
        assert phases == ("device", "four_cards")
    else:
        assert "four_cards" not in phases
        assert phases[1] == "gpu_tests"  # before this process opens the card
        assert set(chip_smoke._PRE_JAX) == set(phases[:2])


def test_bench_refuses_without_gpu():
    res = _run(["bench.py"], ROOT)
    assert res.returncode != 0
    assert "metric" not in res.stdout


def test_cli_run_npy_dump_and_setup_report(tmp_path, capsys):
    from hpcmg.cli import main

    dump = str(tmp_path / "uT.npy")
    assert main(["run", "--n", "32", "--steps", "3", "--dtype", "f64",
                 "--levels", "2", "--dump", dump]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("build_s", "compile_s", "seconds"):
        assert out[key] > 0
    assert out["memory"]["argument_size_in_bytes"] > 0
    uT = np.load(dump)
    assert uT.shape == (33, 33) and uT.dtype == np.float64
    assert uT[16, 16] == out["center_uT"]  # lossless
