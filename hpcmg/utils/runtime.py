"""Process set-up shared by the entry points (cli.py, bench.py,
chip_smoke.py): the persistent compilation cache, and the accelerator checks
that every measurement path makes before it reports a number."""

from __future__ import annotations

import os
import subprocess

# root of the checkout that holds this package (hpcmg/utils/runtime.py)
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    changed here.  Otherwise the cache goes to the fixed `<checkout>/.jax_cache`
    (listed in .gitignore): a directory that moved between runs would never
    hit.  Call before the first compilation; nothing calls this at import.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> list[str]:
    """One `name, power.limit` line per card, as nvidia-smi prints them.

    Runs in a child process that does not import JAX, so it can be called
    while another process holds the card.  Raises if nvidia-smi is missing
    or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpu():
    """Return JAX's first device, which must be a GPU.

    A measurement that finds no GPU stops here instead of falling back to
    the CPU, whose times say nothing about the card."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is on platform {dev.platform!r}"
        )
    return dev
