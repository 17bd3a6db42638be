"""Process-level runtime environment control.

JAX backends are initialized once per process, so process-level settings
may demand a re-exec before first use. Parity mode has three:

* CPU backend — the parity engine is the f64 oracle and stays on the CPU
  on purpose: it needs the FMA-free codegen below to be bit-exact,
* ``jax_enable_x64``,
* ``--xla_cpu_max_isa=AVX`` — caps LLVM below FMA so XLA cannot contract
  ``a*b + c`` into a fused multiply-add. The reference binary is compiled for
  baseline x86-64 (no FMA, reference serial/Makefile:1-10); contraction
  changes the last ulp, and a chaotic N-body run amplifies one ulp past the
  golden tolerance within hundreds of steps.
"""

from __future__ import annotations

import os
import sys

PARITY_XLA_FLAGS = "--xla_cpu_max_isa=AVX"
_GUARD = "PSIM_RUNTIME_REEXEC"


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parity_env(n_cpu_devices: int = 1) -> dict:
    """Env deltas for a parity-capable process."""
    flags = os.environ.get("XLA_FLAGS", "")
    for needed in (PARITY_XLA_FLAGS,
                   f"--xla_force_host_platform_device_count={n_cpu_devices}"):
        if needed not in flags:
            flags = (flags + " " + needed).strip()
    return {
        "PYTHONPATH": repo_root(),
        "JAX_PLATFORMS": "cpu",
        "JAX_ENABLE_X64": "true",
        "XLA_FLAGS": flags,
    }


def runtime_satisfies_parity() -> bool:
    return (
        os.environ.get("JAX_PLATFORMS") == "cpu"
        and os.environ.get("JAX_ENABLE_X64", "").lower() in ("1", "true")
        and PARITY_XLA_FLAGS in os.environ.get("XLA_FLAGS", "")
    )


def ensure_parity_runtime(module: str, args: list[str],
                          n_cpu_devices: int = 1) -> None:
    """Re-exec ``python -m module *args`` with a parity env, at most once."""
    if runtime_satisfies_parity() or os.environ.get(_GUARD) == "1":
        return
    env = {**os.environ, **parity_env(n_cpu_devices), _GUARD: "1"}
    os.execvpe(sys.executable, [sys.executable, "-m", module] + list(args), env)


_COUNT_GUARD = "PSIM_DEVCOUNT_REEXEC"


def ensure_device_count(module: str, args: list[str], n: int) -> None:
    """Make sure an ``n``-device mesh exists.

    On the CPU, re-exec onto an ``n``-device virtual CPU mesh when fewer
    devices exist — the analog of the reference harness running
    ``mpirun -np N`` on one machine (reference mpi/run_tests.sh:8-16).
    Keeps the current env (so a parity re-exec's x64/AVX flags survive)
    and only forces the device count. At most one re-exec; if the count
    is still short afterwards the engine raises its own error.

    On an accelerator with fewer than ``n`` devices this raises: a mesh
    run never leaves the device it was asked to run on.
    """
    import jax

    if os.environ.get(_COUNT_GUARD) == "1" or jax.device_count() >= n:
        return
    if jax.default_backend() != "cpu":
        raise RuntimeError(
            f"mesh of {n} devices requested but only {jax.device_count()} "
            f"{jax.default_backend()} device(s) are present")
    flags = os.environ.get("XLA_FLAGS", "")
    # Replace any stale forced count rather than appending a duplicate.
    parts = [f for f in flags.split()
             if not f.startswith("--xla_force_host_platform_device_count=")]
    parts.append(f"--xla_force_host_platform_device_count={n}")
    env = {**os.environ, "PYTHONPATH": repo_root(), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": " ".join(parts), _COUNT_GUARD: "1"}
    os.execvpe(sys.executable, [sys.executable, "-m", module] + list(args), env)
