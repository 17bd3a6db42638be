"""Early pytest plugin: re-exec with the parity test environment.

Loaded via ``addopts = -p tests.bootstrap_env`` (pytest.ini), whose import
happens *before* pytest starts fd-level capture — so the re-exec'd child
inherits the real stdout. A conftest-time exec would write into the parent's
already-active capture tempfile and appear silent.

The environment cannot be set in-process: JAX fixes its backend and XLA
flags at first use, and the parity engine needs a CPU backend with x64 and
FMA-free codegen plus an 8-device virtual mesh for the sharding tests (the
JAX analog of the reference's "mpirun -np 4 on one machine", reference
mpi/run_tests.sh:8-16).
"""

import os
import sys

_GUARD = "PSIM_TEST_ENV_READY"

if os.environ.get(_GUARD) != "1":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from particlesimulation_tpu.utils import runtime

    env = {**os.environ, **runtime.parity_env(n_cpu_devices=8), _GUARD: "1"}
    os.execvpe(sys.executable,
               [sys.executable, "-m", "pytest"] + sys.argv[1:], env)
