"""Golden vectors through the FAST engine (the production path).

The reference harness tolerances (coords ±0.001, collision count exact,
serial/run_tests.sh:30-42) are asserted for the f32 fast engine on the five
fast vectors, for every implementation in the escalation chain, so the
production path's end-to-end output is asserted and not only the parity
engine's.

Divergence horizon on the heavy vectors is measured separately by
tools/fast_divergence.py (f32 trajectories of a
chaotic system leave the ±0.001 window after a few hundred steps; the
reference's own OpenMP/MPI variants have the same property vs its serial
binary, which is why its harness only checks short runs at full tolerance).
"""

import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine

from tests.test_golden import FAST_VECTORS

IMPLS = ["sweep", "resident", "dense", "tiered"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("vec", FAST_VECTORS,
                         ids=[f"v{i}" for i in range(len(FAST_VECTORS))])
def test_fast_engine_golden(vec, impl):
    seed, side, nc, n, steps, ex, ey, ec = vec
    cfg = SimConfig(seed=seed, side=side, ncside=nc, n_particles=n,
                    precision=Precision.FAST)
    eng = Engine(cfg, impl=impl)
    out = eng.run(eng.init_state(), steps)
    x, y, c = eng.result(out)
    assert abs(x - ex) <= 0.001, f"x: {x:.4f} vs {ex:.3f}"
    assert abs(y - ey) <= 0.001, f"y: {y:.4f} vs {ey:.3f}"
    assert c == ec, f"collisions: {c} vs {ec}"
    assert int(np.asarray(out.overflow)) == 0


def test_fast_engine_cli_golden(tmp_path):
    """`--engine fast` through the real CLI (subprocess, byte contract)."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "particlesimulation_tpu",
         "-10", "3", "3", "100", "10", "--engine", "fast"],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 2
    x, y = map(float, lines[0].split())
    assert abs(x - 1.733) <= 0.001 and abs(y - 1.643) <= 0.001
    assert int(lines[1]) == 2
