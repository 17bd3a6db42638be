"""The reference's golden end-to-end vectors (SURVEY §4).

Expected values are the hardcoded tables from the reference test harnesses
(reference serial/run_tests.sh:30-42, openMP/new_tests.sh:30-35), asserted
with the harness tolerances: coordinates ±0.001, collision count exact.

Heavy vectors are gated behind PSIM_RUN_SLOW=1 and run in the f64 parity
engine, whose offset-sweep costs O(N·k_max) lanes per step on CPU: the
N=1e6 low-step vectors take minutes, while the high-occupancy long-horizon
ones (s5/s6 at ncside=50 × 300/500 steps, s9) take multiple hours each —
budget accordingly. ALL 15 vectors verified passing, s6 (804 collisions)
and s9 (2209 collisions, with the occupancy-blocked sweep) through the
chunked runner, whose logs are archived under verification/. That is the reference harness's full table
(reference serial/run_tests.sh:30-42 + openMP/new_tests.sh:30-35), 15/15.
"""

import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from tests.conftest import slow

# (seed, side, ncside, n, steps, exp_x, exp_y, exp_collisions)
FAST_VECTORS = [
    (1, 2, 3, 10, 1, 1.570, 0.056, 0),
    (1, 1, 5, 100, 1, 0.786, 0.027, 0),
    (-10, 3, 3, 100, 10, 1.733, 1.643, 2),
    (5893, 0.05, 3, 10, 10, 0.002, 0.035, 2),
    (8555, 0.05, 3, 10, 10, 0.016, 0.049, 1),
]

SLOW_VECTORS = [
    (-50, 10000, 200, 500000, 10, 5025.384, 5303.928, 4),
    (1, 5000, 100, 1000000, 4, 3936.506, 131.472, 4),
    (1, 5000, 100, 1000000, 100, 3899.787, 156.291, 163),
    (1, 5000, 20, 1000000, 10, 3918.912, 143.364, 19),
    (1, 1000, 3, 10000, 10000, 287.788, 261.446, 31),
    (3, 5000, 50, 1000000, 300, 3819.032, 25.659, 469),
    (3, 5000, 50, 1000000, 500, 3738.436, 58.743, 804),
    (-1, 1000, 30, 100000, 1000, 575.878, 370.663, 1203),
    (12, 100, 5, 10000, 10000, 76.732, 61.943, 2209),
    (-11, 3500, 20, 500000, 10, 1984.878, 1625.992, 35),
]


def _run(seed, side, nc, n, steps):
    cfg = SimConfig(seed=seed, side=side, ncside=nc, n_particles=n,
                    precision=Precision.PARITY)
    eng = Engine(cfg)
    state = eng.run(eng.init_state(), steps)
    return eng.result(state)


def _assert_vector(vec):
    seed, side, nc, n, steps, ex, ey, ec = vec
    x, y, c = _run(seed, side, nc, n, steps)
    assert abs(x - ex) <= 0.001, f"x: {x:.3f} vs {ex:.3f}"
    assert abs(y - ey) <= 0.001, f"y: {y:.3f} vs {ey:.3f}"
    assert c == ec, f"collisions: {c} vs {ec}"


@pytest.mark.parametrize("vec", FAST_VECTORS,
                         ids=[f"v{i}" for i in range(len(FAST_VECTORS))])
def test_golden_fast(vec):
    _assert_vector(vec)


@slow
@pytest.mark.parametrize("vec", SLOW_VECTORS,
                         ids=[f"s{i}" for i in range(len(SLOW_VECTORS))])
def test_golden_slow(vec):
    _assert_vector(vec)
