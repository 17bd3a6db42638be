"""Statistical-parity gate: the f32 fast engine vs the f64 parity oracle
on heavy-vector configurations.

The reference validates its parallel variants on ALL golden vectors
(reference mpi/run_tests.sh:41-53 asserts the full table under mpirun);
the f32 fast engine cannot match ±0.001 coordinates over thousands of
chaotic steps (trajectory divergence is physical — the reference's own
OpenMP variant only matches because it is also f64 with identical op
order). This tier is the substitute gate the round-2 review asked for:
run heavy-vector configurations at reduced horizons in BOTH precisions
from identical initial conditions and assert

* collision-count band (collisions are the observable macro-events),
* total-mass band (mass changes only through merge deaths),
* momentum-drift envelope (forces are pairwise-antisymmetric; total
  momentum moves only through f32 rounding, never physics),
* circular center-of-mass envelope (bulk transport agrees even when
  individual trajectories have long since decorrelated).

Horizons are chosen so the f64 parity run stays affordable on CPU in the
default suite; the full-length vectors remain covered exactly by the
parity engine in tests/test_golden.py (PSIM_RUN_SLOW tier).
"""

import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.utils import observables

from tests.conftest import slow

# (seed, side, ncside, N, steps) — heavy-vector shapes at reduced horizons.
CASES = [
    (1, 1000, 3, 10000, 100),      # vector #8 shape: 3x3 grid, pair-heavy
    (12, 100, 5, 10000, 200),      # vector N3 shape: collision-rich
    (-1, 1000, 30, 100000, 60),    # vector #11 shape: normal-mode, 1e5
]

HEAVY_CASES = [
    (3, 5000, 50, 1000000, 20),    # vector #9/#10 shape: N=1e6
]


def _run_both(seed, side, nc, n, steps, impl="resident"):
    pcfg = SimConfig(seed=seed, side=side, ncside=nc, n_particles=n,
                     precision=Precision.PARITY)
    pe = Engine(pcfg)
    ps = pe.run(pe.init_state(), steps)
    fcfg = SimConfig(seed=seed, side=side, ncside=nc, n_particles=n,
                     precision=Precision.FAST)
    fe = Engine(fcfg, impl=impl)
    fs = fe.run(fe.init_state(), steps)
    return ps, fs


def _assert_statistical_parity(ps, fs, side):
    po = observables.summary(ps, side)
    fo = observables.summary(fs, side)

    # Collision counts: same macro-event count within a band. f32 vs f64
    # trajectories decorrelate, so individual near-threshold pairs can
    # resolve differently; the band scales with the count.
    cp, cf = po["collisions"], fo["collisions"]
    band = max(3, int(0.15 * cp))
    assert abs(cf - cp) <= band, f"collisions {cf} vs parity {cp} (±{band})"

    # Mass is conserved except through merge deaths: each collision event
    # kills >= 2 particles; a count mismatch of k events moves mass by
    # O(k * mean particle mass).
    m0 = po["mass"] / max(1, po["alive"])  # mean alive mass scale
    assert abs(fo["mass"] - po["mass"]) <= (3 * band + 4) * 2 * m0, (
        f"mass {fo['mass']:.6g} vs {po['mass']:.6g}")

    # Momentum: physics conserves it exactly (Newton's 3rd law pairs +
    # symmetric monopole approximation errors are not symmetric, so allow
    # a scale-relative envelope vs the absolute momentum content).
    pscale = float(np.sum(np.abs(np.asarray(ps.m))
                          * (np.abs(np.asarray(ps.vx))
                             + np.abs(np.asarray(ps.vy))))) + 1e-30
    dp = abs(fo["momentum"][0] - po["momentum"][0]) + abs(
        fo["momentum"][1] - po["momentum"][1])
    assert dp <= 0.05 * pscale, f"momentum drift {dp:.3g} vs scale {pscale:.3g}"

    # Bulk transport: circular COM within 4% of the box. The COM is
    # mass-weighted, so on collision-rich configs each near-threshold
    # event that resolves differently re-weights it (measured ~2.5-3% on
    # the N3 shape at 200 steps); the tight invariants are the collision
    # band and momentum above, not this transport envelope.
    dcx = abs(fo["com"][0] - po["com"][0])
    dcy = abs(fo["com"][1] - po["com"][1])
    wrap = lambda d: min(d, side - d)
    assert wrap(dcx) <= 0.04 * side and wrap(dcy) <= 0.04 * side, (
        f"COM drift ({dcx:.4g}, {dcy:.4g}) vs side {side}")


@pytest.mark.parametrize("case", CASES,
                         ids=[f"h{i}" for i in range(len(CASES))])
def test_fast_statistical_parity(case):
    seed, side, nc, n, steps = case
    ps, fs = _run_both(seed, side, nc, n, steps)
    _assert_statistical_parity(ps, fs, side)


@slow
@pytest.mark.parametrize("case", HEAVY_CASES,
                         ids=[f"H{i}" for i in range(len(HEAVY_CASES))])
def test_fast_statistical_parity_heavy(case):
    seed, side, nc, n, steps = case
    ps, fs = _run_both(seed, side, nc, n, steps)
    _assert_statistical_parity(ps, fs, side)


def test_fast_statistical_parity_supercell():
    """The sparse-grid super-cell engine through the same gate on a
    SMALL-shaped workload (reference SMALL: 0.3 particles/cell,
    CPD_2nd_delivery.pdf p.4) — the regime it exists for."""
    seed, side, nc, n, steps = (50, 2000, 260, 20000, 50)
    ps, fs = _run_both(seed, side, nc, n, steps, impl="supercell")
    _assert_statistical_parity(ps, fs, side)


@pytest.mark.parametrize("impl", ["banded", "tiered"])
def test_fast_statistical_parity_clustered_impls(impl):
    """The clustered-grid engines through the same gate on the
    normal-mode (Gaussian-blob) vector-#11 shape — the workload regime
    they exist for (reference UNEVEN, CPD_2nd_delivery.pdf p.6)."""
    seed, side, nc, n, steps = (-1, 1000, 30, 100000, 60)
    ps, fs = _run_both(seed, side, nc, n, steps, impl=impl)
    _assert_statistical_parity(ps, fs, side)
