"""Row-banded resident engine (ops/banded.py) vs the resident engine.

The banded engine must reproduce the single-buffer resident physics
(same collision counts, same dead sets, positions within f32
order-of-summation noise) while crossing band boundaries through the
halo-row shipping path — the in-program analog of the reference MPI
variant's particle exchange (mpi/parsim-mpi.cpp:512-600), asserted the
way mpi/run_tests.sh asserts same-output-as-serial.
"""

import numpy as np
import pytest

import tests.bootstrap_env  # noqa: F401

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine


def _dead(out):
    pid = np.asarray(out.pid)
    alive = np.asarray(out.alive)
    return set(pid[~alive].tolist())


def _sorted_xy(out):
    order = np.argsort(np.asarray(out.pid))
    return np.asarray(out.x)[order], np.asarray(out.y)[order]


def _run_pair(cfg, band_plan, steps):
    ref = Engine(cfg, impl="resident")
    out_r = ref.run(ref.init_state(), steps)
    eng = Engine(cfg, impl="banded")
    if band_plan is not None:
        eng._band_plan = band_plan
    out_b = eng.run(eng.init_state(), steps)
    return out_r, out_b, eng


def test_banded_matches_resident_clustered():
    """Gaussian-blob (normal-mode) config across 4 uneven-cap bands."""
    cfg = SimConfig(seed=-7, side=100.0, ncside=12, n_particles=4000,
                    precision=Precision.FAST)
    plan = ((0, 3, 64), (3, 3, 256), (6, 3, 256), (9, 3, 64))
    out_r, out_b, eng = _run_pair(cfg, plan, 25)
    assert eng.impl == "banded"
    assert int(np.asarray(out_b.overflow)) == 0
    assert int(np.asarray(out_r.collisions)) == int(
        np.asarray(out_b.collisions))
    assert _dead(out_r) == _dead(out_b)
    xr, yr = _sorted_xy(out_r)
    xb, yb = _sorted_xy(out_b)
    np.testing.assert_allclose(xr, xb, atol=5e-3)
    np.testing.assert_allclose(yr, yb, atol=5e-3)
    # No particle lost or duplicated through band shipping.
    assert sorted(np.asarray(out_b.pid).tolist()) == list(
        range(cfg.n_particles))
    assert np.isclose(np.asarray(out_r.m).sum(), np.asarray(out_b.m).sum(),
                      rtol=1e-6)


def test_banded_migration_across_bands():
    """Fast-moving uniform load: every band boundary sees crossings."""
    cfg = SimConfig(seed=5, side=8.0, ncside=8, n_particles=600,
                    precision=Precision.FAST)
    plan = ((0, 2, 64), (2, 2, 64), (4, 2, 64), (6, 2, 64))
    out_r, out_b, _ = _run_pair(cfg, plan, 30)
    assert int(np.asarray(out_b.overflow)) == 0
    assert int(np.asarray(out_r.collisions)) == int(
        np.asarray(out_b.collisions))
    assert _dead(out_r) == _dead(out_b)
    xr, yr = _sorted_xy(out_r)
    xb, yb = _sorted_xy(out_b)
    np.testing.assert_allclose(xr, xb, atol=5e-3)
    np.testing.assert_allclose(yr, yb, atol=5e-3)


def test_banded_capacity_retry_lossless():
    """Undersized band caps overflow and the engine replays losslessly."""
    cfg = SimConfig(seed=-3, side=50.0, ncside=10, n_particles=3000,
                    precision=Precision.FAST)
    ref = Engine(cfg, impl="resident")
    out_r = ref.run(ref.init_state(), 10)
    eng = Engine(cfg, impl="banded")
    # Blob center lands in the middle rows; 32 slots/cell is far too few.
    eng._band_plan = ((0, 3, 32), (3, 4, 32), (7, 3, 32))
    out_b = eng.run(eng.init_state(), 10)
    # The retry grew capacity (possibly escalating impls) without losing
    # a particle or a collision.
    assert int(np.asarray(out_b.overflow)) == 0
    assert int(np.asarray(out_r.collisions)) == int(
        np.asarray(out_b.collisions))
    assert sorted(np.asarray(out_b.pid).tolist()) == list(
        range(cfg.n_particles))


def test_banded_halo_lane_budget_overflow_lossless(monkeypatch):
    """A tiny PSIM_BAND_HALO_W drops band-crossers from the attempt; the
    overflow flag must fire and the engine replay losslessly."""
    monkeypatch.setenv("PSIM_BAND_HALO_W", "1")
    cfg = SimConfig(seed=5, side=8.0, ncside=8, n_particles=600,
                    precision=Precision.FAST)
    ref = Engine(cfg, impl="resident")
    out_r = ref.run(ref.init_state(), 15)
    eng = Engine(cfg, impl="banded")
    eng._band_plan = ((0, 4, 64), (4, 4, 64))
    out_b = eng.run(eng.init_state(), 15)
    assert int(np.asarray(out_b.overflow)) == 0
    assert int(np.asarray(out_r.collisions)) == int(
        np.asarray(out_b.collisions))
    assert sorted(np.asarray(out_b.pid).tolist()) == list(
        range(cfg.n_particles))


def test_plan_bands_shapes():
    from particlesimulation_tpu.ops.banded import plan_bands

    # Uniform occupancy: banding buys nothing -> None.
    assert plan_bands(np.full((20, 20), 9), 20, 4096) is None

    # Strongly clustered rows: a real plan that tiles the grid.
    hist = np.ones((64, 64), np.int64)
    hist[28:36] = 600
    plan = plan_bands(hist, 64, 4096)
    assert plan is not None and len(plan) >= 2
    assert plan[0][0] == 0
    assert sum(rw for _, rw, _ in plan) == 64
    for (r0, rw, k), (r0n, _, _) in zip(plan, plan[1:]):
        assert r0 + rw == r0n
        assert k % 32 == 0 or k == plan[-1][2]
    # The hot rows got a fat cap, the fringe a thin one.
    caps = {r0: k for r0, _, k in plan}
    assert max(k for _, _, k in plan) >= 608
    assert min(k for _, _, k in plan) <= 64


def test_banded_golden_vector_3():
    """Reference golden vector #3 (-10 3 3 100 10 -> 1.733 1.643 / 2,
    serial/run_tests.sh:33) through forced 3-band tiles."""
    cfg = SimConfig(seed=-10, side=3.0, ncside=3, n_particles=100,
                    precision=Precision.FAST)
    eng = Engine(cfg, impl="banded")
    eng._band_plan = ((0, 1, 64), (1, 1, 128), (2, 1, 64))
    out = eng.run(eng.init_state(), 10)
    from particlesimulation_tpu.state import result_of
    x, y, coll = result_of(out)
    assert f"{x:.3f} {y:.3f}" == "1.733 1.643"
    assert coll == 2


# ---- band-major fused step (round 5) -----------------------------------

def _banded_out(cfg, plan, steps, state=None, fused=True):
    # Default is the general step; opt in per-run via env so both paths
    # stay covered.
    import os
    prev = os.environ.get("PSIM_BANDED_FUSED")
    os.environ["PSIM_BANDED_FUSED"] = "1" if fused else "0"
    try:
        eng = Engine(cfg, impl="banded")
        eng._band_plan = plan
        out = eng.run(state if state is not None else eng.init_state(),
                      steps)
    finally:
        if prev is None:
            os.environ.pop("PSIM_BANDED_FUSED", None)
        else:
            os.environ["PSIM_BANDED_FUSED"] = prev
    return out, eng


def test_banded_fused_matches_general_bitwise():
    """fused=True and fused=False run the identical op sequence whenever
    one exchange suffices: same mover walks, same merge ranks, same pair
    domain — so the trajectories are BITWISE equal, not just close."""
    cfg = SimConfig(seed=-7, side=100.0, ncside=12, n_particles=4000,
                    precision=Precision.FAST)
    plan = ((0, 3, 64), (3, 3, 256), (6, 3, 256), (9, 3, 64))
    out_f, eng_f = _banded_out(cfg, plan, 25, fused=True)
    out_g, _ = _banded_out(cfg, plan, 25, fused=False)
    assert not eng_f._fused_off, "fused run fell back unexpectedly"
    assert int(np.asarray(out_f.overflow)) == 0
    for f in ("x", "y", "vx", "vy", "m", "alive", "pid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out_f, f)), np.asarray(getattr(out_g, f)),
            err_msg=f)
    assert int(np.asarray(out_f.collisions)) == int(
        np.asarray(out_g.collisions))


def test_banded_fused_ship_fallback_lossless():
    """A mover crossing TWO band boundaries in one step exceeds the fused
    step's single unrolled exchange: the run must flag SHIP_OVF, fall
    back to the general shipping step, and lose nothing."""
    import jax.numpy as jnp
    from particlesimulation_tpu.state import SimState

    nc, side, n = 8, 8.0, 64
    cfg = SimConfig(seed=1, side=side, ncside=nc, n_particles=n,
                    precision=Precision.FAST)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, side, n)
    y = rng.uniform(0, side, n)
    vx = np.zeros(n)
    vy = np.zeros(n)
    # Particle 0: crosses 2.5 cell rows per step (DELTAT=0.1, w=1.0).
    x[0], y[0] = 4.5, 0.5
    vy[0] = 25.0
    m = np.full(n, 1e-9)  # tiny masses: no collisions, forces negligible

    def mkstate():
        z = jnp.zeros((), jnp.int32)
        return SimState(
            x=jnp.asarray(x, jnp.float32), y=jnp.asarray(y, jnp.float32),
            vx=jnp.asarray(vx, jnp.float32),
            vy=jnp.asarray(vy, jnp.float32),
            m=jnp.asarray(m, jnp.float32),
            alive=jnp.ones(n, dtype=bool),
            pid=jnp.arange(n, dtype=jnp.int32),
            collisions=z, panics=z, overflow=z)

    plan = tuple((r, 1, 32) for r in range(nc))  # 1-row bands
    out_f, eng = _banded_out(cfg, plan, 4, state=mkstate(), fused=True)
    assert eng._fused_off, "2-boundary hop did not trigger the fallback"
    assert int(np.asarray(out_f.overflow)) == 0
    ref = Engine(cfg, impl="resident")
    out_r = ref.run(mkstate(), 4)
    order_f = np.argsort(np.asarray(out_f.pid))
    order_r = np.argsort(np.asarray(out_r.pid))
    np.testing.assert_allclose(np.asarray(out_f.x)[order_f],
                               np.asarray(out_r.x)[order_r], atol=5e-3)
    np.testing.assert_allclose(np.asarray(out_f.y)[order_f],
                               np.asarray(out_r.y)[order_r], atol=5e-3)
    assert sorted(np.asarray(out_f.pid).tolist()) == list(range(n))
