"""Sharded super-cell engine vs the single-chip super-cell engine.

The decomposition changes communication, not math: every super-cell row
lives wholly on one shard, COM/stencil run at cell granularity with a
one-cell-row ppermute halo, and the sub-labeled pair kernel reduces over
slots identically — so collision counts and the dead set must match the
single-chip super-cell engine exactly, positions to printed precision.

This is the distributed path for the reference's sparse SMALL regime
(ncside >> sqrt(N)), which the reference itself runs distributed —
badly, 1.43x serial at 12x8 MPI (g32mpi/CPD_2nd_delivery.pdf p.5
table 1) — under the same one-binary mpirun harness
(mpi/run_tests.sh:8-16).

Also covers the mesh census auto-routing contract: a sparse config under a mesh auto-selects supercell, a clustered
UNEVEN-shaped config auto-selects banded-cols, with no --impl flag.
"""

import jax
import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.parallel.sharded import ShardedEngine

NDEV = len(jax.devices())
needs_mesh = pytest.mark.skipif(NDEV < 8, reason="needs 8 virtual devices")


def _run_pair(base, shards, steps, **kw):
    se = Engine(SimConfig(**base), impl="supercell")
    ss = se.run(se.init_state(), steps)
    me = ShardedEngine(SimConfig(**base, n_shards=shards),
                       impl="supercell", **kw)
    ms = me.run(me.init_state(), steps)
    assert me.impl == "supercell", "fell off the supercell path"
    return se, ss, me, ms


@needs_mesh
@pytest.mark.parametrize(
    "seed,side,nc,n,steps,shards",
    [
        (1, 3.0, 24, 300, 20, 8),     # 0.52/cell sparse, S=3, nsc=8
        (1, 3.0, 24, 300, 20, 3),     # uneven: nsc=8 over 3 shards
        (7, 6.0, 32, 400, 15, 8),     # S=2/4 candidates, migration
        (5893, 0.5, 16, 200, 15, 2),  # collisions (reference N1 seed)
        (1, 3.0, 24, 300, 12, 1),     # d=1 self-wrap ring
    ],
)
def test_sharded_supercell_matches_single(seed, side, nc, n, steps,
                                          shards):
    base = dict(seed=seed, side=side, ncside=nc, n_particles=n,
                precision=Precision.FAST)
    se, ss, me, ms = _run_pair(base, shards, steps)
    xs, ys, cs = se.result(ss)
    xm, ym, cm = me.result(ms)
    assert cm == cs
    assert abs(xm - xs) < 1e-3 and abs(ym - ys) < 1e-3
    assert int(np.asarray(ms.overflow)) == 0
    g = me.gather(ms)
    assert (np.unique(g["pid"]) == np.arange(n)).all()
    order = np.argsort(np.asarray(ss.pid))
    np.testing.assert_array_equal(
        g["alive"], np.asarray(ss.alive)[order])
    # Positions to printed precision (same formulation, same math).
    np.testing.assert_allclose(
        g["x"], np.asarray(ss.x)[order], atol=1e-3)
    np.testing.assert_allclose(
        g["y"], np.asarray(ss.y)[order], atol=1e-3)


@needs_mesh
def test_sharded_supercell_collides_and_migrates():
    """The contract case: collisions AND cross-shard migration happen."""
    base = dict(seed=5893, side=0.5, ncside=16, n_particles=200,
                precision=Precision.FAST)
    se, ss, me, ms = _run_pair(base, 4, 15)
    assert int(np.asarray(ms.collisions)) > 0
    g0 = me.gather(me.init_state())
    g = me.gather(ms)
    # Some particle changed owner super-row block.
    from particlesimulation_tpu.parallel.sharded_supercell import (
        sc_row_starts)
    S = me._sc_factor
    nsc = 16 // S
    starts = np.asarray(sc_row_starts(nsc, 4))
    w = base["side"] / base["ncside"]

    def owner(gg):
        scrow = np.clip((np.asarray(gg["y"]) / w).astype(np.int64) // S,
                        0, nsc - 1)
        return np.clip(np.searchsorted(starts, scrow, side="right") - 1,
                       0, 3)

    assert (owner(g0) != owner(g)).sum() > 0


@needs_mesh
def test_sharded_supercell_chunked_runs_compose():
    """run(10)+run(10) == run(20): lossless slab round-trip.

    The epilogue/prologue round trip canonicalizes within-tile slot
    order, which reorders the f32 pair-sum accumulation (a ~1-ulp
    effect); the contract is the particle SET (pid/alive exact) and
    trajectories far below the 1e-3 print tolerance, not slot-order
    bitwise identity.
    """
    cfg = SimConfig(seed=1, side=3.0, ncside=24, n_particles=300,
                    precision=Precision.FAST, n_shards=8)
    e1 = ShardedEngine(cfg, impl="supercell")
    s1 = e1.run(e1.run(e1.init_state(), 10), 10)
    e2 = ShardedEngine(cfg, impl="supercell")
    s2 = e2.run(e2.init_state(), 20)
    g1, g2 = e1.gather(s1), e2.gather(s2)
    np.testing.assert_array_equal(g1["pid"], g2["pid"])
    np.testing.assert_array_equal(g1["alive"], g2["alive"])
    np.testing.assert_array_equal(g1["m"], g2["m"])
    for f in ("x", "y", "vx", "vy"):
        np.testing.assert_allclose(g1[f], g2[f], atol=1e-6, err_msg=f)


@needs_mesh
def test_sharded_supercell_kcap_retry():
    """Tile overflow retries losslessly with larger tiles."""
    base = dict(seed=5893, side=0.5, ncside=16, n_particles=200,
                precision=Precision.FAST)
    se, ss, me, ms = _run_pair(base, 2, 15, kcap=8)
    assert int(np.asarray(ms.collisions)) == int(np.asarray(ss.collisions))
    assert int(np.asarray(ms.overflow)) == 0


# ---- census auto-routing ------------------------------------------------

@needs_mesh
def test_mesh_auto_routes_sparse_to_supercell():
    """A SMALL-shaped sparse config under a mesh must not silently run
    per-cell resident tiles (engine-choice parity with the single chip)."""
    cfg = SimConfig(seed=1, side=3.0, ncside=24, n_particles=300,
                    precision=Precision.FAST, n_shards=8)
    eng = ShardedEngine(cfg)  # no impl flag
    assert eng.impl == "supercell"
    st = eng.run(eng.init_state(), 10)
    assert int(np.asarray(st.overflow)) == 0


@needs_mesh
def test_mesh_auto_routes_clustered_to_banded_cols():
    """An UNEVEN-shaped clustered config auto-selects the column-sharded
    banded engine through the real planner (ops/banded.plan_bands).

    Census-scale shape: UNEVEN at reduced N (the same config the
    single-chip routing test uses, tests/test_tiered.py) — the routing
    gate is the real one (plan_tiers clustered test), not a knob-forced
    variant. init_state runs the census + planner; step execution on
    the banded-cols engine is covered by tests/test_sharded_banded.py.
    """
    cfg = SimConfig(seed=-7, side=5000.0, ncside=100, n_particles=200_000,
                    precision=Precision.FAST, n_shards=8)
    eng = ShardedEngine(cfg)  # no impl flag
    eng.init_state()
    assert eng.impl == "banded" and eng.banded_variant == "cols", (
        f"auto-routed to {eng.impl}/{getattr(eng, 'banded_variant', '')}")
    assert eng._band_plan is not None and len(eng._band_plan) >= 2


@needs_mesh
def test_mesh_auto_uniform_stays_resident():
    cfg = SimConfig(seed=1, side=8.0, ncside=8, n_particles=400,
                    precision=Precision.FAST, n_shards=8)
    eng = ShardedEngine(cfg)
    eng.init_state()
    assert eng.impl == "resident"


@needs_mesh
def test_mesh_auto_streaming_route():
    """Uniform loads whose per-shard tile state exceeds PSIM_STREAM_BYTES
    take uniform streaming bands on the cols-sharded banded engine."""
    import os
    # Shrink both thresholds so a CPU-sized workload exercises the route
    # (same protocol as tests/test_stream_route.py single-chip).
    os.environ["PSIM_STREAM_BYTES"] = "1"
    os.environ["PSIM_STREAM_BAND_BYTES"] = "4000"
    try:
        cfg = SimConfig(seed=1, side=8.0, ncside=16, n_particles=2048,
                        precision=Precision.FAST, n_shards=8)
        eng = ShardedEngine(cfg)
        state = eng.init_state()
        assert eng.impl == "banded" and eng.banded_variant == "cols"
        assert len(eng._band_plan) >= 2
        st = eng.run(state, 5)
        assert int(np.asarray(st.overflow)) == 0
    finally:
        del os.environ["PSIM_STREAM_BYTES"]
        del os.environ["PSIM_STREAM_BAND_BYTES"]
