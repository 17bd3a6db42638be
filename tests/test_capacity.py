"""Adversarial capacity / retry-ladder tests.

The engine's lossless capacity protocol (occupancy overflow detected
in-graph, run replayed with larger tiles, escalation resident → dense →
sweep, engine.py:run) replaces the reference's PANIC-skip data loss
(reference serial/parsim.cpp:276-280). Round 1 only exercised the first
rung; these tests force every branch:

* single-cell pile-up driving kcap past MAX_XLA_KCAP → full escalation
  to the sweep impl;
* the reference's own UNEVEN workload shape (normal-mode seed -23,
  CPD_2nd_delivery.pdf p.4's `-23 5000 100 1000000 200`, scaled to unit-test
  size) through the tile impls with a deliberately tiny starting capacity;
* a constructed 8-direction mover burst that needs multiple resident
  delivery rounds (ops/resident.py's one-arrival-per-(row,direction)-per-
  round protocol);
* sharded slab migration-buffer overflow → hard error (never silent drop);
* sharded resident tile overflow → lossless retry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particlesimulation_tpu.config import EPSILON, Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.ops import binning
from particlesimulation_tpu.parallel.sharded import ShardedEngine
from particlesimulation_tpu.state import SimState

NDEV = len(jax.devices())
needs_mesh = pytest.mark.skipif(NDEV < 8, reason="needs 8 virtual devices")


def _conserved(state, n):
    pid = np.sort(np.asarray(state.pid))
    assert (pid == np.arange(n)).all(), "particle lost or duplicated"


def test_escalation_chain_to_sweep(monkeypatch):
    """ncside=1 piles every particle into one cell; with a tiny dense-tile
    cap the ladder must walk resident → dense → sweep and still match the
    sweep-only run exactly (same f32 formulation after escalation)."""
    from particlesimulation_tpu.ops import dense_xla
    monkeypatch.setattr(dense_xla, "MAX_XLA_KCAP", 64)

    cfg = SimConfig(seed=1, side=1.0, ncside=1, n_particles=300,
                    precision=Precision.FAST)
    eng = Engine(cfg, kcap=32, impl="resident")
    out = eng.run(eng.init_state(), 5)
    assert eng.impl == "sweep"          # escalated all the way
    assert int(out.overflow) == 0
    _conserved(out, 300)

    ref = Engine(cfg, impl="sweep")
    exp = ref.run(ref.init_state(), 5)
    assert int(out.collisions) == int(exp.collisions)
    order_o = np.argsort(np.asarray(out.pid))
    order_e = np.argsort(np.asarray(exp.pid))
    np.testing.assert_array_equal(np.asarray(out.x)[order_o],
                                  np.asarray(exp.x)[order_e])


def test_resident_kcap_retry_succeeds():
    """Starting capacity far below true occupancy: the in-graph overflow
    report must resize the tiles and replay losslessly."""
    cfg = SimConfig(seed=1, side=1.0, ncside=4, n_particles=400,
                    precision=Precision.FAST)
    eng = Engine(cfg, kcap=8, impl="resident")
    out = eng.run(eng.init_state(), 3)
    assert int(out.overflow) == 0
    assert eng.kcap > 8 or eng.impl != "resident"
    _conserved(out, 400)

    ref = Engine(cfg, impl="resident")
    exp = ref.run(ref.init_state(), 3)
    assert int(out.collisions) == int(exp.collisions)


@pytest.mark.parametrize("impl", ["resident", "dense"])
def test_uneven_workload_shape(impl):
    """The reference's UNEVEN benchmark shape (normal-mode clustering,
    CPD_2nd_delivery.pdf p.4) scaled to unit-test size, with a deliberately
    tiny starting capacity so the cluster forces at least one retry."""
    cfg = SimConfig(seed=-23, side=50.0, ncside=10, n_particles=2000,
                    precision=Precision.FAST)
    eng = Engine(cfg, kcap=32, impl=impl)
    out = eng.run(eng.init_state(), 20)
    assert int(out.overflow) == 0
    _conserved(out, 2000)
    # Lossless determinism: an identical engine reproduces the run bit for
    # bit (retries replay from the input state, never partial progress).
    eng2 = Engine(cfg, kcap=32, impl=impl)
    out2 = eng2.run(eng2.init_state(), 20)
    assert int(out.collisions) == int(out2.collisions)
    order1 = np.argsort(np.asarray(out.pid))
    order2 = np.argsort(np.asarray(out2.pid))
    np.testing.assert_array_equal(np.asarray(out.x)[order1],
                                  np.asarray(out2.x)[order2])


def test_resident_multi_round_burst():
    """40 movers from all 8 neighbor directions converge on one cell in a
    single step; the resident delivery protocol lands one arrival per
    (row, direction) per round, so this needs ≥5 rounds — all must arrive
    (the round cap only exists for pathological non-progress)."""
    nc, side, n = 8, 8.0, 40
    cfg = SimConfig(seed=1, side=side, ncside=nc, n_particles=n,
                    precision=Precision.FAST)
    eng = Engine(cfg, kcap=64, impl="resident")

    # 5 particles per surrounding cell, each just inside its boundary with
    # the center cell (4,4) = [4,5)², velocity carrying it across in one
    # step (Δx = v·Δt = 0.2). Spacing ≥ 0.02 > EPSILON avoids collisions.
    xs, ys, vxs, vys = [], [], [], []
    k = 0
    for dx, dy in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                   (1, -1), (1, 0), (1, 1)):
        for i in range(5):
            # Position inside neighbor cell (4+dx, 4+dy), near the border.
            px = 4.5 + dx * 0.6 + 0.02 * i
            py = 4.5 + dy * 0.6 + 0.02 * ((k * 3) % 5)
            xs.append(px)
            ys.append(py)
            vxs.append(-dx * 2.0)   # Δ = 0.2 toward the center cell
            vys.append(-dy * 2.0)
            k += 1
    m = np.full(n, 1e-12)  # negligible forces; pure advection
    key, _ = binning.cell_keys(jnp.asarray(xs, jnp.float32),
                               jnp.asarray(ys, jnp.float32), side, nc)
    arrs = binning.sort_by_cell(
        key, jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32),
        jnp.asarray(vxs, jnp.float32), jnp.asarray(vys, jnp.float32),
        jnp.asarray(m, jnp.float32), jnp.ones(n, dtype=bool))
    _, pid, x, y, vx, vy, mm, alive = arrs
    state = SimState(x=x, y=y, vx=vx, vy=vy, m=mm, alive=alive, pid=pid,
                     collisions=jnp.zeros((), jnp.int32),
                     panics=jnp.zeros((), jnp.int32),
                     overflow=jnp.zeros((), jnp.int32))
    out = eng.run(state, 1)
    assert int(out.overflow) == 0
    _conserved(out, n)
    key_out, _ = binning.cell_keys(out.x, out.y, side, nc)
    # Every particle must have been delivered to the center cell.
    assert (np.asarray(key_out) == 4 * nc + 4).all()


@needs_mesh
def test_sharded_migration_overflow_retries_losslessly():
    """Slab migration buffers too small for the crossing traffic: the run
    replays with grown buffers/slabs and still matches the single-chip
    result bitwise (reference silently PANIC2-skips; we refuse to lose
    data — round 2 raised here, round 3 retries like every other path)."""
    base = dict(seed=3, side=8.0, ncside=8, n_particles=400,
                precision=Precision.PARITY)
    cfg = SimConfig(**base, n_shards=8, migration_capacity=1)
    eng = ShardedEngine(cfg)
    out = eng.run(eng.init_state(), 30)
    assert int(np.asarray(out.overflow)) == 0
    assert eng.bcap > 1  # the ladder actually grew the buffer
    g = eng.gather(out)
    assert (np.unique(g["pid"]) == np.arange(400)).all()

    se = Engine(SimConfig(**base))
    ss = se.run(se.init_state(), 30)
    order = np.argsort(np.asarray(ss.pid))
    for f in ("x", "y", "m", "alive"):
        np.testing.assert_array_equal(
            g[f], np.asarray(getattr(ss, f))[order], err_msg=f)
    assert int(np.asarray(out.collisions)) == int(np.asarray(ss.collisions))


@needs_mesh
def test_sharded_resident_kcap_retry():
    """Sharded resident tiles sized far below occupancy: lossless retry."""
    cfg = SimConfig(seed=1, side=1.0, ncside=8, n_particles=500,
                    precision=Precision.FAST, n_shards=4)
    eng = ShardedEngine(cfg, kcap=8)
    out = eng.run(eng.init_state(), 5)
    assert int(np.asarray(out.overflow)) == 0
    assert eng.kcap > 8 or eng.impl != "resident"
    g = eng.gather(out)
    assert (np.unique(g["pid"]) == np.arange(500)).all()
