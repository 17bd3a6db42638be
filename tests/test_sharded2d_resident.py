"""2D-sharded resident (fast) engine vs the single-chip resident engine.

Same contract as tests/test_sharded_resident.py, over the rectangular
(rows × cols) mesh: every cell lives wholly on one shard and tiles fill in
the same initial slot order, so on these configs the sharded f32 run
agrees with the single-chip resident run to full printed precision, with
collision-count and dead-set equality as the hard contract (the
reference's same-output-as-serial invariant for its mpirun harness,
reference mpi/run_tests.sh:41-53 — which only ever ran a 1D row
decomposition; the 2D mesh is the torus-native generalization).

Covers: square and rectangular aspects, uneven decompositions on both
axes, dimension-ordered migration (rows then cols hops), the d=1 axis
degenerate cases, collisions in a tiny box, and composition with the
sweep impl (same module, shared retry ladder).
"""

import jax
import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.parallel.sharded2d import Sharded2DEngine

NDEV = len(jax.devices())
needs_mesh = pytest.mark.skipif(NDEV < 8, reason="needs 8 virtual devices")


def _run_pair(base, mesh_shape, steps, **kw):
    shards = mesh_shape[0] * mesh_shape[1]
    se = Engine(SimConfig(**base), impl="resident")
    ss = se.run(se.init_state(), steps)
    # Pin impl: these are resident-vs-resident tests; the round-5 census
    # auto-route would delegate the sparse configs to the 1D supercell
    # path (covered by tests/test_sharded_supercell.py + the 2D routing
    # tests in tests/test_sharded2d.py).
    kw.setdefault("impl", "resident")
    me = Sharded2DEngine(
        SimConfig(**base, n_shards=shards, mesh_shape=mesh_shape),
        mesh_shape, **kw)
    ms = me.run(me.init_state(), steps)
    assert me.impl == "resident" or kw.get("kcap"), "fell off the fast path"
    return se, ss, me, ms


@needs_mesh
@pytest.mark.parametrize(
    "seed,side,nc,n,steps,mesh_shape",
    [
        (5893, 0.05, 8, 64, 12, (2, 4)),   # collisions + migration, tiny box
        (5893, 0.05, 8, 64, 12, (4, 2)),   # transposed aspect
        (-10, 3.0, 16, 300, 10, (2, 2)),   # normal-mode clustering
        (1, 2.0, 9, 200, 10, (2, 2)),      # uneven 9 rows+cols / 2x2
        (-10, 3.0, 13, 300, 10, (2, 4)),   # uneven both axes
        (17, 0.12, 4, 120, 20, (1, 1)),    # d=1 self-wrap on both axes
        (3, 8.0, 8, 400, 30, (1, 8)),      # cols-only decomposition
        (3, 8.0, 8, 400, 30, (8, 1)),      # rows-only (vs 1D engine shape)
        (3, 8.0, 8, 400, 30, (2, 4)),      # fast movers, wraparound
    ],
)
def test_sharded2d_resident_matches_single(seed, side, nc, n, steps,
                                           mesh_shape):
    base = dict(seed=seed, side=side, ncside=nc, n_particles=n,
                precision=Precision.FAST)
    se, ss, me, ms = _run_pair(base, mesh_shape, steps)
    xs, ys, cs = se.result(ss)
    xm, ym, cm = me.result(ms)
    assert cm == cs
    assert abs(xm - xs) < 1e-3 and abs(ym - ys) < 1e-3
    assert int(np.asarray(ms.overflow)) == 0
    g = me.gather(ms)
    assert (np.unique(g["pid"]) == np.arange(n)).all()
    # Dead set must agree exactly (collision semantics, not just counts).
    order = np.argsort(np.asarray(ss.pid))
    np.testing.assert_array_equal(
        g["alive"], np.asarray(ss.alive)[order])


@needs_mesh
def test_sharded2d_resident_chunked_runs_compose():
    """run(10)+run(10) == run(20): the epilogue/prologue round-trip through
    the slab representation is lossless on the 2D mesh too."""
    cfg = SimConfig(seed=3, side=8.0, ncside=8, n_particles=400,
                    precision=Precision.FAST, n_shards=8,
                    mesh_shape=(2, 4))
    e1 = Sharded2DEngine(cfg, (2, 4))
    s1 = e1.run(e1.run(e1.init_state(), 10), 10)
    e2 = Sharded2DEngine(cfg, (2, 4))
    s2 = e2.run(e2.init_state(), 20)
    g1, g2 = e1.gather(s1), e2.gather(s2)
    np.testing.assert_array_equal(g1["pid"], g2["pid"])
    for f in ("x", "y", "vx", "vy", "m", "alive"):
        np.testing.assert_array_equal(g1[f], g2[f], err_msg=f)
    assert int(np.asarray(s1.collisions)) == int(np.asarray(s2.collisions))


@needs_mesh
def test_sharded2d_resident_matches_2d_sweep():
    """Resident and sweep impls of the same 2D decomposition agree on the
    output contract (count + dead set + 1e-3 coords)."""
    cfg = SimConfig(seed=5893, side=0.05, ncside=8, n_particles=128,
                    precision=Precision.FAST, n_shards=8,
                    mesh_shape=(2, 4))
    er = Sharded2DEngine(cfg, (2, 4), impl="resident")
    sr = er.run(er.init_state(), 15)
    ew = Sharded2DEngine(cfg, (2, 4), impl="sweep")
    sw = ew.run(ew.init_state(), 15)
    xr, yr, cr = er.result(sr)
    xw, yw, cw = ew.result(sw)
    assert cr == cw
    assert abs(xr - xw) < 1e-3 and abs(yr - yw) < 1e-3
    gr, gw = er.gather(sr), ew.gather(sw)
    np.testing.assert_array_equal(gr["alive"], gw["alive"])


@needs_mesh
def test_sharded2d_resident_tile_overflow_retries():
    """A deliberately tiny kcap triggers the lossless retry ladder and
    still produces the single-chip answer."""
    base = dict(seed=5893, side=0.05, ncside=8, n_particles=64,
                precision=Precision.FAST)
    se = Engine(SimConfig(**base), impl="resident")
    ss = se.run(se.init_state(), 12)
    me = Sharded2DEngine(
        SimConfig(**base, n_shards=8, mesh_shape=(2, 4)), (2, 4), kcap=1)
    ms = me.run(me.init_state(), 12)
    assert me.kcap > 1  # the ladder actually grew the tiles
    assert int(np.asarray(ms.collisions)) == int(np.asarray(ss.collisions))
    g = me.gather(ms)
    order = np.argsort(np.asarray(ss.pid))
    np.testing.assert_array_equal(g["alive"], np.asarray(ss.alive)[order])
