"""Sharded banded engines vs the single-chip resident engine.

The clustered-regime composition: ops/banded.py's
per-band capacity right-sizing on a 1D ring mesh. Two decompositions
exist: column-sharded (parallel/sharded_banded_cols.py — every shard owns
a contiguous column range of every row band; the default) and block-cyclic
rows (parallel/sharded_banded.py — every shard owns 1/D of every band's
rows; kept selectable after measuring a 2.18x composition factor at D=8).
The parametrized matrix runs whatever ``impl="banded"`` resolves to (the
default variant); ``test_sharded_banded_variants_agree`` pins both
explicitly. Contract mirrors the other sharded suites: collision-count and
dead-set equality vs single-chip (the reference's same-output-as-serial
invariant for its mpirun harness, reference mpi/run_tests.sh:41-53),
coordinates to 1e-3, no overflow, no particle lost.
"""

import jax
import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.parallel.sharded import ShardedEngine

NDEV = len(jax.devices())
needs_mesh = pytest.mark.skipif(NDEV < 8, reason="needs 8 virtual devices")


def _pair(base, shards, steps, plan=None, impl_override="banded", **kw):
    se = Engine(SimConfig(**base), impl="resident")
    ss = se.run(se.init_state(), steps)
    me = ShardedEngine(SimConfig(**base, n_shards=shards),
                       impl=impl_override, **kw)
    if plan is not None:
        me._band_plan = tuple(tuple(p) for p in plan)
    ms = me.run(me.init_state(), steps)
    return se, ss, me, ms


def _check(se, ss, me, ms, n):
    xs, ys, cs = se.result(ss)
    xm, ym, cm = me.result(ms)
    assert cm == cs
    assert abs(xm - xs) < 1e-3 and abs(ym - ys) < 1e-3
    assert int(np.asarray(ms.overflow)) == 0
    g = me.gather(ms)
    assert (np.unique(g["pid"]) == np.arange(n)).all()
    order = np.argsort(np.asarray(ss.pid))
    np.testing.assert_array_equal(g["alive"], np.asarray(ss.alive)[order])


@needs_mesh
@pytest.mark.parametrize(
    "seed,side,nc,n,steps,shards,plan",
    [
        # Single band over 8 shards == banded mechanics, resident
        # decomposition (1 row per shard).
        (5893, 0.05, 8, 64, 12, 8, ((0, 8, 64),)),
        # Two equal bands, tiny box with collisions + migration.
        (5893, 0.05, 16, 256, 12, 8, ((0, 8, 96), (8, 8, 96))),
        # Normal-mode blob, two bands with distinct K.
        (-10, 3.0, 16, 600, 10, 8, ((0, 8, 96), (8, 8, 64))),
        # Ragged band (13 rows / 8 shards: uneven chunks + tail rows).
        (-10, 3.0, 13, 300, 10, 8, ((0, 13, 96),)),
        # d=1 self-wrap ring with a band structure (edge-shift rolls
        # degenerate to the single-chip banded up/dn rule).
        (17, 0.12, 8, 120, 20, 1, ((0, 4, 64), (4, 4, 64))),
        # d=4, bands of 4 and 5 rows (second band ragged over 4 shards).
        (3, 8.0, 9, 400, 30, 4, ((0, 4, 96), (4, 5, 96))),
    ],
)
def test_sharded_banded_matches_single(seed, side, nc, n, steps, shards,
                                       plan):
    base = dict(seed=seed, side=side, ncside=nc, n_particles=n,
                precision=Precision.FAST)
    se, ss, me, ms = _pair(base, shards, steps, plan=plan)
    assert me.impl == "banded", "fell off the banded path"
    _check(se, ss, me, ms, n)


@needs_mesh
@pytest.mark.parametrize("variant", ["banded-cols", "banded-cyclic"])
def test_sharded_banded_variants_agree(variant):
    """Both decomposition variants stay selectable by explicit impl name
    and produce the single-chip answer on a migration+collision config
    (the default-variant switch must never silently retire the other)."""
    base = dict(seed=5893, side=0.05, ncside=16, n_particles=256,
                precision=Precision.FAST)
    plan = ((0, 8, 96), (8, 8, 96))  # shard-divisible: legal for both
    se, ss, me, ms = _pair(base, 8, 12, plan=plan, impl_override=variant)
    assert me.impl == "banded"
    assert me.banded_variant == variant.split("-", 1)[1]
    _check(se, ss, me, ms, 256)


@needs_mesh
def test_sharded_banded_cols_ragged_columns():
    """ncside not divisible by n_shards: ragged column counts (CNT of 2
    and 1 at nc=13, d=8) with x-direction migration across the wrap."""
    base = dict(seed=17, side=0.12, ncside=13, n_particles=300,
                precision=Precision.FAST)
    se, ss, me, ms = _pair(base, 8, 20, plan=((0, 6, 96), (6, 7, 96)),
                           impl_override="banded-cols")
    assert me.impl == "banded" and me.banded_variant == "cols"
    _check(se, ss, me, ms, 300)


@needs_mesh
def test_sharded_banded_planner_route():
    """A census-planned clustered load routes through plan_bands_cyclic;
    whether the planner accepts or declines, the answer matches
    single-chip."""
    base = dict(seed=-10, side=3.0, ncside=32, n_particles=4000,
                precision=Precision.FAST)
    se, ss, me, ms = _pair(base, 8, 10)
    if me.impl == "banded":
        assert me._band_plan is not None
        rows = sum(rw for _, rw, _ in me._band_plan)
        assert rows == 32
        ks = [k for _, _, k in me._band_plan]
        assert max(ks) > min(ks), "clustered plan should class K"
    _check(se, ss, me, ms, 4000)


@needs_mesh
def test_sharded_banded_chunked_runs_compose():
    """run(8)+run(8) == run(16) through the slab round-trip.

    Discrete state (pids, dead set, masses, collisions) must be exact.
    The epilogue compacts each cell's occupants to its lowest tile slots,
    so a refilled cell's occupant ORDER can differ from the continuous
    run's — permuting f32 pair-sum association by 1-2 ulps (measured
    max |dvx| ≈ 5e-10 on this config; positions bitwise-equal because a
    velocity ulp is far below a coordinate ulp over these step counts).
    Velocities therefore get an ulp-scale tolerance, positions exactness.
    """
    base = dict(seed=-10, side=3.0, ncside=16, n_particles=600,
                precision=Precision.FAST)
    plan = ((0, 8, 96), (8, 8, 64))
    cfg = SimConfig(**base, n_shards=8)
    e1 = ShardedEngine(cfg, impl="banded")
    e1._band_plan = plan
    s1 = e1.run(e1.run(e1.init_state(), 8), 8)
    e2 = ShardedEngine(cfg, impl="banded")
    e2._band_plan = plan
    s2 = e2.run(e2.init_state(), 16)
    g1, g2 = e1.gather(s1), e2.gather(s2)
    np.testing.assert_array_equal(g1["pid"], g2["pid"])
    for f in ("x", "y", "m", "alive"):
        np.testing.assert_array_equal(g1[f], g2[f], err_msg=f)
    for f in ("vx", "vy"):
        np.testing.assert_allclose(g1[f], g2[f], rtol=1e-5, atol=1e-9,
                                   err_msg=f)
    assert int(np.asarray(s1.collisions)) == int(np.asarray(s2.collisions))


@needs_mesh
def test_sharded_banded_overflow_grows_plan():
    """A deliberately starved plan triggers the lossless grow_plan retry
    and still produces the single-chip answer."""
    base = dict(seed=5893, side=0.05, ncside=16, n_particles=256,
                precision=Precision.FAST)
    se = Engine(SimConfig(**base), impl="resident")
    ss = se.run(se.init_state(), 12)
    me = ShardedEngine(SimConfig(**base, n_shards=8), impl="banded")
    me._band_plan = ((0, 8, 2), (8, 8, 2))
    ms = me.run(me.init_state(), 12)
    if me.impl == "banded":
        assert max(k for _, _, k in me._band_plan) > 2
    assert int(np.asarray(ms.collisions)) == int(np.asarray(ss.collisions))
    g = me.gather(ms)
    order = np.argsort(np.asarray(ss.pid))
    np.testing.assert_array_equal(g["alive"], np.asarray(ss.alive)[order])
