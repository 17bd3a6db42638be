"""Two-tier dense tiles (ops/tiered.py): equivalence, planning, retries.

The tiered impl exists for clustered loads (the reference's normal-mode
``-seed`` inits, serial/parsim.cpp:220-232): a hot cell at ~10x the mean
occupancy must not tax every cell's pair pass. Semantics must equal the
single-tier dense impl — same cells, same in-cell slot order ((key, pid)
sort), same collision set rule — with only f32 summation-tree differences
in the forces.
"""

import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.ops.tiered import plan_tiers

CLUSTERED = dict(seed=-7, side=24.0, ncside=12, n_particles=2000,
                 precision=Precision.FAST)


def _run(impl, steps=12, plan=None, **cfg_over):
    cfg = SimConfig(**{**CLUSTERED, **cfg_over})
    eng = Engine(cfg, impl=impl)
    if plan is not None:
        eng._tier_plan = plan
    out = eng.run(eng.init_state(), steps)
    return eng, out


def test_tiered_matches_dense_clustered():
    """Clustered normal-mode init: tiered vs single-tier dense must agree
    on the collision set and trajectories (f32 association differs only in
    reduction-tree shape — tight allclose, identical dead sets)."""
    _, a = _run("dense")
    engb, b = _run("tiered")
    assert engb.impl == "tiered"  # did not silently escalate away
    assert int(a.collisions) == int(b.collisions)
    np.testing.assert_array_equal(np.asarray(a.pid), np.asarray(b.pid))
    np.testing.assert_array_equal(np.asarray(a.alive), np.asarray(b.alive))
    for f in ("x", "y", "vx", "vy", "m"):
        np.testing.assert_allclose(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
            rtol=2e-5, atol=2e-5, err_msg=f)
    assert int(b.overflow) == 0


def test_tiered_fat_tier_actually_used():
    """The clustered config must exercise both tiers (otherwise this suite
    proves nothing about the fat path)."""
    from particlesimulation_tpu.ops.tiered import make_tiered_step

    cfg = SimConfig(**CLUSTERED)
    eng = Engine(cfg, impl="tiered")
    state = eng.init_state()
    plan = eng._tier_plan
    assert len(plan) >= 2
    _, build_tiles, _ = make_tiered_step(cfg, plan)
    import jax
    tiles = jax.jit(build_tiles)(state)
    # At least one cell must land in a higher class, with real particles.
    assert int(tiles["ncls"][-1]) + sum(
        int(tiles["ncls"][t]) for t in range(len(plan) - 1)) >= 1
    k0 = plan[0][0]
    ok = np.asarray(tiles["ok"])
    idx = np.asarray(tiles["idx"])
    in_higher = ok & (idx >= plan[0][0] * cfg.ncells)
    assert in_higher.sum() > k0  # a genuinely over-k0 cell's particles
    assert (ok & ~in_higher).sum() > 0


def test_tiered_overflow_retry_lossless():
    """An undersized plan (k_big below the real max occupancy, fatcap of 1
    row) must heal through the lossless retry ladder and still match the
    right-sized run exactly — the reference PANIC-drops in this situation,
    this engine may not (engine.py:run)."""
    _, ref = _run("tiered")
    eng, out = _run("tiered",
                    plan=((16, CLUSTERED["ncside"] ** 2), (32, 256)))
    assert eng.impl == "tiered"  # healed by growing the top cap, no
    #                              escalation to single-tier dense
    assert int(ref.collisions) == int(out.collisions)
    np.testing.assert_array_equal(np.asarray(ref.alive), np.asarray(out.alive))
    for f in ("x", "y"):
        np.testing.assert_allclose(
            np.asarray(getattr(ref, f)), np.asarray(getattr(out, f)),
            rtol=2e-5, atol=2e-5, err_msg=f)


def test_plan_tiers_uniform_declines():
    """Near-uniform occupancy: two tiers cannot save 40% of the lanes, so
    the planner returns None (single-tier stays)."""
    rng = np.random.default_rng(0)
    hist = rng.poisson(100, size=400)
    assert plan_tiers(hist, 400, 4096) is None


def test_plan_tiers_clustered_plans():
    """One 10x hot cell among a uniform bulk: the planner must produce a
    small k_small and a fat tier covering the hot cell."""
    rng = np.random.default_rng(0)
    hist = rng.poisson(100, size=10_000)
    hist[123] = 960
    plan = plan_tiers(hist, 10_000, 4096)
    assert plan is not None
    caps = [k for k, _ in plan]
    rows = [r for _, r in plan]
    assert caps == sorted(caps)
    assert rows[0] == 10_000
    assert caps[0] <= 192       # bulk class sized to the distribution
    assert caps[-1] >= 960      # top class covers the hot cell
    lanes = sum(r * k * k for k, r in plan)
    assert lanes < 0.2 * 10_000 * caps[-1] ** 2


def _auto_route_impl(clustered_impl=None):
    """Run init_state's occupancy census on a clustered config and return
    the engine (init_state only computes the host-side census here — the
    engine never builds a step)."""
    import os

    # Census-scale shape (UNEVEN at reduced N).
    cfg = SimConfig(seed=-7, side=5000.0, ncside=100, n_particles=200_000,
                    precision=Precision.FAST)
    saved = {k: os.environ.get(k) for k in ("PSIM_DENSE",
                                            "PSIM_CLUSTERED_IMPL")}
    os.environ["PSIM_DENSE"] = "1"
    if clustered_impl is None:
        os.environ.pop("PSIM_CLUSTERED_IMPL", None)
    else:
        os.environ["PSIM_CLUSTERED_IMPL"] = clustered_impl
    try:
        eng = Engine(cfg)
        eng.init_state()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return eng


def test_auto_select_picks_banded_when_clustered():
    """The occupancy census must route clustered loads to the clustered
    default (banded)."""
    eng = _auto_route_impl()
    assert eng.impl == "banded"
    assert eng._band_plan is not None


def test_auto_select_honors_tiered_override():
    """PSIM_CLUSTERED_IMPL=tiered must still route to the classed dense
    engine (cheapest first compile)."""
    eng = _auto_route_impl("tiered")
    assert eng.impl == "tiered"
    assert eng._tier_plan is not None
