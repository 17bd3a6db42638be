"""Slot-resident engine: equivalence with the sweep/dense engines.

In-cell slot order departs from pid order once particles migrate, so
collision *chain* tie-breaks may differ from the reference's bucket order;
the test configs below are checked for agreement empirically (and physical
invariants are asserted regardless).
"""

import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine


def _by_pid(state):
    pid = np.asarray(state.pid)
    order = np.argsort(pid)
    return {f: np.asarray(getattr(state, f))[order]
            for f in ("x", "y", "vx", "vy", "m", "alive")}, pid[order]


def _engines(n, side, nc, seed):
    base = dict(seed=seed, side=side, ncside=nc, n_particles=n,
                precision=Precision.FAST)
    return (Engine(SimConfig(**base), impl="sweep"),
            Engine(SimConfig(**base), impl="resident"))


def test_resident_matches_sweep_trajectories():
    sweep, res = _engines(3000, 50.0, 8, 1)
    s = sweep.run(sweep.init_state(), 5)
    r = res.run(res.init_state(), 5)
    sv, spid = _by_pid(s)
    rv, rpid = _by_pid(r)
    np.testing.assert_array_equal(rpid, spid)  # nothing lost or duplicated
    np.testing.assert_allclose(rv["x"], sv["x"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(rv["vx"], sv["vx"], rtol=1e-4, atol=1e-7)
    assert int(r.overflow) == 0


def test_resident_collisions_and_deaths():
    sweep, res = _engines(200, 0.08, 4, 5893)
    s = sweep.run(sweep.init_state(), 8)
    r = res.run(res.init_state(), 8)
    assert int(r.collisions) == int(s.collisions)
    sv, _ = _by_pid(s)
    rv, _ = _by_pid(r)
    np.testing.assert_array_equal(rv["alive"], sv["alive"])


def test_resident_heavy_migration():
    # Small cells + fast motion: most particles change cells repeatedly.
    sweep, res = _engines(500, 16.0, 16, 3)
    s = sweep.run(sweep.init_state(), 25)
    r = res.run(res.init_state(), 25)
    sv, spid = _by_pid(s)
    rv, rpid = _by_pid(r)
    np.testing.assert_array_equal(rpid, spid)
    np.testing.assert_allclose(rv["x"], sv["x"], rtol=0, atol=1e-3)
    assert int(r.overflow) == 0


def test_resident_capacity_retry():
    cfg = SimConfig(seed=1, side=10.0, ncside=2, n_particles=400,
                    precision=Precision.FAST)
    eng = Engine(cfg, kcap=8, impl="resident")
    out = eng.run(eng.init_state(), 2)
    assert int(out.overflow) == 0
    assert eng.kcap > 8 or eng.impl != "resident"


def test_resident_mass_conservation_and_dead_frozen():
    _, res = _engines(60, 0.06, 3, 8555)
    s0 = res.init_state()
    m0 = float(np.asarray(s0.m).sum())
    r1 = res.run(s0, 4)
    rv1, pid1 = _by_pid(r1)
    r2 = res.run(r1, 6)
    rv2, pid2 = _by_pid(r2)
    assert float(rv2["m"].sum()) <= m0 + 1e-6
    dead1 = ~rv1["alive"]
    if dead1.any():
        np.testing.assert_array_equal(rv2["x"][dead1], rv1["x"][dead1])


def test_rebin_r2_argmax_form_bitexact(monkeypatch):
    """The chained-argmax R=2 delivery form selects the same winner lanes
    and target slots as the cumsum rank form (the r-th set lane / the
    (d*R+r+1)-th free slot), so whole runs must be BIT-identical —
    identical slot placement means identical f32 reduction order."""
    import numpy as np

    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.engine import Engine

    base = dict(seed=3, side=16.0, ncside=16, n_particles=500,
                precision=Precision.FAST)
    monkeypatch.setenv("PSIM_REBIN_R", "2")
    monkeypatch.setenv("PSIM_REBIN_FORM", "argmax")
    e1 = Engine(SimConfig(**base), impl="resident")
    s1 = e1.run(e1.init_state(), 25)
    monkeypatch.setenv("PSIM_REBIN_FORM", "rank")
    e2 = Engine(SimConfig(**base), impl="resident")
    s2 = e2.run(e2.init_state(), 25)
    assert int(s1.collisions) == int(s2.collisions)
    for f in ("x", "y", "vx", "vy", "m", "pid", "alive"):
        np.testing.assert_array_equal(np.asarray(getattr(s1, f)),
                                      np.asarray(getattr(s2, f)), err_msg=f)


def test_rebin_compact_matches_rounds(monkeypatch):
    """Straggler compaction (opt-in; kept as the CPU-class/A-B variant)
    vs the default delivery rounds: same
    physics. Slot assignment differs (compaction packs lowest free slots
    in row order), so f32 reduction order may differ; collision counts,
    dead sets and positions must agree."""
    import numpy as np

    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.engine import Engine

    base = dict(seed=3, side=8.0, ncside=8, n_particles=400,
                precision=Precision.FAST)
    monkeypatch.setenv("PSIM_REBIN_COMPACT", "1")
    e1 = Engine(SimConfig(**base), impl="resident")
    s1 = e1.run(e1.init_state(), 30)
    monkeypatch.setenv("PSIM_REBIN_COMPACT", "0")
    e2 = Engine(SimConfig(**base), impl="resident")
    s2 = e2.run(e2.init_state(), 30)
    assert int(s1.collisions) == int(s2.collisions)
    o1 = np.argsort(np.asarray(s1.pid))
    o2 = np.argsort(np.asarray(s2.pid))
    np.testing.assert_array_equal(np.asarray(s1.alive)[o1],
                                  np.asarray(s2.alive)[o2])
    np.testing.assert_allclose(np.asarray(s1.x)[o1], np.asarray(s2.x)[o2],
                               atol=1e-4)
    assert (np.unique(np.asarray(s1.pid)) == np.arange(400)).all()


def test_rebin_axis_routed_matches_full_stencil(monkeypatch):
    """PSIM_REBIN_DIRS=4 (x-first axis routing; diagonal movers take two
    hops) must deliver the same particles to the same cells as the full
    8-direction stencil — only slot assignment within a cell may differ."""
    import jax.numpy as jnp

    from particlesimulation_tpu.ops import resident as res

    ncside, kcap, side = 8, 12, 8.0
    ncells = ncside * ncside
    rng = np.random.default_rng(11)
    x = np.zeros((ncells, kcap), np.float32)
    y = np.zeros((ncells, kcap), np.float32)
    occ = np.zeros((ncells, kcap), bool)
    pid = np.full((ncells, kcap), -1, np.int32)
    p = 0
    for c in range(ncells):
        cy0, cx0 = divmod(c, ncside)
        for k in range(3):
            occ[c, k] = True
            # ~Half the particles have wandered into a neighbor cell
            # (incl. diagonals and wraparound edges).
            dx, dy = rng.integers(-1, 2), rng.integers(-1, 2)
            if rng.random() < 0.5:
                dx = dy = 0
            x[c, k] = ((cx0 + dx) % ncside) + 0.3 + 0.05 * k
            y[c, k] = ((cy0 + dy) % ncside) + 0.4
            pid[c, k] = p
            p += 1
    m = np.where(occ, 1.0, 0.0).astype(np.float32)

    def mk():
        return res.TileState(
            x=jnp.asarray(x), y=jnp.asarray(y),
            vx=jnp.zeros_like(jnp.asarray(x)),
            vy=jnp.zeros_like(jnp.asarray(x)),
            m=jnp.asarray(m), occ=jnp.asarray(occ), pid=jnp.asarray(pid),
            collisions=jnp.zeros((), jnp.int32),
            panics=jnp.zeros((), jnp.int32),
            overflow=jnp.zeros((), jnp.int32))

    outs = {}
    for dirs in ("8", "4"):
        monkeypatch.setenv("PSIM_REBIN_DIRS", dirs)
        out, left = res.rebin(mk(), side, ncside, kcap)
        assert int(left) == 0
        po, oo = np.asarray(out.pid), np.asarray(out.occ)
        outs[dirs] = [sorted(po[c][oo[c]].tolist()) for c in range(ncells)]
    assert outs["8"] == outs["4"]


def test_rebin_axis_routed_needs_no_extra_rounds(monkeypatch):
    """At the physical diagonal-mover rate (corner crossings are rare),
    axis routing must deliver in the same number of rounds as the full
    stencil — the basis of its 2x transport model;
    rounds are deterministic, so this pins the census result."""
    import jax.numpy as jnp

    from particlesimulation_tpu.ops import resident as res

    ncside, kcap, side = 16, 32, 16.0
    ncells = ncside * ncside
    rng = np.random.default_rng(3)

    def build(res):
        x = np.zeros((ncells, kcap), np.float32)
        y = np.zeros((ncells, kcap), np.float32)
        occ = np.zeros((ncells, kcap), bool)
        pid = np.full((ncells, kcap), -1, np.int32)
        p = 0
        for c in range(ncells):
            cy0, cx0 = divmod(c, ncside)
            for k in range(12):
                occ[c, k] = True
                dx = dy = 0
                r = rng.random()
                if r < 0.05:           # movers: 5% of slots
                    if rng.random() < 0.05:   # ~5% of movers diagonal
                        dx = rng.choice((-1, 1))
                        dy = rng.choice((-1, 1))
                    elif rng.random() < 0.5:
                        dx = rng.choice((-1, 1))
                    else:
                        dy = rng.choice((-1, 1))
                x[c, k] = (cx0 + dx) % ncside + 0.25 + 0.04 * k
                y[c, k] = (cy0 + dy) % ncside + 0.5
                pid[c, k] = p
                p += 1
        m = np.where(occ, 1.0, 0.0).astype(np.float32)
        return res.TileState(
            x=jnp.asarray(x), y=jnp.asarray(y),
            vx=jnp.zeros_like(jnp.asarray(x)),
            vy=jnp.zeros_like(jnp.asarray(x)),
            m=jnp.asarray(m), occ=jnp.asarray(occ), pid=jnp.asarray(pid),
            collisions=jnp.zeros((), jnp.int32),
            panics=jnp.zeros((), jnp.int32),
            overflow=jnp.zeros((), jnp.int32))

    rounds = {}
    for dirs in ("8", "4"):
        monkeypatch.setenv("PSIM_REBIN_DIRS", dirs)
        rng = np.random.default_rng(3)  # identical movers for both
        out, left, r = res.rebin(build(res), side, ncside, kcap,
                                 return_rounds=True)
        assert int(left) == 0
        rounds[dirs] = int(r)
    assert rounds["4"] <= rounds["8"] + 1, rounds


@pytest.mark.parametrize("r_env,form", [("1", "argmax"), ("2", "argmax"),
                                        ("2", "rank")])
def test_rebin_packed_slots_no_direction_deadlock(r_env, form, monkeypatch):
    """A nearly-full destination row must still accept arrivals from
    high-numbered stencil directions (regression: free slots used to be
    assigned by static direction rank d*R+r+1, so a row with fewer than
    ~8R free slots blocked late directions forever; the delivery loop
    spun to MAX_ROUNDS and raised a spurious capacity retry — observed
    at the N=1e6 bench as kcap 160 -> 256)."""
    import jax.numpy as jnp

    from particlesimulation_tpu.ops import resident as res

    monkeypatch.setenv("PSIM_REBIN_R", r_env)
    monkeypatch.setenv("PSIM_REBIN_FORM", form)
    ncside, kcap, side = 4, 8, 4.0
    ncells = ncside * ncside
    x = np.zeros((ncells, kcap), np.float32)
    y = np.zeros((ncells, kcap), np.float32)
    occ = np.zeros((ncells, kcap), bool)
    pid = np.full((ncells, kcap), -1, np.int32)
    # Destination cell (1,1) = row 5: 7 residents, ONE free slot.
    for k in range(7):
        occ[5, k] = True
        x[5, k], y[5, k] = 1.2 + 0.05 * k, 1.3
        pid[5, k] = k
    # The mover: resident in row 0 (cell (0,0)) but positioned in cell
    # (1,1) -> sign delta (+1,+1) = STENCIL index 7, the last direction.
    occ[0, 0] = True
    x[0, 0], y[0, 0] = 1.5, 1.5
    pid[0, 0] = 99
    m = np.where(occ, 1.0, 0.0).astype(np.float32)
    ts = res.TileState(
        x=jnp.asarray(x), y=jnp.asarray(y),
        vx=jnp.zeros_like(jnp.asarray(x)),
        vy=jnp.zeros_like(jnp.asarray(x)),
        m=jnp.asarray(m), occ=jnp.asarray(occ), pid=jnp.asarray(pid),
        collisions=jnp.zeros((), jnp.int32),
        panics=jnp.zeros((), jnp.int32),
        overflow=jnp.zeros((), jnp.int32))
    out, left = res.rebin(ts, side, ncside, kcap)
    assert int(left) == 0  # delivered, not deadlocked
    occ_out = np.asarray(out.occ)
    pid_out = np.asarray(out.pid)
    assert occ_out[5].sum() == 8
    assert not occ_out[0].any()
    assert 99 in pid_out[5][occ_out[5]]


def test_prologue_clamp_parks_out_of_range():
    """Out-of-range (PANIC2-limbo) particles park in their CLAMPED row,
    not a fixed far-away row. The round-2 cell-0 parking made each limbo
    particle a multi-cell walker on re-entry; at large grids the walks
    exceeded the delivery round cap, flagged spurious overflow, and
    silently downgraded N=1e7 runs to the 12x-slower dense impl."""
    import jax
    import jax.numpy as jnp

    from particlesimulation_tpu.engine import make_resident_run
    from particlesimulation_tpu.ops import resident as res

    cfg = SimConfig(seed=1, side=100.0, ncside=20, n_particles=64,
                    precision=Precision.FAST)
    eng = Engine(cfg, impl="resident")
    state = eng.init_state()
    # Push particle pid=0 out of range past the far corner.
    i0 = int(np.argmin(np.asarray(state.pid)))
    state = state._replace(
        x=state.x.at[i0].set(100.0),      # == side -> cx = ncside (invalid)
        y=state.y.at[i0].set(97.0))       # row 19
    kcap = 32
    _, prologue, _ = make_resident_run(cfg, kcap)
    ts = jax.jit(prologue)(state)
    occ = np.asarray(ts.occ)
    pid = np.asarray(ts.pid)
    rows = np.argwhere(occ & (pid == 0))
    assert len(rows) == 1
    row = int(rows[0][0])
    # Clamped cell: (cx=19, cy=19) -> row 19*20+19 = 399 (NOT row 0).
    assert row == 399, f"limbo parked in row {row}, want clamped 399"
    assert int(np.asarray(ts.overflow)) == 0
    # Masked out of physics until back in range.
    binned, limbo_count = res.binned_mask(ts, cfg.side, cfg.ncside)
    assert int(limbo_count) == 1
    assert not bool(np.asarray(binned)[row][np.asarray(ts.pid)[row] == 0][0])


def test_rebin_walker_straggler_compaction():
    """A teleported multi-cell mover (e.g. limbo re-entering far from its
    parked row) must deliver via the straggler compaction within
    STRAGGLER+1 rounds instead of walking one cell per full-grid round."""
    import jax
    import jax.numpy as jnp

    from particlesimulation_tpu.engine import make_resident_run
    from particlesimulation_tpu.ops import resident as res

    cfg = SimConfig(seed=1, side=100.0, ncside=25, n_particles=300,
                    precision=Precision.FAST)
    eng = Engine(cfg, impl="resident")
    state = eng.init_state()
    kcap = 32
    _, prologue, _ = make_resident_run(cfg, kcap)
    ts = jax.jit(prologue)(state)
    # Teleport one occupied slot's POSITION across the grid (slot stays):
    # a 12+12-cell walker under the minimal-image one-hop delivery.
    occ = np.asarray(ts.occ)
    r, k = map(int, np.argwhere(occ)[0])
    ts = ts._replace(
        x=ts.x.at[r, k].set((r % 25) * 4.0 + 2.0 + 48.0
                            if (r % 25) < 12 else 2.0),
        y=ts.y.at[r, k].set((r // 25) * 4.0 + 2.0 + 48.0
                            if (r // 25) < 12 else 2.0))
    out, left, rounds = res.rebin(ts, cfg.side, cfg.ncside, kcap,
                                  return_rounds=True)
    assert int(left) == 0
    assert int(rounds) <= 9, f"walker took {int(rounds)} rounds"
