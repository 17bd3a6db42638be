"""Dense per-cell tile pair passes (ops/dense_xla.py) vs the sweep and an
f64 direct sum.

The dense per-cell tile passes must agree with the sweep implementations:
forces to f32 tolerance (different summation order), collision counts and
death sets exactly (integer semantics are order-independent by construction).
"""

import os

import numpy as np
import pytest

from particlesimulation_tpu.config import EPSILON, Precision, SimConfig

RNG = np.random.default_rng(7)


def _mk_engines(n=3000, side=50.0, nc=8, seed=1):
    from particlesimulation_tpu.engine import Engine
    base = dict(seed=seed, side=side, ncside=nc, n_particles=n,
                precision=Precision.FAST)
    sweep = Engine(SimConfig(**base), use_dense=False)
    dense = Engine(SimConfig(**base), use_dense=True)
    return sweep, dense


def _by_pid(state):
    pid = np.asarray(state.pid)
    order = np.argsort(pid)
    return {f: np.asarray(getattr(state, f))[order]
            for f in ("x", "y", "vx", "vy", "m", "alive")}


def test_dense_step_matches_sweep_step():
    sweep, dense = _mk_engines()
    s_state = sweep.run(sweep.init_state(), 3)
    d_state = dense.run(dense.init_state(), 3)
    sv, dv = _by_pid(s_state), _by_pid(d_state)
    np.testing.assert_allclose(dv["x"], sv["x"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(dv["vx"], sv["vx"], rtol=1e-4, atol=1e-7)
    assert int(d_state.overflow) == 0


def test_dense_collisions_match_sweep_exactly():
    # Tiny box → many collisions; counts and death sets are exact integers.
    sweep, dense = _mk_engines(n=200, side=0.08, nc=4, seed=5893)
    s_state = sweep.run(sweep.init_state(), 8)
    d_state = dense.run(dense.init_state(), 8)
    assert int(s_state.collisions) == int(d_state.collisions)
    sv, dv = _by_pid(s_state), _by_pid(d_state)
    np.testing.assert_array_equal(dv["alive"], sv["alive"])


def test_dense_overflow_triggers_capacity_retry():
    from particlesimulation_tpu.engine import Engine
    cfg = SimConfig(seed=1, side=10.0, ncside=2, n_particles=500,
                    precision=Precision.FAST)
    # Force a deliberately tiny capacity; run() must retry transparently.
    eng = Engine(cfg, kcap=8, use_dense=True)
    out = eng.run(eng.init_state(), 2)
    assert int(out.overflow) == 0  # the returned (retried) run is clean
    assert eng.kcap > 8 or not eng.use_dense


@pytest.mark.parametrize("form", ["v2", "v4"])
def test_dense_force_kernel_against_direct_numpy(form):
    """The fused pair pass's forces (collide=False) vs an f64 direct sum,
    for the per-pair form (v2) and the contraction form (v4)."""
    import jax.numpy as jnp

    from particlesimulation_tpu.ops import dense_xla
    from tests.oracle_np import tile_pair_forces

    ncells, kcap = 6, 16
    x = RNG.uniform(0, 1, (ncells, kcap)).astype(np.float32)
    y = RNG.uniform(0, 1, (ncells, kcap)).astype(np.float32)
    m = RNG.uniform(0.5, 1.0, (ncells, kcap)).astype(np.float32)
    m[:, 12:] = 0.0  # empty slots
    fx, fy, cnt, _ = dense_xla.resolve_pair_impl(form)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
        jnp.asarray((m > 0).astype(np.int32)), ncells, kcap, EPSILON,
        collide=False)
    tx, ty = tile_pair_forces(x, y, m)
    assert int(cnt) == 0
    np.testing.assert_allclose(np.asarray(fx), tx, rtol=2e-4, atol=1e-12)
    np.testing.assert_allclose(np.asarray(fy), ty, rtol=2e-4, atol=1e-12)


def test_fused_pairs_v2_equals_v1():
    """The occupancy-adaptive pair pass must reproduce the flat K² pass
    exactly: same hits, same ranks, same counts, same force bits (identical
    per-pair expressions, identical reduction extents over non-empty slots).
    """
    import numpy as np
    import jax.numpy as jnp

    from particlesimulation_tpu.config import EPSILON
    from particlesimulation_tpu.ops import dense_xla

    rng = np.random.default_rng(7)
    ncells, kcap = 37, 16
    for trial, eps_scale in enumerate((1.0, 50.0)):  # few vs many hits
        occ = rng.integers(0, kcap + 1, ncells)
        xd = np.zeros((ncells, kcap), np.float32)
        yd = np.zeros((ncells, kcap), np.float32)
        md = np.zeros((ncells, kcap), np.float32)
        ad = np.zeros((ncells, kcap), np.int32)
        pd = np.zeros((ncells, kcap), np.int32)
        nxt = 0
        for c in range(ncells):
            k = occ[c]
            xd[c, :k] = rng.uniform(0, 0.02, k)
            yd[c, :k] = rng.uniform(0, 0.02, k)
            md[c, :k] = rng.uniform(0.5, 2.0, k)
            ad[c, :k] = (rng.uniform(size=k) > 0.2).astype(np.int32)
            perm = rng.permutation(k)  # slot order != pid order
            pd[c, :k] = nxt + perm
            nxt += k
        args = (jnp.asarray(xd), jnp.asarray(yd), jnp.asarray(md),
                jnp.asarray(ad))
        eps = EPSILON * eps_scale
        for pid in (None, jnp.asarray(pd)):
            for collide in (True, False):
                r1 = dense_xla.fused_pairs(*args, ncells, kcap, eps,
                                           collide=collide, cb=8, pid=pid)
                r2 = dense_xla.fused_pairs_v2(*args, ncells, kcap, eps,
                                              collide=collide, cb=8, pid=pid,
                                              ichunk=4)
                r3 = dense_xla.fused_pairs_v3(*args, ncells, kcap, eps,
                                              collide=collide, cb=8, pid=pid,
                                              ichunk=4)
                msg = (f"trial={trial} collide={collide} "
                       f"pid={pid is not None}")
                # Integers (count, collision ranks) must agree exactly;
                # force sums may differ in the last ulp (XLA picks a
                # different reduction tree per chunk shape).
                assert int(r1[2]) == int(r2[2]), msg
                np.testing.assert_array_equal(np.asarray(r1[3]),
                                              np.asarray(r2[3]),
                                              err_msg="ft " + msg)
                for a, b, name in zip(r1[:2], r2[:2], ("fx", "fy")):
                    np.testing.assert_allclose(
                        np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-12,
                        err_msg=name + " " + msg)
                # v3 (one-sweep + cond recompute) must be BIT-identical to
                # v2: same chunked per-pair expressions, same reduction
                # extents, recompute-not-correct under the hit cond.
                assert int(r2[2]) == int(r3[2]), "v3 count " + msg
                np.testing.assert_array_equal(np.asarray(r2[3]),
                                              np.asarray(r3[3]),
                                              err_msg="v3 ft " + msg)
                for a, b, name in zip(r2[:2], r3[:2], ("fx", "fy")):
                    np.testing.assert_array_equal(
                        np.asarray(a), np.asarray(b),
                        err_msg="v3 " + name + " " + msg)


def test_fused_pairs_v4_matches_v2_semantics():
    """Contraction-form force pass: identical collision outputs (the
    machinery is v2's code), forces equal to v2 within the cancellation
    envelope (adoption gated on the measured error,
    test_v4_quantization_study)."""
    import jax.numpy as jnp
    import numpy as np

    from particlesimulation_tpu.config import EPSILON
    from particlesimulation_tpu.ops import dense_xla

    rng = np.random.default_rng(7)
    ncells, kcap = 16, 32
    x = rng.uniform(0, 50.0, (ncells, kcap)).astype(np.float32)
    y = rng.uniform(0, 50.0, (ncells, kcap)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, (ncells, kcap)).astype(np.float32)
    m[:, 24:] = 0.0
    # plant a near-EPSILON pair (worst cancellation case)
    x[3, 1] = x[3, 0] + EPSILON * 1.5
    y[3, 1] = y[3, 0]
    alive = (m > 0).astype(np.int32)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
            jnp.asarray(alive), ncells, kcap, EPSILON)
    r2 = dense_xla.fused_pairs_v2(*args)
    r4 = dense_xla.fused_pairs_v4(*args)
    np.testing.assert_array_equal(np.asarray(r4[3]), np.asarray(r2[3]))
    assert int(r4[2]) == int(r2[2])
    f2 = np.asarray(r2[0])
    f4 = np.asarray(r4[0])
    scale = np.abs(f2).max()
    # Cancellation amplification ~ |xl|/d ULPs; on this config the
    # near-pair error stays under 1e-3 of the max force (documented).
    assert np.abs(f4 - f2).max() <= 1e-3 * scale


def test_fused_pairs_v5_equals_v2():
    """Triangular N3L pass: identical collision outputs (count, ft) and
    forces equal to v2 up to f32 summation order — each pair's term is the
    bitwise-same expression (negation/multiplication are exact in IEEE),
    only the reduction tree differs."""
    import numpy as np
    import jax.numpy as jnp

    from particlesimulation_tpu.config import EPSILON
    from particlesimulation_tpu.ops import dense_xla

    rng = np.random.default_rng(11)
    ncells, kcap = 37, 16
    for trial, eps_scale in enumerate((1.0, 50.0)):  # few vs many hits
        occ = rng.integers(0, kcap + 1, ncells)
        xd = np.zeros((ncells, kcap), np.float32)
        yd = np.zeros((ncells, kcap), np.float32)
        md = np.zeros((ncells, kcap), np.float32)
        ad = np.zeros((ncells, kcap), np.int32)
        pd = np.zeros((ncells, kcap), np.int32)
        sb = np.zeros((ncells, kcap), np.int32)
        nxt = 0
        for c in range(ncells):
            k = occ[c]
            xd[c, :k] = rng.uniform(0, 0.02, k)
            yd[c, :k] = rng.uniform(0, 0.02, k)
            md[c, :k] = rng.uniform(0.5, 2.0, k)
            ad[c, :k] = (rng.uniform(size=k) > 0.2).astype(np.int32)
            perm = rng.permutation(k)
            pd[c, :k] = nxt + perm
            nxt += k
            sb[c, :k] = rng.integers(0, 3, k)  # super-cell labels
        args = (jnp.asarray(xd), jnp.asarray(yd), jnp.asarray(md),
                jnp.asarray(ad))
        eps = EPSILON * eps_scale
        for pid in (None, jnp.asarray(pd)):
            for sub in (None, jnp.asarray(sb)):
                for collide in (True, False):
                    r2 = dense_xla.fused_pairs_v2(
                        *args, ncells, kcap, eps, collide=collide, cb=8,
                        pid=pid, ichunk=4, sub=sub)
                    r5 = dense_xla.fused_pairs_v5(
                        *args, ncells, kcap, eps, collide=collide, cb=8,
                        pid=pid, ichunk=4, sub=sub)
                    msg = (f"trial={trial} collide={collide} "
                           f"pid={pid is not None} sub={sub is not None}")
                    assert int(r2[2]) == int(r5[2]), "count " + msg
                    np.testing.assert_array_equal(np.asarray(r2[3]),
                                                  np.asarray(r5[3]),
                                                  err_msg="ft " + msg)
                    for a, b, name in zip(r2[:2], r5[:2], ("fx", "fy")):
                        np.testing.assert_allclose(
                            np.asarray(a), np.asarray(b),
                            rtol=2e-5, atol=1e-12,
                            err_msg="v5 " + name + " " + msg)


def test_engine_runs_with_v5_pair_impl(monkeypatch):
    """PSIM_PAIR_IMPL=v5 end-to-end through the resident engine: golden
    vector N1 (openMP/new_tests.sh:31) must come out exactly."""
    import numpy as np

    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.engine import Engine

    monkeypatch.setenv("PSIM_PAIR_IMPL", "v5")
    cfg = SimConfig(seed=5893, side=0.05, ncside=3, n_particles=10,
                    precision=Precision.FAST)
    eng = Engine(cfg, impl="resident")
    out = eng.run(eng.init_state(), 10)
    x, y, c = eng.result(out)
    assert (round(x, 3), round(y, 3), c) == (0.002, 0.035, 2)


def test_v4_quantization_study():
    """The adaptive default's justification (dense_xla.V4_MIN_SIDE), as a
    regression test: at production domain sizes the f32 coordinate
    quantization error BOTH variants carry dwarfs v4's extra contraction
    cancellation, while in tiny boxes v2 is genuinely more accurate near
    EPSILON — so v4 defaults on only for side >= V4_MIN_SIDE."""
    import jax.numpy as jnp
    import numpy as np

    from particlesimulation_tpu.config import EPSILON, G
    from particlesimulation_tpu.ops import dense_xla

    def truth_fx(x, y, m):
        dx = x[:, None, :] - x[:, :, None]
        dy = y[:, None, :] - y[:, :, None]
        d2 = dx * dx + dy * dy
        nz = d2 > 0
        inv3 = np.where(nz, 1.0 / np.where(nz, np.sqrt(d2) ** 3, 1.0), 0.0)
        s = G * m[:, :, None] * m[:, None, :] * inv3
        return (s * dx).sum(2)

    def near_err(base, cellw):
        rng = np.random.default_rng(3)
        ncells, kcap = 64, 32
        x = base + rng.uniform(0, cellw, (ncells, kcap))
        y = base + rng.uniform(0, cellw, (ncells, kcap))
        m = rng.uniform(0.5, 2.0, (ncells, kcap))
        x[:, 1] = x[:, 0] + EPSILON * 1.5   # planted near pair per cell
        y[:, 1] = y[:, 0]
        ft = truth_fx(x, y, m)
        args = (jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                jnp.asarray(m, jnp.float32),
                jnp.ones((ncells, kcap), jnp.int32), ncells, kcap, EPSILON)
        r2 = np.asarray(dense_xla.fused_pairs_v2(*args, collide=False)[0],
                        np.float64)
        r4 = np.asarray(dense_xla.fused_pairs_v4(*args, collide=False)[0],
                        np.float64)
        def rel(f):
            return np.abs(f[:, :2] - ft[:, :2]) / np.abs(ft[:, :2])
        return np.median(rel(r2)), np.median(rel(r4))

    # Flagship magnitude (side=5000, cells near 4000): quantization floors
    # both variants at the same ~1e-2 level; v4 adds nothing measurable.
    e2, e4 = near_err(4000.0, 50.0)
    assert e2 > 1e-3, f"quantization floor vanished? v2 err {e2:.2e}"
    assert e4 <= 2.0 * e2, f"v4 {e4:.2e} vs v2 {e2:.2e} at side=5000"

    # Tiny box (golden N1/N2 magnitude): both variants are benign
    # (~1e-6), but nothing is gained by switching (pair work is trivial
    # at N=10) and the fast-golden exact-count tier is trajectory-
    # sensitive — V4_MIN_SIDE keeps tiny boxes on v2.
    t2, t4 = near_err(0.02, 0.0167)
    assert t2 < 1e-5 and t4 < 1e-5, f"tiny box errs grew: {t2:.2e}/{t4:.2e}"
    assert dense_xla.V4_MIN_SIDE > 0.05  # N1/N2 stay on v2


def test_hit_chunk_skipping_high_chunk():
    """Round-4 hit-chunk gating regression: the min/count candidate sweeps
    skip receiver chunks whose hit flag is clear. Plant hit pairs ONLY in
    high receiver chunks (and one spanning two chunks) and require exact
    agreement with the ungated flat pass (fused_pairs v1)."""
    import jax.numpy as jnp

    from particlesimulation_tpu.config import EPSILON
    from particlesimulation_tpu.ops import dense_xla

    rng = np.random.default_rng(3)
    ncells, kcap, ichunk = 9, 16, 4
    x = rng.uniform(0, 10.0, (ncells, kcap)).astype(np.float32)
    y = rng.uniform(0, 10.0, (ncells, kcap)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, (ncells, kcap)).astype(np.float32)
    alive = np.ones((ncells, kcap), np.int32)
    # pair entirely inside the LAST receiver chunk (slots 13,14 -> chunk 3)
    x[2, 14] = x[2, 13] + EPSILON * 0.5
    y[2, 14] = y[2, 13]
    # pair spanning chunks (receiver slot 5 in chunk 1, partner slot 12):
    # the j>i candidate lives in chunk 1; slot 12's own chunk 3 is also
    # flagged (both endpoints are hit slots).
    x[5, 12] = x[5, 5] + EPSILON * 0.5
    y[5, 12] = y[5, 5]
    pd = rng.permutation(ncells * kcap).astype(np.int32).reshape(ncells, kcap)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
            jnp.asarray(alive))
    for pid in (None, jnp.asarray(pd)):
        r1 = dense_xla.fused_pairs(*args, ncells, kcap, EPSILON,
                                   cb=4, pid=pid)
        for fn in (dense_xla.fused_pairs_v2, dense_xla.fused_pairs_v4):
            rv = fn(*args, ncells, kcap, EPSILON, cb=4, pid=pid,
                    ichunk=ichunk)
            assert int(rv[2]) == int(r1[2]) == 2, fn.__name__
            np.testing.assert_array_equal(np.asarray(rv[3]),
                                          np.asarray(r1[3]),
                                          err_msg=fn.__name__)
