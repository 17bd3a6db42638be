"""Checkpointing, debug tooling, profiling, and the Simulation facade."""

import os

import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.models import Simulation
from particlesimulation_tpu.utils import checkpointing, debug, profiling


def test_checkpoint_roundtrip_resumes_bitexact(tmp_path):
    cfg = SimConfig(seed=5893, side=0.05, ncside=3, n_particles=10,
                    precision=Precision.PARITY)
    eng = Engine(cfg)
    s0 = eng.init_state()
    mid = eng.run(s0, 5)
    path = str(tmp_path / "mid.npz")
    checkpointing.save_state(path, mid)
    restored = checkpointing.load_state(path)
    a = eng.run(mid, 5)
    b = eng.run(restored, 5)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    assert int(a.collisions) == int(b.collisions)


def test_sharded_checkpoint_roundtrip_resumes_bitexact(tmp_path):
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    cfg = SimConfig(seed=3, side=8.0, ncside=8, n_particles=400,
                    precision=Precision.PARITY, n_shards=4)
    eng = ShardedEngine(cfg)
    mid = eng.run(eng.init_state(), 10)
    path = str(tmp_path / "mid_sharded.npz")
    checkpointing.save_sharded_state(path, mid, n_shards=4)
    restored = checkpointing.restore_sharded(path, eng)
    a = eng.run(mid, 10)
    b = eng.run(restored, 10)
    ga, gb = eng.gather(a), eng.gather(b)
    for f in ("pid", "x", "y", "vx", "vy", "m", "alive"):
        np.testing.assert_array_equal(ga[f], gb[f], err_msg=f)
    assert int(np.asarray(a.collisions)) == int(np.asarray(b.collisions))


def test_sharded_checkpoint_restores_across_mesh_width(tmp_path):
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    base = dict(seed=3, side=8.0, ncside=8, n_particles=400,
                precision=Precision.PARITY)
    e4 = ShardedEngine(SimConfig(**base, n_shards=4))
    mid = e4.run(e4.init_state(), 10)
    path = str(tmp_path / "mid4.npz")
    checkpointing.save_sharded_state(path, mid, n_shards=4)

    # Restore onto a 2-shard mesh: the repack path (different slab
    # geometry) must produce a legal state whose continuation matches.
    e2 = ShardedEngine(SimConfig(**base, n_shards=2))
    restored = checkpointing.restore_sharded(path, e2)
    a = e4.run(mid, 10)
    b = e2.run(restored, 10)
    ga, gb = e4.gather(a), e2.gather(b)
    for f in ("pid", "x", "y", "m", "alive"):
        np.testing.assert_array_equal(ga[f], gb[f], err_msg=f)


def test_sharded_checkpoint_restores_across_row_decomposition(tmp_path):
    """A checkpoint from census-balanced shard boundaries must re-pack
    when restored under different boundaries — slab placement encodes
    row ownership (regression: the as-is fast path used to ignore
    row_starts and would mis-own every relocated particle)."""
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    base = dict(seed=-4, side=8.0, ncside=8, n_particles=400,
                precision=Precision.PARITY)
    cfg_b = SimConfig(**base, n_shards=4, row_starts=(0, 3, 4, 5))
    eb = ShardedEngine(cfg_b)
    mid = eb.run(eb.init_state(), 10)
    path = str(tmp_path / "mid_bal.npz")
    checkpointing.save_sharded_state(path, mid, n_shards=4,
                                     row_starts=eb.config.row_starts)

    ed = ShardedEngine(SimConfig(**base, n_shards=4))  # default split
    import os
    os.environ["PSIM_SHARD_BALANCE"] = "0"
    try:
        restored = checkpointing.restore_sharded(path, ed)
        a = eb.run(mid, 10)
        b = ed.run(restored, 10)
    finally:
        os.environ.pop("PSIM_SHARD_BALANCE", None)
    ga, gb = eb.gather(a), ed.gather(b)
    for f in ("pid", "x", "y", "m", "alive"):
        np.testing.assert_array_equal(ga[f], gb[f], err_msg=f)
    assert int(np.asarray(b.overflow)) == 0


def test_sharded_checkpoint_banded_to_resident_repacks(tmp_path):
    """A checkpoint from the block-cyclic banded engine must NOT be
    placed as-is into a block-ownership engine with identical slab
    geometry — cyclic vs block placement would mis-own every particle
    (regression for restore_sharded's ownership-signature check)."""
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    base = dict(seed=-10, side=3.0, ncside=8, n_particles=400,
                precision=Precision.FAST)
    eb = ShardedEngine(SimConfig(**base, n_shards=4), impl="banded")
    eb._band_plan = ((0, 4, 96), (4, 4, 96))
    mid = eb.run(eb.init_state(), 8)
    path = str(tmp_path / "mid_banded.npz")
    checkpointing.save_sharded_state(path, mid, n_shards=4,
                                     band_plan=eb._band_plan)

    er = ShardedEngine(SimConfig(**base, n_shards=4), impl="resident")
    # Match the slab capacity so ONLY the ownership signature forces the
    # repack (the regression this test pins).
    er.capacity = eb.capacity
    restored = checkpointing.restore_sharded(path, er)
    a = eb.run(mid, 8)
    b = er.run(restored, 8)
    assert int(np.asarray(b.overflow)) == 0
    assert int(np.asarray(a.collisions)) == int(np.asarray(b.collisions))
    ga, gb = eb.gather(a), er.gather(b)
    np.testing.assert_array_equal(ga["pid"], gb["pid"])
    np.testing.assert_array_equal(ga["alive"], gb["alive"])
    assert np.max(np.abs(ga["x"] - gb["x"])) < 1e-3
    assert np.max(np.abs(ga["y"] - gb["y"])) < 1e-3


def test_sharded_checkpoint_cols_as_is_resume(tmp_path):
    """A column-sharded banded checkpoint saved with the engine's
    ownership signature restores AS-IS into a matching engine (bitwise
    slab placement — the strongest resume) and continues identically."""
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    base = dict(seed=-10, side=3.0, ncside=8, n_particles=400,
                precision=Precision.FAST)
    plan = ((0, 4, 96), (4, 4, 64))  # NOT shard-divisible at d=4: cols-only
    eb = ShardedEngine(SimConfig(**base, n_shards=4), impl="banded-cols")
    eb._band_plan = plan
    mid = eb.run(eb.init_state(), 8)
    path = str(tmp_path / "mid_cols.npz")
    assert eb.ownership_plan() == ((-1, -1, -1),)
    checkpointing.save_sharded_state(path, mid, n_shards=4,
                                     band_plan=eb.ownership_plan())

    e2 = ShardedEngine(SimConfig(**base, n_shards=4), impl="banded-cols")
    e2._band_plan = plan
    e2.capacity = eb.capacity
    restored = checkpointing.restore_sharded(path, e2)
    # As-is placement: the restored slabs are bitwise the saved arrays.
    np.testing.assert_array_equal(np.asarray(restored.x), np.asarray(mid.x))
    np.testing.assert_array_equal(np.asarray(restored.pid),
                                  np.asarray(mid.pid))
    a = eb.run(mid, 8)
    b = e2.run(restored, 8)
    ga, gb = eb.gather(a), e2.gather(b)
    for f in ("pid", "x", "y", "vx", "vy", "m", "alive"):
        np.testing.assert_array_equal(ga[f], gb[f], err_msg=f)
    assert int(np.asarray(a.collisions)) == int(np.asarray(b.collisions))


def test_sharded_checkpoint_cols_to_cyclic_repacks(tmp_path):
    """Column ownership and block-cyclic row ownership never match: a
    cols checkpoint restored into a cyclic engine with identical slab
    geometry must take the repack path and still continue correctly."""
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    base = dict(seed=-10, side=3.0, ncside=8, n_particles=400,
                precision=Precision.FAST)
    plan = ((0, 4, 96), (4, 4, 96))  # shard-divisible: legal for both
    eb = ShardedEngine(SimConfig(**base, n_shards=4), impl="banded-cols")
    eb._band_plan = plan
    mid = eb.run(eb.init_state(), 8)
    path = str(tmp_path / "mid_cols2.npz")
    checkpointing.save_sharded_state(path, mid, n_shards=4,
                                     band_plan=eb.ownership_plan())

    ec = ShardedEngine(SimConfig(**base, n_shards=4), impl="banded-cyclic")
    ec._band_plan = plan
    ec.capacity = eb.capacity
    assert ec.ownership_plan() == plan
    restored = checkpointing.restore_sharded(path, ec)
    a = eb.run(mid, 8)
    b = ec.run(restored, 8)
    assert int(np.asarray(b.overflow)) == 0
    assert int(np.asarray(a.collisions)) == int(np.asarray(b.collisions))
    ga, gb = eb.gather(a), ec.gather(b)
    np.testing.assert_array_equal(ga["pid"], gb["pid"])
    np.testing.assert_array_equal(ga["alive"], gb["alive"])
    assert np.max(np.abs(ga["x"] - gb["x"])) < 1e-3
    assert np.max(np.abs(ga["y"] - gb["y"])) < 1e-3


def test_first_divergence_detects_engine_mismatch():
    base = dict(seed=1, side=100.0, ncside=5, n_particles=500)
    pe = Engine(SimConfig(**base, precision=Precision.PARITY))
    fe = Engine(SimConfig(**base, precision=Precision.FAST))
    res = debug.first_divergence(pe, pe.init_state(), fe, fe.init_state(),
                                 max_steps=3, atol=0.0)
    assert res is not None  # f32 vs f64 must differ bitwise immediately
    step, field, _ = res
    assert step == 0


def test_first_divergence_none_for_same_engine():
    cfg = SimConfig(seed=1, side=100.0, ncside=5, n_particles=200,
                    precision=Precision.PARITY)
    a, b = Engine(cfg), Engine(cfg)
    assert debug.first_divergence(a, a.init_state(), b, b.init_state(),
                                  max_steps=2) is None


def test_state_digest_fields():
    cfg = SimConfig(seed=1, side=10.0, ncside=3, n_particles=50,
                    precision=Precision.PARITY)
    eng = Engine(cfg)
    d = debug.state_digest(eng.init_state())
    assert set(d) == {"sx", "sy", "sm", "alive", "collisions"}
    assert d["alive"] == 50


@pytest.mark.skipif(not os.path.isdir("/root/reference"),
                    reason="reference checkout not present")
def test_reference_binary_runner_matches_engine():
    x, y, c = debug.run_reference_binary("/root/reference", [1, 2, 3, 10, 1])
    assert (round(x, 3), round(y, 3), c) == (1.570, 0.056, 0)


def test_simulation_facade():
    sim = Simulation(seed=5893, side=0.05, ncside=3, n_particles=10,
                     precision="parity")
    out = sim.run(10)
    assert out.collisions == 2
    assert f"{out.particle0[0]:.3f}" == "0.002"
    g = out.gather()
    assert len(g["x"]) == 10 and (g["pid"] == np.arange(10)).all()


def test_phase_timer_report():
    t = profiling.PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    rep = t.report()
    assert "a" in rep and "b" in rep


def test_bench_fn_returns_positive():
    import jax.numpy as jnp
    f = lambda v: v * 2.0
    assert profiling.bench_fn(f, jnp.ones(16), warmup=1, iters=3) >= 0.0


def test_compile_cache_enable(monkeypatch, tmp_path):
    """enable() is idempotent, honors the opt-out, and points JAX at the
    directory JAX_COMPILATION_CACHE_DIR names."""
    import jax

    from particlesimulation_tpu.utils import compile_cache

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    monkeypatch.setattr(compile_cache, "_done", False)
    try:
        assert compile_cache.enable() is True
        assert compile_cache.enable() is True  # idempotent
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)

    monkeypatch.setenv("PSIM_COMPILE_CACHE", "0")
    monkeypatch.setattr(compile_cache, "_done", False)
    assert compile_cache.enable() is False


def test_compile_cache_default_dir_in_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at one fixed path
    inside the checkout, and .gitignore lists it."""
    import os

    from particlesimulation_tpu.utils import compile_cache
    from particlesimulation_tpu.utils.runtime import repo_root

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(repo_root(), ".jax_cache")
    assert compile_cache.cache_dir() == path  # fixed, not per process
    with open(os.path.join(repo_root(), ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
