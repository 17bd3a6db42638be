"""Census-weighted shard row boundaries (parallel/balance.py).

The reference's equal-rows MPI decomposition loads one rank with most of
a clustered workload (its report documents 9.69x of ~22x on UNEVEN,
CPD_2nd_delivery.pdf p.6). The balanced decomposition must change only
WHERE rows live, never the math: f64 sharded runs stay bitwise equal to
single-chip, f32 resident runs keep collision counts and dead sets.
"""

import jax
import numpy as np
import pytest

import tests.bootstrap_env  # noqa: F401

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.parallel.balance import plan_shard_rows
from particlesimulation_tpu.parallel.sharded import ShardedEngine

NDEV = len(jax.devices())
needs_mesh = pytest.mark.skipif(NDEV < 8, reason="needs 8 virtual devices")


def test_planner_declines_uniform_and_balances_blob():
    assert plan_shard_rows(np.full(100, 50), 8) is None

    y = np.arange(100)
    w = (1e6 * np.exp(-((y - 50) / 15.0) ** 2 / 2)
         / np.sqrt(2 * np.pi) / 15).astype(int)
    s = plan_shard_rows(w, 8)
    assert s is not None and len(s) == 8 and s[0] == 0
    ends = list(s[1:]) + [100]
    rows = [b - a for a, b in zip(s, ends)]
    loads = [int(w[a:b].sum()) for a, b in zip(s, ends)]
    assert max(rows) <= int(np.ceil(2.0 * 100 / 8))  # stretch cap
    # Default equal-rows split for comparison: balance must at least
    # halve the max shard load on this profile.
    base, rem = 100 // 8, 100 % 8
    r0, def_max = 0, 0
    for i in range(8):
        rws = base + (1 if i < rem else 0)
        def_max = max(def_max, int(w[r0:r0 + rws].sum()))
        r0 += rws
    assert max(loads) < 0.55 * def_max


@needs_mesh
def test_balanced_parity_bitwise_equals_single():
    """Normal-mode blob on 8 shards: the balanced boundaries activate
    (census routes through init_state) and the f64 run stays bitwise
    equal to single-chip — decomposition changes communication, not
    math."""
    base = dict(seed=-4, side=12.0, ncside=24, n_particles=800,
                precision=Precision.PARITY)
    se = Engine(SimConfig(**base))
    ss = se.run(se.init_state(), 12)

    me = ShardedEngine(SimConfig(**base, n_shards=8, shard_capacity=800,
                                 migration_capacity=800))
    st = me.init_state()
    # The blob census must actually have produced custom boundaries.
    assert me.config.row_starts, "balance planner did not activate"
    rows = np.diff(list(me.config.row_starts) + [24])
    assert rows.max() > rows.min()  # genuinely uneven
    ms = me.run(st, 12)
    multi = me.gather(ms)

    order_s = np.argsort(np.asarray(ss.pid))
    order_m = np.argsort(np.asarray(multi["pid"]))
    for f in ("x", "y", "vx", "vy", "m"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ss, f))[order_s],
            np.asarray(multi[f])[order_m], err_msg=f)
    assert int(np.asarray(ss.collisions)) == int(np.asarray(ms.collisions))
    assert int(np.asarray(ms.overflow)) == 0


@needs_mesh
def test_balanced_resident_matches_single_chip():
    """f32 resident sharded engine under forced uneven boundaries:
    collision count and dead set match the single-chip resident run."""
    base = dict(seed=-6, side=8.0, ncside=16, n_particles=900,
                precision=Precision.FAST)
    single = Engine(SimConfig(**base), impl="resident")
    ss = single.run(single.init_state(), 15)

    cfg = SimConfig(**base, n_shards=4, shard_capacity=900,
                    migration_capacity=900,
                    row_starts=(0, 6, 10, 14))
    me = ShardedEngine(cfg, impl="resident")
    ms = me.run(me.init_state(), 15)
    multi = me.gather(ms)

    assert int(np.asarray(ss.collisions)) == int(np.asarray(ms.collisions))
    dead_s = set(np.asarray(ss.pid)[~np.asarray(ss.alive)].tolist())
    alive_m = np.asarray(multi["alive"])
    dead_m = set(np.asarray(multi["pid"])[~alive_m].tolist())
    assert dead_s == dead_m
    os_ = np.argsort(np.asarray(ss.pid))
    om = np.argsort(np.asarray(multi["pid"]))
    np.testing.assert_allclose(np.asarray(ss.x)[os_],
                               np.asarray(multi["x"])[om], atol=5e-3)


def test_row_starts_config_validation():
    base = dict(seed=1, side=4.0, ncside=8, n_particles=10,
                precision=Precision.FAST, n_shards=4)
    with pytest.raises(ValueError):
        SimConfig(**base, row_starts=(1, 2, 4, 6))     # must start at 0
    with pytest.raises(ValueError):
        SimConfig(**base, row_starts=(0, 2, 2, 6))     # strictly increasing
    with pytest.raises(ValueError):
        SimConfig(**base, row_starts=(0, 2, 4))        # wrong length
    cfg = SimConfig(**base, row_starts=(0, 3, 4, 6))
    assert cfg.rows_max == 3
    assert cfg.row0_of_shard(2) == 4
    assert cfg.rows_of_shard(0) == 3 and cfg.rows_of_shard(3) == 2
    assert int(cfg.shard_of_row(0)) == 0
    assert int(cfg.shard_of_row(3)) == 1
    assert int(cfg.shard_of_row(7)) == 3
