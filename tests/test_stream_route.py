"""Streaming auto route: huge uniform loads split into row bands.

Above ``PSIM_STREAM_BYTES`` of resident
tile state the engine auto-routes to the banded impl with an equal-rows
plan (~``PSIM_STREAM_BAND_BYTES`` per band). Thresholds are shrunk here
so a CPU-sized workload exercises the route; physics equality vs the
plain resident impl is the contract.
"""

import numpy as np
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine


@pytest.fixture
def stream_env(monkeypatch):
    monkeypatch.setenv("PSIM_DENSE", "1")  # CPU backend: force dense auto
    monkeypatch.setenv("PSIM_STREAM_BYTES", "1000")
    monkeypatch.setenv("PSIM_STREAM_BAND_BYTES", "8000")


def test_stream_route_fires_and_matches_resident(stream_env):
    cfg = SimConfig(seed=1, side=8.0, ncside=16, n_particles=2000,
                    precision=Precision.FAST)
    e = Engine(cfg)
    s = e.run(e.init_state(), 5)
    assert e.impl == "banded", "streaming route did not fire"
    assert e._band_plan is not None
    assert sum(rw for _, rw, _ in e._band_plan) == cfg.ncside
    assert len(e._band_plan) >= 2

    r = Engine(cfg, impl="resident")
    rs = r.run(r.init_state(), 5)
    assert int(np.asarray(s.collisions)) == int(np.asarray(rs.collisions))
    # Same particles, same trajectories (identical physics, band split
    # changes buffer layout only; initial slot order matches because both
    # prologues scatter the same sorted slab).
    np.testing.assert_array_equal(
        np.sort(np.asarray(s.x)), np.sort(np.asarray(rs.x)))


def test_stream_route_respects_explicit_impl(stream_env):
    cfg = SimConfig(seed=1, side=8.0, ncside=16, n_particles=2000,
                    precision=Precision.FAST)
    e = Engine(cfg, impl="resident")
    e.run(e.init_state(), 2)
    assert e.impl == "resident", "explicit impl must not be rerouted"


def test_stream_route_quiet_below_threshold(monkeypatch):
    monkeypatch.setenv("PSIM_DENSE", "1")
    # Default thresholds: a tiny workload must stay resident.
    cfg = SimConfig(seed=1, side=8.0, ncside=16, n_particles=2000,
                    precision=Precision.FAST)
    e = Engine(cfg)
    e.run(e.init_state(), 2)
    assert e.impl == "resident"
