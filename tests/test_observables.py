"""Observables: conservation-style cross-engine validation."""

import numpy as np

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
from particlesimulation_tpu.utils import observables as obs


def test_momentum_near_conserved_without_collisions():
    # Pairwise forces conserve momentum exactly (Newton's 3rd law); the
    # monopole stencil only approximately (PIC asymmetry), so drift is
    # bounded but nonzero.
    cfg = SimConfig(seed=1, side=1000.0, ncside=10, n_particles=5000,
                    precision=Precision.PARITY)
    eng = Engine(cfg)
    s0 = eng.init_state()
    p0 = obs.total_momentum(s0)
    s = eng.run(s0, 50)
    p1 = obs.total_momentum(s)
    scale = np.hypot(*p0) + 1e-30
    assert np.hypot(p1[0] - p0[0], p1[1] - p0[1]) / scale < 0.05


def test_summary_fields_and_engine_agreement():
    base = dict(seed=1, side=100.0, ncside=5, n_particles=1000)
    pe = Engine(SimConfig(**base, precision=Precision.PARITY))
    fe = Engine(SimConfig(**base, precision=Precision.FAST), impl="resident")
    sp = obs.summary(pe.run(pe.init_state(), 20), 100.0)
    sf = obs.summary(fe.run(fe.init_state(), 20), 100.0)
    assert sp["alive"] == sf["alive"]
    assert sp["collisions"] == sf["collisions"]
    np.testing.assert_allclose(sf["mass"], sp["mass"], rtol=1e-5)
    np.testing.assert_allclose(sf["kinetic_energy"], sp["kinetic_energy"],
                               rtol=1e-3)
    np.testing.assert_allclose(sf["com"], sp["com"], rtol=0, atol=1e-2)
