"""What the fast path does on an accelerator, checked on the CPU.

* census routing with ``jax.default_backend`` reporting a GPU: the
  flagship goes to ``resident``, the SMALL shape to ``supercell``, a
  clustered blob to ``banded``; the CPU keeps its sweep default;
* every ``dot_general`` of the fast engines asks for true f32
  (``Precision.HIGHEST``): on the GPU an f32 matmul otherwise runs in
  TF32, which the CPU never shows;
* a mesh larger than the accelerator's device count fails instead of
  leaving the device;
* ``chip_smoke.py`` and ``bench.py`` refuse to run without a GPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def on_gpu(monkeypatch):
    """Census routing as it runs on a GPU backend (no PSIM_* overrides)."""
    for k in ("PSIM_DENSE", "PSIM_IMPL", "PSIM_CLUSTERED_IMPL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _fast(seed, side, nc, n, **kw):
    return SimConfig(seed=seed, side=side, ncside=nc, n_particles=n,
                     precision=Precision.FAST, **kw)


def test_gpu_routes_flagship_to_resident(on_gpu):
    eng = Engine(_fast(1, 5000.0, 100, 1_000_000))
    assert eng.impl == "resident"


def test_gpu_routes_small_to_supercell(on_gpu):
    eng = Engine(_fast(50, 10000.0, 1300, 500_000))
    assert eng.impl == "supercell"


def test_gpu_routes_clustered_blob_to_banded(on_gpu):
    # UNEVEN shape at reduced N: init_state's census runs the band planner.
    eng = Engine(_fast(-7, 5000.0, 100, 200_000))
    eng.init_state()
    assert eng.impl == "banded"
    assert eng._band_plan is not None and len(eng._band_plan) >= 2


def test_cpu_default_route_unchanged(monkeypatch):
    monkeypatch.delenv("PSIM_DENSE", raising=False)
    monkeypatch.delenv("PSIM_IMPL", raising=False)
    assert jax.default_backend() == "cpu"
    assert Engine(_fast(1, 5000.0, 100, 1_000_000)).impl == "sweep"
    assert Engine(_fast(50, 10000.0, 1300, 500_000)).impl == "sweep"


def _dot_precisions(closed):
    """precision params of every dot_general in a jaxpr, sub-jaxprs too."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(closed.jaxpr)
    return found


def _assert_all_highest(closed):
    precs = _dot_precisions(closed)
    assert precs, "no dot_general traced"
    highest = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p == (highest, highest), precs


def test_v4_contractions_are_f32():
    from particlesimulation_tpu.config import EPSILON
    from particlesimulation_tpu.ops import dense_xla

    nc, k = 16, 32
    x = jnp.zeros((nc, k), jnp.float32)
    a = jnp.ones((nc, k), jnp.int32)
    for stack in ("0", "1"):   # both PSIM_V4_STACK contraction shapes
        os.environ["PSIM_V4_STACK"] = stack
        try:
            closed = jax.make_jaxpr(
                lambda x, m, a: dense_xla.fused_pairs_v4(
                    x, x, m, a, nc, k, EPSILON))(x, x + 1.0, a)
        finally:
            del os.environ["PSIM_V4_STACK"]
        _assert_all_highest(closed)


def test_supercell_com_and_gather_are_f32():
    from particlesimulation_tpu.ops.supercell import make_supercell_run

    cfg = _fast(1, 100.0, 64, 500)
    eng = Engine(cfg, impl="supercell")
    state = eng.init_state()
    _, _, run = make_supercell_run(cfg, eng.kcap, eng._supercell_factor())
    _assert_all_highest(jax.make_jaxpr(run)(state, jnp.int32(1)))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_supercell_com_and_gather_are_f32():
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    eng = ShardedEngine(_fast(1, 3.0, 24, 300, n_shards=8),
                        impl="supercell")
    state = eng.init_state()
    eng._build()
    _assert_all_highest(jax.make_jaxpr(eng._run)(state, jnp.int32(1)))


def test_mesh_larger_than_accelerator_raises(monkeypatch):
    from particlesimulation_tpu.utils import runtime

    monkeypatch.delenv("PSIM_DEVCOUNT_REEXEC", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    monkeypatch.setattr(os, "execvpe", lambda *a: pytest.fail("re-exec"))
    with pytest.raises(RuntimeError, match="mesh of 4 devices"):
        runtime.ensure_device_count("particlesimulation_tpu", [], 4)


def _run_script(path, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode == 1, r.stdout + r.stderr
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stdout


def test_bench_refuses_cpu():
    r = _run_script(os.path.join(ROOT, "bench.py"), ROOT)
    assert r.returncode != 0, r.stdout + r.stderr
    assert "metric" not in r.stdout
    assert "no GPU" in r.stdout + r.stderr
