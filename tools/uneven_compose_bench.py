"""UNEVEN-shaped composition bench: single-chip banded vs sharded banded.

On one physical core emulating all virtual devices, ideal composition is
*equal total work*: the D=8 sharded run should take the same wall time
per step as the single-chip run (plus halo/ship overhead). The gate is
sharded ≤ ~1.15x single-chip on an UNEVEN-shaped (normal-mode blob)
workload.

Usage: uneven_compose_bench.py [N] [ncside] [steps] [seed]
Needs JAX_PLATFORMS=cpu with 8 virtual devices.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(eng, state, steps):
    eng.run(state, 1)  # compile
    t0 = time.perf_counter()
    eng.run(state, 1)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng.run(state, steps)
    tk = time.perf_counter() - t0
    per = max((tk - t1) / (steps - 1), 1e-9)
    return per, out


def main():
    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.engine import Engine
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    nc = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 11
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else -23
    d = int(sys.argv[5]) if len(sys.argv) > 5 else 8

    base = dict(seed=seed, side=5000.0, ncside=nc, n_particles=n,
                precision=Precision.FAST)

    se = Engine(SimConfig(**base), impl="banded")
    ss0 = se.init_state()
    print(f"single-chip banded plan: {se._band_plan}", flush=True)
    per_s, ss = timed(se, ss0, steps)
    cs = int(np.asarray(ss.collisions))
    print(f"single-chip banded: {per_s*1000:.1f} ms/step "
          f"(impl={se.impl}, collisions={cs})", flush=True)

    me = ShardedEngine(SimConfig(**base, n_shards=d), impl="banded")
    ms0 = me.init_state()
    print(f"sharded banded plan: {me._band_plan}", flush=True)
    per_m, ms = timed(me, ms0, steps)
    cm = int(np.asarray(ms.collisions))
    print(f"sharded banded D={d}: {per_m*1000:.1f} ms/step "
          f"(impl={me.impl}, collisions={cm}, "
          f"overflow={int(np.asarray(ms.overflow))})", flush=True)
    print(f"composition factor (sharded / single, 1 core): "
          f"{per_m/per_s:.2f}x (gate: <= ~1.15x)", flush=True)
    assert cm == cs, f"collision mismatch: {cm} vs {cs}"


if __name__ == "__main__":
    main()
