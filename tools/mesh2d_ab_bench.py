"""D=8 virtual-mesh A/B: 1D resident vs 2D resident vs 2D sweep.

On the 8-device virtual CPU mesh (one physical core — wall time ≈ total
work), compare the three sharded formulations of the same uniform
workload. On real hardware the 2D rectangle's advantage is halo volume
(perimeter vs whole rows),
which a virtual mesh cannot show; what it CAN show is that the 2D
resident composition costs no more total work than the 1D resident one
and far less than the 2D sweep.

Usage: mesh2d_ab_bench.py [N] [ncside] [steps]
Needs JAX_PLATFORMS=cpu with 8 virtual devices (see r4_cpu_queue.sh).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(eng, state, steps):
    eng.run(state, 1)
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
    from particlesimulation_tpu.parallel.sharded import ShardedEngine
    from particlesimulation_tpu.parallel.sharded2d import Sharded2DEngine

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    nc = int(sys.argv[2]) if len(sys.argv) > 2 else 48
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 11

    base = dict(seed=1, side=1000.0, ncside=nc, n_particles=n,
                precision=Precision.FAST)
    rows = []
    for label, mk in (
        ("1d resident", lambda c: ShardedEngine(
            SimConfig(**base, n_shards=8), impl="resident")),
        ("2d 2x4 resident", lambda c: Sharded2DEngine(
            SimConfig(**base, n_shards=8, mesh_shape=(2, 4)), (2, 4),
            impl="resident")),
        ("2d 2x4 sweep", lambda c: Sharded2DEngine(
            SimConfig(**base, n_shards=8, mesh_shape=(2, 4)), (2, 4),
            impl="sweep")),
    ):
        eng = mk(base)
        st0 = eng.init_state()
        per, out = timed(eng, st0, steps)
        c = int(np.asarray(out.collisions))
        rows.append((label, per, c))
        print(f"{label}: {per*1000:.1f} ms/step (collisions={c}, "
              f"overflow={int(np.asarray(out.overflow))})", flush=True)
    counts = {c for _, _, c in rows}
    assert len(counts) == 1, f"collision mismatch across impls: {rows}"


if __name__ == "__main__":
    main()
