"""SMALL-shaped composition bench: single-chip vs sharded supercell.

On one physical core emulating all virtual devices, ideal composition is
equal total work: the D-shard run should cost the same wall time per
step as the single-chip supercell run plus halo/ship overhead. Gate:
sharded <= ~1.15x single-chip. The reference runs
this regime distributed at 1.43x its serial (12x8 MPI on SMALL,
g32mpi/CPD_2nd_delivery.pdf p.5 table 1) because its per-rank work
scales with the grid; the super-cell decomposition's per-shard work
tracks particles, which is the structural point being measured.

Usage: supercell_compose_bench.py [N] [ncside] [steps] [seed] [d]
Needs JAX_PLATFORMS=cpu with >= d virtual devices.
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

    # Default: reference SMALL at reduced N (0.3 particles/cell).
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    nc = int(sys.argv[2]) if len(sys.argv) > 2 else 408
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 11
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else 50
    d = int(sys.argv[5]) if len(sys.argv) > 5 else 8

    base = dict(seed=seed, side=float(nc), ncside=nc, n_particles=n,
                precision=Precision.FAST)

    se = Engine(SimConfig(**base), impl="supercell")
    print(f"single-chip supercell S={se._supercell_factor()}", flush=True)
    per_s, ss = timed(se, se.init_state(), steps)
    cs = int(np.asarray(ss.collisions))
    print(f"single-chip supercell: {per_s*1000:.1f} ms/step "
          f"(collisions={cs})", flush=True)

    me = ShardedEngine(SimConfig(**base, n_shards=d), impl="supercell")
    per_m, ms = timed(me, me.init_state(), steps)
    cm = int(np.asarray(ms.collisions))
    print(f"sharded supercell D={d} (S={me._sc_factor}): "
          f"{per_m*1000:.1f} ms/step (collisions={cm}, "
          f"overflow={int(np.asarray(ms.overflow))})", flush=True)
    print(f"composition factor (sharded / single, 1 core): "
          f"{per_m/per_s:.2f}x (gate: <= ~1.15x)", flush=True)
    assert cm == cs, f"collision mismatch: {cm} vs {cs}"


if __name__ == "__main__":
    main()
