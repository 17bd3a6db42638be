"""Weak/strong scaling harness for the sharded engine.

Runs the mesh engine at a given size over D devices and reports per-step
time and aggregate throughput (scalar-readback fenced). On the CPU it
exercises the 8-device virtual CPU mesh (functional scaling only — the
BASELINE.json configs 4/5 runs need real devices); the same entry runs
unchanged on several GPUs.

Usage:
  python tools/scaling_bench.py [n_per_shard] [ncside] [shards] [steps] [precision]
  # weak scaling: fixed n_per_shard, growing shards
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    n_per = int(sys.argv[1]) if len(sys.argv) > 1 else 25_000
    ncside = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    shards = int(sys.argv[3]) if len(sys.argv) > 3 else min(8, len(jax.devices()))
    steps = int(sys.argv[4]) if len(sys.argv) > 4 else 21
    precision = sys.argv[5] if len(sys.argv) > 5 else "fast"

    n = n_per * shards
    cfg = SimConfig(seed=1, side=1000.0, ncside=ncside, n_particles=n,
                    precision=Precision(precision), n_shards=shards)
    eng = ShardedEngine(cfg)
    state = eng.init_state()

    t0 = time.perf_counter()
    eng.run(state, 1)
    print(f"compile+first: {time.perf_counter()-t0:.1f}s "
          f"(D={shards}, N={n}, cap={eng.capacity})", flush=True)
    t0 = time.perf_counter()
    eng.run(state, 1)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng.run(state, steps)
    tk = time.perf_counter() - t0
    per = max((tk - t1) / (steps - 1), 1e-9)
    print(f"per-step {per*1000:.2f} ms; aggregate "
          f"{n/per/1e6:.2f} M particle*steps/s; "
          f"collisions={int(np.asarray(out.collisions))}", flush=True)


if __name__ == "__main__":
    main()
