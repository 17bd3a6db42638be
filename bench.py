#!/usr/bin/env python
"""Benchmark: particle-steps/sec at N=1e6 on the fast engine, one GPU.

Prints the card's name and power limit (``nvidia-smi``) and then one JSON
line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Methodology:
* workload = golden vector #5/#6's configuration (seed 1, side 5000,
  ncside 100, N=1e6), census-routed with no overrides;
* initial conditions are the host-exact reference stream
  (``Engine.init_state``), so the collision count is comparable with the
  golden vector's (163 after 100 steps);
* per-step time = (t(run of 100 steps) - t(run of 0 steps)) / 100 after a
  compiling warm-up call, each fenced with ``block_until_ready``;
* baseline: the reference serial binary at the same configuration on a
  CPU, 1.29e6 particle-steps/s (BASELINE.md).

Refuses to run (exit 1) when JAX finds no GPU.
"""

import json
import subprocess
import sys
import time

SERIAL_BASELINE = 1.29e6  # particle*steps/s, reference serial binary


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"# {smi.stdout.strip().splitlines()[0]}")

    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.engine import Engine

    n = 1_000_000
    steps = 100
    cfg = SimConfig(seed=1, side=5000.0, ncside=100, n_particles=n,
                    precision=Precision.FAST)
    eng = Engine(cfg)
    state = eng.init_state()
    t0 = time.perf_counter()
    jax.block_until_ready(eng.run(state, 0))  # compile (+ capacity retries)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(eng.run(state, 0))
    t_zero = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(eng.run(state, steps))
    t_run = time.perf_counter() - t0
    per_step = max((t_run - t_zero) / steps, 1e-9)
    rate = n / per_step
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", -1)
    print(json.dumps({
        "metric": "particle_steps_per_sec_n1e6",
        "value": rate,
        "unit": "particle*steps/s",
        "vs_baseline": rate / SERIAL_BASELINE,
        "device": dev.device_kind,
    }))
    print(f"# per-step {per_step * 1e3:.3f} ms; first call {compile_s:.1f} s "
          f"(compile); impl={eng.impl} kcap={eng.kcap}; peak device bytes "
          f"{peak}; collisions={int(out.collisions)} (golden 163)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
