"""Measure the fast engine's divergence horizon against the parity engine.

For a chaotic N-body system, f32 trajectories must leave the reference
harness's ±0.001 coordinate window after some number of steps; this tool
measures when, and how the collision count tracks: the production path's
accuracy envelope.
The reference has the same property between its own
variants — its OpenMP harness compares only collision counts on long runs
and coordinates on short ones.

Usage:
    python tools/fast_divergence.py SEED SIDE NCSIDE N STEPS [CHECK_EVERY]

Prints, at each checkpoint: max |Δx|,|Δy| over all particles, particle-0
delta, and the two collision counts.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from particlesimulation_tpu.utils import runtime  # noqa: E402


def main():
    runtime.ensure_parity_runtime("tools.fast_divergence", sys.argv[1:])

    import numpy as np

    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.engine import Engine

    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    side = float(sys.argv[2]) if len(sys.argv) > 2 else 5000.0
    nc = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    n = int(sys.argv[4]) if len(sys.argv) > 4 else 100_000
    steps = int(sys.argv[5]) if len(sys.argv) > 5 else 400
    every = int(sys.argv[6]) if len(sys.argv) > 6 else 25

    pcfg = SimConfig(seed=seed, side=side, ncside=nc, n_particles=n,
                     precision=Precision.PARITY)
    fcfg = SimConfig(seed=seed, side=side, ncside=nc, n_particles=n,
                     precision=Precision.FAST)
    pe = Engine(pcfg)
    fe = Engine(fcfg, impl="resident")
    ps = pe.init_state()
    fs = fe.init_state()

    def by_pid(state):
        pid = np.asarray(state.pid)
        o = np.argsort(pid)
        return (np.asarray(state.x)[o], np.asarray(state.y)[o],
                int(np.asarray(state.collisions)))

    print("step  max|dx|    max|dy|    p0|dx|     parityC fastC  in_window")
    done = 0
    horizon = None
    while done < steps:
        k = min(every, steps - done)
        ps = pe.run(ps, k)
        fs = fe.run(fs, k)
        done += k
        px, py, pc = by_pid(ps)
        fx, fy, fc = by_pid(fs)
        # Periodic wrap: compare minimal-image deltas.
        dx = np.abs(px - fx)
        dx = np.minimum(dx, side - dx)
        dy = np.abs(py - fy)
        dy = np.minimum(dy, side - dy)
        ok = (dx[0] <= 1e-3) and (dy[0] <= 1e-3)
        if not ok and horizon is None:
            horizon = done
        print(f"{done:5d} {dx.max():.3e} {dy.max():.3e} "
              f"{max(dx[0], dy[0]):.3e}  {pc:6d} {fc:5d}  {ok}", flush=True)
    print(f"particle-0 ±0.001 horizon: "
          f"{'>' + str(steps) if horizon is None else '~' + str(horizon)} "
          f"steps; collision counts {'agree' if pc == fc else 'differ'} "
      f"at step {done} (parity {pc} vs fast {fc})")


if __name__ == "__main__":
    main()
