"""BASELINE north-star gate, run verbatim at the headline scale.

BASELINE.json's target: >=100x reference-serial particle.steps/s at N=1e6
on one accelerator **with center-of-mass and merged-particle-count parity vs
the serial binary after 1000 steps**. The throughput half lives in
bench.py; this tool runs the parity half at the same configuration
(golden vector #5's shape, `1 5000 100 1000000`, 1000 steps — the
reference harness never runs this horizon, so the serial binary is run
fresh for ground truth):

  1. `fast`    — run the f32 fast engine for 1000 steps from the
                 host-exact initial stream (the same initializer bits the
                 serial binary consumes) on whatever backend is active;
                 save the final state.
  2. `compare` — load the f64 parity engine's 1000-step checkpoint
                 (produced by tools/verify_golden.py, which itself must
                 PASS against the serial binary's printed output) and the
                 fast state; assert merged-count band and COM / momentum /
                 mass envelopes (the tests/test_fast_statistical.py
                 tolerances at this horizon).

Usage:
    python tools/verify_northstar.py fast [--steps 1000] [--out PATH]
    python tools/verify_northstar.py compare --parity CKPT [--fast PATH] \
        [--serial "X Y C"]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED, SIDE, NCSIDE, N = 1, 5000.0, 100, 1_000_000
FAST_OUT = "/tmp/psim_northstar_fast.npz"


def run_fast(steps: int, out: str) -> None:
    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.engine import Engine
    from particlesimulation_tpu.utils import checkpointing as ckpt

    cfg = SimConfig(seed=SEED, side=SIDE, ncside=NCSIDE, n_particles=N,
                    precision=Precision.FAST)
    eng = Engine(cfg)
    t0 = time.time()
    state = eng.init_state()   # host-exact stream, transferred once
    print(f"init (host-exact stream + transfer): {time.time()-t0:.1f}s",
          flush=True)
    t0 = time.time()
    state = eng.run(state, steps)
    el = time.time() - t0
    print(f"fast run({steps}): {el:.1f}s incl. compile "
          f"({N*steps/el/1e6:.1f} M particle*steps/s wall)", flush=True)
    ckpt.save_state(out, state)
    _report("fast", state)


def _report(tag, state):
    import numpy as np

    from particlesimulation_tpu.utils import observables as obs

    alive = np.asarray(state.alive)
    com = obs.circular_center_of_mass(state, SIDE)
    print(f"[{tag}] collisions={int(np.asarray(state.collisions))} "
          f"merged={int((~alive).sum())} mass={obs.total_mass(state):.6e} "
          f"com=({com[0]:.3f}, {com[1]:.3f}) "
          f"p={tuple(round(v, 6) for v in obs.total_momentum(state))}",
          flush=True)
    return com


def compare(parity_path: str, fast_path: str, serial: str | None) -> int:
    import numpy as np

    from particlesimulation_tpu.utils import checkpointing as ckpt
    from particlesimulation_tpu.utils import observables as obs

    ps = ckpt.load_state(parity_path)
    fs = ckpt.load_state(fast_path)
    if serial:
        # Ground-truth anchor: the parity engine must match the serial
        # binary's printed particle-0 line and collision count exactly.
        sx, sy, sc = serial.split()
        order = np.argsort(np.asarray(ps.pid))
        x0 = float(np.asarray(ps.x)[order][0])
        y0 = float(np.asarray(ps.y)[order][0])
        c = int(np.asarray(ps.collisions))
        ok0 = (abs(x0 - float(sx)) <= 0.001 and abs(y0 - float(sy)) <= 0.001
               and c == int(sc))
        print(f"parity-vs-serial: x={x0:.3f} y={y0:.3f} c={c} "
              f"(serial: {sx} {sy} {sc}) -> {'PASS' if ok0 else 'FAIL'}",
              flush=True)
        if not ok0:
            return 1
    pcom = _report("parity", ps)
    fcom = _report("fast", fs)

    pc = int(np.asarray(ps.collisions))
    fc = int(np.asarray(fs.collisions))
    pm = int((~np.asarray(ps.alive)).sum())
    fm = int((~np.asarray(fs.alive)).sum())
    # Bands: the statistical-parity gate's scaling at this horizon —
    # collision/merged counts within 15% + 5 (chaotic divergence makes
    # individual pairings path-dependent; the *rate* is the invariant),
    # COM within 2 cell widths, mass identical-to-f32, momentum near the
    # initializer's scale.
    tol_c = 0.15 * max(pc, 1) + 5
    cellw = SIDE / NCSIDE
    dcom = max(abs(pcom[0] - fcom[0]), abs(pcom[1] - fcom[1]))
    dmass = abs(obs.total_mass(ps) - obs.total_mass(fs)) / obs.total_mass(ps)
    checks = [
        ("collision count", abs(pc - fc) <= tol_c, f"{pc} vs {fc}"),
        ("merged count", abs(pm - fm) <= 2 * tol_c, f"{pm} vs {fm}"),
        # (merged >= 2*collisions: chains kill k particles for one count,
        # reference serial/parsim.cpp:404-418)
        ("merged >= 2*collisions", fm >= 2 * fc and pm >= 2 * pc,
         f"fast {fm}/{fc}, parity {pm}/{pc}"),
        ("COM drift", dcom <= 2 * cellw, f"{dcom:.2f} (cell {cellw:.1f})"),
        ("mass (rel)", dmass <= 5e-3, f"{dmass:.2e}"),
    ]
    ok = True
    for name, passed, detail in checks:
        print(f"  {name}: {detail} -> {'ok' if passed else 'FAIL'}",
              flush=True)
        ok &= passed
    print("NORTHSTAR " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["fast", "compare"])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default=FAST_OUT)
    ap.add_argument("--fast", default=FAST_OUT)
    ap.add_argument("--parity", default=None)
    ap.add_argument("--serial", default=None,
                    help='serial binary output as "X Y C"')
    args = ap.parse_args()
    if args.mode == "fast":
        run_fast(args.steps, args.out)
        return 0
    return compare(args.parity, args.fast, args.serial)


if __name__ == "__main__":
    raise SystemExit(main())
