#!/usr/bin/env python
"""On-device smoke check: the fast engine's main path on NVIDIA GPUs.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # the four-card mesh path (phase 5) only

Phases, one findings line each:

1. device    — JAX version, device kind, the card's name and power limit;
2. goldens   — the reference's five fast golden vectors through every fast
               impl, at the reference harness tolerance (particle 0 within
               ±0.001, collision count exact; serial/run_tests.sh:30-42);
3. flagship  — golden #5 (``1 5000 100 1000000 4``) through the CLI, whose
               census route must be ``resident``; then 100 steps (golden #6)
               timed, with compile time and peak device memory apart;
4. precision — the v2 and v4 pair passes against an f64 direct sum on the
               flagship's tiles; a SMALL-shaped supercell run against the
               f64 parity engine (a CPU child); what TF32 matmuls
               (``Precision.HIGH``) would have cost, for information;
5. four      — ``ShardedEngine`` over four cards against the same engine
               on one card, and ``--mesh 2x2`` through the CLI.

The last line is one JSON object, ``{"ok": true, "device": {...}}``, printed
only when every phase passed. The script never falls back to the CPU: it
exits 1 when JAX finds no GPU. Everything runs in this one process except
the parity oracle, a child pinned to the CPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

TOL = 0.001                   # reference harness coordinate tolerance
FLAGSHIP = (1, 5000.0, 100, 1_000_000)
GOLDEN5 = (4, 3936.506, 131.472, 4)      # tests/test_golden.py vector s1
GOLDEN6 = (100, 3899.787, 156.291, 163)  # tests/test_golden.py vector s2
SMALL = (50, 10000.0, 1300, 500_000)     # reference SMALL workload shape
SMALL_STEPS = 3
FORCE_RTOL = 2e-4
GOLDEN_IMPLS = ("sweep", "resident", "dense", "tiered", "banded",
                "supercell")


def _cfg(seed, side, nc, n, **kw):
    from particlesimulation_tpu.config import Precision, SimConfig
    return SimConfig(seed=seed, side=side, ncside=nc, n_particles=n,
                     precision=Precision.FAST, **kw)


def _by_pid(state):
    order = np.argsort(np.asarray(state.pid))
    return {f: np.asarray(getattr(state, f))[order]
            for f in ("x", "y", "alive")}


def collision_band(expected: int) -> int:
    """The statistical-parity band of tests/test_fast_statistical.py."""
    return max(3, int(0.15 * expected))


# ---- phases -------------------------------------------------------------

def phase_device():
    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = smi.stdout.strip().splitlines()
    print(f"nvidia-smi: {cards[0]}", flush=True)
    return (f"jax {jax.__version__}, {len(jax.devices())} x "
            f"{d.device_kind}; nvidia-smi: {' | '.join(cards)}")


def phase_goldens(impls=GOLDEN_IMPLS):
    from particlesimulation_tpu.engine import Engine
    from tests.test_golden import FAST_VECTORS

    ran, declined, worst = [], [], 0.0
    for vi, (seed, side, nc, n, steps, ex, ey, ec) in enumerate(FAST_VECTORS):
        for impl in impls:
            eng = Engine(_cfg(seed, side, nc, n), impl=impl)
            out = eng.run(eng.init_state(), steps)
            if eng.impl != impl:
                # The engine's ladder moved the run elsewhere: this impl
                # does not take the shape.
                declined.append(f"v{vi}/{impl}->{eng.impl}")
            x, y, c = eng.result(out)
            err = max(abs(x - ex), abs(y - ey))
            assert err <= TOL and c == ec, (
                f"golden v{vi} impl={impl}: ({x:.4f}, {y:.4f}, {c}) vs "
                f"({ex}, {ey}, {ec})")
            assert int(out.overflow) == 0, f"v{vi}/{impl} overflow"
            worst = max(worst, err)
            ran.append((vi, impl))
    return (f"{len(ran)} runs ({len(FAST_VECTORS)} vectors x "
            f"{', '.join(impls)}) pass; worst |dxy| {worst:.2e}; "
            f"declined: {declined or 'none'}")


def run_cli(args):
    """cli.main in-process; returns (stdout lines, stderr lines)."""
    from particlesimulation_tpu import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in args])
    assert rc == 0, f"cli rc={rc}: {err.getvalue()}"
    return out.getvalue().splitlines(), err.getvalue().splitlines()


def check_golden_lines(lines, ex, ey, ec):
    """The CLI's two stdout lines vs a golden vector, ±0.001 compared in
    the printed thousandths (no binary round-off at the boundary)."""
    x, y = map(float, lines[0].split())
    c = int(lines[1])
    milli = [abs(round(a * 1000) - round(b * 1000))
             for a, b in ((x, ex), (y, ey))]
    assert max(milli) <= round(TOL * 1000) and c == ec, (
        f"({x}, {y}, {c}) vs golden ({ex}, {ey}, {ec})")
    return x, y, c


def phase_flagship(cfg_args=FLAGSHIP, golden5=GOLDEN5, golden6=GOLDEN6,
                   expect_impl="resident"):

    from particlesimulation_tpu.engine import Engine

    # Timed run first, on a fresh process cache: the first call compiles.
    eng = Engine(_cfg(*cfg_args))
    state = eng.init_state()
    t0 = time.perf_counter()
    jax.block_until_ready(eng.run(state, 0))
    first_call = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(eng.run(state, 0))
    fixed = time.perf_counter() - t0
    steps, _, _, ec6 = golden6
    t0 = time.perf_counter()
    out = jax.block_until_ready(eng.run(state, steps))
    total = time.perf_counter() - t0
    per_step = (total - fixed) / steps
    n = cfg_args[3]
    _, _, c6 = eng.result(out)
    band = collision_band(ec6)
    ovf, panics = int(out.overflow), int(out.panics)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", -1)
    s5, ex, ey, ec = golden5
    x5, y5, c5 = eng.result(eng.run(state, s5))
    print(f"[flagship] {steps} steps: {per_step * 1e3:.4f} ms/step, "
          f"{n / per_step:.6e} particle-steps/s (run of {steps} "
          f"{total:.4f} s, run of 0 {fixed:.4f} s); first call (compile + "
          f"run of 0 steps) {first_call:.2f} s; peak device bytes {peak}; "
          f"impl={eng.impl} kcap={eng.kcap}; overflow={ovf} "
          f"panics={panics}; collisions {c6} (golden {ec6} ±{band}); "
          f"golden #5 unrounded ({x5!r}, {y5!r}, {c5})", flush=True)
    assert ovf == 0 and panics == 0, f"overflow={ovf} panics={panics}"
    assert abs(c6 - ec6) <= band, f"collisions {c6} vs {ec6} ±{band}"
    assert eng.impl == expect_impl, f"census routed to {eng.impl}"

    # Golden #5 through the user's entry point.
    lines, err = run_cli(list(cfg_args[:3]) + [n, s5, "--engine", "fast"])
    route = [ln for ln in err if ln.startswith("route:")]
    assert route and f"impl={expect_impl}" in route[0], f"route {route}"
    x, y, c = check_golden_lines(lines, ex, ey, ec)
    return (f"cli golden #5 ({x:.3f}, {y:.3f}, {c}) {route[0]}; "
            f"{per_step * 1e3:.4f} ms/step at {steps} steps")


def _frob_rel(fx, fy, tx, ty):
    num = np.sqrt(np.sum((fx - tx) ** 2 + (fy - ty) ** 2))
    return float(num / np.sqrt(np.sum(tx ** 2 + ty ** 2)))


def pair_force_errors(ts, precisions=("F32",)):
    """Frobenius relative error of the v2/v4 pair passes vs f64 direct sum.

    ``ts``: resident tiles (x, y, m). Returns {label: error}; labels are
    ``v2``, ``v4`` and ``v4@<name>`` for each other precision name asked
    for (``HIGH``, ``DEFAULT``; the CPU ignores matmul precision).
    """
    from particlesimulation_tpu.config import EPSILON
    from particlesimulation_tpu.ops import dense_xla
    from tests.oracle_np import tile_pair_forces

    x, y, m = (np.asarray(a, np.float32) for a in (ts.x, ts.y, ts.m))
    ncells, kcap = x.shape
    tx, ty = tile_pair_forces(x, y, m)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
            jnp.asarray((m > 0).astype(np.int32)), ncells, kcap, EPSILON)
    runs = [("v2", dense_xla.fused_pairs_v2, None),
            ("v4", dense_xla.fused_pairs_v4, None)]
    for name in precisions:
        if name != "F32":
            runs.append((f"v4@{name}", dense_xla.fused_pairs_v4,
                         jax.lax.Precision[name]))
    errs = {}
    saved = dense_xla.F32_MATMUL
    for label, fn, prec in runs:
        try:
            if prec is not None:
                dense_xla.F32_MATMUL = prec
            f = jax.jit(lambda *a: fn(*a[:4], ncells, kcap, EPSILON,
                                      collide=False)[:2])(*args[:4])
            fx, fy = (np.asarray(v, np.float64) for v in f)
        finally:
            dense_xla.F32_MATMUL = saved
        errs[label] = _frob_rel(fx, fy, tx, ty)
    return errs


def onehot_gather_errors(rows=4096, k=32, s2=16, side=10000.0, seed=0):
    """Max error of the supercell one-hot COM sum and gather, per precision.

    Returns {precision name: (COM coordinate error, gathered coordinate
    error)} in length units against f64 — what a TF32 matmul would do to
    the supercell engine's contractions (ops/supercell.py).
    """
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, side, (rows, k)).astype(np.float32)
    m = rng.uniform(0.01, 1.0, (rows, k)).astype(np.float32)
    lab = rng.integers(0, s2, (rows, k))
    oh = (lab[..., None] == np.arange(s2)).astype(np.float32)
    tbl = rng.uniform(0, side, (rows, s2, 3)).astype(np.float32)
    M = np.einsum("rk,rks->rs", m.astype(np.float64), oh)
    SX = np.einsum("rk,rks->rs", (m * x).astype(np.float64), oh)
    com_t = np.where(M > 0, SX / np.where(M > 0, M, 1), 0)
    gat_t = np.einsum("rks,rsc->rkc", oh.astype(np.float64), tbl)
    out = {}
    for prec in (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGH,
                 jax.lax.Precision.DEFAULT):
        @jax.jit
        def f(m, x, oh, tbl):
            M = jnp.einsum("rk,rks->rs", m, oh, precision=prec)
            SX = jnp.einsum("rk,rks->rs", m * x, oh, precision=prec)
            com = jnp.where(M > 0, SX / jnp.where(M > 0, M, 1), 0)
            return com, jnp.einsum("rks,rsc->rkc", oh, tbl, precision=prec)
        com, gat = (np.asarray(v, np.float64) for v in f(m, x, oh, tbl))
        out[prec.name] = (float(np.abs(com - com_t).max()),
                          float(np.abs(gat - gat_t).max()))
    return out


PARITY_CHILD = """
import sys
import numpy as np
from particlesimulation_tpu.config import Precision, SimConfig
from particlesimulation_tpu.engine import Engine
seed, side, nc, n, steps = sys.argv[1:]
cfg = SimConfig(seed=int(seed), side=float(side), ncside=int(nc),
                n_particles=int(n), precision=Precision.PARITY)
eng = Engine(cfg)
st = eng.run(eng.init_state(), int(steps))
order = np.argsort(np.asarray(st.pid))
rows = [np.asarray(getattr(st, f))[order].astype(np.float64)
        for f in ("x", "y", "alive")]
rows.append(np.full(len(order), float(np.asarray(st.collisions))))
np.save(sys.stdout.buffer, np.stack(rows))
"""


def parity_on_cpu(seed, side, nc, n, steps):
    """The f64 parity engine in a CPU-pinned child (the oracle)."""
    from particlesimulation_tpu.utils.runtime import parity_env

    env = {**os.environ, **parity_env(1)}
    r = subprocess.run(
        [sys.executable, "-c", PARITY_CHILD, str(seed), str(side), str(nc),
         str(n), str(steps)],
        cwd=REPO, env=env, capture_output=True, timeout=900)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    a = np.load(io.BytesIO(r.stdout))
    return {"x": a[0], "y": a[1], "alive": a[2] > 0.5,
            "collisions": int(a[3][0])}


def supercell_vs_parity(cfg_args=SMALL, steps=SMALL_STEPS):
    """Fast auto-routed run on the card vs the parity engine on the CPU.

    Returns (impl, collisions, max coordinate delta, tolerance).
    Tolerance: two f32 ulps at ``side`` per step (the fast engine rounds
    the stored velocity and position every step; over a few steps the two
    trajectories differ by that rounding, not by physics). From step 4 of
    the SMALL run on, one pair whose f64 distance is 0.00533 sits 0.0039
    apart in f32 and merges in the fast engine on any backend, so the
    comparison stays at 3 steps.
    """

    from particlesimulation_tpu.engine import Engine

    eng = Engine(_cfg(*cfg_args))
    st = eng.run(eng.init_state(), steps)
    fast = _by_pid(st)
    ref = parity_on_cpu(*cfg_args, steps)
    c = int(st.collisions)
    assert c == ref["collisions"], f"collisions {c} vs {ref['collisions']}"
    assert (fast["alive"] == ref["alive"]).all(), "dead sets differ"
    tol = 2 * steps * float(np.spacing(np.float32(cfg_args[1])))
    dmax = float(max(np.abs(fast["x"] - ref["x"]).max(),
                     np.abs(fast["y"] - ref["y"]).max()))
    assert dmax <= tol, f"max coordinate delta {dmax} > {tol}"
    return eng.impl, c, dmax, tol


def flagship_tiles(cfg_args=FLAGSHIP):
    from particlesimulation_tpu.engine import Engine, make_resident_run

    eng = Engine(_cfg(*cfg_args), impl="resident")
    state = eng.init_state()
    _, prologue, _ = make_resident_run(eng.config, eng.kcap)
    return jax.jit(prologue)(state)


def phase_precision():
    ts = flagship_tiles()
    errs = pair_force_errors(ts, precisions=("F32", "HIGH", "DEFAULT"))
    for label in ("v2", "v4"):
        assert errs[label] <= FORCE_RTOL, f"{label}: {errs[label]:.3e}"
    gath = onehot_gather_errors()
    assert gath["HIGHEST"][1] == 0.0, f"one-hot gather inexact: {gath}"
    impl, c, dmax, tol = supercell_vs_parity()
    assert impl == "supercell", f"SMALL routed to {impl}"
    ncells, kcap = np.asarray(ts.x).shape
    return (f"pair forces vs f64 direct sum on the flagship tiles "
            f"({ncells}x{kcap}), Frobenius rel err: v2 {errs['v2']:.3e}, "
            f"v4 {errs['v4']:.3e} (bound {FORCE_RTOL}); info: v4 at "
            f"HIGH {errs['v4@HIGH']:.3e}, DEFAULT {errs['v4@DEFAULT']:.3e}; "
            f"one-hot COM/gather max err (length units, side 1e4) HIGHEST "
            f"{gath['HIGHEST']}, HIGH {gath['HIGH']}, DEFAULT "
            f"{gath['DEFAULT']}; SMALL {SMALL} x{SMALL_STEPS} steps: "
            f"{impl} vs CPU parity, collisions {c} equal, dead sets equal, "
            f"max |dxy| {dmax:.3e} <= {tol:.3e}")


def compare_sharded(cfg_args, steps, impl, devices):
    """ShardedEngine over ``devices`` vs the same engine on one card."""
    from particlesimulation_tpu.engine import Engine
    from particlesimulation_tpu.parallel.sharded import ShardedEngine

    single = Engine(_cfg(*cfg_args), impl=impl)
    ss = single.run(single.init_state(), steps)
    mesh = ShardedEngine(_cfg(*cfg_args, n_shards=len(devices)),
                         devices=devices, impl=impl)
    ms = mesh.run(mesh.init_state(), steps)
    sx, sy, sc = single.result(ss)
    mx, my, mc = mesh.result(ms)
    g = mesh.gather(ms)
    single_alive = _by_pid(ss)["alive"]
    assert int(ms.overflow) == 0, "mesh overflow"
    assert mc == sc, f"collisions {mc} vs one card {sc}"
    assert (g["alive"] == single_alive).all(), "dead sets differ"
    assert abs(mx - sx) <= TOL and abs(my - sy) <= TOL, (
        f"particle 0 ({mx}, {my}) vs one card ({sx}, {sy})")
    variant = getattr(mesh, "banded_variant", "") if mesh.impl == "banded" \
        else ""
    return (f"{single.impl}/{mesh.impl}{'-' + variant if variant else ''}"
            f" c={mc} p0=({mx:.3f},{my:.3f})")


def phase_four():
    devices = jax.devices()[:4]
    assert len(devices) == 4, f"{len(devices)} devices"
    out = [compare_sharded(FLAGSHIP, 20, "resident", devices)]
    heavy = compare_sharded((-1, 1000.0, 30, 100_000), 50, None, devices)
    assert "banded-cols" in heavy, f"vector #11 shape routed {heavy}"
    out.append(heavy)
    small = compare_sharded(SMALL, 10, None, devices)
    assert "supercell/supercell" in small, f"SMALL routed {small}"
    out.append(small)
    s5, ex, ey, ec = GOLDEN5
    lines, err = run_cli(list(FLAGSHIP[:3]) + [FLAGSHIP[3], s5, "--engine",
                                               "fast", "--mesh", "2x2"])
    x, y, c = check_golden_lines(lines, ex, ey, ec)
    route = [ln for ln in err if ln.startswith("route:")]
    out.append(f"cli --mesh 2x2 golden #5 ({x:.3f}, {y:.3f}, {c}) "
               f"{route[0] if route else ''}")
    return "; ".join(out)


# ---- driver -------------------------------------------------------------

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    try:
        devices = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: JAX found no accelerator ({e})")
        return 1
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r}); this check never runs on the CPU")
        return 1
    if four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, JAX found {len(devices)}")
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    phases = [("device", phase_device)]
    if four:
        phases.append(("four", phase_four))
    else:
        phases += [("goldens", phase_goldens), ("flagship", phase_flagship),
                   ("precision", phase_precision)]
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            msg = fn()
        except Exception:
            ok = False
            traceback.print_exc()
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s "
                  f"(traceback on stderr)", flush=True)
            continue
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: {msg}",
              flush=True)
    if not ok:
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
