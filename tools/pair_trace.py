#!/usr/bin/env python
"""Pair-pass forms on the flagship: step time, pair-pass time, trace share.

    python tools/pair_trace.py [--out DIR] [--steps 100] [--pairs 10]

The two fused pair-pass forms (PSIM_PAIR_IMPL v2 and v4) on the flagship
configuration (golden #5/#6 shape: seed 1, side 5000, ncside 100, N=1e6)
through the auto-routed resident engine, in ``--pairs`` alternating pairs:
ms/step from (t(run of S steps) - t(run of 0)) / S, and the wall time of
one standalone collide=True pair pass on the flagship's tiles; medians and
quartiles. Then one jax.profiler trace of a 5-step run per form, reduced
to the device time under the ``pair_pass`` and ``rebin`` named scopes,
the device busy time (union of kernel intervals) and the trace window.
Needs a GPU; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _engine(form):
    """Flagship engine built (compiled) with pair-pass form ``form``."""
    import jax

    os.environ["PSIM_PAIR_IMPL"] = form   # read when the step is traced
    from particlesimulation_tpu.config import Precision, SimConfig
    from particlesimulation_tpu.engine import Engine
    eng = Engine(SimConfig(seed=1, side=5000.0, ncside=100,
                           n_particles=1_000_000, precision=Precision.FAST))
    state = eng.init_state()
    jax.block_until_ready(eng.run(state, 0))
    return eng, state


def _per_step(eng, state, steps):
    """(t(run of steps) - t(run of 0)) / steps, and the collision count."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(eng.run(state, 0))
    fixed = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(eng.run(state, steps))
    return (time.perf_counter() - t0 - fixed) / steps, int(out.collisions)


def _pair_pass_time(eng, state, form, reps=20):
    import jax
    import jax.numpy as jnp

    from particlesimulation_tpu.config import EPSILON
    from particlesimulation_tpu.engine import make_resident_run
    from particlesimulation_tpu.ops import dense_xla

    _, prologue, _ = make_resident_run(eng.config, eng.kcap)
    ts = jax.jit(prologue)(state)
    fn = dense_xla.resolve_pair_impl(form)
    ncells, kcap = ts.x.shape
    f = jax.jit(lambda x, y, m, pid: fn(
        x, y, m, (m > 0).astype(jnp.int32), ncells, kcap, EPSILON,
        collide=True, pid=pid))
    args = (ts.x, ts.y, ts.m, ts.pid)
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        r = f(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / reps


def hlo_scopes(hlo_text):
    """{hlo instruction name: metadata op_name} from compiled HLO text."""
    import re

    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*'
                     r'metadata=\{[^}]*op_name="([^"]*)"')
    out = {}
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _trace_reduce(logdir, scopes_of):
    """Device time per named scope from the newest .xplane.pb under logdir.

    Kernel events carry their HLO instruction (``hlo_op`` stat); the
    compiled module's metadata maps it to the jax.named_scope path.
    """
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    pd = ProfileData.from_file(paths[-1])
    scopes = {"pair_pass": 0, "rebin": 0}
    busy = []
    lines_seen = {}
    top = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines_seen[line.name] = len(evs)
            if not line.name.startswith("Stream"):
                continue
            for ev in evs:
                st = dict(ev.stats)
                if st.get("hlo_module") != "jit_run":
                    continue
                dur = ev.duration_ns
                busy.append((ev.start_ns, ev.start_ns + dur))
                op_name = scopes_of.get(str(st.get("hlo_op")), "")
                for sc in scopes:
                    if sc in op_name:
                        scopes[sc] += dur
                top[ev.name] = top.get(ev.name, 0) + dur
    busy.sort()
    total, end = 0, None
    for a, b in busy:                      # union of op intervals
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    window = (busy[-1][1] - busy[0][0]) if busy else 0
    return {"lines": lines_seen, "busy_ns": total, "window_ns": window,
            "kernels": len(busy),
            "scope_ns": scopes,
            "top_ops": sorted(top.items(), key=lambda kv: -kv[1])[:8]}


def _quartiles(v):
    import numpy as np
    return [float(q) for q in np.percentile(v, [25, 50, 75])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/pair_trace")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--pairs", type=int, default=10)
    a = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        print("pair_trace: needs a GPU", file=sys.stderr)
        return 1
    forms = ("v2", "v4")
    built = {f: _engine(f) for f in forms}
    res = {"device": jax.devices()[0].device_kind, "steps": a.steps,
           "forms": {f: {"ms_per_step": [], "pair_pass_ms": []}
                     for f in forms}}
    for i in range(a.pairs):              # alternate which form goes first
        for f in (forms if i % 2 == 0 else forms[::-1]):
            eng, state = built[f]
            per, cols = _per_step(eng, state, a.steps)
            r = res["forms"][f]
            r["ms_per_step"].append(per * 1e3)
            r["collisions"] = cols
            r["pair_pass_ms"].append(_pair_pass_time(eng, state, f) * 1e3)
    for f in forms:
        eng, state = built[f]
        r = res["forms"][f]
        r["ms_per_step_q"] = _quartiles(r["ms_per_step"])
        r["pair_pass_ms_q"] = _quartiles(r["pair_pass_ms"])
        logdir = os.path.join(a.out, f)
        state_in = state._replace(overflow=jnp.zeros((), jnp.int32))
        hlo = eng._run.lower(state_in, jnp.int32(5)).compile().as_text()
        with jax.profiler.trace(logdir):
            jax.block_until_ready(eng.run(state, 5))
        r["trace_run_of_5"] = _trace_reduce(logdir, hlo_scopes(hlo))
        print(f, "ms/step quartiles", r["ms_per_step_q"],
              "pair pass ms quartiles", r["pair_pass_ms_q"], flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
