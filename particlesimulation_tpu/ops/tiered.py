"""Occupancy-classed dense tiles for clustered (high-variance) grids.

The reference's bucket grid pays per-particle work regardless of how
particles distribute over cells (reference serial/parsim.cpp:261-290,
292-377: per-bucket loops). The dense-tile formulation instead pays
``ncells x kcap^2`` pair lanes with ``kcap`` = the *global* max occupancy —
on clustered loads (the reference harness's normal-mode ``-seed`` inits,
serial/parsim.cpp:220-232, a Gaussian blob) the occupancy spans orders of
magnitude (UNEVEN: median 21, max ~750 at a mean of 100), so one hot cell
taxes every cell: kcap=960, 9.2e9 pair lanes.

A two-tier cut helps little: the blob's occupancy is a smooth
continuum — 1888 of 10000 cells exceed any reasonable small cap, and
every one of them paid the global-max tile. The fix is a **geometric ladder of occupancy classes**: cells are grouped
by occupancy into T classes with static caps k_0 < k_1 < ... < k_{T-1};
class 0 keeps a row for every cell (row = cell id, no indirection), and
each higher class holds a compact census-budgeted row list. A cell pays
pair lanes proportional to (at worst) 4x its own occupancy squared —
``sum_t rows_t * k_t^2`` ~ 0.6G lanes on UNEVEN vs 11.8G single-tier
(lane model in the planner below; sum occ^2 = 0.35G is the floor).

Layout: all classes live in ONE flat slot buffer (class offsets are
static), so tile build is a single scatter per field and the force
readback a single gather — per-particle traffic does not scale with T.
The per-class pair/collision passes (`ops/dense_xla.py`) run unchanged
on reshaped views of the flat buffer. Per-cell COM rows merge by
scatter-add (a classed cell's class-0 row is empty), so the stencil tables and every downstream consumer see
the same (ncells,) arrays as the single-tier step.

Capacity is planned from a host-side occupancy census (`plan_tiers`, a
boundary DP over 32-multiples) and guarded in-graph: occupancy beyond
the top cap flags ``state.overflow`` positive, a class row-budget
deficit flags it negative, and the engine's lossless retry ladder
re-plans — exactly like the single-tier impls (engine.py:run). The
reference PANIC-skips in its analogous case.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from particlesimulation_tpu.config import DELTAT, EPSILON, Precision, SimConfig
from particlesimulation_tpu.ops import binning, collisions, integrate, stencil
from particlesimulation_tpu.ops import dense_xla as dmod
from particlesimulation_tpu.state import SimState


def _round32(x: float) -> int:
    return max(32, (int(x) + 31) // 32 * 32)


# Cost-model weights in pair-lane units: a per-extra-class fixed overhead
# (an extra pair + collision dispatch and COM merge inside the step)
# charged as lane-equivalents — it also makes the planner decline
# ladders on small grids, where dispatch overhead beats lane savings.
# Untuned defaults carried over from the first target; not calibrated on
# the H100.
_CLASS_PENALTY = 8_000_000
_SLOT_WEIGHT = 24  # linear per-slot passes (scatter, COM, collision aux)


def plan_tiers(occ_hist, ncells: int, max_kcap: int):
    """Choose class caps+row budgets from a host-side occupancy census.

    Returns ``[(cap_0, rows_0=ncells), (cap_1, rows_1), ...]`` (caps
    ascending, row budgets census * 1.3 headroom) minimizing
    ``sum rows*k^2 + slot/class overheads`` via a boundary DP over
    32-multiples, or None when the best ladder saves < 40% of the
    single-tier cost (then plain dense tiles are simpler and as fast).
    """
    import numpy as np

    occ = np.asarray(occ_hist)
    maxocc = int(occ.max()) if occ.size else 0
    top = min(_round32(maxocc * 1.1 + 4), max_kcap)
    single = ncells * top * top + _SLOT_WEIGHT * ncells * top
    caps = [k for k in range(32, top, 32)] + [top]
    # occupancy counts above each candidate boundary, for O(1) rows()
    counts = {k: int((occ > k).sum()) for k in [0] + caps}

    def seg_cost(prev: int, k: int, first: bool):
        n_seg = counts[prev] - counts[k]
        rows = ncells if first else max(32, -(-int(n_seg * 1.3) // 32) * 32)
        return rows * k * k + _SLOT_WEIGHT * rows * k + _CLASS_PENALTY, rows

    best = {}  # prev_cap -> (cost, plan-tail)
    order = [0] + caps

    def solve(prev: int, first: bool):
        if prev == top:
            return 0, ()
        key = (prev, first)
        if key in best:
            return best[key]
        b = None
        for k in caps:
            if k <= prev:
                continue
            c0, rows = seg_cost(prev, k, first)
            ct, tail = solve(k, False)
            cand = (c0 + ct, ((k, rows),) + tail)
            if b is None or cand[0] < b[0]:
                b = cand
        best[key] = b
        return b

    import sys
    rec = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec, len(order) + 100))
    try:
        cost, plan = solve(0, True)
    finally:
        sys.setrecursionlimit(rec)
    if cost > 0.6 * single or len(plan) < 2:
        return None
    return list(plan)


def make_tiered_step(config: SimConfig, plan):
    """Fast f32 step over occupancy-classed dense tiles.

    ``plan``: [(cap, rows), ...] caps ascending, rows_0 == ncells.
    Mirrors ``engine.make_dense_step`` (same step sequencing, same carried
    post-move tiles, reference serial/parsim.cpp:422-448) with the tile
    build/consume split across the classes.
    """
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    assert config.precision is Precision.FAST
    plan = [(int(k), int(r)) for k, r in plan]
    caps = [k for k, _ in plan]
    rows = [r for _, r in plan]
    assert caps == sorted(caps) and len(set(caps)) == len(caps)
    assert rows[0] == ncells
    T = len(plan)
    offs = [0]
    for k, r in plan:
        offs.append(offs[-1] + r * k)
    total = offs[-1]

    caps_a = jnp.asarray(caps, jnp.int32)          # (T,)
    rows_a = jnp.asarray(rows, jnp.int32)
    offs_a = jnp.asarray(offs[:-1], jnp.int32)
    cell_ids = jnp.arange(ncells, dtype=jnp.int32)

    def build_tiles(state: SimState):
        """Classed tiles (one flat slot buffer) + index maps."""
        key, valid = binning.cell_keys(state.x, state.y, side, nc)
        pos, _ = binning.segment_positions(key)
        occ = (jnp.zeros(ncells + 1, jnp.int32).at[key].add(1))[:ncells]
        kmax = jnp.max(occ)
        # Class of each cell: first cap >= occ (top class for over-cap
        # cells too — they overflow k slots, flagged below).
        cls = jnp.searchsorted(caps_a, occ, side="left").astype(jnp.int32)
        cls = jnp.minimum(cls, T - 1)
        # Row of each cell within its class: class 0 is identity (every
        # cell owns a row); higher classes are compact rank lists.
        row_of_cell = cell_ids
        ids_list = []   # (rows_t,) cell id per class row, classes 1..T-1
        n_list = []
        deficit = jnp.int32(0)
        for t in range(1, T):
            sel = cls == t
            n_t = jnp.sum(sel, dtype=jnp.int32)
            rank = jnp.cumsum(sel.astype(jnp.int32)) - 1
            row_of_cell = jnp.where(sel, rank, row_of_cell)
            ids_t = (jnp.zeros(rows[t], jnp.int32)
                     .at[jnp.where(sel & (rank < rows[t]), rank, rows[t])]
                     .set(cell_ids, mode="drop"))
            ids_list.append(ids_t)
            n_list.append(n_t)
            deficit = jnp.maximum(deficit, n_t - rows[t])
        # Overflow telemetry: positive = occupancy needs top cap >= that;
        # negative = worst class row deficit (engine.run re-plans).
        ovf = jnp.where(kmax > caps[-1], kmax, 0).astype(jnp.int32)
        ovf = jnp.where((ovf == 0) & (deficit > 0), -deficit, ovf)

        kc = jnp.minimum(key, jnp.int32(ncells - 1))
        cls_p = cls[kc]
        k_p = caps_a[cls_p]
        row_p = row_of_cell[kc]
        ok = (valid & (pos < k_p) & (row_p < rows_a[cls_p]))
        idx = jnp.where(ok, offs_a[cls_p] + row_p * k_p + pos, total)
        xf = jnp.zeros(total, state.x.dtype).at[idx].set(state.x,
                                                         mode="drop")
        yf = jnp.zeros(total, state.y.dtype).at[idx].set(state.y,
                                                         mode="drop")
        mf = jnp.zeros(total, state.m.dtype).at[idx].set(state.m,
                                                         mode="drop")
        return {"xf": xf, "yf": yf, "mf": mf, "idx": idx, "ok": ok,
                "ids": ids_list, "ncls": n_list, "ovf": ovf,
                "panic": jnp.sum(~valid, dtype=jnp.int32)}

    def views(flat):
        return [flat[offs[t]:offs[t + 1]].reshape(rows[t], caps[t])
                for t in range(T)]

    INF = jnp.int32(0x7FFFFFFF)

    def step(state: SimState, tiles):
        x, y, vx, vy, m, alive, pid = (state.x, state.y, state.vx, state.vy,
                                       state.m, state.alive, state.pid)
        ovf = tiles["ovf"]
        xs, ys, ms = views(tiles["xf"]), views(tiles["yf"]), views(tiles["mf"])

        # Per-cell COM: class-0 rows are cell-indexed; higher classes
        # merge by scatter-add (their class-0 rows are all-zero).
        def merged(parts):
            out = parts[0]
            for t in range(1, T):
                tgt = jnp.where(
                    jnp.arange(rows[t], dtype=jnp.int32) < tiles["ncls"][t - 1],
                    tiles["ids"][t - 1], ncells)
                out = out.at[tgt].add(parts[t], mode="drop")
            return out

        M = merged([jnp.sum(ms[t], axis=1) for t in range(T)])
        SX = merged([jnp.sum(ms[t] * xs[t], axis=1) for t in range(T)])
        SY = merged([jnp.sum(ms[t] * ys[t], axis=1) for t in range(T)])
        safe = jnp.where(M > 0, M, jnp.float32(1.0))
        MX = jnp.where(M > 0, SX / safe, jnp.float32(0.0))
        MY = jnp.where(M > 0, SY / safe, jnp.float32(0.0))

        ml, mxl, myl = stencil.stencil_tables(M, MX, MY, side, nc)
        ml_t = ml[:, :ncells].T  # (ncells, 8)
        mxl_t = mxl[:, :ncells].T
        myl_t = myl[:, :ncells].T

        fparts_x, fparts_y = [], []
        for t in range(T):
            if t == 0:
                mlv, mxv, myv = ml_t, mxl_t, myl_t
            else:
                ids = tiles["ids"][t - 1]
                mlv, mxv, myv = ml_t[ids], mxl_t[ids], myl_t[ids]
            fx_t, fy_t = dmod.dense_pairwise_forces(
                xs[t], ys[t], ms[t], mlv, mxv, myv, rows[t], caps[t])
            fparts_x.append(fx_t.reshape(-1))
            fparts_y.append(fy_t.reshape(-1))
        fxf = jnp.concatenate(fparts_x)
        fyf = jnp.concatenate(fparts_y)

        zero = jnp.float32(0.0)
        g = jnp.minimum(tiles["idx"], total - 1)
        fx = jnp.where(tiles["ok"], fxf[g], zero)
        fy = jnp.where(tiles["ok"], fyf[g], zero)

        x, y, vx, vy = integrate.integrate(x, y, vx, vy, m, fx, fy, side,
                                           DELTAT)

        # Post-move rebin: one sort per step, fresh tiles (reused by the
        # collision pass now and as next step's binning).
        key2, valid2 = binning.cell_keys(x, y, side, nc)
        key2, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key2, pid, x, y, vx, vy, m, alive)
        mid = SimState(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
                       collisions=state.collisions, panics=state.panics,
                       overflow=state.overflow)
        tiles2 = build_tiles(mid)
        ovf = _merge_ovf(ovf, tiles2["ovf"])

        # Collisions per class. Slot order is (key, pid)-sorted in every
        # class, so slot index == bucket order (no pid tiles needed).
        xs2, ys2, ms2 = (views(tiles2["xf"]), views(tiles2["yf"]),
                         views(tiles2["mf"]))
        count = jnp.int32(0)
        ft_parts = []
        for t in range(T):
            ad = (ms2[t] > 0).astype(jnp.int32)
            cnt_t, ft_t = dmod.dense_collisions(
                xs2[t], ys2[t], ad, rows[t], caps[t], EPSILON)
            count = count + cnt_t
            ft_parts.append(ft_t.reshape(-1))
        ftf = jnp.concatenate(ft_parts)
        g2 = jnp.minimum(tiles2["idx"], total - 1)
        died = tiles2["ok"] & (ftf[g2] != INF)
        m, alive = collisions.apply_deaths(m, alive, died)
        # Deaths in tile space keep the carried mass tiles consistent.
        tiles2["mf"] = jnp.where(ftf != INF, jnp.float32(0.0), tiles2["mf"])
        tiles2["ovf"] = ovf

        out = SimState(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
            collisions=state.collisions + count.astype(state.collisions.dtype),
            panics=state.panics + tiles["panic"],
            overflow=_merge_ovf(state.overflow, ovf),
        )
        return out, tiles2

    def run(state: SimState, n_steps):
        tiles = build_tiles(state)

        def body(i, carry):
            st, tl = carry
            return step(st, tl)

        out, _ = jax.lax.fori_loop(0, n_steps, body, (state, tiles))
        return out

    return step, build_tiles, run


def _merge_ovf(a, b):
    """Merge overflow telemetry: positive (occupancy need) dominates,
    otherwise the most-negative row deficit."""
    return jnp.where((a > 0) | (b > 0),
                     jnp.maximum(a, b), jnp.minimum(a, b))
