"""Slot-resident rebinning: move particles between cell tiles without a sort.

The sorted-particle representation pays a per-particle scatter/gather and
a lexicographic sort every step. The resident representation
keeps the *state itself* in (ncells, K) slot tiles and re-bins by moving the
few particles that changed cell ("movers") directly between rows:

1. per slot, the destination cell from the post-move position; a mover's
   next hop is one of the 8 neighbor directions (sign of the minimal-image
   cell delta — diagonal moves allowed);
2. for each direction, departing-slot tiles roll across the periodic cell
   grid (``jnp.roll`` — a reindex copy, no gathers);
3. each round, every row accepts up to R arrivals per direction: the
   first pending arrivals (``argmax``/cumsum rank over the rolled mover
   mask) land in the row's free slots assigned *packed* across directions
   (a per-row accepted-so-far counter, so a row with F free slots takes
   up to F arrivals regardless of which directions they come from), with
   the transfer done by one-hot masked reductions — pure elementwise +
   reduce ops, no gathers, no scatters, no matmuls, bit-exact data
   movement (pids ride int32 masked sums);
4. rounds repeat in a ``while_loop`` until every mover is delivered
   (guaranteed progress: any row with a free slot and a pending arrival
   accepts at least one per round; typical steps need one or two rounds,
   multi-cell hops a few more).

A round cap plus an overflow flag lets the engine retry losslessly with
bigger tiles, mirroring the dense-capacity protocol.

Fragmentation is free: force/collision kernels do full K² masked work
regardless of which slots are occupied, so rows are never compacted.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from particlesimulation_tpu.ops.stencil import STENCIL

# Rounds are cheap (elementwise + reductions in a while_loop) and deliver up
# to 8 arrivals per row each; the cap only bounds pathological bursts before
# the engine's lossless retry/escalation takes over.
MAX_ROUNDS = 64

# Straggler-compaction capacity: once the pending-mover count fits, the
# remaining deliveries happen in one compact pass (two nonzero()s + an
# 8k sort + small gather/scatter) instead of more full-grid rounds.
# Opt-in (PSIM_REBIN_COMPACT=1): nonzero() lowers to the scatter class
# the resident design exists to avoid. It lost on the first target; its
# speed on the H100 is not measured yet.
MCAP = int(os.environ.get("PSIM_REBIN_MCAP", "8192"))


class TileState(NamedTuple):
    """Slot-resident simulation state. Tile arrays are (ncells, K)."""

    x: jnp.ndarray
    y: jnp.ndarray
    vx: jnp.ndarray
    vy: jnp.ndarray
    m: jnp.ndarray
    occ: jnp.ndarray     # bool: slot holds a particle (alive or dead)
    pid: jnp.ndarray     # int32
    collisions: jnp.ndarray
    panics: jnp.ndarray
    overflow: jnp.ndarray


def cell_of(x, y, side: float, ncside: int):
    """Per-slot destination cell and validity (C truncation semantics)."""
    w = jnp.asarray(side / ncside, dtype=x.dtype)
    cx = (x / w).astype(jnp.int32)
    cy = (y / w).astype(jnp.int32)
    nc = jnp.int32(ncside)
    valid = (cx >= 0) & (cx < nc) & (cy >= 0) & (cy < nc)
    return cx, cy, valid


def _wrap_delta(d, ncside: int):
    """Minimal-image cell delta in [-nc/2, nc/2)."""
    nc = jnp.int32(ncside)
    half = nc // 2
    return ((d + half) % nc) - half


def _roll_grid(a, dx: int, dy: int, ncside: int, nrows: int | None = None):
    """grid[c] -> grid[c - (dx,dy)] over the periodic (nrows, nc) cell grid.

    The sharded engine passes a non-square local grid (halo rows included);
    its halo rows carry no movers, so y-wraparound never aliases there.
    """
    g = a.reshape(nrows or ncside, ncside, *a.shape[1:])
    g = jnp.roll(g, (dy, dx), axis=(0, 1))
    return g.reshape(a.shape)


def rebin(ts: TileState, side: float, ncside: int, kcap: int,
          mover_fn=None, nrows: int | None = None, dest_fn=None,
          return_rounds: bool = False):
    """Deliver all movers to their destination rows. Returns (ts', overflow).

    ``return_rounds=True`` appends the executed delivery-round count to
    the return tuple (telemetry for the direction-decomposition and R
    sweeps — per-round cost is static, so rounds × terms is the cost
    model).

    overflow is 0 when everything was delivered within MAX_ROUNDS and no
    row ran out of free slots; otherwise the number of undelivered movers
    (the engine retries the run with larger tiles).

    ``mover_fn(st) -> (moving, sx, sy)`` overrides the mover predicate
    (the sharded engine freezes halo-row occupants awaiting shipment and
    maps global rows to its local halo-extended grid); ``nrows`` overrides
    the grid height for non-square local grids. ``dest_fn(st) ->
    (moving, dest_row)`` provides absolute destinations for the straggler
    compaction (derived from positions by default; pass it alongside
    ``mover_fn`` to enable compaction on custom grids — without it a
    custom-grid rebin uses delivery rounds only).
    """
    ncells = (nrows or ncside) * ncside
    nslots = ncells * kcap
    rowid = jnp.arange(ncells, dtype=jnp.int32)[:, None]  # (ncells, 1)
    row_cy = rowid // ncside
    row_cx = rowid % ncside

    def default_mover_info(st: TileState):
        cx, cy, valid = cell_of(st.x, st.y, side, ncside)
        dest = cy * ncside + cx
        moving = st.occ & valid & (dest != rowid)
        sx = jnp.sign(_wrap_delta(cx - row_cx, ncside))
        sy = jnp.sign(_wrap_delta(cy - row_cy, ncside))
        return moving, sx, sy

    mover_info = mover_fn or default_mover_info

    def default_dest_info(st: TileState):
        cx, cy, valid = cell_of(st.x, st.y, side, ncside)
        dest = cy * ncside + cx
        moving = st.occ & valid & (dest != rowid)
        return moving, dest

    if dest_fn is None and mover_fn is None:
        dest_fn = default_dest_info
    compact_ok = (dest_fn is not None
                  and os.environ.get("PSIM_REBIN_COMPACT", "0") == "1")

    FIELDS = ("x", "y", "vx", "vy", "m")
    lane = jnp.arange(kcap, dtype=jnp.int32)[None, :]

    def compact_pass(st: TileState):
        """Deliver all pending movers in one compacted gather/scatter.

        Entered once the pending count fits MCAP: replaces the tail of
        full-grid delivery rounds (each re-runs the whole grid for a few
        stragglers, 5-8 rounds/step at the N=1e6 flagship). Movers compact to an (MCAP,) buffer (nonzero),
        sort by destination row, and land in their destination's lowest
        free slots; the landing set is enumerated row-major (second
        nonzero) so the i-th deliverable mover pairs with the i-th
        landing slot by construction. Multi-row hops deliver directly
        (no per-round neighbor stepping). Bit-exact transport: values
        move by gather/scatter only.
        """
        moving, dest = dest_fn(st)
        n_moving = jnp.sum(moving, dtype=jnp.int32)
        mflat = moving.reshape(-1)
        src_idx = jnp.nonzero(mflat, size=MCAP, fill_value=nslots)[0]
        src_idx = src_idx.astype(jnp.int32)
        in_cap = src_idx < nslots
        destf = jnp.where(
            in_cap,
            dest.reshape(-1)[jnp.minimum(src_idx, nslots - 1)],
            jnp.int32(ncells))
        drow, sidx = jax.lax.sort((destf, src_idx), num_keys=2)
        # Per-destination-row arrival rank (0-based, source order).
        mc = jnp.arange(MCAP, dtype=jnp.int32)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), drow[1:] != drow[:-1]])
        seg_start = jax.lax.cummax(jnp.where(first, mc, 0))
        arank = mc - seg_start
        occ = st.occ
        fr = jnp.cumsum((~occ).astype(jnp.int32), axis=1)  # 1-based
        navail = fr[:, -1]
        nav_m = jnp.where(drow < ncells,
                          navail[jnp.minimum(drow, ncells - 1)], 0)
        deliv = (drow < ncells) & (arank < nav_m)
        n_del = jnp.sum(deliv, dtype=jnp.int32)
        a_r = jnp.zeros(ncells, jnp.int32).at[
            jnp.minimum(drow, ncells - 1)].add(
                deliv.astype(jnp.int32), mode="drop")
        tgt = (~occ) & (fr <= a_r[:, None])
        tgt_idx = jnp.nonzero(tgt.reshape(-1), size=MCAP,
                              fill_value=nslots)[0].astype(jnp.int32)
        dm_pos = jnp.nonzero(deliv, size=MCAP,
                             fill_value=MCAP - 1)[0].astype(jnp.int32)
        act = mc < n_del
        srcs = jnp.where(act, sidx[dm_pos], jnp.int32(nslots))
        tgts = jnp.where(act, tgt_idx, jnp.int32(nslots))
        gsrc = jnp.minimum(srcs, nslots - 1)

        def move(a):
            flat = a.reshape(-1)
            vals = flat[gsrc]
            return flat.at[tgts].set(vals, mode="drop").reshape(a.shape)

        new = {f: move(getattr(st, f)) for f in FIELDS}
        pidn = move(st.pid)
        occf = occ.reshape(-1).at[tgts].set(True, mode="drop")
        occf = occf.at[srcs].set(False, mode="drop")  # sentinels drop
        st = st._replace(occ=occf.reshape(occ.shape), pid=pidn, **new)
        st = st._replace(m=jnp.where(st.occ, st.m,
                                     jnp.asarray(0.0, st.m.dtype)))
        return st, n_moving - n_del

    # Deliveries per (row, direction) per round. R=3 made XLA's lowering
    # collapse on the first target. The rebin constants below (R, FORM,
    # STACKF, NDIRS) are untuned defaults carried over from that target;
    # none has been tuned on the H100.
    R = int(os.environ.get("PSIM_REBIN_R", "2"))
    # Arrival-selection formulation: "argmax" chains per-rank argmax
    # reductions, "rank" is the general cumsum form. Winner/target
    # selection is identical — the r-th set lane — so the two are
    # bit-equivalent; only the op class differs. Default: argmax.
    FORM = os.environ.get("PSIM_REBIN_FORM",
                          "argmax" if R <= 2 else "rank")
    # Phase-2 transport batching: stacking the five f32 fields into one
    # (5, ncells, K) array turns 5 masked-sum/roll/select chains per term
    # into 1 (pid stays a separate int32 pass — bitcasting pids through
    # f32 arithmetic is not NaN-payload-safe). Off by default, kept for
    # A/B.
    STACKF = os.environ.get("PSIM_REBIN_STACK", "0") == "1"
    # Direction decomposition: 8 = full stencil (one term set per sign
    # pair), 4 = axis-routed (dimension-ordered routing: movers with a
    # nonzero x-delta ship along ±x first, pure-y movers along ±y;
    # diagonal movers reach their row in two hops). Per-round cost is
    # mask-dominated and scales with the direction-term count, while
    # corner-crossing (diagonal) movers are rare at physical step sizes —
    # so 4 halves the per-round transport for at most ~one extra round.
    # Default 4.
    NDIRS = int(os.environ.get("PSIM_REBIN_DIRS", "4"))
    if NDIRS == 4:
        DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
    else:
        DIRS = tuple(STENCIL)

    def _going(moving, sx, sy, dx, dy):
        if NDIRS == 4:
            if dx != 0:
                return moving & (sx == dx)
            return moving & (sx == 0) & (sy == dy)
        return moving & (sx == dx) & (sy == dy)

    def one_round(st: TileState):
        """One delivery round: per (row, direction), the first R pending
        arrivals land in the row's free slots (rank-matched).

        Two phases keep HBM traffic low: (1) a mask-only sweep over the 8
        directions (bool tiles, sequential free-slot accounting); (2) one
        data pass per field — per-(direction, rank) winner values reduce
        to (ncells, 1) columns at the source, roll as columns, and a
        single masked select writes each field tile once.
        """
        moving, sx, sy = mover_info(st)

        # Phase 1 — masks. Free slots are assigned PACKED: a per-row
        # running `base` counts arrivals accepted so far this round, and
        # the next acceptance (any direction) takes free slot base+1.
        # The earlier static assignment (direction d's rank r took slot
        # d*R+r+1 unconditionally) deadlocked at snug kcap: a row with
        # fewer than 8R free slots blocked high-numbered directions
        # forever, the while_loop spun to MAX_ROUNDS, and the engine's
        # lossless retry grew kcap 160 -> 256 spuriously (observed at the
        # N=1e6 bench, step ~75, R=2). Packed, any row with a free slot
        # and a pending arrival makes progress every round, so
        # "undelivered" can only mean genuinely full rows — which kcap
        # growth does fix.
        occ = st.occ
        fr = jnp.cumsum((~occ).astype(jnp.int32), axis=1)  # 1-based free rank
        n_free = fr[:, -1:]
        base = jnp.zeros_like(n_free)  # (ncells, 1) accepted-so-far
        wins_src = []   # winner one-hots at source coordinates
        tgts = []       # landing one-hots at destination coordinates
        rolls = []      # (dx, dy) per term, for phase 2's column rolls
        departed = jnp.zeros(st.occ.shape, dtype=bool)
        tgt_any = jnp.zeros(st.occ.shape, dtype=bool)
        for d, (dx, dy) in enumerate(DIRS):
            going = _going(moving, sx, sy, dx, dy)
            arr = _roll_grid(going, dx, dy, ncside, nrows)
            if R == 1 and FORM == "argmax":
                # argmax formulation: one reduction instead of the rank
                # form's cumsum (bit-equivalent; faster on the first
                # target, not measured on the H100).
                has = jnp.any(arr, axis=1, keepdims=True)
                ok = has & (base < n_free)
                win = arr & (lane == jnp.argmax(arr, axis=1)[:, None]) & ok
                tgt = (~occ) & (fr == base + 1) & ok
                src_win = _roll_grid(win, -dx, -dy, ncside, nrows) & going
                wins_src.append(src_win)
                tgts.append(tgt)
                rolls.append((dx, dy))
                departed = departed | src_win
                tgt_any = tgt_any | tgt
                base = base + ok.astype(jnp.int32)
                continue
            if FORM == "argmax":
                # Chained-argmax form for R=2: rank r's winner is the
                # first set lane of arr with the previous winners cleared
                # — the same lane the cumsum form selects (arank == r+1),
                # via 2 reductions instead of a (ncells, K) cumsum.
                rem = arr
                for r in range(R):
                    has = jnp.any(rem, axis=1, keepdims=True)
                    ok = has & (base < n_free)
                    sel = rem & (lane == jnp.argmax(rem, axis=1)[:, None])
                    win = sel & ok
                    tgt = (~occ) & (fr == base + 1) & ok
                    src_win = _roll_grid(win, -dx, -dy, ncside,
                                         nrows) & going
                    wins_src.append(src_win)
                    tgts.append(tgt)
                    rolls.append((dx, dy))
                    departed = departed | src_win
                    tgt_any = tgt_any | tgt
                    base = base + ok.astype(jnp.int32)
                    rem = rem & ~sel
                continue
            arank = jnp.cumsum(arr.astype(jnp.int32), axis=1)  # 1-based
            cnt = arank[:, -1:]
            for r in range(R):
                ok = (cnt > r) & (base < n_free)
                # The (r+1)-th pending arrival (source-slot order)...
                win = arr & (arank == r + 1) & ok
                # ...lands in the row's next packed free slot.
                tgt = (~occ) & (fr == base + 1) & ok
                src_win = _roll_grid(win, -dx, -dy, ncside, nrows) & going
                wins_src.append(src_win)
                tgts.append(tgt)
                rolls.append((dx, dy))
                departed = departed | src_win
                tgt_any = tgt_any | tgt
                base = base + ok.astype(jnp.int32)
        occ = occ | tgt_any

        # Phase 2 — data: one write per field.
        def place(field, is_int=False):
            z = jnp.zeros((), field.dtype)
            ins = None
            for (dx, dy), src_win, tgt in zip(rolls, wins_src, tgts):
                if is_int:
                    w = jnp.sum(jnp.where(src_win, field, 0), axis=1,
                                keepdims=True, dtype=field.dtype)
                else:
                    w = jnp.sum(jnp.where(src_win, field, z), axis=1,
                                keepdims=True)
                w_dst = _roll_grid(w, dx, dy, ncside, nrows)  # (ncells, 1) column
                term = jnp.where(tgt, w_dst, z)
                ins = term if ins is None else ins + term
            return jnp.where(tgt_any, ins, field)

        def place_stacked():
            # One masked-sum/roll/select chain moves all five f32 fields
            # per term (leading stack axis) instead of five chains.
            F = jnp.stack([getattr(st, f) for f in FIELDS])  # (5,ncells,K)
            z = jnp.zeros((), F.dtype)
            ins = None
            for (dx, dy), src_win, tgt in zip(rolls, wins_src, tgts):
                w = jnp.sum(jnp.where(src_win[None], F, z), axis=2,
                            keepdims=True)                    # (5,ncells,1)
                g = w.reshape(len(FIELDS), nrows or ncside, ncside, 1)
                w_dst = jnp.roll(g, (dy, dx), axis=(1, 2)).reshape(w.shape)
                term = jnp.where(tgt[None], w_dst, z)
                ins = term if ins is None else ins + term
            out = jnp.where(tgt_any[None], ins, F)
            return {f: out[i] for i, f in enumerate(FIELDS)}

        new_fields = (place_stacked() if STACKF else
                      {f: place(getattr(st, f)) for f in FIELDS})
        st = st._replace(
            occ=occ & ~departed,
            pid=place(st.pid, is_int=True),
            **new_fields)
        st = st._replace(m=jnp.where(st.occ, st.m,
                                     jnp.asarray(0.0, st.m.dtype)))
        still, _, _ = mover_info(st)
        left = jnp.sum(still, dtype=jnp.int32)
        return st, left

    moving0, _, _ = mover_info(ts)
    left0 = jnp.sum(moving0, dtype=jnp.int32)

    def cond(carry):
        _, left, rounds = carry
        return (left > 0) & (rounds < MAX_ROUNDS)

    # Straggler fallback: after this many one-hop rounds, pending movers
    # are walkers (multi-cell hops — e.g. a limbo particle re-entering the
    # domain far from its parked row), and each further round re-runs the
    # whole grid to move them one cell. One compact pass delivers ANY
    # distance directly; gating it on a round threshold keeps it out of
    # typical steps entirely (they finish in <= ~4 rounds), so the cost
    # of compact-always (5x on the first target) is never paid on the
    # fast path.
    STRAGGLER = int(os.environ.get("PSIM_REBIN_STRAGGLER_ROUNDS", "8"))

    if compact_ok:
        def body(carry):
            st, left, rounds = carry
            st, left = jax.lax.cond(left <= MCAP, compact_pass, one_round,
                                    st)
            return st, left, rounds + 1
    elif dest_fn is not None:
        def body(carry):
            st, left, rounds = carry
            st, left = jax.lax.cond(
                (rounds >= STRAGGLER) & (left <= MCAP),
                compact_pass, one_round, st)
            return st, left, rounds + 1
    else:
        def body(carry):
            st, _, rounds = carry
            st, left = one_round(st)
            return st, left, rounds + 1

    # Static-prefix delivery (PSIM_REBIN_STATIC_ROUNDS=K): run up to K
    # rounds as *statically unrolled* lax.conds before (or instead of)
    # the dynamic while_loop. On the first target, at N=1e7, the mere
    # presence of the dynamic while_loop in the step graph made the whole
    # program much slower even though the loop ran ~1 round/step; the
    # static prefix lets typical steps avoid dynamic trips entirely. With
    # PSIM_REBIN_NO_TAIL=1 the while_loop is dropped from the graph altogether and undelivered movers after K
    # rounds surface through the overflow counter (lossless retry).
    K_STATIC = int(os.environ.get("PSIM_REBIN_STATIC_ROUNDS", "0"))
    NO_TAIL = os.environ.get("PSIM_REBIN_NO_TAIL", "0") == "1"
    st, left, rounds = ts, left0, jnp.int32(0)
    if K_STATIC > 0:
        def skip(carry):
            return carry

        for _ in range(K_STATIC):
            st, left, rounds = jax.lax.cond(
                left > 0, lambda c: body(c), skip, (st, left, rounds))
    if not (K_STATIC > 0 and NO_TAIL):
        st, left, rounds = jax.lax.while_loop(cond, body, (st, left, rounds))
    if return_rounds:
        return st, left, rounds
    return st, left


def binned_mask(ts: TileState, side: float, ncside: int):
    """Occupied slots whose position is in range (the reference PANIC2 skip
    leaves out-of-range particles unbinned but integrating; here they stay
    in their last row, masked out of COM/forces/collisions)."""
    cx, cy, valid = cell_of(ts.x, ts.y, side, ncside)
    return ts.occ & valid, jnp.sum(ts.occ & ~valid, dtype=jnp.int32)
