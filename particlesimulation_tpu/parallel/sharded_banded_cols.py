"""Column-sharded banded engine: clustered loads on a 1D ring mesh.

The block-cyclic sharded banded engine (parallel/sharded_banded.py)
composes poorly across shards: giving every shard 1/D of every band's
rows makes every chunk boundary a ring boundary, so each shard pays 2 halo rows per band
(80 halo vs 100 owned rows at D=8 x 5 bands) and every row-direction
hop is a ppermute round. This engine is the structural fix, found by
transposing the decomposition: **shard the mesh axis along grid COLUMNS
and keep the row-band K structure of the single-chip banded engine
(ops/banded.py) intact**. Every shard owns a contiguous column range of
EVERY row band.

Why this composes where block-cyclic didn't:

* **the band plan is the unquantized single-chip plan** (ops/banded
  .plan_bands) — per-cell pair cost is K_band(row)^2 regardless of
  column, so every column has IDENTICAL static work and balanced-uneven
  column splitting is perfectly load-balanced by construction (no
  census-weighted boundaries, no shard-divisible band quantization);
* **static shapes agree across shards with zero padding** — each shard
  holds the same (rows_b + 2, cols_local + 2, K_b) tile per band;
* **each shard pays 2 halo COLUMNS total** (left/right), not 2 halo
  rows per band: halo inflation is 2/(ncside/D) of the slot count and,
  because the fused pair pass slices halo cells out before dispatch,
  ~0 of the pair lanes;
* **cross-band (row-direction) migration is intra-shard** — the band
  ring of ops/banded.py runs locally inside each shard (band b's halo
  rows merge into bands b∓1 directly); only column-direction movers
  ride the ppermute ring, and the common case is one hop, exactly like
  the resident row engine. The block-cyclic variant's edge-shard band
  shift has no analog here.

This is the analog of the reference MPI code's ghost exchange and
migration (mpi/parsim-mpi.cpp:670-815,512-600) rotated 90 degrees — a
decomposition its row-major 1D design cannot express.

Capacity overflow anywhere (tile occupancy, halo-lane budget, merge
free slots, ship-round cap) raises the replicated ``overflow`` counter
and the engine retries losslessly with a grown plan; the reference
PANIC-skips in the analogous situation (serial/parsim.cpp:276-280).

The f64 sweep impl remains the bitwise-parity claim; this is the
clustered throughput path (f32, order-free reductions): collision
counts and dead sets match the single-chip banded engine exactly on the
test configs, trajectories statistically.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from particlesimulation_tpu.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu.ops import binning, integrate
from particlesimulation_tpu.ops import dense_xla as dmod
from particlesimulation_tpu.ops import resident as res
from particlesimulation_tpu.ops.banded import HALO_W
from particlesimulation_tpu.ops.stencil import STENCIL
from particlesimulation_tpu.parallel.sharded import (
    AXIS, CAP_OVF, STRAY_OVF, _ring_perm)
from particlesimulation_tpu.state import ShardedState

INF = jnp.int32(0x7FFFFFFF)
_FIELDS = ("x", "y", "vx", "vy", "m")
_ALL = _FIELDS + ("occ", "pid")
SHIP_SLACK = 4


def col_owner(ncside: int, n_shards: int, cols):
    """Owning shard per global grid column (balanced-uneven split).

    Host-side (numpy). The transpose of the reference's
    ``cell_y / rows_per_proc`` ownership rule (mpi/parsim-mpi.cpp:
    396-403).
    """
    import numpy as np
    cols = np.asarray(cols)
    base, rem = ncside // n_shards, ncside % n_shards
    split = rem * (base + 1)
    return np.where(cols < split, cols // (base + 1),
                    rem + (cols - split) // max(1, base))


def stencil_tables_halo_cols(Mp, MXp, MYp, side: float, ncside: int,
                             cols_local: int, col0, cnt):
    """Monopole stencil tables for a column-halo-padded local COM grid.

    Mp/MXp/MYp: (ncside, cols_local + 2); col 0 is global column col0-1
    (wrapped), col j+1 is owned column col0+j, and the caller placed the
    right halo (global column col0+cnt, wrapped) at traced position
    cnt+1. Rows wrap locally (every shard owns all grid rows). Mirror
    offsets are applied by the *consumer* from global coordinates, so
    halo payloads are raw COM data (reference mpi/parsim-mpi.cpp:874-935
    semantics). Columns beyond cnt are consumed only by unreal cells.

    Returns (ml, mxl, myl): each (8, ncside * cols_local), row-major
    over (row, owned column).
    """
    dt = MXp.dtype
    nc = ncside
    side_a = jnp.asarray(side, dt)
    cy = jnp.arange(nc, dtype=jnp.int32)[:, None]
    gx = col0 + jnp.arange(cols_local, dtype=jnp.int32)[None, :]

    ml, mxl, myl = [], [], []
    for dx, dy in STENCIL:
        # Neighbor (cy+dy, gx+dx): static column slice through the halo
        # padding, then a local periodic row roll.
        cols = Mp[:, 1 + dx:1 + dx + cols_local]
        colsx = MXp[:, 1 + dx:1 + dx + cols_local]
        colsy = MYp[:, 1 + dx:1 + dx + cols_local]
        rm = jnp.roll(cols, -dy, axis=0)
        rmx = jnp.roll(colsx, -dy, axis=0)
        rmy = jnp.roll(colsy, -dy, axis=0)
        # Mirror in x only where the *global* neighbor column wraps.
        if dx == 1:
            offx = jnp.where(gx == nc - 1, side_a, jnp.asarray(0.0, dt))
        elif dx == -1:
            offx = jnp.where(gx == 0, -side_a, jnp.asarray(0.0, dt))
        else:
            offx = jnp.zeros((1, 1), dt)
        if dy == 1:
            offy = jnp.where(cy == nc - 1, side_a, jnp.asarray(0.0, dt))
        elif dy == -1:
            offy = jnp.where(cy == 0, -side_a, jnp.asarray(0.0, dt))
        else:
            offy = jnp.zeros((1, 1), dt)
        ml.append(jnp.broadcast_to(rm, (nc, cols_local)).reshape(-1))
        mxl.append((offx + rmx).reshape(-1))
        myl.append((offy + rmy).reshape(-1))
    return jnp.stack(ml), jnp.stack(mxl), jnp.stack(myl)


def make_sharded_banded_cols_run(config: SimConfig, mesh, plan, cap: int):
    """Build ``run(slab_state, n_steps) -> slab_state`` (shard_map + jit).

    ``plan``: [(row0, rows, kcap), ...] contiguous over the grid rows —
    the single-chip plan (ops/banded.plan_bands), unquantized.
    """
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    d = config.n_shards
    bands = [(int(r0), int(rw), int(k)) for r0, rw, k in plan]
    B = len(bands)
    assert bands[0][0] == 0 and sum(b[1] for b in bands) == nc
    for (r0, rw, _), (r0n, _, _) in zip(bands, bands[1:]):
        assert r0 + rw == r0n
    assert d <= nc, "column decomposition needs n_shards <= ncside"
    fused_fn = dmod.resolve_pair_impl(side=config.side)
    halo_w = int(os.environ.get("PSIM_BAND_HALO_W", str(HALO_W)))

    # Column geometry: shard s owns global columns [C0(s), C0(s)+CNT(s)),
    # balanced-uneven; tile width is static (CMAXC owned + 2 halo cols).
    BASE, REM = nc // d, nc % d
    CMAXC = BASE + (1 if REM else 0)
    WIDE = CMAXC + 2
    KS = [k for _, _, k in bands]
    NROWS = [rw + 2 for _, rw, _ in bands]           # + 2 band halo rows
    NCT = [nr * WIDE for nr in NROWS]
    LROW = [jnp.arange(nct, dtype=jnp.int32)[:, None] // WIDE
            for nct in NCT]
    LCOL = [jnp.arange(nct, dtype=jnp.int32)[:, None] % WIDE
            for nct in NCT]
    W = min(halo_w, max(KS))
    HSTACK = sum(NROWS)  # stacked column-halo height (nc + 2B)

    def grid3(a, b):
        return a.reshape(NROWS[b], WIDE, KS[b])

    def local_run(slab: ShardedState, n_steps):
        me = jax.lax.axis_index(AXIS)
        C0 = (me * BASE + jnp.minimum(me, REM)).astype(jnp.int32)
        CNT = (BASE + (me < REM)).astype(jnp.int32)
        OWNED = [((LROW[b] >= 1) & (LROW[b] <= bands[b][1])
                  & (LCOL[b] >= 1) & (LCOL[b] <= CNT)) for b in range(B)]

        # ---- prologue: sorted slab -> per-band column tiles -----------
        def prologue(st: ShardedState):
            key, valid = binning.cell_keys(st.x, st.y, side, nc)
            gy = key // nc
            gx = key - gy * nc
            mine = valid & (gx >= C0) & (gx < C0 + CNT)
            bl = []
            ovf = jnp.int32(0)
            for b in range(B):
                r0, rw, k = bands[b]
                ok = st.valid & mine & (gy >= r0) & (gy < r0 + rw)
                tkey = jnp.where(ok, (gy - r0 + 1) * WIDE + (gx - C0 + 1),
                                 jnp.int32(NCT[b]))
                pos, _ = binning.segment_positions(tkey)
                kmax = binning.max_occupancy(pos, tkey < NCT[b])
                ovf = jnp.maximum(ovf, jnp.where(kmax > k, kmax, 0))
                fits = pos < k
                idx = jnp.where(ok & fits, tkey * k + pos,
                                jnp.int32(NCT[b] * k))
                if b == 0:
                    # Limbo (PANIC2 out-of-range) parks in my band-0 tile
                    # at cell (row 1, col 1), tail slots downward (see
                    # ops/banded.py prologue).
                    limbo = st.valid & ~valid
                    lpos, _ = binning.segment_positions(
                        jnp.where(limbo, jnp.int32(0), jnp.int32(1)))
                    park = jnp.int32(WIDE + 1) * k
                    idx = jnp.where(limbo & (lpos < k),
                                    park + (jnp.int32(k - 1) - lpos), idx)
                    occ0 = jnp.sum(ok & (tkey == WIDE + 1),
                                   dtype=jnp.int32)
                    nlimbo = jnp.sum(limbo, dtype=jnp.int32)
                    ovf = jnp.maximum(
                        ovf, jnp.where(occ0 + nlimbo > k,
                                       occ0 + nlimbo, 0))

                def scat(a, fill=0):
                    flat = jnp.full(NCT[b] * k, fill, a.dtype)
                    return flat.at[idx].set(a, mode="drop").reshape(
                        NCT[b], k)

                z = jnp.zeros((), jnp.int32)
                bl.append(res.TileState(
                    x=scat(st.x), y=scat(st.y), vx=scat(st.vx),
                    vy=scat(st.vy), m=scat(st.m),
                    occ=scat(st.valid & fits, fill=False),
                    pid=scat(st.pid),
                    collisions=z, panics=z, overflow=z))
            stray = jnp.sum(st.valid & valid & ~mine, dtype=jnp.int32)
            ovf = jnp.maximum(ovf, jnp.where(stray > 0, STRAY_OVF, 0))
            return tuple(bl), jax.lax.pmax(ovf, AXIS)

        # ---- physics masks -------------------------------------------
        def physics_mass(ts: res.TileState, b):
            _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
            binned = ts.occ & valid & OWNED[b]
            limbo = jnp.sum(ts.occ & ~valid, dtype=jnp.int32)
            return jnp.where(binned, ts.m, jnp.float32(0.0)), binned, limbo

        # ---- COM + stencil: one local grid, column ring halo ----------
        def com_tables(bl, mfs):
            Ms, SXs, SYs = [], [], []
            for b in range(B):
                rw = bands[b][1]

                def red(v):
                    g = jnp.sum(v, axis=1).reshape(NROWS[b], WIDE)
                    return g[1:rw + 1, 1:1 + CMAXC]

                Ms.append(red(mfs[b]))
                SXs.append(red(mfs[b] * bl[b].x))
                SYs.append(red(mfs[b] * bl[b].y))
            M = jnp.concatenate(Ms, axis=0)     # (nc, CMAXC)
            SX = jnp.concatenate(SXs, axis=0)
            SY = jnp.concatenate(SYs, axis=0)
            safe = jnp.where(M > 0, M, jnp.float32(1.0))
            MX = jnp.where(M > 0, SX / safe, jnp.float32(0.0))
            MY = jnp.where(M > 0, SY / safe, jnp.float32(0.0))

            def last_col(A):
                return jax.lax.dynamic_slice_in_dim(A, CNT - 1, 1,
                                                    axis=1)[:, 0]

            firsts = tuple(A[:, 0] for A in (M, MX, MY))
            lasts = tuple(last_col(A) for A in (M, MX, MY))
            if d > 1:
                # Shard s's left halo is shard s-1's last owned column;
                # its right halo is shard s+1's first owned column. The
                # ring closes periodically = the global x wrap.
                lh = jax.lax.ppermute(lasts, AXIS, _ring_perm(d, 1))
                rh = jax.lax.ppermute(firsts, AXIS, _ring_perm(d, -1))
            else:
                lh, rh = lasts, firsts

            zcol = jnp.zeros((nc, 1), jnp.float32)

            def padded(A, hl, hr):
                Ap = jnp.concatenate([hl[:, None], A, zcol], axis=1)
                return jax.lax.dynamic_update_slice_in_dim(
                    Ap, hr[:, None], CNT + 1, axis=1)

            ml, mxl, myl = stencil_tables_halo_cols(
                padded(M, lh[0], rh[0]), padded(MX, lh[1], rh[1]),
                padded(MY, lh[2], rh[2]), side, nc, CMAXC, C0, CNT)
            out = []
            for b in range(B):
                r0, rw, _ = bands[b]
                sl = slice(r0 * CMAXC, (r0 + rw) * CMAXC)
                out.append(tuple(
                    jnp.pad(t[:, sl].T.reshape(rw, CMAXC, 8),
                            ((1, 1), (1, 1), (0, 0))).reshape(NCT[b], 8)
                    for t in (ml, mxl, myl)))
            return out

        # ---- migration routing (column-first clamping) ----------------
        def route_for(b):
            r0, rw, _ = bands[b]
            nrt = NROWS[b]
            lrow_of, lcol_of = LROW[b], LCOL[b]

            def _route(st: res.TileState):
                cxg, cyg, valid = res.cell_of(st.x, st.y, side, nc)
                gy_row = r0 + lrow_of - 1
                gx_col = C0 + lcol_of - 1
                dlr = lrow_of + res._wrap_delta(cyg - gy_row, nc)
                dlc = lcol_of + res._wrap_delta(cxg - gx_col, nc)
                dest_lr = jnp.where(
                    dlr < 1, 0,
                    jnp.where(dlr > rw, jnp.int32(nrt - 1), dlr))
                dest_lc = jnp.where(
                    dlc < 1, 0, jnp.where(dlc > CNT, CNT + 1, dlc))
                # Column-first: a shard-crossing mover parks in the halo
                # COLUMN at a real band row (corner halo cells stay empty
                # by construction); the receiving shard's rebin finishes
                # the row leg.
                col_halo = (dest_lc == 0) | (dest_lc == CNT + 1)
                dest_lr = jnp.where(col_halo, jnp.clip(dest_lr, 1, rw),
                                    dest_lr)
                movable = OWNED[b]
                moving = (st.occ & valid & movable
                          & ((dest_lr != lrow_of) | (dest_lc != lcol_of)))
                return moving, dest_lr, dest_lc

            def mover_fn(st):
                moving, dest_lr, dest_lc = _route(st)
                sy = jnp.sign(dest_lr - lrow_of)
                sx = jnp.sign(dest_lc - lcol_of)
                return moving, sx, sy

            def dest_fn(st):
                moving, dest_lr, dest_lc = _route(st)
                return moving, dest_lr * WIDE + dest_lc

            return mover_fn, dest_fn

        ROUTE = [route_for(b) for b in range(B)]

        def rebin_all(bl):
            out, ovf = [], jnp.int32(0)
            for b in range(B):
                mover_fn, dest_fn = ROUTE[b]
                ts, und = res.rebin(bl[b], side, WIDE, KS[b],
                                    mover_fn=mover_fn, nrows=NROWS[b],
                                    dest_fn=dest_fn)
                out.append(ts)
                ovf = ovf + und
            return tuple(out), ovf

        # ---- halo extraction / merging --------------------------------
        def extract_row(ts, r: int, b):
            return {f: grid3(getattr(ts, f), b)[r] for f in _ALL}

        def extract_col(ts, c, b):
            return {f: jax.lax.dynamic_slice_in_dim(
                        grid3(getattr(ts, f), b), c, 1, axis=1)[:, 0]
                    for f in _ALL}

        def take_w(row):
            """Packed-prefix halo slice cut to the uniform W lanes;
            occupants beyond the lane budget are dropped from this
            attempt and flagged (lossless retry with a grown plan)."""
            if row["occ"].shape[1] <= W:
                pad = W - row["occ"].shape[1]
                if pad == 0:
                    return row, jnp.int32(0)

                def padf(v):
                    return jnp.concatenate(
                        [v, jnp.zeros((v.shape[0], pad), v.dtype)],
                        axis=1)

                return {f: padf(v) for f, v in row.items()}, jnp.int32(0)
            dropped = jnp.sum(row["occ"][:, W:], dtype=jnp.int32)
            return {f: v[:, :W] for f, v in row.items()}, dropped

        def _merge(row, arr):
            """Rank-match arriving (n, W) particles into (n, K) free
            slots (cross-K one-hot placement). Returns (new row, ovf)."""
            free = ~row["occ"]
            frank = jnp.cumsum(free.astype(jnp.int32), axis=1)
            nfree = frank[:, -1:]
            aocc = arr["occ"]
            arank = jnp.cumsum(aocc.astype(jnp.int32), axis=1)
            deliv = aocc & (arank <= nfree)
            ovf = (jnp.sum(aocc, dtype=jnp.int32)
                   - jnp.sum(deliv, dtype=jnp.int32))
            match = (free[:, :, None]
                     & (frank[:, :, None] == arank[:, None, :])
                     & deliv[:, None, :])
            placed = jnp.any(match, axis=2)

            def put(fld, afld):
                w = jnp.sum(jnp.where(match, afld[:, None, :],
                                      jnp.zeros((), afld.dtype)),
                            axis=2, dtype=afld.dtype)
                return jnp.where(placed, w, fld)

            new = {f: put(row[f], arr[f]) for f in _FIELDS + ("pid",)}
            new["occ"] = row["occ"] | placed
            return new, ovf

        def merge_into_row(ts, arr, r: int, b):
            new, ovf = _merge(extract_row(ts, r, b), arr)
            upd = {f: grid3(getattr(ts, f), b).at[r].set(new[f])
                   .reshape(NCT[b], KS[b]) for f in _ALL}
            return ts._replace(**upd), ovf

        def merge_into_col(ts, arr, c, b):
            new, ovf = _merge(extract_col(ts, c, b), arr)
            upd = {}
            for f in _ALL:
                g = jax.lax.dynamic_update_slice_in_dim(
                    grid3(getattr(ts, f), b), new[f][:, None, :], c,
                    axis=1)
                upd[f] = g.reshape(NCT[b], KS[b])
            return ts._replace(**upd), ovf

        def clear_halo_rows(ts, b):
            halo = (LROW[b] == 0) | (LROW[b] == NROWS[b] - 1)
            occ = ts.occ & ~halo
            return ts._replace(occ=occ,
                               m=jnp.where(occ, ts.m, jnp.float32(0.0)))

        def clear_halo_cols(ts, b):
            # Halo columns only — unreal columns (CNT < lcol <= CMAXC)
            # are empty by construction, but clearing them here would
            # turn a latent routing bug into silent particle loss.
            halo = (LCOL[b] == 0) | (LCOL[b] == CNT + 1)
            occ = ts.occ & ~halo
            return ts._replace(occ=occ,
                               m=jnp.where(occ, ts.m, jnp.float32(0.0)))

        def halo_pending(bl):
            local = sum(jnp.sum(bl[b].occ & ~OWNED[b], dtype=jnp.int32)
                        for b in range(B))
            return jax.lax.psum(local, AXIS)

        def ship_and_deliver(bl):
            bl, ovf0 = rebin_all(bl)
            pending = halo_pending(bl)
            max_rounds = B + d + SHIP_SLACK

            def cond(c):
                _, pending, rounds, _ = c
                return (pending > 0) & (rounds < max_rounds)

            def body(c):
                bl, _, rounds, ovf = c
                bl = list(bl)
                # Phase A — band ring (row direction), fully local:
                # band b's top halo row (global row r0-1) merges into
                # band b-1's last real row; its bottom halo into band
                # b+1's first real row. The ring closes periodically
                # (the global y wrap), as in ops/banded.py.
                tops, bots = [], []
                for b in range(B):
                    t, d1 = take_w(extract_row(bl[b], 0, b))
                    bo, d2 = take_w(extract_row(bl[b], NROWS[b] - 1, b))
                    tops.append(t)
                    bots.append(bo)
                    ovf = ovf + d1 + d2
                bl = [clear_halo_rows(bl[b], b) for b in range(B)]
                for b in range(B):
                    up = (b - 1) % B
                    dn = (b + 1) % B
                    bl[up], o1 = merge_into_row(bl[up], tops[b],
                                                NROWS[up] - 2, up)
                    bl[dn], o2 = merge_into_row(bl[dn], bots[b], 1, dn)
                    ovf = ovf + o1 + o2
                # Phase B — column ring (x direction), one ppermute per
                # direction on band-stacked buffers.
                lefts, rights = [], []
                for b in range(B):
                    le, d1 = take_w(extract_col(bl[b], jnp.int32(0), b))
                    ri, d2 = take_w(extract_col(bl[b], CNT + 1, b))
                    lefts.append(le)
                    rights.append(ri)
                    ovf = ovf + d1 + d2
                bl = [clear_halo_cols(bl[b], b) for b in range(B)]
                left_s = {f: jnp.concatenate([le[f] for le in lefts])
                          for f in _ALL}
                right_s = {f: jnp.concatenate([ri[f] for ri in rights])
                           for f in _ALL}
                if d > 1:
                    # My rights land on shard me+1 (its first owned col);
                    # my lefts on shard me-1 (its last owned col).
                    from_left = jax.lax.ppermute(right_s, AXIS,
                                                 _ring_perm(d, 1))
                    from_right = jax.lax.ppermute(left_s, AXIS,
                                                  _ring_perm(d, -1))
                else:
                    from_left, from_right = right_s, left_s
                off = 0
                for b in range(B):
                    arr_l = {f: v[off:off + NROWS[b]]
                             for f, v in from_left.items()}
                    arr_r = {f: v[off:off + NROWS[b]]
                             for f, v in from_right.items()}
                    off += NROWS[b]
                    bl[b], o1 = merge_into_col(bl[b], arr_l,
                                               jnp.int32(1), b)
                    bl[b], o2 = merge_into_col(bl[b], arr_r, CNT, b)
                    ovf = ovf + o1 + o2
                bl, und = rebin_all(tuple(bl))
                return bl, halo_pending(bl), rounds + 1, ovf + und

            bl, pending, _, ovf = jax.lax.while_loop(
                cond, body, (bl, pending, jnp.int32(0), ovf0))
            ovf = ovf + pending  # ship-round cap exceeded
            return bl, jax.lax.psum(ovf, AXIS)

        # ---- pair pass: halo cells sliced out before dispatch ----------
        def pair_pass(ts, b, collide: bool):
            rw, k = bands[b][1], KS[b]
            mf, binned, _ = physics_mass(ts, b)
            ad = (binned & (ts.m > 0)).astype(jnp.int32)

            def inner(a):
                return (a.reshape(NROWS[b], WIDE, k)
                        [1:rw + 1, 1:1 + CMAXC].reshape(rw * CMAXC, k))

            fxd, fyd, count, ftd = fused_fn(
                inner(ts.x), inner(ts.y), inner(mf), inner(ad),
                rw * CMAXC, k, EPSILON, collide=collide,
                pid=inner(ts.pid))

            def embed(a, fill):
                g = a.reshape(rw, CMAXC, k)
                return jnp.pad(g, ((1, 1), (1, 1), (0, 0)),
                               constant_values=fill).reshape(NCT[b], k)

            return (embed(fxd, 0.0), embed(fyd, 0.0), count,
                    embed(ftd != INF, False))

        # Debug-only phase ablation for composition cost attribution
        # (PSIM_ABLATE=rebin|pairs|mono skips that phase; results are
        # wrong) — same contract as ops/banded.py, so single-chip and
        # sharded legs of a composition A/B can ablate symmetrically.
        ablate = os.environ.get("PSIM_ABLATE", "")

        # ---- one step --------------------------------------------------
        def step(carry):
            bl, fxs, fys, coll, panics, ovf = carry
            bl = list(bl)
            mfs, limbo = [], jnp.int32(0)
            for b in range(B):
                mf, _, lb = physics_mass(bl[b], b)
                mfs.append(mf)
                limbo = limbo + lb
            tables = com_tables(bl, mfs)
            for b in range(B):
                if ablate == "mono":
                    fx_tot, fy_tot = fxs[b], fys[b]
                else:
                    ml_t, mxl_t, myl_t = tables[b]
                    fxm, fym = dmod.monopole_tile_forces(
                        bl[b].x, bl[b].y, mfs[b], ml_t, mxl_t, myl_t)
                    fx_tot, fy_tot = fxs[b] + fxm, fys[b] + fym
                x, y, vx, vy = integrate.integrate(
                    bl[b].x, bl[b].y, bl[b].vx, bl[b].vy, bl[b].m,
                    fx_tot, fy_tot, side, DELTAT)
                bl[b] = bl[b]._replace(x=x, y=y, vx=vx, vy=vy)

            if ablate == "rebin":
                mig_ovf = jnp.int32(0)
            else:
                bl, mig_ovf = ship_and_deliver(tuple(bl))
            bl = list(bl)

            fxs2, fys2 = [], []
            count = jnp.int32(0)
            for b in range(B):
                if ablate == "pairs":
                    fxd = jnp.zeros_like(bl[b].x)
                    fyd, cnt = fxd, jnp.int32(0)
                    died = jnp.zeros(bl[b].occ.shape, bool)
                else:
                    fxd, fyd, cnt, died = pair_pass(bl[b], b,
                                                    collide=True)
                bl[b] = bl[b]._replace(
                    m=jnp.where(died, jnp.float32(0.0), bl[b].m))
                fxs2.append(fxd)
                fys2.append(fyd)
                count = count + cnt

            coll = coll + jax.lax.psum(count, AXIS)
            panics = panics + jax.lax.psum(limbo, AXIS)
            ovf = jnp.maximum(ovf, mig_ovf)
            return (tuple(bl), tuple(fxs2), tuple(fys2), coll, panics,
                    ovf)

        # ---- epilogue: column tiles -> sorted slab ----------------------
        def epilogue(bl, coll, panics, ovf,
                     st: ShardedState) -> ShardedState:
            flats = {f: [] for f in _ALL}
            for b in range(B):
                rw = bands[b][1]
                for f in _ALL:
                    g = grid3(getattr(bl[b], f), b)[1:rw + 1, 1:1 + CMAXC]
                    flats[f].append(g.reshape(-1))
            cat = {f: jnp.concatenate(v) for f, v in flats.items()}
            nslots = cat["occ"].shape[0]
            pad = max(0, cap - nslots)
            if pad:
                for f in cat:
                    fill = (jnp.zeros(pad, cat[f].dtype) if f != "pid"
                            else jnp.full(pad, -1, jnp.int32))
                    cat[f] = jnp.concatenate([cat[f], fill])
            order = jnp.argsort(~cat["occ"], stable=True)[:cap]
            valid = cat["occ"][order]
            n_occ = jnp.sum(cat["occ"], dtype=jnp.int32)
            covf = jnp.where(n_occ > cap, CAP_OVF + (n_occ - cap), 0)

            def take(f, fill=0):
                return jnp.where(valid, cat[f][order],
                                 jnp.asarray(fill, cat[f].dtype))

            x, y, m = take("x"), take("y"), take("m")
            pid = take("pid", fill=jnp.iinfo(jnp.int32).max)
            key, _ = binning.cell_keys(x, y, side, nc)
            key = jnp.where(valid, key, jnp.int32(ncells + 1))
            key, pid, x, y, vx, vy, m, alive, valid = binning.sort_by_cell(
                key, pid, x, y, take("vx"), take("vy"), m,
                valid & (m > 0), valid)
            covf = jax.lax.pmax(covf, AXIS)
            return ShardedState(
                x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, valid=valid,
                pid=pid,
                collisions=st.collisions + coll.astype(
                    st.collisions.dtype),
                panics=st.panics + panics,
                overflow=jnp.maximum(jnp.maximum(st.overflow, ovf), covf))

        bl, ovf0 = prologue(slab)
        fxs, fys = [], []
        for b in range(B):
            fxd, fyd, _, _ = pair_pass(bl[b], b, collide=False)
            fxs.append(fxd)
            fys.append(fyd)
        z = jnp.zeros((), slab.collisions.dtype)
        zi = jnp.zeros((), jnp.int32)
        carry = (bl, tuple(fxs), tuple(fys), z, zi, ovf0)
        carry = jax.lax.fori_loop(0, n_steps, lambda i, c: step(c), carry)
        bl, _, _, coll, panics, ovf = carry
        return epilogue(bl, coll, panics, ovf, slab)

    spec_arr = P(AXIS)
    specs = ShardedState(
        x=spec_arr, y=spec_arr, vx=spec_arr, vy=spec_arr, m=spec_arr,
        alive=spec_arr, valid=spec_arr, pid=spec_arr,
        collisions=P(), panics=P(), overflow=P())
    fn = jax.shard_map(local_run, mesh=mesh, in_specs=(specs, P()),
                       out_specs=specs, check_vma=False)
    return jax.jit(fn)
