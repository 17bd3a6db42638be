"""2D-sharded slot-resident fast engine: rectangle tiles + two-axis halos.

The rectangle decomposition (parallel/sharded2d.py) on its own runs the
sweep formulation only; the fast resident-tile engine otherwise shards
over a 1D ring but not over the (rows × cols) mesh, whose halos carry a
rectangle's perimeter instead of whole rows. This module is the
composition: each shard's state lives in
``(local_cells, K)`` slot tiles covering its cell *rectangle* plus a
one-cell halo ring, and one ``shard_map``-wrapped program per step does

* local COM from the tiles (row reductions) and the classic two-phase COM
  halo (rows axis, then cols over the row-padded grid so corners ride
  along — parallel/sharded2d.two_phase_com_halo; the torus form of the
  reference's ghost-cell Isend/Irecv, mpi/parsim-mpi.cpp:670-815);
* the same fused pairwise+monopole force and collision kernels as the
  single-chip resident engine (ops/dense_xla.py) over the local tiles;
* migration by tile rebinning with *dimension-ordered* routing (rows
  first, then cols — standard 2D-torus routing): a cell-crosser whose
  destination row block differs lands in the top/bottom halo row (keeping
  its current column); one whose row block matches but column block
  differs lands in the left/right halo column; whole halo rows/columns
  ship to ring neighbors via ``ppermute`` (the reference's Alltoall +
  point-to-point exchange, mpi/parsim-mpi.cpp:512-600). Shipping repeats
  (a psum-gated ``while_loop``) until no shard holds halo occupants, so
  the common case pays one rows-axis hop and/or one cols-axis hop.

Local tile grid layout (static (rows_max + 2) × (cols_max + 2) cells):

    local row 0 / col 0           = top / left halo (to shard r-1 / c-1)
    rows 1..rows_mine × cols 1..cols_mine = owned rectangle
    rows/cols beyond the owned extent     = transit (uneven decomposition
                                            only; empty between deliveries)
    local row rows_max+1 / col cols_max+1 = bottom / right halo

Corner halo cells stay empty by construction: a row-exiting mover keeps
its (owned) current column, and only movers whose row block already
matches enter a halo column — so halo rows/columns ship without corner
cases and all arrivals land in owned cells.

Capacity overflow anywhere (tile occupancy, merge free-slot exhaustion,
undelivered movers, ship-round cap) raises the replicated ``overflow``
counter and the engine retries the run losslessly with larger tiles — the
reference PANIC-skips particles in its analogous situation
(serial/parsim.cpp:276-280); here no particle is ever dropped.

As with the 1D resident path, the f64 sweep (same module's sweep impl)
carries the bitwise-parity claim; this is the throughput path (f32,
order-free reductions): cells receiving cross-shard immigrants may fill
slots in a different order than the single-chip engine, so trajectories
agree statistically and collision counts/dead sets exactly on the test
configs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from particlesimulation_tpu.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu.ops import binning, integrate
from particlesimulation_tpu.ops import dense_xla as dmod
from particlesimulation_tpu.ops import resident as res
from particlesimulation_tpu.parallel.sharded import CAP_OVF, STRAY_OVF
from particlesimulation_tpu.parallel.sharded2d import (
    AXIS_C, AXIS_R, BOTH, AxisDecomp, _ring_perm, stencil_tables_halo2d,
    two_phase_com_halo)
from particlesimulation_tpu.state import ShardedState

INF = jnp.int32(0x7FFFFFFF)
_FIELDS = ("x", "y", "vx", "vy", "m")
# Ship rounds beyond the (d_r + d_c)-hop worst case before flagging
# overflow (same rationale as the 1D engine's slack).
SHIP_SLACK = 4


def make_sharded2d_resident_run(config: SimConfig, mesh, dec_r: AxisDecomp,
                                dec_c: AxisDecomp, kcap: int, cap: int):
    """Build ``run(slab_state, n_steps) -> slab_state`` (shard_map + jit)."""
    side = config.side
    nc = config.ncside
    d_r, d_c = dec_r.nblocks, dec_c.nblocks
    rows_max, cols_max = dec_r.max_blocks, dec_c.max_blocks
    nrows_t = rows_max + 2
    ncols_t = cols_max + 2
    ncells_t = nrows_t * ncols_t
    ncells = config.ncells

    lrow_of = (jnp.arange(ncells_t, dtype=jnp.int32) // ncols_t)[:, None]
    lcol_of = (jnp.arange(ncells_t, dtype=jnp.int32) % ncols_t)[:, None]
    row_halo = (lrow_of == 0) | (lrow_of == nrows_t - 1)
    col_halo = (lcol_of == 0) | (lcol_of == ncols_t - 1)
    halo_cell = row_halo | col_halo

    def grid3(a):
        return a.reshape(nrows_t, ncols_t, kcap)

    def local_run(slab: ShardedState, n_steps):
        mer = jax.lax.axis_index(AXIS_R)
        mec = jax.lax.axis_index(AXIS_C)
        row0 = dec_r.first_of(mer)
        rows_mine = dec_r.count_of(mer)
        col0 = dec_c.first_of(mec)
        cols_mine = dec_c.count_of(mec)
        owned_cell = ((lrow_of >= 1) & (lrow_of <= rows_mine)
                      & (lcol_of >= 1) & (lcol_of <= cols_mine))
        # First owned cell, the limbo parking spot (see prologue).
        park = jnp.int32(ncols_t + 1)

        # ---- prologue: sorted slab -> tiles --------------------------------
        def prologue(st: ShardedState) -> res.TileState:
            key, valid = binning.cell_keys(st.x, st.y, side, nc)
            gy = key // nc
            gx = key - gy * nc
            # A particle outside this shard's rectangle cannot appear in a
            # slab produced by init_state or epilogue; flag it as overflow
            # (the run is invalidated) rather than silently mis-binning it.
            mine = ((gy >= row0) & (gy < row0 + rows_mine)
                    & (gx >= col0) & (gx < col0 + cols_mine))
            stray = jnp.sum(st.valid & valid & ~mine, dtype=jnp.int32)
            ok = st.valid & valid & mine
            # Global (gy, gx) lexicographic slab order maps monotonically to
            # the local tile key, so segment_positions still sees runs.
            tkey = jnp.where(ok, (gy - row0 + 1) * ncols_t + (gx - col0 + 1),
                             jnp.int32(ncells_t))
            pos, _ = binning.segment_positions(tkey)
            kmax = binning.max_occupancy(pos, tkey < ncells_t)
            ovf = jnp.where(kmax > kcap, kmax, 0).astype(jnp.int32)
            ovf = jnp.maximum(ovf, jnp.where(stray > 0, STRAY_OVF, 0))
            fits = pos < kcap
            idx = jnp.where(ok & fits, tkey * kcap + pos, ncells_t * kcap)
            # Out-of-range (PANIC2-limbo) particles park in the first owned
            # cell, filling from slot kcap-1 *downward* so they can't
            # silently overwrite residents (which fill from slot 0 up);
            # masked out of physics until back in range. A rank crossing
            # flags overflow -> lossless kcap retry (ops/binning.py).
            limbo = st.valid & ~valid
            idx = jnp.where(limbo & fits,
                            park * kcap + (jnp.int32(kcap - 1) - pos), idx)
            occ_first = jnp.sum(ok & (tkey == park), dtype=jnp.int32)
            nlimbo = jnp.sum(limbo, dtype=jnp.int32)
            crowd = occ_first + nlimbo
            ovf = jnp.maximum(ovf, jnp.where(crowd > kcap, crowd, 0))

            def scatter(a, fill=0):
                flat = jnp.full(ncells_t * kcap, fill, a.dtype)
                return flat.at[idx].set(a, mode="drop").reshape(ncells_t,
                                                                kcap)

            return res.TileState(
                x=scatter(st.x), y=scatter(st.y),
                vx=scatter(st.vx), vy=scatter(st.vy), m=scatter(st.m),
                occ=scatter(st.valid & fits, fill=False),
                pid=scatter(st.pid),
                collisions=st.collisions,
                panics=st.panics,
                # pmax, not psum: sentinel values must not sum across
                # shards (D x STRAY_OVF would wrap int32).
                overflow=jnp.maximum(st.overflow,
                                     jax.lax.pmax(
                                         jax.lax.pmax(ovf, AXIS_R),
                                         AXIS_C)),
            )

        # ---- physics masks --------------------------------------------------
        def physics_mass(ts: res.TileState):
            _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
            binned = ts.occ & valid & owned_cell
            limbo_count = jnp.sum(ts.occ & ~valid, dtype=jnp.int32)
            return (jnp.where(binned, ts.m, jnp.float32(0.0)), binned,
                    limbo_count)

        # ---- COM + stencil with the two-phase halo ---------------------------
        def com_tables(ts: res.TileState, mf):
            M = jnp.sum(mf, axis=1)
            SX = jnp.sum(mf * ts.x, axis=1)
            SY = jnp.sum(mf * ts.y, axis=1)
            safe = jnp.where(M > 0, M, jnp.float32(1.0))
            MX = jnp.where(M > 0, SX / safe, jnp.float32(0.0))
            MY = jnp.where(M > 0, SY / safe, jnp.float32(0.0))
            # Owned + transit block (halo ring stripped; transit rows/cols
            # are empty between deliveries, so their COM is zero).
            M2 = M.reshape(nrows_t, ncols_t)[1:rows_max + 1, 1:cols_max + 1]
            MX2 = MX.reshape(nrows_t, ncols_t)[1:rows_max + 1,
                                               1:cols_max + 1]
            MY2 = MY.reshape(nrows_t, ncols_t)[1:rows_max + 1,
                                               1:cols_max + 1]
            Mpp, MXpp, MYpp = two_phase_com_halo(M2, MX2, MY2, rows_mine,
                                                 cols_mine, d_r, d_c)
            ml, mxl, myl = stencil_tables_halo2d(Mpp, MXpp, MYpp, side, nc,
                                                 rows_max, cols_max,
                                                 row0, col0)

            # Tile-aligned (ncells_t, 8) tables: zero ring for the particle
            # halo cells (no physics there; they are empty outside delivery).
            def align(t):
                core = t[:, :rows_max * cols_max].T.reshape(
                    rows_max, cols_max, 8)
                return jnp.pad(core, ((1, 1), (1, 1), (0, 0))).reshape(
                    ncells_t, 8)

            return align(ml), align(mxl), align(myl)

        # ---- migration routing: dimension-ordered (rows, then cols) ---------
        def _route(st: res.TileState):
            cxg, cyg, valid = res.cell_of(st.x, st.y, side, nc)
            gy_row = row0 + lrow_of - 1
            gx_col = col0 + lcol_of - 1
            dlr = lrow_of + res._wrap_delta(cyg - gy_row, nc)
            dlc = lcol_of + res._wrap_delta(cxg - gx_col, nc)
            dest_lrow = jnp.where(dlr < 1, 0,
                                  jnp.where(dlr > rows_mine,
                                            jnp.int32(nrows_t - 1), dlr))
            # Transit-region occupants (uneven decomposition) continue
            # toward the bottom/right halo; their line has no meaningful
            # global coordinate.
            dest_lrow = jnp.where(lrow_of > rows_mine,
                                  jnp.int32(nrows_t - 1), dest_lrow)
            row_exit = (dest_lrow == 0) | (dest_lrow == nrows_t - 1)
            dest_lcol = jnp.where(dlc < 1, 0,
                                  jnp.where(dlc > cols_mine,
                                            jnp.int32(ncols_t - 1), dlc))
            dest_lcol = jnp.where(lcol_of > cols_mine,
                                  jnp.int32(ncols_t - 1), dest_lcol)
            # Dimension-ordered: a row-exiting mover keeps its current
            # (owned) column, so halo-row corners stay empty and the cols
            # hop happens only after the row block matches.
            dest_lcol = jnp.where(row_exit, lcol_of, dest_lcol)
            movable = ((lrow_of >= 1) & (lrow_of <= rows_max)
                       & (lcol_of >= 1) & (lcol_of <= cols_max))
            moving = (st.occ & valid & movable
                      & ((dest_lrow != lrow_of) | (dest_lcol != lcol_of)))
            return moving, dest_lrow, dest_lcol

        def mover_fn(st: res.TileState):
            moving, dr, dc = _route(st)
            # Local signs, not wrap deltas: destinations are clamped into
            # the halo-extended window, so movement never wraps the local
            # grid.
            return moving, jnp.sign(dc - lcol_of), jnp.sign(dr - lrow_of)

        def dest_fn(st: res.TileState):
            """Absolute local destinations for the straggler-compaction
            fallback (ops/resident.py) — multi-cell movers (e.g. limbo
            re-entries) deliver in one compact pass instead of walking."""
            moving, dr, dc = _route(st)
            return moving, dr * ncols_t + dc

        # ---- halo extraction / merging ---------------------------------------
        def extract_row(ts: res.TileState, r):
            out = {}
            for f in _FIELDS + ("occ", "pid"):
                out[f] = jax.lax.dynamic_slice_in_dim(
                    grid3(getattr(ts, f)), r, 1, axis=0)[0]
            return out

        def extract_col(ts: res.TileState, c):
            out = {}
            for f in _FIELDS + ("occ", "pid"):
                out[f] = jax.lax.dynamic_slice_in_dim(
                    grid3(getattr(ts, f)), c, 1, axis=1)[:, 0]
            return out

        def clear_mask(ts: res.TileState, mask) -> res.TileState:
            occ = ts.occ & ~mask
            return ts._replace(
                occ=occ, m=jnp.where(occ, ts.m, jnp.float32(0.0)))

        def _merge_line(line, arr):
            """Pack arriving (L, K) particles into a line's free slots.

            Rank-matched one-hot placement per cell (arrival i goes to
            free slot i); arrivals beyond a cell's free-slot count are
            overflow (the engine retries with larger tiles).
            """
            free = ~line["occ"]
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

            new = {f: put(line[f], arr[f]) for f in _FIELDS + ("pid",)}
            new["occ"] = line["occ"] | placed
            return new, ovf

        def merge_into_row(ts: res.TileState, arr, r):
            new, ovf = _merge_line(extract_row(ts, r), arr)
            upd = {}
            for f in _FIELDS + ("occ", "pid"):
                g = jax.lax.dynamic_update_slice_in_dim(
                    grid3(getattr(ts, f)), new[f][None], r, axis=0)
                upd[f] = g.reshape(ncells_t, kcap)
            return ts._replace(**upd), ovf

        def merge_into_col(ts: res.TileState, arr, c):
            new, ovf = _merge_line(extract_col(ts, c), arr)
            upd = {}
            for f in _FIELDS + ("occ", "pid"):
                g = jax.lax.dynamic_update_slice_in_dim(
                    grid3(getattr(ts, f)), new[f][:, None], c, axis=1)
                upd[f] = g.reshape(ncells_t, kcap)
            return ts._replace(**upd), ovf

        def halo_pending(ts: res.TileState):
            return jax.lax.psum(
                jnp.sum(ts.occ & halo_cell, dtype=jnp.int32), BOTH)

        def ship_and_deliver(ts: res.TileState):
            """Deliver every mover to its destination cell, crossing shard
            boundaries through the halo ring (rows phase, then cols phase,
            then local redelivery each round). Returns (ts, overflow)."""
            ts, undelivered = res.rebin(ts, side, ncols_t, kcap,
                                        mover_fn=mover_fn, nrows=nrows_t,
                                        dest_fn=dest_fn)
            ovf0 = undelivered
            pending = halo_pending(ts)
            max_rounds = d_r + d_c + SHIP_SLACK

            def cond(c):
                _, pending, rounds, _ = c
                return (pending > 0) & (rounds < max_rounds)

            def body(c):
                ts, _, rounds, ovf = c
                # Rows phase: ship halo rows along the rows-axis ring.
                top = extract_row(ts, 0)
                bot = extract_row(ts, nrows_t - 1)
                ts = clear_mask(ts, row_halo)
                if d_r > 1:
                    up = _ring_perm(d_r, -1)
                    down = _ring_perm(d_r, 1)
                    from_below = jax.lax.ppermute(top, AXIS_R, up)
                    from_above = jax.lax.ppermute(bot, AXIS_R, down)
                else:
                    from_below, from_above = top, bot
                ts, o1 = merge_into_row(ts, from_above, jnp.int32(1))
                ts, o2 = merge_into_row(ts, from_below, rows_mine)
                # Cols phase: ship halo columns along the cols-axis ring.
                left = extract_col(ts, 0)
                right = extract_col(ts, ncols_t - 1)
                ts = clear_mask(ts, col_halo)
                if d_c > 1:
                    lperm = _ring_perm(d_c, -1)
                    rperm = _ring_perm(d_c, 1)
                    from_right = jax.lax.ppermute(left, AXIS_C, lperm)
                    from_left = jax.lax.ppermute(right, AXIS_C, rperm)
                else:
                    from_right, from_left = left, right
                ts, o3 = merge_into_col(ts, from_left, jnp.int32(1))
                ts, o4 = merge_into_col(ts, from_right, cols_mine)
                ts, undeliv = res.rebin(ts, side, ncols_t, kcap,
                                        mover_fn=mover_fn, nrows=nrows_t,
                                        dest_fn=dest_fn)
                return (ts, halo_pending(ts), rounds + 1,
                        ovf + o1 + o2 + o3 + o4 + undeliv)

            ts, pending, _, ovf = jax.lax.while_loop(
                cond, body, (ts, pending, jnp.int32(0), ovf0))
            ovf = ovf + pending  # ship-round cap exceeded
            return ts, jax.lax.psum(ovf, BOTH)

        # ---- fused pair pass (collisions + next step's pair forces) ---------
        fused_fn = dmod.resolve_pair_impl(side=config.side)

        def pair_pass(ts: res.TileState, collide: bool):
            mf, binned, _ = physics_mass(ts)
            ad = (binned & (ts.m > 0)).astype(jnp.int32)
            fxd, fyd, count, ftd = fused_fn(
                ts.x, ts.y, mf, ad, ncells_t, kcap, EPSILON,
                collide=collide, pid=ts.pid)
            died = ftd != INF
            return fxd, fyd, count, died

        # ---- one step --------------------------------------------------------
        def step(carry):
            ts, fxd, fyd = carry
            mf, binned, limbo = physics_mass(ts)
            ml_t, mxl_t, myl_t = com_tables(ts, mf)
            fxm, fym = dmod.monopole_tile_forces(ts.x, ts.y, mf,
                                                 ml_t, mxl_t, myl_t)
            fx_tot, fy_tot = fxd + fxm, fyd + fym
            x, y, vx, vy = integrate.integrate(ts.x, ts.y, ts.vx, ts.vy,
                                               ts.m, fx_tot, fy_tot, side,
                                               DELTAT)
            ts = ts._replace(x=x, y=y, vx=vx, vy=vy)

            ts, mig_ovf = ship_and_deliver(ts)

            fxd, fyd, count, died = pair_pass(ts, collide=True)
            m = jnp.where(died, jnp.float32(0.0), ts.m)
            total = jax.lax.psum(count, BOTH)
            panics = jax.lax.psum(limbo, BOTH)
            ts = ts._replace(
                m=m,
                collisions=ts.collisions + total.astype(ts.collisions.dtype),
                panics=ts.panics + panics,
                overflow=jnp.maximum(ts.overflow, mig_ovf),
            )
            return ts, fxd, fyd

        # ---- epilogue: tiles -> sorted slab ----------------------------------
        def epilogue(ts: res.TileState) -> ShardedState:
            nslots = ncells_t * kcap
            pad = max(0, cap - nslots)  # static: slab wider than the tiles
            flat_occ = ts.occ.reshape(-1)
            if pad:
                flat_occ = jnp.concatenate(
                    [flat_occ, jnp.zeros(pad, dtype=bool)])
            order = jnp.argsort(~flat_occ, stable=True)[:cap]
            valid = flat_occ[order]

            def take(a, fill=0):
                flat = a.reshape(-1)
                if pad:
                    flat = jnp.concatenate(
                        [flat, jnp.zeros(pad, dtype=a.dtype)])
                return jnp.where(valid, flat[order],
                                 jnp.asarray(fill, a.dtype))

            n_occ = jnp.sum(flat_occ, dtype=jnp.int32)
            # Slab-capacity exhaustion is a distinct cause (growing kcap
            # cannot fix it): flag with the CAP_OVF sentinel + deficit.
            ovf = jnp.where(n_occ > cap, CAP_OVF + (n_occ - cap), 0)
            x = take(ts.x)
            y = take(ts.y)
            m = take(ts.m)
            pid = take(ts.pid, fill=jnp.iinfo(jnp.int32).max)
            key, _ = binning.cell_keys(x, y, side, nc)
            key = jnp.where(valid, key, jnp.int32(ncells + 1))
            key, pid, x, y, vx, vy, m, alive, valid = binning.sort_by_cell(
                key, pid, x, y, take(ts.vx), take(ts.vy), m,
                valid & (m > 0), valid)
            ovf = jax.lax.pmax(jax.lax.pmax(ovf, AXIS_R), AXIS_C)
            return ShardedState(
                x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, valid=valid,
                pid=pid, collisions=ts.collisions, panics=ts.panics,
                overflow=jnp.maximum(ts.overflow, ovf))

        ts = prologue(slab)
        fxd, fyd, _, _ = pair_pass(ts, collide=False)
        ts, _, _ = jax.lax.fori_loop(
            0, n_steps, lambda i, c: step(c), (ts, fxd, fyd))
        return epilogue(ts)

    spec_arr = P(BOTH)
    specs = ShardedState(
        x=spec_arr, y=spec_arr, vx=spec_arr, vy=spec_arr, m=spec_arr,
        alive=spec_arr, valid=spec_arr, pid=spec_arr,
        collisions=P(), panics=P(), overflow=P())
    # check_vma=False: the fused pair kernels (ops/dense_xla.py) are shared
    # with the single-chip engine and initialize loop carries from literals,
    # which the varying-manual-axes type check rejects under shard_map.
    fn = jax.shard_map(local_run, mesh=mesh, in_specs=(specs, P()),
                       out_specs=specs, check_vma=False)
    return jax.jit(fn)
