"""Sharded slot-resident fast engine: resident tiles + ppermute halos.

Round 1 proved two things separately: (a) the slot-resident tile
representation is the fast single-chip formulation (no per-step sort, no
per-particle scatter/gather), and (b) the
row-block decomposition with a one-row ppermute COM halo ring is bitwise
correct. This module composes them: each shard's state lives in
``(local_cells, K)`` slot tiles covering its row block plus two *particle
halo rows*, and one ``shard_map``-wrapped program per step does

* local COM from the tiles (row reductions) and a one-row COM halo ring via
  ``lax.ppermute`` (the reference's ghost-cell Isend/Irecv,
  reference mpi/parsim-mpi.cpp:670-815 — only monopole data crosses shards
  in the force phase, never particle bodies);
* fused pairwise+monopole forces and the collision set rule on the tiles
  (same kernels as the single-chip resident engine, ops/dense_xla.py);
* migration by tile rebinning: cell-crossers move between rows via rolls
  (ops/resident.py); a crosser whose destination row leaves the local block
  lands in the adjacent halo row, and whole halo rows ship to ring
  neighbors via ``ppermute`` — the reference's Alltoall + point-to-point
  exchange (mpi/parsim-mpi.cpp:512-600). Shipping repeats (a psum-gated
  ``while_loop``) until no shard holds halo occupants, so the common case
  pays exactly one neighbor hop and a quiet step pays zero — unlike the
  round-1 slab path's unconditional D-1 ring hops.

Local tile grid layout (static height ``rows_max + 2``):

    local row 0             = top halo    (emigrants heading to shard-1)
    local rows 1..rows_mine = owned rows  (global rows row0..row0+rows_mine-1)
    local rows rows_mine+1..rows_max = transit (uneven decomposition only;
                              at most one row, empty between deliveries)
    local row rows_max+1    = bottom halo (emigrants heading to shard+1)

Capacity overflow anywhere (tile occupancy, merge free-slot exhaustion,
undelivered movers, ship-round cap) raises the replicated ``overflow``
counter and the engine retries the run losslessly with larger tiles — the
reference PANIC-skips particles in its analogous situation
(serial/parsim.cpp:276-280); here no particle is ever dropped.

The f64 slab path (parallel/sharded.py) remains the bitwise-parity claim;
this is the throughput path (f32, order-free reductions): cells that
receive cross-shard immigrants may fill their slots in a different order
than the single-chip resident engine, so trajectories agree statistically
(and collision counts exactly on the test configs), not bit-for-bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from particlesimulation_tpu.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu.ops import binning, integrate
from particlesimulation_tpu.ops import dense_xla as dmod
from particlesimulation_tpu.ops import resident as res
from particlesimulation_tpu.parallel.sharded import (
    AXIS, CAP_OVF, STRAY_OVF, _ring_perm, stencil_tables_halo)
from particlesimulation_tpu.state import ShardedState

INF = jnp.int32(0x7FFFFFFF)
_FIELDS = ("x", "y", "vx", "vy", "m")
# Ship rounds beyond the d-hop worst case before flagging overflow.
SHIP_SLACK = 4


def make_sharded_resident_run(config: SimConfig, mesh, kcap: int, cap: int):
    """Build ``run(slab_state, n_steps) -> slab_state`` (shard_map + jit)."""
    side = config.side
    nc = config.ncside
    d = config.n_shards
    rows_max = config.rows_max
    nrows_t = rows_max + 2
    ncells_t = nrows_t * nc
    ncells = config.ncells

    lrow_of = (jnp.arange(ncells_t, dtype=jnp.int32) // nc)[:, None]
    col_of = (jnp.arange(ncells_t, dtype=jnp.int32) % nc)[:, None]

    def grid3(a):
        return a.reshape(nrows_t, nc, kcap)

    def local_run(slab: ShardedState, n_steps):
        me = jax.lax.axis_index(AXIS)
        row0 = config.row0_of_shard(me).astype(jnp.int32)
        rows_mine = config.rows_of_shard(me).astype(jnp.int32)
        owned_row = (lrow_of >= 1) & (lrow_of <= rows_mine)
        halo_row = (lrow_of == 0) | (lrow_of == nrows_t - 1)

        # ---- prologue: sorted slab -> tiles --------------------------------
        def prologue(st: ShardedState) -> res.TileState:
            key, valid = binning.cell_keys(st.x, st.y, side, nc)
            gy = key // nc
            gx = key - gy * nc
            # A particle outside this shard's rows cannot appear in a slab
            # produced by init_state or epilogue; flag it as overflow (the
            # run is invalidated) rather than silently mis-binning it.
            mine = (gy >= row0) & (gy < row0 + rows_mine)
            stray = jnp.sum(st.valid & valid & ~mine, dtype=jnp.int32)
            ok = st.valid & valid & mine
            tkey = jnp.where(ok, (gy - row0 + 1) * nc + gx,
                             jnp.int32(ncells_t))
            pos, _ = binning.segment_positions(tkey)
            kmax = binning.max_occupancy(pos, tkey < ncells_t)
            ovf = jnp.where(kmax > kcap, kmax, 0).astype(jnp.int32)
            ovf = jnp.maximum(ovf, jnp.where(stray > 0, STRAY_OVF, 0))
            fits = pos < kcap
            idx = jnp.where(ok & fits, tkey * kcap + pos, ncells_t * kcap)
            # Out-of-range (PANIC2-limbo) particles park in the first owned
            # row's leading cell, filling from slot kcap-1 *downward* so
            # they can't silently overwrite that cell's residents (which
            # fill from slot 0 up); masked out of physics until back in
            # range (rare by construction — see ops/binning.py docstring).
            # A rank crossing flags overflow → lossless kcap retry.
            limbo = st.valid & ~valid
            idx = jnp.where(limbo & fits,
                            nc * kcap + (jnp.int32(kcap - 1) - pos), idx)
            occ_first = jnp.sum(ok & (tkey == nc), dtype=jnp.int32)
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
                # shards (8×STRAY_OVF would wrap int32).
                overflow=jnp.maximum(st.overflow,
                                     jax.lax.pmax(ovf, AXIS)),
            )

        # ---- physics masks --------------------------------------------------
        def physics_mass(ts: res.TileState):
            _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
            binned = ts.occ & valid & owned_row
            limbo_count = jnp.sum(ts.occ & ~valid, dtype=jnp.int32)
            return (jnp.where(binned, ts.m, jnp.float32(0.0)), binned,
                    limbo_count)

        # ---- COM + stencil with the ppermute halo ring ----------------------
        def com_tables(ts: res.TileState, mf):
            M = jnp.sum(mf, axis=1)
            SX = jnp.sum(mf * ts.x, axis=1)
            SY = jnp.sum(mf * ts.y, axis=1)
            safe = jnp.where(M > 0, M, jnp.float32(1.0))
            MX = jnp.where(M > 0, SX / safe, jnp.float32(0.0))
            MY = jnp.where(M > 0, SY / safe, jnp.float32(0.0))
            M2 = M.reshape(nrows_t, nc)[1:rows_max + 1]
            MX2 = MX.reshape(nrows_t, nc)[1:rows_max + 1]
            MY2 = MY.reshape(nrows_t, nc)[1:rows_max + 1]

            def last_row(A):
                return jax.lax.dynamic_slice_in_dim(A, rows_mine - 1, 1,
                                                    axis=0)[0]

            if d > 1:
                down = _ring_perm(d, 1)
                up = _ring_perm(d, -1)
                top = jax.lax.ppermute((last_row(M2), last_row(MX2),
                                        last_row(MY2)), AXIS, down)
                bot = jax.lax.ppermute((M2[0], MX2[0], MY2[0]), AXIS, up)
            else:
                top = (last_row(M2), last_row(MX2), last_row(MY2))
                bot = (M2[0], MX2[0], MY2[0])
            zrow = jnp.zeros((1, nc), M2.dtype)

            def padded(A, halo_top, halo_bot):
                Ap = jnp.concatenate([halo_top[None], A, zrow], axis=0)
                return jax.lax.dynamic_update_slice_in_dim(
                    Ap, halo_bot[None], rows_mine + 1, axis=0)

            Mp = padded(M2, top[0], bot[0])
            MXp = padded(MX2, top[1], bot[1])
            MYp = padded(MY2, top[2], bot[2])
            ml, mxl, myl = stencil_tables_halo(Mp, MXp, MYp, side, nc,
                                               rows_max, row0)
            # Tile-aligned (ncells_t, 8) tables: zero rows for the particle
            # halo rows (no physics there; they are empty outside delivery).
            zpad = jnp.zeros((nc, 8), ml.dtype)

            def align(t):
                return jnp.concatenate(
                    [zpad, t[:, :rows_max * nc].T, zpad], axis=0)

            return align(ml), align(mxl), align(myl)

        # ---- migration: local rebin + halo-row shipping ---------------------
        def mover_fn(st: res.TileState):
            cxg, cyg, valid = res.cell_of(st.x, st.y, side, nc)
            gy_row = row0 + lrow_of - 1
            delta = res._wrap_delta(cyg - gy_row, nc)
            dlr = lrow_of + delta
            dest_lrow = jnp.where(dlr < 1, 0,
                                  jnp.where(dlr > rows_mine,
                                            jnp.int32(nrows_t - 1), dlr))
            # Transit-region occupants (uneven decomposition) always continue
            # toward the bottom halo; their row has no meaningful global y.
            dest_lrow = jnp.where(lrow_of > rows_mine,
                                  jnp.int32(nrows_t - 1), dest_lrow)
            movable = (lrow_of >= 1) & (lrow_of <= rows_max)
            moving = (st.occ & valid & movable
                      & ((dest_lrow != lrow_of) | (cxg != col_of)))
            sy = jnp.sign(dest_lrow - lrow_of)
            sx = jnp.sign(res._wrap_delta(cxg - col_of, nc))
            return moving, sx, sy

        def dest_fn(st: res.TileState):
            """Absolute local destination rows for the straggler-compaction
            fallback (ops/resident.py): a multi-cell mover (e.g. a limbo
            particle re-entering far from its parked cell) otherwise walks
            one cell per full-grid round and can exhaust MAX_ROUNDS,
            flagging a spurious kcap retry. Emigrants compact into their
            halo row exactly as the one-hop delivery would."""
            cxg, cyg, valid = res.cell_of(st.x, st.y, side, nc)
            gy_row = row0 + lrow_of - 1
            delta = res._wrap_delta(cyg - gy_row, nc)
            dlr = lrow_of + delta
            dest_lrow = jnp.where(dlr < 1, 0,
                                  jnp.where(dlr > rows_mine,
                                            jnp.int32(nrows_t - 1), dlr))
            dest_lrow = jnp.where(lrow_of > rows_mine,
                                  jnp.int32(nrows_t - 1), dest_lrow)
            movable = (lrow_of >= 1) & (lrow_of <= rows_max)
            moving = (st.occ & valid & movable
                      & ((dest_lrow != lrow_of) | (cxg != col_of)))
            dest = dest_lrow * nc + jnp.clip(cxg, 0, nc - 1)
            return moving, dest

        def extract_row(ts: res.TileState, r):
            out = {}
            for f in _FIELDS + ("occ", "pid"):
                out[f] = jax.lax.dynamic_slice_in_dim(
                    grid3(getattr(ts, f)), r, 1, axis=0)[0]
            return out

        def clear_halos(ts: res.TileState) -> res.TileState:
            occ = ts.occ & ~halo_row
            return ts._replace(
                occ=occ, m=jnp.where(occ, ts.m, jnp.float32(0.0)))

        def merge_into_row(ts: res.TileState, arr, r):
            """Pack arriving (nc, K) particles into row ``r``'s free slots.

            Rank-matched one-hot placement per cell column (arrival i goes
            to free slot i); arrivals beyond a cell's free-slot count are
            overflow (the engine retries with larger tiles).
            """
            row = extract_row(ts, r)
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
            upd = {}
            for f in _FIELDS + ("occ", "pid"):
                g = jax.lax.dynamic_update_slice_in_dim(
                    grid3(getattr(ts, f)), new[f][None], r, axis=0)
                upd[f] = g.reshape(ncells_t, kcap)
            return ts._replace(**upd), ovf

        def halo_pending(ts: res.TileState):
            return jax.lax.psum(
                jnp.sum(ts.occ & halo_row, dtype=jnp.int32), AXIS)

        def ship_and_deliver(ts: res.TileState):
            """Deliver every mover to its destination cell, crossing shard
            boundaries through the halo rows. Returns (ts, overflow)."""
            ts, undelivered = res.rebin(ts, side, nc, kcap,
                                        mover_fn=mover_fn, nrows=nrows_t,
                                        dest_fn=dest_fn)
            ovf0 = undelivered
            pending = halo_pending(ts)
            max_rounds = d + SHIP_SLACK

            def cond(c):
                _, pending, rounds, _ = c
                return (pending > 0) & (rounds < max_rounds)

            def body(c):
                ts, _, rounds, ovf = c
                top = extract_row(ts, 0)
                bot = extract_row(ts, nrows_t - 1)
                ts = clear_halos(ts)
                if d > 1:
                    up = _ring_perm(d, -1)
                    down = _ring_perm(d, 1)
                    from_below = jax.lax.ppermute(top, AXIS, up)
                    from_above = jax.lax.ppermute(bot, AXIS, down)
                else:
                    from_below, from_above = top, bot
                ts, o1 = merge_into_row(ts, from_above, jnp.int32(1))
                ts, o2 = merge_into_row(ts, from_below, rows_mine)
                ts, undeliv = res.rebin(ts, side, nc, kcap,
                                        mover_fn=mover_fn, nrows=nrows_t,
                                        dest_fn=dest_fn)
                return ts, halo_pending(ts), rounds + 1, ovf + o1 + o2 + undeliv

            ts, pending, _, ovf = jax.lax.while_loop(
                cond, body, (ts, pending, jnp.int32(0), ovf0))
            ovf = ovf + pending  # ship-round cap exceeded
            return ts, jax.lax.psum(ovf, AXIS)

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
            total = jax.lax.psum(count, AXIS)
            panics = jax.lax.psum(limbo, AXIS)
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
            return ShardedState(
                x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, valid=valid,
                pid=pid, collisions=ts.collisions, panics=ts.panics,
                overflow=jnp.maximum(ts.overflow,
                                     jax.lax.pmax(ovf, AXIS)))

        ts = prologue(slab)
        fxd, fyd, _, _ = pair_pass(ts, collide=False)
        ts, _, _ = jax.lax.fori_loop(
            0, n_steps, lambda i, c: step(c), (ts, fxd, fyd))
        return epilogue(ts)

    spec_arr = P(AXIS)
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
