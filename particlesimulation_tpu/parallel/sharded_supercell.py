"""Sharded super-cell engine: the sparse-grid regime on the 1D ring mesh.

The reference runs EVERY workload distributed — ``mpirun`` wraps the one
binary regardless of shape (reference mpi/run_tests.sh:8-16,76), so its
sparse SMALL workload (ncside=1300, N=5e5, 0.3 particles/cell) runs
under the same row decomposition as everything else — badly: 12x8 MPI
is 1.43x its serial (g32mpi/CPD_2nd_delivery.pdf p.5 table 1), because
per-rank work scales with the *grid*, not the particles. Here the
single-chip answer to that regime is the super-cell engine
(ops/supercell.py: one tile row per SxS cell block, tile count tracks
particles); this module is its distributed composition.

Decomposition: each shard owns a contiguous block of SUPER-ROWS of the
(nsc, nsc) super-cell grid — coarse-grid rows are just bands with SxS
sub-cell labels, so the whole halo/ship design of the sharded resident
engine (parallel/sharded_resident.py) applies verbatim at super-row
granularity:

* local tile grid ``(scrows_max + 2, nsc)`` rows x K slots — one halo
  super-row per side; emigrants whose destination super-row leaves the
  local block land in a halo super-row and ship to ring neighbors via
  ``lax.ppermute`` under a psum-gated while_loop (the reference's
  particle exchange, mpi/parsim-mpi.cpp:512-600);
* the pair pass is the same sub-labeled fused kernel as single-chip
  super-cell tiles (pairs interact/collide only on equal cell labels —
  the reference's strictly same-cell rule, serial/parsim.cpp:356-366);
* COM + monopole run at CELL granularity: per-cell mass/moment sums
  land on the shard's local cell grid (scrows_mine*S rows), ONE
  boundary cell row is exchanged each way over the ring (the
  reference's ghost-cell COM halo, mpi/parsim-mpi.cpp:670-815 — only
  monopole data ever crosses shards), and
  ``sharded.stencil_tables_halo`` resolves periodic mirrors from
  global coordinates exactly as the resident engine does. The per-slot
  8-neighbor gather is the super-cell engine's one-hot contraction
  over the locally packed tables.

Requires ``ncside % S == 0`` (so shard boundaries at super-rows are
also cell-row boundaries; ``choose_supercell_factor`` prefers divisor
factors) and ``nsc >= n_shards``. Capacity overflow anywhere flags
``overflow`` and the engine retries losslessly with larger tiles, like
every other impl — the reference PANIC-skips in its analogous case.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from particlesimulation_tpu.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu.ops import binning, integrate
from particlesimulation_tpu.ops import dense_xla as dmod
from particlesimulation_tpu.ops import resident as res
from particlesimulation_tpu.ops.dense_xla import F32_MATMUL
from particlesimulation_tpu.parallel.sharded import (
    AXIS, CAP_OVF, STRAY_OVF, _ring_perm, stencil_tables_halo)
from particlesimulation_tpu.state import ShardedState

INF = jnp.int32(0x7FFFFFFF)
_FIELDS = ("x", "y", "vx", "vy", "m")
SHIP_SLACK = 4


def sc_row_starts(nsc: int, d: int) -> tuple:
    """Balanced-uneven super-row split: floor + remainder on leaders.

    Same convention as the cell-row default (config.row0_of_shard);
    returns d+1 boundaries.
    """
    base, rem = divmod(nsc, d)
    starts = [0]
    for i in range(d):
        starts.append(starts[-1] + base + (1 if i < rem else 0))
    return tuple(starts)


def supercell_shard_viable(config: SimConfig, S: int | None) -> bool:
    """Whether the sharded super-cell layout applies to this config."""
    if S is None or S < 2:
        return False
    if config.ncside % S != 0:
        return False
    nsc = config.ncside // S
    return nsc >= max(2, config.n_shards)


def make_sharded_supercell_run(config: SimConfig, mesh, kcap: int,
                               cap: int, S: int):
    """Build ``run(slab_state, n_steps) -> slab_state`` (shard_map + jit)."""
    side = config.side
    nc = config.ncside
    d = config.n_shards
    assert nc % S == 0, "sharded supercell requires S | ncside"
    nsc = nc // S
    s2 = S * S
    ncells = config.ncells
    starts = sc_row_starts(nsc, d)
    scrows_max = max(starts[i + 1] - starts[i] for i in range(d))
    nsrows_t = scrows_max + 2          # + 2 halo super-rows
    ncells_t = nsrows_t * nsc          # local tile rows
    rows_cells = scrows_max * S        # owned cell rows (static bound)
    starts_arr = jnp.asarray(starts, dtype=jnp.int32)

    l_srow = (jnp.arange(ncells_t, dtype=jnp.int32) // nsc)[:, None]
    col_of = (jnp.arange(ncells_t, dtype=jnp.int32) % nsc)[:, None]
    sub_range = jnp.arange(s2, dtype=jnp.int32)

    def grid3(a):
        return a.reshape(nsrows_t, nsc, kcap)

    def local_run(slab: ShardedState, n_steps):
        me = jax.lax.axis_index(AXIS)
        row0_sc = starts_arr[me]
        rows_mine = starts_arr[me + 1] - row0_sc   # owned super-rows
        row0_cell = row0_sc * S
        rows_mine_c = rows_mine * S                # owned cell rows
        owned_row = (l_srow >= 1) & (l_srow <= rows_mine)
        halo_row = (l_srow == 0) | (l_srow == nsrows_t - 1)

        # ---- per-slot geometry (derived from positions, nothing stored) --
        def slot_geometry(x, y):
            cx, cy, valid = res.cell_of(x, y, side, nc)
            scx, scy = cx // S, cy // S
            lrow = scy - row0_sc + 1            # local super-row (if owned)
            sub = (cy - scy * S) * S + (cx - scx * S)
            return scx, scy, lrow, sub, valid

        # ---- prologue: sorted slab -> super-cell tiles -------------------
        def prologue(st: ShardedState) -> res.TileState:
            scx, scy, lrow, _, valid = slot_geometry(st.x, st.y)
            mine = (scy >= row0_sc) & (scy < row0_sc + rows_mine)
            stray = jnp.sum(st.valid & valid & ~mine, dtype=jnp.int32)
            ok = st.valid & valid & mine
            # Sentinels survive the sort: ncells_t = limbo (valid slab
            # slot, out-of-range position — parked below), ncells_t+1 =
            # stray/dead (dropped; strays abort via STRAY_OVF).
            tkey = jnp.where(
                ok, lrow * nsc + scx,
                jnp.where(st.valid & ~valid, jnp.int32(ncells_t),
                          jnp.int32(ncells_t + 1)))
            # Establish per-tile segments: slab order is by CELL key,
            # which is not monotone in the super-cell key.
            tkey, pid, x, y, vx, vy, m, alive, svalid = binning.sort_by_cell(
                tkey, st.pid, st.x, st.y, st.vx, st.vy, st.m, st.alive,
                st.valid)
            pos, _ = binning.segment_positions(tkey)
            kmax = binning.max_occupancy(pos, tkey < ncells_t)
            ovf = jnp.where(kmax > kcap, kmax, 0).astype(jnp.int32)
            ovf = jnp.maximum(ovf, jnp.where(stray > 0, STRAY_OVF, 0))
            fits = pos < kcap
            idx = jnp.where((tkey < ncells_t) & fits, tkey * kcap + pos,
                            ncells_t * kcap)
            # Limbo (PANIC2 out-of-range) particles park in the first owned
            # super-row's leading tile, filling tail slots downward (same
            # protocol as parallel/sharded_resident.py).
            limbo = svalid & (tkey == ncells_t)
            idx = jnp.where(limbo & fits,
                            nsc * kcap + (jnp.int32(kcap - 1) - pos), idx)
            occ_first = jnp.sum((tkey == nsc) & fits, dtype=jnp.int32)
            nlimbo = jnp.sum(limbo, dtype=jnp.int32)
            crowd = occ_first + nlimbo
            ovf = jnp.maximum(ovf, jnp.where(crowd > kcap, crowd, 0))

            def scatter(a, fill=0):
                flat = jnp.full(ncells_t * kcap, fill, a.dtype)
                return flat.at[idx].set(a, mode="drop").reshape(ncells_t,
                                                                kcap)

            return res.TileState(
                x=scatter(x), y=scatter(y),
                vx=scatter(vx), vy=scatter(vy), m=scatter(m),
                occ=scatter(svalid & fits, fill=False),
                pid=scatter(pid),
                collisions=st.collisions, panics=st.panics,
                overflow=jnp.maximum(st.overflow,
                                     jax.lax.pmax(ovf, AXIS)))

        def physics_mass(ts: res.TileState):
            _, _, _, _, valid = slot_geometry(ts.x, ts.y)
            binned = ts.occ & valid & owned_row
            limbo_count = jnp.sum(ts.occ & ~valid, dtype=jnp.int32)
            return (jnp.where(binned, ts.m, jnp.float32(0.0)), binned,
                    limbo_count)

        # ---- cell-granularity COM + monopole with the ppermute halo ------
        def unpack_local(a):
            """(owned tile rows, s2) -> local (rows_cells, nc) cell grid."""
            g = a.reshape(scrows_max, nsc, S, S)
            g = jnp.moveaxis(g, 1, 2)           # (scrows_max, S, nsc, S)
            return g.reshape(rows_cells, nc)

        def pack_local(a):
            """local (rows_cells, nc, T) cell grid -> (owned rows, s2, T)."""
            T = a.shape[2:]
            g = a.reshape(scrows_max, S, nsc, S, *T)
            g = jnp.moveaxis(g, 1, 2)           # (scrows_max, nsc, S, S, ..)
            return g.reshape(scrows_max * nsc, s2, *T)

        def monopole_forces(ts: res.TileState, mf, binned):
            _, _, _, sub, _ = slot_geometry(ts.x, ts.y)
            onehot = ((sub[:, :, None] == sub_range)
                      & binned[:, :, None]).astype(jnp.float32)
            M_sc = jnp.einsum("rk,rks->rs", mf, onehot,
                              precision=F32_MATMUL)
            SX_sc = jnp.einsum("rk,rks->rs", mf * ts.x, onehot,
                               precision=F32_MATMUL)
            SY_sc = jnp.einsum("rk,rks->rs", mf * ts.y, onehot,
                               precision=F32_MATMUL)
            own = slice(nsc, (scrows_max + 1) * nsc)  # drop halo super-rows
            M = unpack_local(M_sc[own])
            safe = jnp.where(M > 0, M, jnp.float32(1.0))
            MX = jnp.where(M > 0, unpack_local(SX_sc[own]) / safe,
                           jnp.float32(0.0))
            MY = jnp.where(M > 0, unpack_local(SY_sc[own]) / safe,
                           jnp.float32(0.0))

            # One-cell-row COM halo over the ring (raw data; mirrors are
            # resolved by stencil_tables_halo from global coordinates).
            def last_row(A):
                return jax.lax.dynamic_slice_in_dim(
                    A, rows_mine_c - 1, 1, axis=0)[0]

            if d > 1:
                down = _ring_perm(d, 1)
                up = _ring_perm(d, -1)
                top = jax.lax.ppermute((last_row(M), last_row(MX),
                                        last_row(MY)), AXIS, down)
                bot = jax.lax.ppermute((M[0], MX[0], MY[0]), AXIS, up)
            else:
                top = (last_row(M), last_row(MX), last_row(MY))
                bot = (M[0], MX[0], MY[0])
            zrow = jnp.zeros((1, nc), M.dtype)

            def padded(A, halo_top, halo_bot):
                Ap = jnp.concatenate([halo_top[None], A, zrow], axis=0)
                return jax.lax.dynamic_update_slice_in_dim(
                    Ap, halo_bot[None], rows_mine_c + 1, axis=0)

            ml, mxl, myl = stencil_tables_halo(
                padded(M, top[0], bot[0]), padded(MX, top[1], bot[1]),
                padded(MY, top[2], bot[2]), side, nc, rows_cells,
                row0_cell)
            tbl = jnp.concatenate(
                [ml[:, :rows_cells * nc].T.reshape(rows_cells, nc, 8),
                 mxl[:, :rows_cells * nc].T.reshape(rows_cells, nc, 8),
                 myl[:, :rows_cells * nc].T.reshape(rows_cells, nc, 8)],
                axis=2)                                   # (rc, nc, 24)
            tbl_sc = pack_local(tbl)                      # (own rows, s2, 24)
            zpad = jnp.zeros((nsc, s2, 24), tbl_sc.dtype)
            tbl_t = jnp.concatenate([zpad, tbl_sc, zpad], axis=0)
            slot_t = jnp.einsum("rks,rsc->rkc", onehot, tbl_t,
                                precision=F32_MATMUL)
            # 8 monopole terms per slot (ops/supercell._force_terms math).
            g = jnp.float32(dmod.G)
            gm = g * mf
            fx = jnp.zeros_like(ts.x)
            fy = jnp.zeros_like(ts.x)
            for l in range(8):
                cm = slot_t[:, :, l]
                dxl = slot_t[:, :, 8 + l] - ts.x
                dyl = slot_t[:, :, 16 + l] - ts.y
                d2l = dxl * dxl + dyl * dyl
                nzl = (d2l > 0.0) & (cm != 0.0)
                invl = jnp.where(
                    nzl, jax.lax.rsqrt(jnp.where(nzl, d2l, 1.0)), 0.0)
                sl = gm * cm * (invl * invl * invl)
                fx = fx + sl * dxl
                fy = fy + sl * dyl
            return fx, fy

        # ---- migration over the super-cell grid --------------------------
        def mover_fn(st: res.TileState):
            scx, scy, _, _, valid = slot_geometry(st.x, st.y)
            gy_row = row0_sc + l_srow - 1
            delta = res._wrap_delta(scy - gy_row, nsc)
            dlr = l_srow + delta
            dest_lrow = jnp.where(dlr < 1, 0,
                                  jnp.where(dlr > rows_mine,
                                            jnp.int32(nsrows_t - 1), dlr))
            dest_lrow = jnp.where(l_srow > rows_mine,
                                  jnp.int32(nsrows_t - 1), dest_lrow)
            movable = (l_srow >= 1) & (l_srow <= scrows_max)
            moving = (st.occ & valid & movable
                      & ((dest_lrow != l_srow) | (scx != col_of)))
            sy = jnp.sign(dest_lrow - l_srow)
            sx = jnp.sign(res._wrap_delta(scx - col_of, nsc))
            return moving, sx, sy

        def dest_fn(st: res.TileState):
            scx, scy, _, _, valid = slot_geometry(st.x, st.y)
            gy_row = row0_sc + l_srow - 1
            delta = res._wrap_delta(scy - gy_row, nsc)
            dlr = l_srow + delta
            dest_lrow = jnp.where(dlr < 1, 0,
                                  jnp.where(dlr > rows_mine,
                                            jnp.int32(nsrows_t - 1), dlr))
            dest_lrow = jnp.where(l_srow > rows_mine,
                                  jnp.int32(nsrows_t - 1), dest_lrow)
            movable = (l_srow >= 1) & (l_srow <= scrows_max)
            moving = (st.occ & valid & movable
                      & ((dest_lrow != l_srow) | (scx != col_of)))
            dest = dest_lrow * nsc + jnp.clip(scx, 0, nsc - 1)
            return moving, dest

        def extract_row(ts: res.TileState, r):
            return {f: jax.lax.dynamic_slice_in_dim(
                        grid3(getattr(ts, f)), r, 1, axis=0)[0]
                    for f in _FIELDS + ("occ", "pid")}

        def clear_halos(ts: res.TileState) -> res.TileState:
            occ = ts.occ & ~halo_row
            return ts._replace(
                occ=occ, m=jnp.where(occ, ts.m, jnp.float32(0.0)))

        def merge_into_row(ts: res.TileState, arr, r):
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

        def rebin_local(ts):
            return res.rebin(ts, side, nsc, kcap, mover_fn=mover_fn,
                             nrows=nsrows_t, dest_fn=dest_fn)

        def ship_and_deliver(ts: res.TileState):
            ts, undelivered = rebin_local(ts)
            ovf0 = undelivered
            pending = halo_pending(ts)
            max_rounds = d + SHIP_SLACK

            def cond(c):
                _, pending, rounds, _ = c
                return (pending > 0) & (rounds < max_rounds)

            def body(c):
                ts, _, rounds, ovf = c
                top = extract_row(ts, 0)
                bot = extract_row(ts, nsrows_t - 1)
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
                ts, undeliv = rebin_local(ts)
                return (ts, halo_pending(ts), rounds + 1,
                        ovf + o1 + o2 + undeliv)

            ts, pending, _, ovf = jax.lax.while_loop(
                cond, body, (ts, pending, jnp.int32(0), ovf0))
            ovf = ovf + pending
            return ts, jax.lax.psum(ovf, AXIS)

        # ---- sub-labeled fused pair pass ----------------------------------
        fused_fn = dmod.resolve_pair_impl(side=config.side)
        if fused_fn not in (dmod.fused_pairs_v2, dmod.fused_pairs_v4,
                            dmod.fused_pairs_v5):
            fused_fn = dmod.fused_pairs_v2

        def pair_pass(ts: res.TileState, collide: bool):
            mf, binned, _ = physics_mass(ts)
            _, _, _, sub, _ = slot_geometry(ts.x, ts.y)
            sub = jnp.where(binned, sub, jnp.int32(-1))
            ad = (binned & (ts.m > 0)).astype(jnp.int32)

            # Halo super-rows are empty whenever pairs run (the ship loop
            # drains them first; a non-empty residue flags overflow and
            # the whole run replays), so slice them out before dispatch —
            # otherwise each shard pays 2 of nsrows_t rows of K² lanes
            # for nothing (~29% at D=8 on the SMALL compose config).
            # Same move as sharded_banded_cols'
            # pair_pass halo-column slice.
            own = slice(nsc, (scrows_max + 1) * nsc)

            def inner(a):
                return a[own]

            fxd, fyd, count, ftd = fused_fn(
                inner(ts.x), inner(ts.y), inner(mf), inner(ad),
                scrows_max * nsc, kcap, EPSILON,
                collide=collide, pid=inner(ts.pid), sub=inner(sub))

            def embed(a, fill):
                return jnp.pad(a, ((nsc, nsc), (0, 0)),
                               constant_values=fill)

            died = embed(ftd != INF, False)
            return embed(fxd, 0.0), embed(fyd, 0.0), count, died

        # ---- one step ------------------------------------------------------
        def step(carry):
            ts, fxd, fyd = carry
            mf, binned, limbo = physics_mass(ts)
            fxm, fym = monopole_forces(ts, mf, binned)
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
                collisions=ts.collisions + total.astype(
                    ts.collisions.dtype),
                panics=ts.panics + panics,
                overflow=jnp.maximum(ts.overflow, mig_ovf))
            return ts, fxd, fyd

        # ---- epilogue: tiles -> sorted slab --------------------------------
        def epilogue(ts: res.TileState) -> ShardedState:
            nslots = ncells_t * kcap
            pad = max(0, cap - nslots)
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
    fn = jax.shard_map(local_run, mesh=mesh, in_specs=(specs, P()),
                       out_specs=specs, check_vma=False)
    return jax.jit(fn)
