"""Super-cell resident engine for the sparse-grid regime.

The slot-resident representation (ops/resident.py) keys one tile row per
*cell*. On sparse grids — the reference's SMALL workload is ncside=1300
with N=5e5, 0.3 particles per cell (g32mpi/CPD_2nd_delivery.pdf p.4) —
that wastes two orders of magnitude: 1.69M rows × K padded slots for
500k particles, and every pass pays traffic proportional to the *grid*,
not the particles.

Here one tile row covers an S×S block of physical cells (a "super-cell"),
so tile count tracks particles, not cells:

* **storage** — (nsc², K) slot tiles, nsc = ceil(ncside/S); a slot's
  physical cell is derived from its position each pass (nothing stored);
* **pair pass** — the same fused kernel (dense_xla.fused_pairs_v2) with a
  per-slot ``sub`` label = index of the slot's cell within its super-cell;
  pairs interact/collide only on equal labels, preserving the reference's
  strictly same-cell pair rule (serial/parsim.cpp:356-366,393-411);
* **per-cell COM** — a one-hot (rows, K, S²) membership tensor contracted
  as a batched matmul (precision=F32_MATMUL: COM values must not be
  rounded to a reduced-precision mantissa) gives per-cell mass/moment
  sums, which transpose-reshape onto the true (ncside, ncside) cell grid;
* **monopole stencil** — built exactly as everywhere else
  (ops/stencil.py on the true cell grid, periodic mirrors at *cell*
  granularity), then packed back to super-cell layout and gathered
  per-slot with the same one-hot tensor (one batched matmul — the
  one-hot contraction IS the gather, exact at F32_MATMUL);
* **rebin** — ops/resident.rebin on the (nsc, nsc) super-cell grid:
  movers are only *super-cell* crossers (S× fewer boundary crossings,
  nsc²/S⁴ fewer rows per delivery round), movement within a super-cell
  is free because cells are derived, not stored.

The super-cell partition may be uneven (S need not divide ncside): edge
super-cells simply cover fewer real cells. Periodic wrap stays exact
because all physics (stencil mirrors, pair rule) happens at cell
granularity on the true grid; the super-cell grid is only a storage and
transport partition.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from particlesimulation_tpu.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu.ops import binning, integrate, stencil
from particlesimulation_tpu.ops import dense_xla as dmod
from particlesimulation_tpu.ops import resident as res

INF = jnp.int32(0x7FFFFFFF)
# The one-hot COM/gather contractions run at true f32 (dense_xla.F32_MATMUL):
# a gather through a TF32 matmul would round each coordinate it moves.
F32_MATMUL = dmod.F32_MATMUL


def choose_supercell_factor(config: SimConfig, target_occ: float = 24.0,
                            min_nsc: int = 8) -> int | None:
    """Pick S so a super-cell tile row holds ~target_occ particles.

    Prefers divisors of ncside: an even partition enables the fast
    halo-table monopole path (no cell-grid transposes — see
    make_supercell_run); a non-divisor S still works through the
    general pack/unpack path. Returns None when the super-cell layout
    doesn't apply (grid too small to coarsen, or already dense enough
    that plain resident tiles win).
    """
    import math

    nc = config.ncside
    avg = config.n_particles / max(1, config.ncells)
    if avg >= 1.5 or nc < 2 * min_nsc:
        return None
    s_ideal = max(2.0, (target_occ / max(avg, 1e-9)) ** 0.5)
    s_max = nc // min_nsc
    if s_max < 2:
        return None
    divs = [d for d in range(2, s_max + 1) if nc % d == 0]
    if divs:
        # Within 2x of ideal, an even partition beats an exact match.
        best = min(divs, key=lambda d: abs(math.log(d / s_ideal)))
        if abs(math.log(best / s_ideal)) <= math.log(2.0):
            return best
    return min(max(2, int(round(s_ideal))), s_max)


def make_supercell_run(config: SimConfig, kcap: int, S: int):
    """Build (step_state, prologue, run) over (nsc², K) super-cell tiles."""
    side = config.side
    nc = config.ncside
    nsc = -(-nc // S)          # super-cells per axis (ceil)
    rows = nsc * nsc
    ncp = nsc * S              # padded cell grid edge
    ncells = config.ncells
    s2 = S * S

    rowid = jnp.arange(rows, dtype=jnp.int32)[:, None]
    row_scy = rowid // nsc
    row_scx = rowid % nsc

    # ---- cell-grid <-> super-cell-layout shuffles -----------------------
    def pack_grid(a):
        """(nc, nc, ...) cell grid -> (rows, S², ...) super-cell layout."""
        tail = a.shape[2:]
        pad = [(0, ncp - nc), (0, ncp - nc)] + [(0, 0)] * len(tail)
        ap = jnp.pad(a, pad)
        ap = ap.reshape(nsc, S, nsc, S, *tail)
        ap = jnp.moveaxis(ap, 2, 1)          # (nsc, nsc, S, S, ...)
        return ap.reshape(rows, s2, *tail)

    def unpack_grid(a):
        """(rows, S², ...) -> flat (nc*nc, ...) cell grid."""
        tail = a.shape[2:]
        ap = a.reshape(nsc, nsc, S, S, *tail)
        ap = jnp.moveaxis(ap, 1, 2)          # (nsc, S, nsc, S, ...)
        ap = ap.reshape(ncp, ncp, *tail)[:nc, :nc]
        return ap.reshape(nc * nc, *tail)

    # ---- per-slot cell/sub-cell geometry --------------------------------
    def slot_geometry(x, y):
        """(row_key, sub_label, valid) per slot from positions."""
        cx, cy, valid = res.cell_of(x, y, side, nc)
        scx, scy = cx // S, cy // S
        rowk = scy * nsc + scx
        sub = (cy - scy * S) * S + (cx - scx * S)
        return rowk, sub, valid

    def physics_mass(ts: res.TileState):
        _, _, valid = slot_geometry(ts.x, ts.y)
        binned = ts.occ & valid
        limbo = jnp.sum(ts.occ & ~valid, dtype=jnp.int32)
        return jnp.where(binned, ts.m, jnp.float32(0.0)), binned, limbo

    # ---- prologue: sorted state -> super-cell tiles ---------------------
    def prologue(state) -> res.TileState:
        from particlesimulation_tpu.state import SimState  # noqa: F401
        rowk, _, valid = slot_geometry(state.x, state.y)
        key = jnp.where(valid, rowk, jnp.int32(rows))
        # State arrives sorted by *cell* key, which is not monotone in the
        # super-cell key — one (key, pid) sort establishes segments.
        key, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key, state.pid, state.x, state.y, state.vx, state.vy,
            state.m, state.alive)
        pos, _ = binning.segment_positions(key)
        kmax = binning.max_occupancy(pos, key < rows)
        ovf = jnp.where(kmax > kcap, kmax, 0).astype(jnp.int32)
        ok = (key < rows) & (pos < kcap)
        idx = jnp.where(ok, key * kcap + pos, rows * kcap)
        # Limbo (PANIC2 out-of-range) particles park in row 0's tail slots
        # (top-down, overlap-flagged — same protocol as the resident impl).
        limbo = (key == rows) & (pos < kcap)
        idx = jnp.where(limbo, jnp.int32(kcap - 1) - pos, idx)
        occ0 = jnp.sum(ok & (key == 0), dtype=jnp.int32)
        nlimbo = jnp.sum(key == rows, dtype=jnp.int32)
        crowd = occ0 + nlimbo
        ovf = jnp.maximum(ovf, jnp.where(crowd > kcap, crowd, 0))

        def scatter(a, fill=0):
            flat = jnp.full(rows * kcap, fill, a.dtype)
            return flat.at[idx].set(a, mode="drop").reshape(rows, kcap)

        return res.TileState(
            x=scatter(x), y=scatter(y), vx=scatter(vx), vy=scatter(vy),
            m=scatter(m),
            occ=scatter(jnp.ones_like(m, dtype=bool), fill=False),
            pid=scatter(pid),
            collisions=state.collisions, panics=state.panics,
            overflow=jnp.maximum(state.overflow, ovf))

    # Sub-phase ablation for on-device cost attribution
    # (PSIM_SC_MONO=com|tables|gather truncates the path; results wrong).
    mono_ablate = os.environ.get("PSIM_SC_MONO", "")
    # The halo-table path needs an even partition (S | ncside); the
    # general pack/unpack path covers the rest. PSIM_SC_HALO=0 forces the
    # general path for A/B runs.
    halo_path = (nc % S == 0
                 and os.environ.get("PSIM_SC_HALO", "1") != "0")

    def _ablate_exit(ts, keep):
        z = keep.reshape(-1)[:1] * 0
        return jnp.zeros_like(ts.x) + z, jnp.zeros_like(ts.x)

    def _force_terms(ts, mf, slot_t):
        """8 monopole terms per slot from its gathered (24,) table row."""
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
            invl = jnp.where(nzl, jax.lax.rsqrt(jnp.where(nzl, d2l, 1.0)),
                             0.0)
            sl = gm * cm * (invl * invl * invl)
            fx = fx + sl * dxl
            fy = fy + sl * dyl
        return fx, fy

    # ---- monopole, general path: true-grid stencil + pack/unpack --------
    def monopole_forces_general(ts: res.TileState, mf, binned):
        _, sub, _ = slot_geometry(ts.x, ts.y)
        onehot = ((sub[:, :, None] == jnp.arange(s2, dtype=jnp.int32))
                  & binned[:, :, None]).astype(jnp.float32)
        # Per-cell mass / moment sums: (rows, K) x (rows, K, S²) -> (rows, S²)
        M_sc = jnp.einsum("rk,rks->rs", mf, onehot, precision=F32_MATMUL)
        SX_sc = jnp.einsum("rk,rks->rs", mf * ts.x, onehot,
                           precision=F32_MATMUL)
        SY_sc = jnp.einsum("rk,rks->rs", mf * ts.y, onehot,
                           precision=F32_MATMUL)
        if mono_ablate == "com":
            return _ablate_exit(ts, M_sc + SX_sc + SY_sc)
        M = unpack_grid(M_sc)
        safe = jnp.where(M > 0, M, jnp.float32(1.0))
        MX = jnp.where(M > 0, unpack_grid(SX_sc) / safe, jnp.float32(0.0))
        MY = jnp.where(M > 0, unpack_grid(SY_sc) / safe, jnp.float32(0.0))
        # True-grid stencil (exact periodic mirrors at cell granularity).
        ml, mxl, myl = stencil.stencil_tables(M, MX, MY, side, nc)
        tbl = jnp.concatenate(
            [ml[:, :ncells].T.reshape(nc, nc, 8),
             mxl[:, :ncells].T.reshape(nc, nc, 8),
             myl[:, :ncells].T.reshape(nc, nc, 8)], axis=2)  # (nc, nc, 24)
        tbl_sc = pack_grid(tbl).reshape(rows, s2, 24)
        if mono_ablate == "tables":
            return _ablate_exit(ts, tbl_sc)
        # Per-slot gather of its own cell's 8 neighbor terms — a batched
        # one-hot matmul, i.e. a gather.
        slot_t = jnp.einsum("rks,rsc->rkc", onehot, tbl_sc,
                            precision=F32_MATMUL)
        if mono_ablate == "gather":
            return _ablate_exit(ts, slot_t)
        return _force_terms(ts, mf, slot_t)

    # ---- monopole, halo-table path (S | ncside) -------------------------
    # The general path's cost is its cell-grid shuffles: unpack×3, the
    # (8, ncells)→(ncells, 8) transposes, and pack — most of the SMALL
    # shape's step on the first target. This path never leaves super-cell
    # layout: per-cell COM lands directly in a halo-extended (S+2)²
    # per-tile grid whose ring is filled from ring-neighbor tiles by
    # major-axis rolls (the cheap roll class — ops/resident.py), grid
    # mirrors (±side) are applied to the ring of edge tiles (with S | nc
    # the true grid edge IS the super-cell grid edge), and the per-slot
    # 8-direction gather is one shifted-one-hot contraction (direction
    # offsets are constant lane shifts of the halo table).
    SP = S + 2
    sp2 = SP * SP

    def _mroll(A, bx, by):
        """out[(scy,scx)] = A[(scy+by)%nsc, (scx+bx)%nsc] per tile row."""
        G = A.reshape(nsc, nsc, *A.shape[1:])
        return jnp.roll(G, (-by, -bx), axis=(0, 1)).reshape(A.shape)

    scx_first = (row_scx == 0)            # (rows, 1) edge-tile masks
    scx_last = (row_scx == nsc - 1)
    scy_first = (row_scy == 0)
    scy_last = (row_scy == nsc - 1)
    side_f = jnp.float32(side)

    def _halo_fill(Mh, offx_mask=None, offy_mask=None):
        """Fill the (S+2)² ring from neighbor tiles (+ grid mirrors).

        Mh: (rows, sp2) with interior values set, ring zero. offx_mask /
        offy_mask: (edge_first, edge_last) pairs of (rows, 1) masks that
        receive ∓/± side (the reference's temp-cell mirror offsets,
        serial/parsim.cpp:314-347) — None for the mass field.
        """
        H = Mh.reshape(rows, SP, SP)

        def interior(bx, by):
            return _mroll(Mh, bx, by).reshape(rows, SP, SP)[:, 1:S + 1,
                                                            1:S + 1]

        def offx(v, at_first: bool):
            if offx_mask is None:
                return v
            m = offx_mask[0] if at_first else offx_mask[1]
            o = jnp.where(m, -side_f if at_first else side_f,
                          jnp.float32(0.0))
            return o + v  # reference add order: offset first

        def offy(v, at_first: bool):
            if offy_mask is None:
                return v
            m = offy_mask[0] if at_first else offy_mask[1]
            o = jnp.where(m, -side_f if at_first else side_f,
                          jnp.float32(0.0))
            return o + v

        top = offy(interior(0, -1)[:, S - 1, :], True)       # (rows, S)
        bot = offy(interior(0, 1)[:, 0, :], False)
        left = offx(interior(-1, 0)[:, :, S - 1], True)
        right = offx(interior(1, 0)[:, :, 0], False)
        tl = offy(offx(interior(-1, -1)[:, S - 1:S, S - 1], True), True)
        tr = offy(offx(interior(1, -1)[:, S - 1:S, 0], False), True)
        bl = offy(offx(interior(-1, 1)[:, 0:1, S - 1], True), False)
        br = offy(offx(interior(1, 1)[:, 0:1, 0], False), False)
        H = H.at[:, 0, 1:S + 1].set(top)
        H = H.at[:, S + 1, 1:S + 1].set(bot)
        H = H.at[:, 1:S + 1, 0].set(left)
        H = H.at[:, 1:S + 1, S + 1].set(right)
        H = H.at[:, 0, 0:1].set(tl)
        H = H.at[:, 0, S + 1:S + 2].set(tr)
        H = H.at[:, S + 1, 0:1].set(bl)
        H = H.at[:, S + 1, S + 1:S + 2].set(br)
        return H.reshape(rows, sp2)

    def monopole_forces_halo(ts: res.TileState, mf, binned):
        _, sub, _ = slot_geometry(ts.x, ts.y)
        subh = ((sub // S + 1) * SP + (sub % S + 1))
        onehot = ((subh[:, :, None] == jnp.arange(sp2, dtype=jnp.int32))
                  & binned[:, :, None]).astype(jnp.float32)
        # Per-cell sums land directly at interior halo-grid positions.
        M_h = jnp.einsum("rk,rkh->rh", mf, onehot, precision=F32_MATMUL)
        SX_h = jnp.einsum("rk,rkh->rh", mf * ts.x, onehot,
                          precision=F32_MATMUL)
        SY_h = jnp.einsum("rk,rkh->rh", mf * ts.y, onehot,
                          precision=F32_MATMUL)
        if mono_ablate == "com":
            return _ablate_exit(ts, M_h + SX_h + SY_h)
        safe = jnp.where(M_h > 0, M_h, jnp.float32(1.0))
        MX_h = jnp.where(M_h > 0, SX_h / safe, jnp.float32(0.0))
        MY_h = jnp.where(M_h > 0, SY_h / safe, jnp.float32(0.0))
        M_f = _halo_fill(M_h)
        MX_f = _halo_fill(MX_h, offx_mask=(scx_first, scx_last))
        MY_f = _halo_fill(MY_h, offy_mask=(scy_first, scy_last))
        # Direction l's table = the halo grid lane-shifted by its constant
        # flat offset (interior labels stay in range; wrapped entries land
        # only at ring labels the one-hot never selects).
        cols = []
        for F in (M_f, MX_f, MY_f):
            for dx, dy in stencil.STENCIL:
                cols.append(jnp.roll(F, -(dy * SP + dx), axis=1))
        HH = jnp.stack(cols, axis=2)                  # (rows, sp2, 24)
        if mono_ablate == "tables":
            return _ablate_exit(ts, HH)
        slot_t = jnp.einsum("rkh,rhc->rkc", onehot, HH,
                            precision=F32_MATMUL)
        if mono_ablate == "gather":
            return _ablate_exit(ts, slot_t)
        return _force_terms(ts, mf, slot_t)

    monopole_forces = (monopole_forces_halo if halo_path
                      else monopole_forces_general)

    # ---- rebin over the super-cell grid ---------------------------------
    def mover_fn(st: res.TileState):
        rowk, _, valid = slot_geometry(st.x, st.y)
        moving = st.occ & valid & (rowk != rowid)
        scx, scy = (rowk % nsc), (rowk // nsc)
        sx = jnp.sign(res._wrap_delta(scx - row_scx, nsc))
        sy = jnp.sign(res._wrap_delta(scy - row_scy, nsc))
        return moving, sx, sy

    def dest_fn(ts: res.TileState):
        rowk, _, valid = slot_geometry(ts.x, ts.y)
        moving = ts.occ & valid & (rowk != rowid)
        return moving, rowk

    def rebin_fn(ts):
        return res.rebin(ts, side, nsc, kcap, mover_fn=mover_fn,
                         dest_fn=dest_fn)

    # ---- fused pair pass with the same-cell label mask ------------------
    # Side-adaptive variant selection like the resident engine, restricted
    # to the sub-capable forms (the label mask needs the ``sub`` kwarg;
    # v1/v3 lack it, so an env override naming one falls back to v2).
    fused_fn = dmod.resolve_pair_impl(side=side)
    if fused_fn not in (dmod.fused_pairs_v2, dmod.fused_pairs_v4,
                        dmod.fused_pairs_v5):
        fused_fn = dmod.fused_pairs_v2

    def pair_pass(ts: res.TileState, collide: bool):
        mf, binned, _ = physics_mass(ts)
        _, sub, _ = slot_geometry(ts.x, ts.y)
        # Non-binned slots get label -1: they can only "match" each other
        # and carry m=0 / alive=0, so they are inert either way.
        sub = jnp.where(binned, sub, jnp.int32(-1))
        ad = (binned & (ts.m > 0)).astype(jnp.int32)
        fxd, fyd, count, ftd = fused_fn(
            ts.x, ts.y, mf, ad, rows, kcap, EPSILON, collide=collide,
            pid=ts.pid, sub=sub)
        died = ftd != INF
        return fxd, fyd, count, died

    # Debug-only phase ablation for on-device cost attribution
    # (PSIM_ABLATE=rebin|pairs|mono skips that phase; results are wrong).
    ablate = os.environ.get("PSIM_ABLATE", "")

    # ---- one step --------------------------------------------------------
    def step(carry):
        ts, fxd, fyd = carry
        mf, binned, limbo_count = physics_mass(ts)
        if ablate == "mono":
            fx_tot, fy_tot = fxd, fyd
        else:
            fxm, fym = monopole_forces(ts, mf, binned)
            fx_tot, fy_tot = fxd + fxm, fyd + fym
        x, y, vx, vy = integrate.integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m,
                                           fx_tot, fy_tot, side, DELTAT)
        ts = ts._replace(x=x, y=y, vx=vx, vy=vy)

        if ablate == "rebin":
            undelivered = jnp.int32(0)
        else:
            ts, undelivered = rebin_fn(ts)

        if ablate == "pairs":
            count = jnp.int32(0)
            died = jnp.zeros((rows, kcap), bool)
        else:
            fxd, fyd, count, died = pair_pass(ts, collide=True)
        m = jnp.where(died, jnp.float32(0.0), ts.m)
        ts = ts._replace(
            m=m,
            collisions=ts.collisions + count.astype(ts.collisions.dtype),
            panics=ts.panics + limbo_count,
            overflow=jnp.maximum(
                ts.overflow,
                jnp.where(undelivered > 0, jnp.int32(kcap + 1),
                          jnp.int32(0))))
        return ts, fxd, fyd

    # ---- epilogue: tiles -> sorted state --------------------------------
    def epilogue(ts: res.TileState, n: int):
        from particlesimulation_tpu.state import SimState
        order = jnp.argsort(~ts.occ.reshape(-1), stable=True)[:n]
        x = ts.x.reshape(-1)[order]
        y = ts.y.reshape(-1)[order]
        vx = ts.vx.reshape(-1)[order]
        vy = ts.vy.reshape(-1)[order]
        m = ts.m.reshape(-1)[order]
        pid = ts.pid.reshape(-1)[order]
        occ = ts.occ.reshape(-1)[order]
        alive = occ & (m > 0)
        key, _ = binning.cell_keys(x, y, side, nc)
        key, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key, pid, x, y, vx, vy, m, alive)
        return SimState(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
                        collisions=ts.collisions, panics=ts.panics,
                        overflow=ts.overflow)

    def initial_forces(ts):
        fxd, fyd, _, _ = pair_pass(ts, collide=False)
        return fxd, fyd

    def run(state, n_steps):
        ts = prologue(state)
        fxd, fyd = initial_forces(ts)
        ts, _, _ = jax.lax.fori_loop(
            0, n_steps, lambda i, c: step(c), (ts, fxd, fyd))
        return epilogue(ts, state.x.shape[0])

    def step_state(ts):
        fxd, fyd = initial_forces(ts)
        out, _, _ = step((ts, fxd, fyd))
        return out

    return step_state, prologue, run
