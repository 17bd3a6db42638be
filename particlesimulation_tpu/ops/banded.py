"""Row-banded resident tiles: per-band capacity without a per-step sort.

The clustered (normal-mode Gaussian blob) workloads of the reference
harness (serial/parsim.cpp:220-232, negative seeds) give cell occupancy
spanning orders of magnitude (UNEVEN `-23 5000 100 1e6`: median 21, mean
100, max ~750). The single-buffer resident engine (engine.py:
make_resident_run) must size EVERY cell's tile row to the global max
occupancy, so the K-proportional passes (rebin delivery masks, COM
reductions, monopole, integrate) pay ~6x the flagship's slot count; the
occupancy-classed dense engine (ops/tiered.py) right-sizes the lanes but
re-sorts every step.

This engine combines the two wins. Occupancy is *spatially coherent*
(the blob is a smooth density), so a partition of the grid into
contiguous ROW BANDS, each with its own slot-resident tile buffer
``(band_rows + 2 halo rows) * ncside, K_band)``, tracks the occupancy
profile with static shapes: hot central bands get fat tiles, the empty
fringe gets K=32. No per-step sort (states stay resident), and total
slots shrink ~3-4x vs the global-K resident buffer.

Mechanics reuse the sharded-resident design (parallel/sharded_resident
.py) verbatim, but in-program (a Python loop over bands inside one jit,
not shard_map):

* in-band rebin: ``ops/resident.rebin`` with a mover predicate that
  clamps out-of-band destinations to the band's two halo rows;
* inter-band migration: halo rows extract and rank-match-merge into the
  adjacent band's edge row (cross-K one-hot placement), iterated under
  a while_loop until no halo slot is occupied — the analog of the
  reference MPI variant's particle exchange (mpi/parsim-mpi.cpp:512-600)
  with bands in place of ranks;
* COM + stencil: per-cell reductions per band concatenate into the full
  (ncside²,) grid — the monopole tables are global and cheap, exactly
  like the reference's cell pass (serial/parsim.cpp:261-290);
* pair forces + collisions: the occupancy-adaptive fused kernel
  (dense_xla.fused_pairs_v2) runs per band at that band's K.

Capacity is planned from a host-side occupancy census (``plan_bands``,
a boundary DP over grid rows) and guarded in-graph: tile overflow,
halo-merge overflow, and undeliverable movers all flag
``state.overflow`` and the engine retries losslessly with grown caps
(engine.py:run), like every other impl. The reference PANIC-skips in
its analogous case.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from particlesimulation_tpu.config import DELTAT, EPSILON, Precision, SimConfig
from particlesimulation_tpu.ops import binning, integrate, stencil
from particlesimulation_tpu.ops import dense_xla as dmod
from particlesimulation_tpu.ops import resident as res
from particlesimulation_tpu.state import SimState

_FIELDS = ("x", "y", "vx", "vy", "m")
# Extra ship rounds beyond the band count (multi-band hops + x-fixups).
SHIP_SLACK = 4
INF = jnp.int32(0x7FFFFFFF)
# Halo-transfer lane budget: delivery packs halo arrivals into each
# cell's lowest slots (rows are cleared every ship round, free-slot
# ranks assign contiguously), so the cross-capacity merge only needs the
# first W lanes of a halo row — (nc, K_dst, W) one-hot placement instead
# of (nc, K_dst, K_src). Per-cell per-round crossers beyond W flag
# overflow (lossless retry; the attempt's result is discarded).
HALO_W = int(os.environ.get("PSIM_BAND_HALO_W", "64"))
# Fused-step ship-pending cause code: the band-major fused step (see
# make_banded_run(fused=True)) unrolls exactly ONE cross-band halo
# exchange; a mover still in a halo row after it (crossed >1 band
# boundary in one step — impossible at physical step sizes with >=2-row
# bands, possible for fast movers on thin bands) flags
# SHIP_OVF + pending and the engine replays the run on the general
# while_loop shipping step — lossless, the same protocol as every other
# capacity retry. Sits below dense_xla.HIT_OVF (1 << 29) and
# engine.RANK_OVF (1 << 30) so the engine ladder can dispatch on range.
SHIP_OVF = 1 << 27


def _round32(x: float) -> int:
    return max(32, (int(x) + 31) // 32 * 32)


# Cost-model weights in pair-lane units. A slot costs _SLOT_WEIGHT
# lane-equivalents of K-proportional traversal (rebin and the linear
# passes) plus K lanes of pair work. Each band adds two halo rows and its
# own rebin/pair dispatches. Both weights are untuned defaults carried
# over from the first target; they have not been calibrated on the H100.
_SLOT_WEIGHT = 220
# Per-band fixed cost in lane units (dispatch). Also the compile-time
# lever: each band adds its own rebin/pair/ship sub-graphs to the step
# program — raise PSIM_BAND_PENALTY to plan fewer, fatter bands when
# compile time dominates a short experiment.
_BAND_PENALTY = int(os.environ.get("PSIM_BAND_PENALTY", "10000000"))


def plan_bands(hist2d, ncside: int, max_kcap: int):
    """Partition grid rows into bands with per-band tile capacity.

    ``hist2d``: (ncside, ncside) per-cell occupancy census (y-major).
    Returns ``[(row0, rows, kcap), ...]`` covering rows contiguously, or
    None when one band (uniform occupancy) is as good — then the plain
    resident engine is simpler and equal.
    """
    occ = np.asarray(hist2d).reshape(ncside, ncside)
    row_kmax = occ.max(axis=1).astype(np.int64)  # per grid row

    def seg_k(i, j):
        return min(_round32(int(row_kmax[i:j].max()) * 1.15 + 4), max_kcap)

    def seg_cost(i, j):
        k = seg_k(i, j)
        return ((j - i + 2) * ncside * k * (_SLOT_WEIGHT + k)
                + _BAND_PENALTY)

    # O(n^2) boundary DP (ncside rows; 100 -> 10k segment evaluations).
    best = np.full(ncside + 1, np.inf)
    cut = np.zeros(ncside + 1, np.int64)
    best[0] = 0.0
    for j in range(1, ncside + 1):
        for i in range(j):
            c = best[i] + seg_cost(i, j)
            if c < best[j]:
                best[j] = c
                cut[j] = i
    single = seg_cost(0, ncside)
    if best[ncside] > 0.7 * single:
        return None
    bounds = []
    j = ncside
    while j > 0:
        i = int(cut[j])
        bounds.append((i, j))
        j = i
    bounds.reverse()
    return [(i, j - i, seg_k(i, j)) for i, j in bounds]


def plan_bands_cyclic(hist2d, ncside: int, n_shards: int, max_kcap: int):
    """Band plan with boundaries at multiples of ``n_shards`` rows.

    The block-cyclic sharded banded engine (parallel/sharded_banded.py)
    gives every shard 1/n_shards of every band's rows, so each band must
    span at least ``n_shards`` rows; restricting boundaries to multiples
    of n_shards keeps every shard's chunk of a band the same height (no
    padding rows). Same cost model and return shape as ``plan_bands``;
    returns None when a single band is within 30% (uniform occupancy —
    the plain sharded resident engine is simpler and equal). The last
    band absorbs ``ncside % n_shards`` extra rows (ragged chunking).
    """
    d = int(n_shards)
    if d < 1 or ncside < d:
        return None
    occ = np.asarray(hist2d).reshape(ncside, ncside)
    row_kmax = occ.max(axis=1).astype(np.int64)
    g = ncside // d  # candidate boundaries: 0, d, 2d, ..., g*d (+ tail)

    def seg_k(i, j):
        """K over super-rows [i, j) (rows i*d .. j*d, tail into the last)."""
        hi = ncside if j == g else j * d
        return min(_round32(int(row_kmax[i * d:hi].max()) * 1.15 + 4),
                   max_kcap)

    def seg_cost(i, j):
        k = seg_k(i, j)
        hi = ncside if j == g else j * d
        rows = hi - i * d
        # Per-shard chunk cost × d shards ≈ total work; +2 halo rows per
        # chunk per shard.
        return ((rows + 2 * d) * ncside * k * (_SLOT_WEIGHT + k)
                + d * _BAND_PENALTY)

    best = np.full(g + 1, np.inf)
    cut = np.zeros(g + 1, np.int64)
    best[0] = 0.0
    for j in range(1, g + 1):
        for i in range(j):
            c = best[i] + seg_cost(i, j)
            if c < best[j]:
                best[j] = c
                cut[j] = i
    single = seg_cost(0, g)
    if best[g] > 0.7 * single:
        return None
    bounds = []
    j = g
    while j > 0:
        i = int(cut[j])
        bounds.append((i, j))
        j = i
    bounds.reverse()
    return [(i * d, (ncside if j == g else j * d) - i * d, seg_k(i, j))
            for i, j in bounds]


def uniform_band_plan(ncside: int, band_rows: int, kcap: int):
    """Equal-rows band plan: the HBM-streaming split for *uniform* loads.

    plan_bands targets clustered occupancy (per-band K right-sizing) and
    declines uniform grids; this plan instead bounds each band's tile
    working set so a band's rebin+pair sub-passes operate on a smaller
    live set than the whole grid's tile state (the large-N streaming
    route, engine.Engine.init_state).
    """
    band_rows = max(1, int(band_rows))
    plan = []
    r = 0
    while r < ncside:
        rows = min(band_rows, ncside - r)
        plan.append((r, rows, kcap))
        r += rows
    return tuple(plan)


def grow_plan(plan, factor: float = 1.5, max_kcap: int = 1 << 30):
    """Lossless-retry growth: every band's capacity scales up."""
    return [(r0, rw, min(_round32(k * factor), max_kcap))
            for r0, rw, k in plan]


def make_banded_run(config: SimConfig, plan,
                    hcap: int | None = None,
                    collide_mode: str | None = None,
                    fused: bool = False):
    """Fast f32 step over row-banded resident tiles.

    ``plan``: [(row0, rows, kcap), ...] contiguous over the grid rows.
    Same step sequencing as engine.make_resident_run (reference
    serial/parsim.cpp:422-448): carried post-move pair forces, fused
    collision(t) + pair-force(t+1) pass per band.

    ``hcap``: per-band flagged-slot capacity for compact collision
    resolution (PSIM_COLLIDE=compact; dense_xla.resolve_collide_mode).

    ``fused``: band-major phase fusion — integrate(b)+rebin(b) and
    rebin(b)+pairs(b) run adjacently per band with ONE unrolled halo
    exchange in between, instead of the phase-major global barriers
    (integrate all; while_loop{ship all}; pair all). Identical physics
    when one exchange suffices (the common case: crossing two band
    boundaries in one step needs a >band-height hop); otherwise flags
    ``SHIP_OVF`` and the engine replays on the general step. Motive:
    every global phase barrier forces the whole tile state through
    device memory; band-major adjacency keeps one band's live set
    between the phase pair.
    """
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    assert config.precision is Precision.FAST
    bands = [(int(r0), int(rw), int(k)) for r0, rw, k in plan]
    B = len(bands)
    assert bands[0][0] == 0 and sum(b[1] for b in bands) == nc
    for (r0, rw, _), (r0n, _, _) in zip(bands, bands[1:]):
        assert r0 + rw == r0n
    # The end-of-run compaction needs at least N real slots grid-wide
    # (census plans always satisfy this: every band cap >= its cells'
    # occupancy); a hand-forced plan that can't even hold the particles
    # should fail loudly here, not as an epilogue shape error.
    real_slots = sum(rw * nc * k for _, rw, k in bands)
    if real_slots < config.n_particles:
        raise ValueError(
            f"band plan holds {real_slots} slots < N={config.n_particles}")
    fused_fn = dmod.resolve_pair_impl(side=config.side)
    halo_w = int(os.environ.get("PSIM_BAND_HALO_W", str(HALO_W)))
    # Debug-only phase ablation for on-device cost attribution
    # (PSIM_ABLATE=rebin|pairs|mono skips that phase; results are wrong).
    ablate = os.environ.get("PSIM_ABLATE", "")

    # Per-band static geometry.
    NROWS = [rw + 2 for _, rw, _ in bands]          # + 2 halo rows
    NCT = [nr * nc for nr in NROWS]                 # tile rows per band
    LROW = [jnp.arange(nct, dtype=jnp.int32)[:, None] // nc
            for nct in NCT]
    COL = [jnp.arange(nct, dtype=jnp.int32)[:, None] % nc
           for nct in NCT]
    REAL = [(LROW[b] >= 1) & (LROW[b] <= bands[b][1]) for b in range(B)]

    def mover_fn_for(b):
        row0, rw, k = bands[b]
        nrt = NROWS[b]
        lrow_of, col_of = LROW[b], COL[b]

        def mover_fn(st: res.TileState):
            cxg, cyg, valid = res.cell_of(st.x, st.y, side, nc)
            gy_row = row0 + lrow_of - 1
            delta = res._wrap_delta(cyg - gy_row, nc)
            dlr = lrow_of + delta
            dest_lrow = jnp.where(dlr < 1, 0,
                                  jnp.where(dlr > rw, jnp.int32(nrt - 1),
                                            dlr))
            movable = (lrow_of >= 1) & (lrow_of <= rw)
            moving = (st.occ & valid & movable
                      & ((dest_lrow != lrow_of) | (cxg != col_of)))
            sy = jnp.sign(dest_lrow - lrow_of)
            sx = jnp.sign(res._wrap_delta(cxg - col_of, nc))
            return moving, sx, sy

        return mover_fn

    MOVER = [mover_fn_for(b) for b in range(B)]

    def grid3(a, b):
        return a.reshape(NROWS[b], nc, bands[b][2])

    def extract_row(ts: res.TileState, r: int, b: int):
        return {f: grid3(getattr(ts, f), b)[r]
                for f in _FIELDS + ("occ", "pid")}

    def clear_halos(ts: res.TileState, b: int) -> res.TileState:
        occ = ts.occ & REAL[b]
        return ts._replace(occ=occ,
                           m=jnp.where(occ, ts.m, jnp.float32(0.0)))

    def merge_into_row(ts: res.TileState, arr, r: int, b: int):
        """Rank-match arriving (nc, K_src) particles into row ``r``'s free
        slots (arrival i -> free slot i, per cell column); arrivals beyond
        a cell's free slots count as overflow (lossless retry)."""
        row = extract_row(ts, r, b)
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
            g = grid3(getattr(ts, f), b).at[r].set(new[f])
            upd[f] = g.reshape(NCT[b], bands[b][2])
        return ts._replace(**upd), ovf

    def halo_pending(bl):
        return sum(jnp.sum(bl[b].occ & ~REAL[b], dtype=jnp.int32)
                   for b in range(B))

    def rebin_all(bl):
        out, ovf = [], jnp.int32(0)
        for b in range(B):
            ts, und = res.rebin(bl[b], side, nc, bands[b][2],
                                mover_fn=MOVER[b], nrows=NROWS[b])
            out.append(ts)
            ovf = ovf + und
        return tuple(out), ovf

    def exchange_once(bl, ovf):
        """One cross-band halo exchange: extract every band's halo rows,
        clear them, merge into the neighbors' edge rows. Returns
        (bands, ovf) with halo_w drops and merge overflow accumulated."""
        bl = list(bl)

        def take(row, b):
            # Packed-prefix halo slice (see HALO_W); occupants beyond
            # the lane budget are dropped from this attempt and
            # flagged, so the engine replays with a grown plan.
            w = min(halo_w, bands[b][2])
            dropped = jnp.sum(row["occ"][:, w:], dtype=jnp.int32)
            return {f: v[:, :w] for f, v in row.items()}, dropped

        tops, bots = [], []
        for b in range(B):
            t, d1 = take(extract_row(bl[b], 0, b), b)
            bo, d2 = take(extract_row(bl[b], NROWS[b] - 1, b), b)
            tops.append(t)
            bots.append(bo)
            ovf = ovf + d1 + d2
        bl = [clear_halos(bl[b], b) for b in range(B)]
        for b in range(B):
            # band b's top halo (global row row0-1) -> previous band's
            # last real row; bottom halo (row0+rows) -> next band's
            # first real row. The ring closes periodically (band 0's
            # top halo is band B-1's last row), matching the
            # reference's wraparound row exchange
            # (mpi/parsim-mpi.cpp:735-781).
            up = (b - 1) % B
            dn = (b + 1) % B
            bl[up], o1 = merge_into_row(bl[up], tops[b],
                                        NROWS[up] - 2, up)
            bl[dn], o2 = merge_into_row(bl[dn], bots[b], 1, dn)
            ovf = ovf + o1 + o2
        return bl, ovf

    def ship_and_deliver(bl):
        """Deliver every mover to its destination cell, crossing band
        boundaries through the halo rows (the in-program analog of the
        sharded engine's ppermute shipping). Returns (bands, overflow)."""
        bl, ovf0 = rebin_all(bl)
        pending = halo_pending(bl)
        max_rounds = B + SHIP_SLACK

        def cond(c):
            _, pending, rounds, _ = c
            return (pending > 0) & (rounds < max_rounds)

        def body(c):
            bl, _, rounds, ovf = c
            bl, ovf = exchange_once(bl, ovf)
            bl, und = rebin_all(tuple(bl))
            return bl, halo_pending(bl), rounds + 1, ovf + und

        bl, pending, _, ovf = jax.lax.while_loop(
            cond, body, (bl, pending, jnp.int32(0), ovf0))
        return bl, ovf + pending  # leftover pending = ship cap exceeded

    # ---- physics ---------------------------------------------------------
    def physics_mass(ts: res.TileState, b: int):
        _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
        binned = ts.occ & valid & REAL[b]
        limbo = jnp.sum(ts.occ & ~valid, dtype=jnp.int32)
        return jnp.where(binned, ts.m, jnp.float32(0.0)), binned, limbo

    def com_tables(bl, mfs):
        """Global monopole tables from per-band cell reductions."""
        Ms, SXs, SYs = [], [], []
        for b in range(B):
            rw = bands[b][1]
            M = jnp.sum(mfs[b], axis=1).reshape(NROWS[b], nc)[1:rw + 1]
            SX = (jnp.sum(mfs[b] * bl[b].x, axis=1)
                  .reshape(NROWS[b], nc)[1:rw + 1])
            SY = (jnp.sum(mfs[b] * bl[b].y, axis=1)
                  .reshape(NROWS[b], nc)[1:rw + 1])
            Ms.append(M)
            SXs.append(SX)
            SYs.append(SY)
        M = jnp.concatenate(Ms).reshape(-1)
        SX = jnp.concatenate(SXs).reshape(-1)
        SY = jnp.concatenate(SYs).reshape(-1)
        safe = jnp.where(M > 0, M, jnp.float32(1.0))
        MX = jnp.where(M > 0, SX / safe, jnp.float32(0.0))
        MY = jnp.where(M > 0, SY / safe, jnp.float32(0.0))
        ml, mxl, myl = stencil.stencil_tables(M, MX, MY, side, nc)
        zpad = jnp.zeros((nc, 8), ml.dtype)
        out = []
        for b in range(B):
            r0, rw, _ = bands[b]
            sl = slice(r0 * nc, (r0 + rw) * nc)
            out.append(tuple(
                jnp.concatenate([zpad, t[:, sl].T, zpad], axis=0)
                for t in (ml, mxl, myl)))
        return out

    if collide_mode is None:
        collide_mode = dmod.resolve_collide_mode()
    eff_hcap = hcap if hcap is not None else dmod.default_hcap()

    def pair_pass(ts: res.TileState, b: int, collide: bool):
        """Returns (fxd, fyd, count, died, hovf); hovf is nonzero only
        in compact collision mode (more than hcap slots flagged)."""
        mf, binned, _ = physics_mass(ts, b)
        ad = (binned & (ts.m > 0)).astype(jnp.int32)
        if (collide and collide_mode == "compact"
                and fused_fn in (dmod.fused_pairs_v2,
                                 dmod.fused_pairs_v4)):
            # Compact mode (see engine.make_resident_run.pair_pass): the
            # kernel emits endpoint flags == deaths; the exact first-pair
            # count runs once per band over the few flagged slots. Tile
            # rows (incl. the band's halo rows) are the same-cell domain.
            kb = bands[b][2]
            fxd, fyd, _, died = fused_fn(
                ts.x, ts.y, mf, ad, NCT[b], kb, EPSILON,
                collide="flags", pid=ts.pid)
            cellf = jax.lax.broadcasted_iota(jnp.int32, (NCT[b], kb), 0)
            count, hovf = dmod.compact_collision_count(
                ts.x.reshape(-1), ts.y.reshape(-1), cellf.reshape(-1),
                ts.pid.reshape(-1), died.reshape(-1), EPSILON, eff_hcap)
            return fxd, fyd, count, died, hovf
        fxd, fyd, count, ftd = fused_fn(
            ts.x, ts.y, mf, ad, NCT[b], bands[b][2], EPSILON,
            collide=collide, pid=ts.pid)
        return fxd, fyd, count, ftd != INF, jnp.int32(0)

    # ---- step --------------------------------------------------------
    def step(carry):
        bl, fxs, fys, coll, panics, ovf = carry
        bl = list(bl)
        mfs, limbos = [], []
        for b in range(B):
            mf, _, limbo = physics_mass(bl[b], b)
            mfs.append(mf)
            limbos.append(limbo)
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
            und = jnp.int32(0)
        else:
            bl, und = ship_and_deliver(tuple(bl))
        bl = list(bl)

        fxs2, fys2 = [], []
        count = jnp.int32(0)
        hovf = jnp.int32(0)
        for b in range(B):
            if ablate == "pairs":
                fxd = jnp.zeros_like(bl[b].x)
                fyd, cnt = fxd, jnp.int32(0)
                died = jnp.zeros(bl[b].occ.shape, bool)
            else:
                fxd, fyd, cnt, died, ho = pair_pass(bl[b], b, collide=True)
                hovf = jnp.maximum(hovf, ho)
            bl[b] = bl[b]._replace(
                m=jnp.where(died, jnp.float32(0.0), bl[b].m))
            fxs2.append(fxd)
            fys2.append(fyd)
            count = count + cnt

        coll = coll + count
        panics = panics + sum(limbos)
        ovf = jnp.maximum(ovf, jnp.where(und > 0, und, 0))
        ovf = jnp.maximum(
            ovf, jnp.where(hovf > 0,
                           jnp.int32(dmod.HIT_OVF)
                           + jnp.minimum(hovf, jnp.int32(dmod.HIT_OVF - 1)),
                           jnp.int32(0)))
        return (tuple(bl), tuple(fxs2), tuple(fys2), coll, panics, ovf)

    # Band-major scheduling fence for the fused step: without it XLA's
    # scheduler is free to interleave all bands' integrate passes before
    # any rebin (the phases are data-independent across bands), which
    # recreates the phase-major HBM pattern the fusion exists to avoid.
    # Threading each band's state through one optimization_barrier with
    # the previous band's freshly produced arrays pins the program order
    # to band-major, keeping the live set ~one band. Off via
    # PSIM_BANDED_FUSED_BARRIER=0 for A/B.
    use_barrier = os.environ.get("PSIM_BANDED_FUSED_BARRIER", "1") != "0"

    def _fence(ts: res.TileState, prev):
        if not use_barrier or prev is None:
            return ts
        fenced = jax.lax.optimization_barrier((ts.x, ts.y, ts.vx, ts.vy,
                                               ts.m, ts.occ, ts.pid,
                                               prev))
        return ts._replace(x=fenced[0], y=fenced[1], vx=fenced[2],
                           vy=fenced[3], m=fenced[4], occ=fenced[5],
                           pid=fenced[6])

    def step_fused(carry):
        """Band-major fused step (see make_banded_run docstring).

        Phase pattern per band: [mono+integrate+rebin](b) adjacent, one
        unrolled halo exchange, then [rebin+pairs](b) adjacent. Any
        mover still in a halo row after the single exchange flags
        SHIP_OVF + pending (engine replays on the general step).
        Physics identical to ``step`` whenever the general step's
        shipping while_loop would have run <= 1 round: same mover
        walks, same merge ranks, same pair domain.
        """
        bl, fxs, fys, coll, panics, ovf = carry
        bl = list(bl)
        mfs, limbos = [], []
        for b in range(B):
            mf, _, limbo = physics_mass(bl[b], b)
            mfs.append(mf)
            limbos.append(limbo)
        tables = com_tables(bl, mfs)
        und = jnp.int32(0)
        prev = None
        for b in range(B):
            bl[b] = _fence(bl[b], prev)
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
            if ablate != "rebin":
                bl[b], u = res.rebin(bl[b], side, nc, bands[b][2],
                                     mover_fn=MOVER[b], nrows=NROWS[b])
                und = und + u
            prev = bl[b].x

        if ablate != "rebin":
            bl, und = exchange_once(bl, und)

        fxs2, fys2 = [], []
        count = jnp.int32(0)
        hovf = jnp.int32(0)
        pending = jnp.int32(0)
        prev = None
        for b in range(B):
            bl[b] = _fence(bl[b], prev)
            if ablate != "rebin":
                bl[b], u2 = res.rebin(bl[b], side, nc, bands[b][2],
                                      mover_fn=MOVER[b], nrows=NROWS[b])
                und = und + u2
                pending = pending + jnp.sum(bl[b].occ & ~REAL[b],
                                            dtype=jnp.int32)
            if ablate == "pairs":
                fxd = jnp.zeros_like(bl[b].x)
                fyd, cnt = fxd, jnp.int32(0)
                died = jnp.zeros(bl[b].occ.shape, bool)
            else:
                fxd, fyd, cnt, died, ho = pair_pass(bl[b], b, collide=True)
                hovf = jnp.maximum(hovf, ho)
            bl[b] = bl[b]._replace(
                m=jnp.where(died, jnp.float32(0.0), bl[b].m))
            fxs2.append(fxd)
            fys2.append(fyd)
            count = count + cnt
            prev = fxd

        coll = coll + count
        panics = panics + sum(limbos)
        ovf = jnp.maximum(ovf, jnp.where(und > 0, und, 0))
        ovf = jnp.maximum(
            ovf, jnp.where(
                pending > 0,
                jnp.int32(SHIP_OVF)
                + jnp.minimum(pending, jnp.int32(SHIP_OVF - 1)),
                jnp.int32(0)))
        ovf = jnp.maximum(
            ovf, jnp.where(hovf > 0,
                           jnp.int32(dmod.HIT_OVF)
                           + jnp.minimum(hovf, jnp.int32(dmod.HIT_OVF - 1)),
                           jnp.int32(0)))
        return (tuple(bl), tuple(fxs2), tuple(fys2), coll, panics, ovf)

    # ---- prologue / epilogue -------------------------------------------
    def _zero_tile(b):
        nct, k = NCT[b], bands[b][2]
        z = jnp.zeros((), jnp.int32)
        return res.TileState(
            x=jnp.zeros((nct, k), jnp.float32),
            y=jnp.zeros((nct, k), jnp.float32),
            vx=jnp.zeros((nct, k), jnp.float32),
            vy=jnp.zeros((nct, k), jnp.float32),
            m=jnp.zeros((nct, k), jnp.float32),
            occ=jnp.zeros((nct, k), bool),
            pid=jnp.full((nct, k), -1, jnp.int32),
            collisions=z, panics=z, overflow=z)

    def prologue(state: SimState):
        """Scatter the particle slab into band tiles.

        Sorts by cell key first (one sort per run, like
        engine.make_resident_run.prologue): segment_positions needs
        contiguous per-cell segments, and while engine-produced states
        are always sorted, a hand-built or externally restored slab is
        not — scattering an unsorted slab would silently overwrite
        same-cell particles.
        """
        key, valid = binning.cell_keys(state.x, state.y, side, nc)
        skey, spid, sx, sy, svx, svy, sm, _salive = binning.sort_by_cell(
            key, state.pid, state.x, state.y, state.vx, state.vy,
            state.m, state.alive)
        state = state._replace(x=sx, y=sy, vx=svx, vy=svy, m=sm, pid=spid)
        key = skey
        valid = key < ncells
        pos, _ = binning.segment_positions(key)
        cy = key // nc
        cx = key - cy * nc
        bl = []
        ovf = jnp.int32(0)
        for b in range(B):
            r0, rw, k = bands[b]
            mine = valid & (cy >= r0) & (cy < r0 + rw)
            kmax = jnp.max(jnp.where(mine, pos + 1, 0))
            ovf = jnp.maximum(ovf, jnp.where(kmax > k, kmax, 0))
            ok = mine & (pos < k)
            idx = jnp.where(ok, ((cy - r0 + 1) * nc + cx) * k + pos,
                            jnp.int32(NCT[b] * k))
            if b == 0:
                # Out-of-range (PANIC2-limbo) particles park in band 0's
                # first real row, cell 0, filling tail slots downward so
                # residents (head slots up) aren't overwritten; a rank
                # crossing flags overflow -> lossless retry (see
                # engine.make_resident_run.prologue).
                limbo = (~valid) & (pos < k)
                idx = jnp.where(limbo, nc * k + (jnp.int32(k - 1) - pos),
                                idx)
                occ0 = jnp.sum(ok & (cy == r0) & (cx == 0),
                               dtype=jnp.int32)
                nlimbo = jnp.sum(~valid, dtype=jnp.int32)
                crowd = occ0 + nlimbo
                ovf = jnp.maximum(ovf, jnp.where(crowd > k, crowd, 0))

            def scat(a, fill=0):
                flat = jnp.full(NCT[b] * k, fill, a.dtype)
                return flat.at[idx].set(a, mode="drop").reshape(NCT[b], k)

            z = jnp.zeros((), jnp.int32)
            bl.append(res.TileState(
                x=scat(state.x), y=scat(state.y),
                vx=scat(state.vx), vy=scat(state.vy), m=scat(state.m),
                occ=scat(jnp.ones_like(state.m, dtype=bool), fill=False),
                pid=scat(state.pid),
                collisions=z, panics=z, overflow=z))
        return tuple(bl), ovf

    def epilogue(bl, coll, panics, ovf, state: SimState) -> SimState:
        n = state.x.shape[0]
        flats = {f: [] for f in _FIELDS + ("occ", "pid")}
        for b in range(B):
            rw = bands[b][1]
            for f in _FIELDS + ("occ", "pid"):
                g = grid3(getattr(bl[b], f), b)[1:rw + 1]
                flats[f].append(g.reshape(-1))
        cat = {f: jnp.concatenate(v) for f, v in flats.items()}
        order = jnp.argsort(~cat["occ"], stable=True)[:n]
        x = cat["x"][order]
        y = cat["y"][order]
        vx = cat["vx"][order]
        vy = cat["vy"][order]
        m = cat["m"][order]
        pid = cat["pid"][order]
        alive = cat["occ"][order] & (m > 0)
        key, _ = binning.cell_keys(x, y, side, nc)
        key, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key, pid, x, y, vx, vy, m, alive)
        return SimState(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
            collisions=state.collisions + coll.astype(
                state.collisions.dtype),
            panics=state.panics + panics,
            overflow=jnp.maximum(state.overflow, ovf))

    def initial_forces(bl):
        fxs, fys = [], []
        for b in range(B):
            fxd, fyd, _, _, _ = pair_pass(bl[b], b, collide=False)
            fxs.append(fxd)
            fys.append(fyd)
        return tuple(fxs), tuple(fys)

    step_fn = step_fused if fused else step

    def run(state: SimState, n_steps):
        bl, ovf = prologue(state)
        fxs, fys = initial_forces(bl)
        z = jnp.zeros((), jnp.int32)
        carry = (bl, fxs, fys, z, z, ovf)
        carry = jax.lax.fori_loop(0, n_steps, lambda i, c: step_fn(c),
                                  carry)
        bl, _, _, coll, panics, ovf = carry
        return epilogue(bl, coll, panics, ovf, state)

    def step_state(state: SimState) -> SimState:
        return run(state, 1)

    return step_state, prologue, run
