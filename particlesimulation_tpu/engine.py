"""Single-chip simulation engines.

The reference's step driver (``simulate``, reference serial/parsim.cpp:422-448)
sequences updateCOM → updateForces → updatePositionAndVelocity →
checkCollisions per timestep. Here the whole step is one pure function over
the sorted-particle representation, jitted once, and the timestep loop is a
``lax.fori_loop`` with a *dynamic* step count — one compilation serves every
run length, and no host round-trips occur inside a run.

The post-move sort of step t doubles as the binning of step t+1 (positions
don't change between the collision pass and the next COM pass), so each step
performs exactly one lexicographic sort.

Three fast-path implementations, escalation chain ``resident → dense →
sweep``:

* ``resident`` — the state lives in (ncells, K) slot tiles; rebinning moves
  cell-crossers directly between rows (ops/resident.py) — no per-step sort
  and no per-particle scatter/gather;
* ``dense`` — sorted particles scattered into slot tiles each step; pair
  passes as blockwise K² arithmetic (``lax.map`` over cell blocks,
  ops/dense_xla.py);
* ``sweep`` — XLA neighbor-offset sweep (works everywhere; the parity
  engine's formulation at f32).

On an accelerator the census router (``Engine.__init__``) picks a tile
engine; on the CPU it keeps the sweep unless ``PSIM_DENSE=1``.

All tile impls are capacity-adaptive: occupancy overflow is detected
in-graph and the engine transparently retries the run with larger tiles
(the reference instead PANIC-skips particles, serial/parsim.cpp:276-280 —
here no particle is ever dropped).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from particlesimulation_tpu.config import DELTAT, EPSILON, Precision, SimConfig
from particlesimulation_tpu.initializer import init_particles_host
from particlesimulation_tpu.ops import binning, collisions, com, forces, integrate, stencil
from particlesimulation_tpu.ops import dense_xla as dmod
from particlesimulation_tpu.state import SimState
from particlesimulation_tpu.utils import compile_cache

# Telemetry sentinel for a uint32 collision-rank domain overflow
# (kmax ≥ 65535) — far above any legal tile-capacity retry value so the
# two overflow kinds cannot be confused.
RANK_OVF = jnp.int32(1 << 30)
# Compact-collision hit-capacity overflow range: [HIT_OVF, 2*HIT_OVF)
# encodes HIT_OVF + needed flagged-slot count (ops/dense_xla.HIT_OVF).
HIT_OVF = dmod.HIT_OVF


def make_step(config: SimConfig):
    """Build the jittable ``step: SimState -> SimState`` (sweep impl)."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    parity = config.precision is Precision.PARITY
    # Occupancy-tiered sweeps (bit-identical; Σ B·kmax_block instead of
    # N·kmax_global lanes) are what make the high-occupancy golden vectors
    # verifiable in reasonable CPU time. PSIM_PARITY_BLOCKED=0 restores the
    # global formulation.
    blocked = parity and os.environ.get("PSIM_PARITY_BLOCKED", "1") != "0"
    blk = int(os.environ.get("PSIM_PARITY_BLOCK", "2048"))

    def step(state: SimState) -> SimState:
        x, y, vx, vy, m, alive, pid = (state.x, state.y, state.vx, state.vy,
                                       state.m, state.alive, state.pid)
        # Phase 1 — binning + COM (arrays arrive sorted by this key).
        key, valid = binning.cell_keys(x, y, side, nc)
        pos, _ = binning.segment_positions(key)
        kmax = binning.max_occupancy(pos, valid)
        if parity:
            M, MX, MY = com.com_parity(key, x, y, m, ncells)
        else:
            M, MX, MY = com.com_fast(key, x, y, m, ncells)

        # Phase 2 — forces (pairwise sweep, then 8 stencil monopole terms).
        ml, mxl, myl = stencil.stencil_tables(M, MX, MY, side, nc)
        if blocked:
            fx, fy = forces.pairwise_forces_parity_blocked(
                x, y, m, alive, key, kmax, ncells, block=blk)
        elif parity:
            fx, fy = forces.pairwise_forces_parity(x, y, m, alive, key, kmax,
                                                   ncells)
        else:
            fx, fy = forces.pairwise_forces_fast(x, y, m, alive, key, kmax,
                                                 ncells)
        fx, fy = forces.monopole_forces(x, y, m, alive, key, fx, fy,
                                        ml, mxl, myl, ncells, parity)

        # Phase 3 — integrate + periodic wrap.
        x, y, vx, vy = integrate.integrate(x, y, vx, vy, m, fx, fy, side,
                                           DELTAT)

        # Phase 4 — post-move rebin (the one sort per step) + collisions.
        key2, valid2 = binning.cell_keys(x, y, side, nc)
        key2, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key2, pid, x, y, vx, vy, m, alive)
        pos2, _ = binning.segment_positions(key2)
        kmax2 = binning.max_occupancy(pos2, key2 < ncells)
        if blocked:
            count, died = collisions.detect_collisions_blocked(
                x, y, alive, key2, pos2, kmax2, EPSILON, ncells, block=blk)
        else:
            count, died = collisions.detect_collisions(
                x, y, alive, key2, pos2, kmax2, EPSILON, ncells)
        m, alive = collisions.apply_deaths(m, alive, died)

        return SimState(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
            collisions=state.collisions + count.astype(state.collisions.dtype),
            panics=state.panics + jnp.sum(~valid, dtype=jnp.int32),
            # Rank-domain guard: a kmax ≥ 65535 cell would wrap the uint32
            # collision ranks — surface it via telemetry instead of
            # silently corrupting the set rule.
            overflow=jnp.maximum(state.overflow,
                                 collisions.rank_overflow(kmax2) * RANK_OVF),
        )

    return step


def make_dense_step(config: SimConfig, kcap: int):
    """Fast f32 step over dense per-cell tiles, re-sorted every step."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    assert config.precision is Precision.FAST

    def scatter_dense(idx, *arrays):
        out = []
        for a in arrays:
            out.append(jnp.zeros(ncells * kcap, a.dtype)
                       .at[idx].set(a, mode="drop")
                       .reshape(ncells, kcap))
        return out

    def build_tiles(state: SimState):
        """Dense tiles + index map for the state's (sorted) positions.

        The post-move tiles of step t are exactly the binning tiles of step
        t+1 (positions don't move between the collision pass and the next
        COM pass), so the run loop carries them and pays the scatters once
        per step, not twice.
        """
        key, valid = binning.cell_keys(state.x, state.y, side, nc)
        pos, _ = binning.segment_positions(key)
        kmax = binning.max_occupancy(pos, valid)
        ovf = jnp.where(kmax > kcap, kmax, 0).astype(jnp.int32)
        ok = valid & (pos < kcap)
        idx = jnp.where(ok, key * kcap + pos, ncells * kcap)  # OOB → dropped
        xd, yd = scatter_dense(idx, state.x, state.y)
        # Dead particles carry m=0, so the mass tile serves COM, forces
        # and (as m>0) the collision alive-mask.
        (md,) = scatter_dense(idx, state.m)
        return {"xd": xd, "yd": yd, "md": md, "idx": idx, "ok": ok,
                "ovf": ovf, "panic": jnp.sum(~valid, dtype=jnp.int32)}

    def step(state: SimState, tiles):
        x, y, vx, vy, m, alive, pid = (state.x, state.y, state.vx, state.vy,
                                       state.m, state.alive, state.pid)
        xd, yd, md = tiles["xd"], tiles["yd"], tiles["md"]
        idx, ok = tiles["idx"], tiles["ok"]
        ovf = tiles["ovf"]

        # COM from the dense tiles: plain row reductions, no segment ops.
        M = jnp.sum(md, axis=1)
        SX = jnp.sum(md * xd, axis=1)
        SY = jnp.sum(md * yd, axis=1)
        safe = jnp.where(M > 0, M, jnp.float32(1.0))
        MX = jnp.where(M > 0, SX / safe, jnp.float32(0.0))
        MY = jnp.where(M > 0, SY / safe, jnp.float32(0.0))

        ml, mxl, myl = stencil.stencil_tables(M, MX, MY, side, nc)
        ml_t = ml[:, :ncells].T  # (ncells, 8) row-aligned for the kernel
        mxl_t = mxl[:, :ncells].T
        myl_t = myl[:, :ncells].T

        fxd, fyd = dmod.dense_pairwise_forces(
            xd, yd, md, ml_t, mxl_t, myl_t, ncells, kcap)
        zero = jnp.float32(0.0)
        gidx = jnp.minimum(idx, ncells * kcap - 1)
        fx = jnp.where(ok, fxd.reshape(-1)[gidx], zero)
        fy = jnp.where(ok, fyd.reshape(-1)[gidx], zero)

        x, y, vx, vy = integrate.integrate(x, y, vx, vy, m, fx, fy, side,
                                           DELTAT)

        # Post-move rebin: the one sort per step, then fresh tiles (reused
        # by the collision pass now and as binning next step).
        key2, valid2 = binning.cell_keys(x, y, side, nc)
        key2, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key2, pid, x, y, vx, vy, m, alive)
        mid = SimState(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
                       collisions=state.collisions, panics=state.panics,
                       overflow=state.overflow)
        tiles2 = build_tiles(mid)
        ovf = jnp.maximum(ovf, tiles2["ovf"])

        # alive ⇔ m > 0 for occupied slots, so the mass tile doubles as the
        # collision alive-mask (empty slots are 0 either way).
        ad2 = (tiles2["md"] > 0).astype(jnp.int32)
        count, ftd = dmod.dense_collisions(
            tiles2["xd"], tiles2["yd"], ad2, ncells, kcap, EPSILON)
        gidx2 = jnp.minimum(tiles2["idx"], ncells * kcap - 1)
        died = tiles2["ok"] & (ftd.reshape(-1)[gidx2] != jnp.int32(0x7FFFFFFF))
        m, alive = collisions.apply_deaths(m, alive, died)
        # Deaths in tile space keep the carried mass tile consistent.
        tiles2["md"] = jnp.where(ftd != jnp.int32(0x7FFFFFFF),
                                 jnp.float32(0.0), tiles2["md"])
        tiles2["ovf"] = ovf

        out = SimState(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
            collisions=state.collisions + count.astype(state.collisions.dtype),
            panics=state.panics + tiles["panic"],
            overflow=jnp.maximum(state.overflow, ovf),
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


def make_resident_run(config: SimConfig, kcap: int,
                      hcap: int | None = None,
                      collide_mode: str | None = None):
    """Slot-resident fast engine: the state lives in (ncells, K) tiles.

    No per-step sort, no per-particle scatter/gather — rebinning moves the
    few cell-crossing particles via rolls + rank-matched one-hot matmuls
    (ops/resident.py). The only N-sized reshuffles are one scatter set at
    run start and one compaction at run end.

    ``hcap``: flagged-slot capacity for compact collision resolution
    (PSIM_COLLIDE=compact; see dense_xla.resolve_collide_mode). Overflow
    is encoded as HIT_OVF + need in the overflow channel and retried
    losslessly by Engine.run.
    """
    from particlesimulation_tpu.ops import resident as res

    side = config.side
    nc = config.ncside
    ncells = config.ncells
    assert config.precision is Precision.FAST
    INF = jnp.int32(0x7FFFFFFF)

    def scatter_dense(idx, a, fill=0):
        flat = jnp.full(ncells * kcap, fill, a.dtype).at[idx].set(
            a, mode="drop")
        return flat.reshape(ncells, kcap)

    def prologue(state: SimState) -> res.TileState:
        # Scatter by the CLAMPED cell key: out-of-range (PANIC2-limbo)
        # particles land in their nearest valid row instead of a far-away
        # parking row. Parking them in cell 0 (the round-2 design) made
        # every limbo particle a multi-cell "walker" when it re-entered
        # range — the one-hop-per-round delivery needs |Δrow|+|Δcol|
        # rounds, which at large grids exceeds MAX_ROUNDS, flags a
        # spurious overflow, and silently downgraded N=1e7 runs to the
        # much slower dense impl. Clamp-parked limbo
        # is ≤1 hop from home, the crowd accounting collapses into the
        # ordinary occupancy bound, and physics is unchanged (limbo slots
        # stay masked via binned_mask; valid particles have clamped key ==
        # key, so their in-cell pid order — the collision tie-break — is
        # identical). Costs one (ck, pid) sort per run, not per step.
        cx, cy, _ = res.cell_of(state.x, state.y, side, nc)
        ck = (jnp.clip(cy, 0, nc - 1) * nc
              + jnp.clip(cx, 0, nc - 1)).astype(jnp.int32)
        ck, pid, x, y, vx, vy, m, _alive = binning.sort_by_cell(
            ck, state.pid, state.x, state.y, state.vx, state.vy,
            state.m, state.alive)
        pos, _ = binning.segment_positions(ck)
        kmax = binning.max_occupancy(pos, jnp.ones_like(ck, bool))
        ovf = jnp.where(kmax > kcap, kmax, 0).astype(jnp.int32)
        ok = pos < kcap
        idx = jnp.where(ok, ck * kcap + pos, ncells * kcap)
        return res.TileState(
            x=scatter_dense(idx, x),
            y=scatter_dense(idx, y),
            vx=scatter_dense(idx, vx),
            vy=scatter_dense(idx, vy),
            m=scatter_dense(idx, m),
            occ=scatter_dense(idx, jnp.ones_like(m, dtype=bool),
                              fill=False),
            pid=scatter_dense(idx, pid),
            collisions=state.collisions,
            panics=state.panics,
            overflow=jnp.maximum(state.overflow, ovf),
        )

    fused = True
    # Debug-only phase ablation for on-device cost attribution
    # (PSIM_ABLATE=rebin|pairs|mono, comma-combinable, skips those
    # phases; results are wrong).
    ablate = set(os.environ.get("PSIM_ABLATE", "").split(","))

    # Rebin: XLA delivery rounds (ops/resident.rebin). The named scopes
    # here and on the pair pass label the step's phases in profiler traces.
    def rebin_fn(ts, side, nc, kcap):
        with jax.named_scope("rebin"):
            return res.rebin(ts, side, nc, kcap)

    def mono_tables(ts, mf):
        # COM + stencil from the tiles (row reductions only).
        M = jnp.sum(mf, axis=1)
        SX = jnp.sum(mf * ts.x, axis=1)
        SY = jnp.sum(mf * ts.y, axis=1)
        safe = jnp.where(M > 0, M, jnp.float32(1.0))
        MX = jnp.where(M > 0, SX / safe, jnp.float32(0.0))
        MY = jnp.where(M > 0, SY / safe, jnp.float32(0.0))
        ml, mxl, myl = stencil.stencil_tables(M, MX, MY, side, nc)
        return ml[:, :ncells].T, mxl[:, :ncells].T, myl[:, :ncells].T

    def physics_mass(ts):
        binned, limbo_count = res.binned_mask(ts, side, nc)
        # Zero mf silences limbo slots in every physics pass: they exert
        # and receive no force (fly ballistically — the reference's skipped
        # PANIC2 particles) and never collide.
        return jnp.where(binned, ts.m, jnp.float32(0.0)), binned, limbo_count

    if collide_mode is None:
        collide_mode = dmod.resolve_collide_mode()
    eff_hcap = hcap if hcap is not None else dmod.default_hcap()

    def pair_pass(ts, collide: bool):
        with jax.named_scope("pair_pass"):
            return _pair_pass(ts, collide)

    def _pair_pass(ts, collide: bool):
        """Fused collision(t) + pairwise-force(t+1) sweep (one d² per pair).

        The post-move positions a step's collision pass scans are exactly
        the positions the next step's force pass needs; forces come out with
        this pass's deaths already applied (reference ordering: merged
        particles are massless from the next step on).

        Returns (fxd, fyd, count, died, hovf); hovf is nonzero only in
        compact collision mode when more than ``hcap`` slots flagged.
        """
        mf, binned, _ = physics_mass(ts)
        ad = (binned & (ts.m > 0)).astype(jnp.int32)
        # pid tiles restore the reference's bucket-order (pid-ascending)
        # collision tie-breaks: resident slot order departs from pid order
        # after migration (serial/parsim.cpp:393-411).
        fused_fn = dmod.resolve_pair_impl(side=config.side)
        if (collide and collide_mode == "compact"
                and fused_fn in (dmod.fused_pairs_v2,
                                 dmod.fused_pairs_v4)):
            # Compact mode: the pair pass emits endpoint flags (== deaths,
            # used for this pass's post-death force masses inside the
            # kernel); the exact first-pair count runs once, globally,
            # over the few flagged slots.
            fxd, fyd, _, died = fused_fn(
                ts.x, ts.y, mf, ad, ncells, kcap, EPSILON,
                collide="flags", pid=ts.pid)
            cellf = jax.lax.broadcasted_iota(jnp.int32, (ncells, kcap), 0)
            count, hovf = dmod.compact_collision_count(
                ts.x.reshape(-1), ts.y.reshape(-1), cellf.reshape(-1),
                ts.pid.reshape(-1), died.reshape(-1), EPSILON, eff_hcap)
            return fxd, fyd, count, died, hovf
        fxd, fyd, count, ftd = fused_fn(
            ts.x, ts.y, mf, ad, ncells, kcap, EPSILON, collide=collide,
            pid=ts.pid)
        died = ftd != INF
        return fxd, fyd, count, died, jnp.int32(0)

    def step(carry):
        ts, fxd, fyd = carry
        mf, binned, limbo_count = physics_mass(ts)
        ml_t, mxl_t, myl_t = mono_tables(ts, mf)

        if fused and "mono" in ablate:
            fx_tot, fy_tot = fxd, fyd
        elif fused:
            fxm, fym = dmod.monopole_tile_forces(ts.x, ts.y, mf,
                                                  ml_t, mxl_t, myl_t)
            fx_tot, fy_tot = fxd + fxm, fyd + fym
        else:
            fx_tot, fy_tot = dmod.dense_pairwise_forces(
                ts.x, ts.y, mf, ml_t, mxl_t, myl_t, ncells, kcap)

        # Integrate in place; m==0 (dead or empty slot) stays frozen.
        x, y, vx, vy = integrate.integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m,
                                           fx_tot, fy_tot, side, DELTAT)
        ts = ts._replace(x=x, y=y, vx=vx, vy=vy)

        # Rebin: deliver movers to their new rows.
        if "rebin" in ablate:
            undelivered = jnp.int32(0)
        elif os.environ.get("PSIM_DEBUG_ROUNDS") == "1":
            # Telemetry: accumulate delivery-round counts into the panics
            # counter (results are wrong — debug-only, like PSIM_ABLATE).
            ts, undelivered, rounds = res.rebin(ts, side, nc, kcap,
                                                return_rounds=True)
            ts = ts._replace(panics=ts.panics + rounds)
        else:
            ts, undelivered = rebin_fn(ts, side, nc, kcap)

        # Collisions on the rebinned tiles (+ next step's pair forces when
        # fused).
        hovf = jnp.int32(0)
        if fused and "pairs" in ablate:
            count = jnp.int32(0)
            died = jnp.zeros((ncells, kcap), bool)
        elif fused:
            fxd, fyd, count, died, hovf = pair_pass(ts, collide=True)
        else:
            binned2, _ = res.binned_mask(ts, side, nc)
            ad = (binned2 & (ts.m > 0)).astype(jnp.int32)
            count, ftd = dmod.dense_collisions(ts.x, ts.y, ad, ncells, kcap,
                                               EPSILON, pid=ts.pid)
            died = ftd != INF
        m = jnp.where(died, jnp.float32(0.0), ts.m)

        ts = ts._replace(
            m=m,
            collisions=ts.collisions + count.astype(ts.collisions.dtype),
            panics=ts.panics + limbo_count,
            overflow=jnp.maximum(
                jnp.maximum(
                    ts.overflow,
                    jnp.where(undelivered > 0, jnp.int32(kcap + 1),
                              jnp.int32(0))),
                jnp.where(hovf > 0,
                          jnp.int32(HIT_OVF)
                          + jnp.minimum(hovf, jnp.int32(HIT_OVF - 1)),
                          jnp.int32(0))),
        )
        return ts, fxd, fyd

    def epilogue(ts: res.TileState, n: int) -> SimState:
        # Compact tiles back to N particle-major arrays (once per run).
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
        if fused:
            fxd, fyd, _, _, _ = pair_pass(ts, collide=False)
        else:
            fxd = jnp.zeros((ncells, kcap), jnp.float32)
            fyd = fxd
        return fxd, fyd

    def run(state: SimState, n_steps):
        ts = prologue(state)
        fxd, fyd = initial_forces(ts)
        ts, _, _ = jax.lax.fori_loop(
            0, n_steps, lambda i, c: step(c), (ts, fxd, fyd))
        return epilogue(ts, state.x.shape[0])

    def step_state(ts):
        """Single-step entry for debugging (recomputes the carried forces)."""
        fxd, fyd = initial_forces(ts)
        out, _, _ = step((ts, fxd, fyd))
        return out

    return step_state, prologue, run


def _use_dense_default() -> bool:
    """Whether census routing may pick a tile engine.

    True on any accelerator. The CPU keeps the sweep (its tile passes
    are no faster there, and the test suite's runtime is tuned to it);
    ``PSIM_DENSE=0/1`` overrides either way.
    """
    if os.environ.get("PSIM_DENSE") == "0":
        return False
    if os.environ.get("PSIM_DENSE") == "1":
        return True
    return jax.default_backend() != "cpu"


class Engine:
    """Single-chip engine: init, jitted run loop, result extraction.

    Fast precision auto-selects a tile implementation on an accelerator
    (census routing below) with occupancy-adaptive tile capacity;
    overflow triggers a transparent retry at grown capacity, falling back
    to the XLA sweep beyond ``dense_xla.MAX_XLA_KCAP``.
    """

    def __init__(self, config: SimConfig, kcap: int | None = None,
                 use_dense: bool | None = None,
                 impl: str | None = None):
        self.config = config
        # Persistent XLA compilation cache: identical (program, backend)
        # re-runs skip the compile (utils/compile_cache.py;
        # PSIM_COMPILE_CACHE=0 opts out).
        compile_cache.enable()
        self._impl_auto = False
        self._tier_plan = None  # (k_small, k_big, fatcap) for impl="tiered"
        self._band_plan = None  # [(row0, rows, kcap), ...] for impl="banded"
        self._hcap = None       # compact-collision flagged-slot capacity
        self._collide_mode = None  # None = resolve from PSIM_COLLIDE
        self._fused_off = False  # SHIP_OVF retry disables the fused step
        if config.precision is Precision.PARITY:
            if not jax.config.jax_enable_x64:
                raise RuntimeError(
                    "parity precision requires jax_enable_x64 "
                    "(see utils.runtime.ensure_parity_runtime)")
            self.dtype = jnp.float64
            self.impl = "sweep"
        else:
            self.dtype = jnp.float32
            if impl is None:
                impl = os.environ.get("PSIM_IMPL")
            if impl is None and use_dense is not None:
                impl = "dense" if use_dense else "sweep"
            self._impl_auto = impl is None
            if impl is None:
                # Sparse-grid regime (grid ≫ particles, the reference's
                # SMALL workload): per-cell tiles pay ncells·K padded
                # slots; super-cell tiles merge S×S cells per row so
                # tile count tracks particles, not cells. Dense regimes
                # stay on per-cell resident tiles; tiny grids fall back
                # to the sweep.
                avg = config.n_particles / max(1, config.ncells)
                if _use_dense_default() and avg >= 1.5:
                    impl = "resident"
                else:
                    from particlesimulation_tpu.ops.supercell import (
                        choose_supercell_factor)
                    s = choose_supercell_factor(config)
                    impl = "supercell" if (_use_dense_default()
                                           and s is not None) else "sweep"
            if impl not in ("resident", "dense", "sweep", "supercell",
                            "tiered", "banded"):
                raise ValueError(
                    f"unknown impl {impl!r}; "
                    "valid: resident, dense, sweep, supercell, tiered, "
                    "banded")
            self.impl = impl
        if kcap is None and os.environ.get("PSIM_KCAP"):
            # Tuning override: pair cost scales with kcap x kb and every
            # tile traversal with kcap; the lossless retry ladder still
            # covers occupancy overflow (at the cost of a recompile).
            kcap = int(os.environ["PSIM_KCAP"])
        self.kcap = kcap
        self._built_key = None
        self._step = None
        self._run = None

    @property
    def use_dense(self) -> bool:
        return self.impl in ("dense", "resident", "supercell", "tiered",
                             "banded")

    def _supercell_factor(self) -> int:
        if getattr(self, "_sc_factor", None) is None:
            if os.environ.get("PSIM_SC_FACTOR"):
                # Tuning override for A/B sweeps.
                self._sc_factor = int(os.environ["PSIM_SC_FACTOR"])
                return self._sc_factor
            from particlesimulation_tpu.ops.supercell import (
                choose_supercell_factor)
            s = choose_supercell_factor(self.config)
            if s is None:
                # Explicitly requested supercell on an unsuited shape:
                # coarsen as far as the grid allows.
                s = max(2, self.config.ncside // 8)
            self._sc_factor = s
        return self._sc_factor

    def _sc_rows(self) -> int:
        nsc = -(-self.config.ncside // self._supercell_factor())
        return nsc * nsc

    # -- build ------------------------------------------------------------

    @staticmethod
    def _round_cap(x: float) -> int:
        # Pair-pass cost scales with kcap², so size tiles snugly: any
        # multiple of 32 works for the XLA pair passes.
        return max(32, (int(x) + 31) // 32 * 32)

    def _heuristic_kcap(self) -> int:
        # Poisson-tail bound on max cell occupancy for near-uniform loads;
        # the in-graph overflow check + lossless retry covers clustered
        # ones. Sized snugly (4.5 sigma + 8): every tile traversal scales
        # with kcap and the pair pass with kcap x kb, and an occupancy
        # miss only costs a lossless retry at the next 32-multiple.
        rows = (self._sc_rows() if self.impl == "supercell"
                else max(1, self.config.ncells))
        avg = max(1.0, self.config.n_particles / rows)
        bound = avg + 4.5 * avg ** 0.5 + 8
        return min(self._round_cap(bound), self._max_kcap())

    def _max_kcap(self) -> int:
        # The lax.map bodies chunk (CB, ichunk, K) and scale CB down with
        # K, so high-occupancy grids (reference MEDIUM: k≈2500) stay dense
        # instead of dropping to the sweep.
        return dmod.MAX_XLA_KCAP

    def _default_tier_plan(self):
        # No census available (state not from init_state): Poisson k_small
        # for the bulk plus a generous top class; the lossless retry
        # ladder refines. Plan format: [(cap, rows), ...], rows_0=ncells.
        ks = self._heuristic_kcap()
        kb = min(max(4 * ks, 256), self._max_kcap())
        fatrows = self._round_cap(max(self.config.ncells // 16, 32))
        if kb <= ks:
            kb = self._round_cap(ks + 32)
        return ((ks, self.config.ncells), (kb, fatrows))

    def _build(self):
        if self.impl == "banded":
            if self._band_plan is None:
                # No census available: one whole-grid band (== resident
                # economics); init_state or the caller provides real plans.
                self._band_plan = ((0, self.config.ncside,
                                    self._heuristic_kcap()),)
            self._band_plan = tuple(tuple(p) for p in self._band_plan)
            self.kcap = max(k for _, _, k in self._band_plan)
            if self.kcap > self._max_kcap():
                self.impl = "dense"
                self._band_plan = None
                self.kcap = None
        if self.impl == "tiered":
            if self._tier_plan is None:
                self._tier_plan = self._default_tier_plan()
            self._tier_plan = tuple(tuple(p) for p in self._tier_plan)
            self.kcap = self._tier_plan[-1][0]  # telemetry: top cap
            if self.kcap > self._max_kcap():
                self.impl = "dense"
                self._tier_plan = None
                self.kcap = None
        if self.use_dense:
            if self.kcap is None:
                self.kcap = self._heuristic_kcap()
            if self.impl == "supercell":
                # The epilogue compaction needs rows*kcap >= N slots.
                need = (-(-self.config.n_particles // self._sc_rows())
                        + 8)
                self.kcap = max(self.kcap, self._round_cap(need))
            if self.kcap > self._max_kcap():
                self.impl = "sweep"
        # Resolve the env-driven collision knobs NOW and key the build on
        # the resolved values: PSIM_COLLIDE/PSIM_HCAP flips between run()
        # calls on a live Engine must trigger a rebuild, not silently
        # reuse the previously compiled mode/hcap (advisor, round 4).
        if self.impl in ("resident", "banded"):
            eff_collide = (self._collide_mode
                           or dmod.resolve_collide_mode())
            eff_hcap = (self._hcap if self._hcap is not None
                        else dmod.default_hcap())
        else:
            eff_collide, eff_hcap = None, None
        # Band-major fused step (ops/banded.make_banded_run(fused=True)):
        # default OFF — it costs about 4x the compile time of the
        # phase-major general step and its speed on this card is not
        # measured. PSIM_BANDED_FUSED=1 opts in; a SHIP_OVF retry (see
        # run()) sets _fused_off for this engine. Resolved here so env
        # flips rebuild.
        eff_fused = (self.impl == "banded"
                     and not self._fused_off
                     and os.environ.get("PSIM_BANDED_FUSED", "0") == "1")
        key = (self.impl, self.kcap if self.use_dense else None,
               self._tier_plan if self.impl == "tiered" else None,
               self._band_plan if self.impl == "banded" else None,
               eff_hcap, eff_collide, eff_fused)
        if self._built_key == key and self._run is not None:
            return
        if self.impl == "banded":
            from particlesimulation_tpu.ops.banded import make_banded_run
            step, prologue, run = make_banded_run(
                self.config, self._band_plan,
                hcap=eff_hcap, collide_mode=eff_collide, fused=eff_fused)
            self._run = jax.jit(run)
            self._step = lambda st: run(st, 1)
        elif self.impl == "tiered":
            from particlesimulation_tpu.ops.tiered import make_tiered_step
            step, build_tiles, run = make_tiered_step(
                self.config, self._tier_plan)
            self._step = lambda st: step(st, build_tiles(st))[0]
            self._run = jax.jit(run)
        elif self.impl == "resident":
            step, prologue, run = make_resident_run(
                self.config, self.kcap,
                hcap=eff_hcap, collide_mode=eff_collide)
            self._run = jax.jit(run)
            self._step = lambda st: run(st, 1)
        elif self.impl == "supercell":
            from particlesimulation_tpu.ops.supercell import (
                make_supercell_run)
            step, prologue, run = make_supercell_run(
                self.config, self.kcap, self._supercell_factor())
            self._run = jax.jit(run)
            self._step = lambda st: run(st, 1)
        elif self.impl == "dense":
            step, build_tiles, run = make_dense_step(
                self.config, self.kcap)
            self._step = lambda st: step(st, build_tiles(st))[0]
            self._run = jax.jit(run)
        else:
            self._step = make_step(self.config)
            self._run = jax.jit(
                lambda s, nsteps: jax.lax.fori_loop(
                    0, nsteps, lambda i, st: self._step(st), s))
        self._built_key = key

    # -- API ---------------------------------------------------------------

    def init_state(self) -> SimState:
        """Host-side initial conditions, cast and pre-sorted by cell key."""
        cfg = self.config
        xs, ys, vxs, vys, ms = init_particles_host(cfg)
        n = cfg.n_particles
        if self.use_dense and self.kcap is None:
            # Occupancy-informed tile capacity (host-side, no readback).
            w = cfg.side / cfg.ncside
            cx = np.clip((xs / w).astype(np.int64), 0, cfg.ncside - 1)
            cy = np.clip((ys / w).astype(np.int64), 0, cfg.ncside - 1)
            if self.impl == "supercell":
                s = self._supercell_factor()
                nsc = -(-cfg.ncside // s)
                occ = np.bincount((cy // s) * nsc + (cx // s),
                                  minlength=nsc * nsc).max()
            else:
                hist = np.bincount(cy * cfg.ncside + cx,
                                   minlength=cfg.ncells)
                occ = hist.max()
                if self.impl == "banded" and self._band_plan is None:
                    from particlesimulation_tpu.ops.banded import plan_bands
                    bp = plan_bands(hist, cfg.ncside, self._max_kcap())
                    self._band_plan = (tuple(tuple(p) for p in bp) if bp
                                       else None)
                from particlesimulation_tpu.ops.tiered import plan_tiers
                plan = plan_tiers(hist, cfg.ncells, self._max_kcap())
                if self.impl == "tiered" or (
                        self._impl_auto and plan is not None
                        and plan[-1][0] >= 2 * plan[0][0]):
                    # Clustered occupancy (a hot cell ≫ the distribution's
                    # bulk): classed tiles stop the hot cell from taxing
                    # every cell's pair pass. PSIM_CLUSTERED_IMPL selects
                    # the clustered engine for the auto route (banded =
                    # row-banded resident, ops/banded.py, the default;
                    # tiered = classed dense, ops/tiered.py, the cheapest
                    # first compile).
                    pick = (self.impl if self.impl == "tiered" else
                            os.environ.get("PSIM_CLUSTERED_IMPL", "banded"))
                    if pick == "banded":
                        from particlesimulation_tpu.ops.banded import (
                            plan_bands)
                        bp = plan_bands(hist, cfg.ncside, self._max_kcap())
                        if bp is not None:
                            self.impl = "banded"
                            self._band_plan = tuple(tuple(p) for p in bp)
                        else:
                            pick = "tiered"  # spatially incoherent cluster
                    if pick == "tiered":
                        self.impl = "tiered"
                        self._tier_plan = plan or self._default_tier_plan()
                if self._impl_auto and self.impl == "resident":
                    # Streaming route for large *uniform* loads: above
                    # PSIM_STREAM_BYTES of tile state the grid is split
                    # into uniform row bands of about PSIM_STREAM_BAND_BYTES
                    # each, so every band's passes work on a smaller live
                    # set. Both thresholds (256 MiB / 40 MiB) are untuned
                    # defaults carried over from the first target; they
                    # have not been tuned on the H100 (its nearest
                    # analogue is the 50 MB L2).
                    kcap_est = min(self._round_cap(occ * 1.1 + 4),
                                   self._max_kcap())
                    row_bytes = cfg.ncside * kcap_est * 25
                    total = cfg.ncells * kcap_est * 25
                    stream_bytes = int(os.environ.get(
                        "PSIM_STREAM_BYTES", str(256 << 20)))
                    band_bytes = int(os.environ.get(
                        "PSIM_STREAM_BAND_BYTES", str(40 << 20)))
                    if total > stream_bytes:
                        band_rows = max(1, band_bytes // max(1, row_bytes))
                        if -(-cfg.ncside // band_rows) >= 2:
                            from particlesimulation_tpu.ops.banded import (
                                uniform_band_plan)
                            self.impl = "banded"
                            self._band_plan = uniform_band_plan(
                                cfg.ncside, band_rows, kcap_est)
            # Snug slack (see _heuristic_kcap): pair-pass cost scales with
            # kcap x kb, and overflow retries are lossless.
            self.kcap = min(self._round_cap(occ * 1.1 + 4),
                            self._max_kcap())
        ctype = (jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
        state = SimState(
            x=jnp.asarray(xs, self.dtype),
            y=jnp.asarray(ys, self.dtype),
            vx=jnp.asarray(vxs, self.dtype),
            vy=jnp.asarray(vys, self.dtype),
            m=jnp.asarray(ms, self.dtype),
            alive=jnp.ones(n, dtype=bool),
            pid=jnp.arange(n, dtype=jnp.int32),
            collisions=jnp.zeros((), dtype=ctype),
            panics=jnp.zeros((), dtype=jnp.int32),
            overflow=jnp.zeros((), dtype=jnp.int32),
        )
        key, _ = binning.cell_keys(state.x, state.y, cfg.side, cfg.ncside)
        key, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key, state.pid, state.x, state.y, state.vx, state.vy,
            state.m, state.alive)
        return state._replace(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive,
                              pid=pid)

    def run(self, state: SimState, n_steps: int) -> SimState:
        for _attempt in range(6):
            self._build()
            if self.use_dense:
                state_in = state._replace(
                    overflow=jnp.zeros((), dtype=jnp.int32))
            else:
                state_in = state
            out = self._run(state_in, jnp.int32(n_steps))
            jax.block_until_ready(out)
            if not self.use_dense:
                np.asarray(out.collisions)
                if int(np.asarray(out.overflow)) >= int(RANK_OVF):
                    raise RuntimeError(
                        "collision rank overflow: a cell exceeded 65534 "
                        "occupants; uint32 pair ranks cannot order its "
                        "collision set")
                return out
            need = int(np.asarray(out.overflow))
            if need == 0:
                return out
            if int(HIT_OVF) <= need < int(RANK_OVF):
                # Compact-collision hit capacity outgrown: more slots
                # flagged than hcap in some step. Grow and replay
                # losslessly (plans/kcap untouched — this is orthogonal
                # to tile occupancy). A collision storm that would need
                # an O(H²) pass beyond HCAP_MAX drops back to the blocked
                # rank machinery instead (exact either way).
                HCAP_MAX = int(os.environ.get("PSIM_HCAP_MAX", "8192"))
                need_h = need - int(HIT_OVF)
                cur = self._hcap if self._hcap is not None else (
                    dmod.default_hcap())
                grown = max(cur * 4,
                            1 << max(4, (need_h - 1).bit_length()))
                if grown > HCAP_MAX or need_h >= int(HIT_OVF) - 1:
                    self._collide_mode = "block"
                else:
                    self._hcap = grown
                continue
            from particlesimulation_tpu.ops.banded import SHIP_OVF
            if (self.impl == "banded"
                    and int(SHIP_OVF) <= need < int(HIT_OVF)):
                # Fused-step ship pending: a mover crossed >1 band
                # boundary in one step, beyond the fused step's single
                # unrolled exchange. Replay on the general while_loop
                # shipping step (plans/kcap untouched) — lossless.
                self._fused_off = True
                continue
            if self.impl == "banded":
                # Band overflow (tile occupancy, halo merge, or ship cap):
                # grow every band's capacity and replay losslessly; if
                # growth stops converging, the resident/dense ladder has
                # no banding assumptions to violate.
                from particlesimulation_tpu.ops.banded import grow_plan
                self._band_plan = tuple(
                    tuple(p) for p in grow_plan(self._band_plan, 1.5,
                                                self._max_kcap()))
                self.kcap = max(k for _, _, k in self._band_plan)
                if _attempt >= 2:
                    self.impl = "dense"
                    self._band_plan = None
                    self.kcap = None
                continue
            if self.impl == "tiered":
                # Negative need = worst class row-budget deficit (grow
                # every class's rows — occupancy drifted between classes),
                # positive = a cell outgrew the top cap (ops/tiered.py).
                plan = [list(p) for p in self._tier_plan]
                if need < 0:
                    for t in range(1, len(plan)):
                        plan[t][1] = self._round_cap(
                            plan[t][1] * 1.5 + (-need) * 1.3)
                else:
                    plan[-1][0] = max(self._round_cap(need * 1.25 + 1),
                                      self._round_cap(plan[-1][0] * 1.5))
                kb = plan[-1][0]
                self._tier_plan = tuple(tuple(p) for p in plan)
                if _attempt >= 2 or kb > self._max_kcap():
                    # Re-planning isn't converging — the occupancy
                    # distribution drifted past the census; single-tier
                    # dense re-censuses from scratch.
                    self.impl = "dense"
                    self._tier_plan = None
                    self.kcap = None
                continue
            # Occupancy outgrew the tiles: retry from the input state with
            # tiles sized to the observed occupancy (the reference
            # PANIC-skips particles in its analogous situation; here the run
            # is replayed losslessly). Beyond the tile cap the engine
            # escalates: resident -> dense -> sweep.
            self.kcap = max(self._round_cap(need * 1.25 + 1),
                            self._round_cap(self.kcap * 1.5))
            if self.impl == "resident" and _attempt >= 2:
                # Capacity growth isn't helping — probe-delivery is the
                # bottleneck (pathological clustering); the dense impl has
                # no delivery step.
                self.impl = "dense"
                self.kcap = None
            elif self.impl == "supercell" and _attempt >= 2:
                # Pathological clustering at super-cell granularity: the
                # sorted sweep has no tile capacity to outgrow.
                self.impl = "sweep"
            elif self.kcap > self._max_kcap():
                if self.impl == "resident":
                    self.impl = "dense"
                    self.kcap = None
                else:
                    self.impl = "sweep"
        raise RuntimeError("tile capacity retries exhausted")

    def result(self, state: SimState) -> tuple[float, float, int]:
        from particlesimulation_tpu.state import result_of
        return result_of(state)

    def run_debug(self, state: SimState, n_steps: int):
        """Unjitted per-step execution for step-diff debugging."""
        self._build()
        for _ in range(n_steps):
            state = self._step(state)
        return jax.block_until_ready(state)
