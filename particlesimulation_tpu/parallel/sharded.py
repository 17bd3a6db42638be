"""Row-sharded simulation engine over a 1D device mesh.

Spatial decomposition identical in spirit to the reference MPI variant
(reference mpi/parsim-mpi.cpp:330-465): the ``ncside`` grid rows are split
into contiguous blocks, one per mesh device; each device owns the particles
whose current cell row falls in its block. Per step, inside one
``shard_map``-wrapped program:

* local binning/COM over the shard's row block;
* a one-row COM halo travels to each ring neighbor via ``lax.ppermute``
  (the reference's Isend/Irecv ghost exchange, mpi/parsim-mpi.cpp:670-815 —
  only monopole data ever crosses shards, never particle bodies);
* forces/integration run locally against the halo-padded stencil;
* emigrants ride a fixed-capacity ring buffer for D-1 ``ppermute`` hops
  (the reference's Alltoall + point-to-point migration,
  mpi/parsim-mpi.cpp:512-600), landing in free slab slots;
* the collision count is ``lax.psum``'d (the reference's MPI_Reduce,
  mpi/parsim-mpi.cpp:1098-1099).

Because each cell lives wholly on one shard, per-cell arithmetic order is
identical to the single-chip engine — in f64 parity mode the sharded run is
*bitwise* equal to the single-chip run, which the test suite asserts. The
reference could only claim 1e-3 agreement between its variants; here the
decomposition changes communication, not math.

Row decomposition is *balanced-uneven*: any ``n_shards ≤ ncside`` works.
The first ``rows_rem`` shards own ``rows_base+1`` rows, the rest
``rows_base`` (the reference floors rows_per_proc and dumps the whole
remainder on the last rank, mpi/parsim-mpi.cpp:338-342). shard_map needs one
static shape, so every shard's local COM grid is ``rows_max`` tall and a
shard with fewer rows leaves its tail rows empty; the bottom halo row is
placed at the dynamic per-shard position ``rows_mine+1``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from particlesimulation_tpu.config import DELTAT, EPSILON, Precision, SimConfig
from particlesimulation_tpu.initializer import init_particles_host
from particlesimulation_tpu.ops import binning, collisions, com, forces, integrate
from particlesimulation_tpu.ops.stencil import STENCIL
from particlesimulation_tpu.state import ShardedState

AXIS = "rows"

# Overflow-cause sentinels. ``ShardedState.overflow`` combines causes via
# ``maximum``, so the largest sentinel present wins and the engine's retry
# ladder dispatches on ranges: values below CAP_OVF are tile-occupancy /
# migration counts (fixable by growing the resident kcap or the sweep
# migration buffer); CAP_OVF+deficit means a slab ran out of slots (grow
# shard capacity and replay); STRAY_OVF means the slab invariant was
# violated (a particle outside its owner's rows) — not capacity-fixable.
CAP_OVF = 1 << 28
STRAY_OVF = 1 << 29


def _ring_perm(d: int, shift: int):
    return [(i, (i + shift) % d) for i in range(d)]


def stencil_tables_halo(Mp, MXp, MYp, side: float, ncside: int,
                        rows_local: int, row0):
    """Monopole stencil tables for a halo-padded local COM grid.

    Mp/MXp/MYp: (rows_local+2, ncside); row 0 is the global row row0-1
    (wrapped), row rows_local+1 is global row row0+rows_local. Mirror offsets
    are applied by the *consumer* from global coordinates, so halo payloads
    are raw COM data (as in the reference, where ghosts carry plain COM and
    the mirror is resolved at force time, mpi/parsim-mpi.cpp:874-935).
    Returns (ml, mxl, myl): each (8, rows_local*ncside + 1) with a zero
    sentinel column.
    """
    dt = MXp.dtype
    nc = ncside
    side_a = jnp.asarray(side, dt)
    cx = jnp.arange(nc, dtype=jnp.int32)[None, :]
    gy = row0 + jnp.arange(rows_local, dtype=jnp.int32)[:, None]  # global row

    ml, mxl, myl = [], [], []
    for dx, dy in STENCIL:
        rows = jax.lax.dynamic_slice_in_dim(Mp, 1 + dy, rows_local, axis=0)
        rowsx = jax.lax.dynamic_slice_in_dim(MXp, 1 + dy, rows_local, axis=0)
        rowsy = jax.lax.dynamic_slice_in_dim(MYp, 1 + dy, rows_local, axis=0)
        rm = jnp.roll(rows, -dx, axis=1)
        rmx = jnp.roll(rowsx, -dx, axis=1)
        rmy = jnp.roll(rowsy, -dx, axis=1)
        if dx == 1:
            offx = jnp.where(cx == nc - 1, side_a, jnp.asarray(0.0, dt))
        elif dx == -1:
            offx = jnp.where(cx == 0, -side_a, jnp.asarray(0.0, dt))
        else:
            offx = jnp.zeros((1, 1), dt)
        # Mirror in y only where the *global* neighbor row wraps.
        if dy == 1:
            offy = jnp.where(gy + 1 >= nc, side_a, jnp.asarray(0.0, dt))
        elif dy == -1:
            offy = jnp.where(gy - 1 < 0, -side_a, jnp.asarray(0.0, dt))
        else:
            offy = jnp.zeros((1, 1), dt)
        ml.append(jnp.broadcast_to(rm, (rows_local, nc)).reshape(-1))
        mxl.append((offx + rmx).reshape(-1))
        myl.append((offy + rmy).reshape(-1))

    pad = jnp.zeros((8, 1), dtype=dt)
    return (jnp.concatenate([jnp.stack(ml), pad], axis=1),
            jnp.concatenate([jnp.stack(mxl), pad], axis=1),
            jnp.concatenate([jnp.stack(myl), pad], axis=1))


def make_sharded_step(config: SimConfig, mesh: Mesh, cap: int | None = None,
                      bcap: int | None = None):
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    d = config.n_shards
    rows_max = config.rows_max
    ncells_local = rows_max * nc
    cap = cap or config.resolved_shard_capacity()
    bcap = bcap or config.resolved_migration_capacity()
    parity = config.precision is Precision.PARITY
    empty_key = jnp.int32(ncells + 1)

    def slab_key(x, y, valid):
        key, in_range = binning.cell_keys(x, y, side, nc)
        key = jnp.where(valid, key, empty_key)
        return key, in_range

    def local_step(state: ShardedState) -> ShardedState:
        me = jax.lax.axis_index(AXIS)
        row0 = config.row0_of_shard(me).astype(jnp.int32)
        rows_mine = config.rows_of_shard(me).astype(jnp.int32)
        x, y, vx, vy, m = state.x, state.y, state.vx, state.vy, state.m
        alive, valid, pid = state.alive, state.valid, state.pid

        # ---- binning (slab arrives sorted by this key) ----
        key, _ = slab_key(x, y, valid)
        pos, _ = binning.segment_positions(key)
        kmax = binning.max_occupancy(pos, key < ncells)
        lk = jnp.where(key < ncells, key - row0 * nc, jnp.int32(ncells_local))

        # ---- local COM over the row block ----
        if parity:
            M, MX, MY = com.com_parity(lk, x, y, m, ncells_local)
        else:
            M, MX, MY = com.com_fast(lk, x, y, m, ncells_local)
        M2 = M.reshape(rows_max, nc)
        MX2 = MX.reshape(rows_max, nc)
        MY2 = MY.reshape(rows_max, nc)

        # ---- COM halo ring (reference ghost exchange P3) ----
        # "My last row" is the last *owned* row (dynamic under the uneven
        # decomposition); "my first row" is always local row 0.
        def last_row(A):
            return jax.lax.dynamic_slice_in_dim(A, rows_mine - 1, 1,
                                                axis=0)[0]

        if d > 1:
            down = _ring_perm(d, 1)    # my last row -> next shard's top halo
            up = _ring_perm(d, -1)     # my first row -> prev shard's bottom halo
            top = jax.lax.ppermute((last_row(M2), last_row(MX2),
                                    last_row(MY2)), AXIS, down)
            bot = jax.lax.ppermute((M2[0], MX2[0], MY2[0]), AXIS, up)
        else:
            top = (last_row(M2), last_row(MX2), last_row(MY2))
            bot = (M2[0], MX2[0], MY2[0])
        # Padded grid: row 0 = top halo, rows 1..rows_max = mine, and the
        # bottom halo lands at the dynamic row rows_mine+1 (overwriting an
        # empty tail row when this shard owns fewer than rows_max rows).
        zrow = jnp.zeros((1, nc), M2.dtype)

        def padded(A, halo_top, halo_bot):
            Ap = jnp.concatenate([halo_top[None], A, zrow], axis=0)
            return jax.lax.dynamic_update_slice_in_dim(
                Ap, halo_bot[None], rows_mine + 1, axis=0)

        Mp = padded(M2, top[0], bot[0])
        MXp = padded(MX2, top[1], bot[1])
        MYp = padded(MY2, top[2], bot[2])

        # ---- forces ----
        ml, mxl, myl = stencil_tables_halo(Mp, MXp, MYp, side, nc,
                                           rows_max, row0)
        if parity:
            fx, fy = forces.pairwise_forces_parity(x, y, m, alive, key, kmax,
                                                   ncells)
        else:
            fx, fy = forces.pairwise_forces_fast(x, y, m, alive, key, kmax,
                                                 ncells)
        fx, fy = forces.monopole_forces(x, y, m, alive, lk, fx, fy,
                                        ml, mxl, myl, ncells_local, parity)

        # ---- integrate + wrap ----
        x, y, vx, vy = integrate.integrate(x, y, vx, vy, m, fx, fy, side,
                                           DELTAT)

        # ---- migration (reference P4) ----
        key2, _ = slab_key(x, y, valid)
        new_row = jnp.where(key2 < ncells, key2 // nc, jnp.int32(0))
        dest = jnp.where(key2 < ncells,
                         config.shard_of_row(new_row, jnp), me)
        dest = jnp.where(valid, dest, me)
        emig = valid & (dest != me)
        n_emig = jnp.sum(emig, dtype=jnp.int32)
        overflow = jnp.maximum(n_emig - bcap, 0)

        # Pack emigrants (slab order) into the ring buffer.
        order = jnp.argsort(~emig, stable=True)
        take = order[:bcap]
        bvalid = emig[take]
        buf = {
            "x": x[take], "y": y[take], "vx": vx[take], "vy": vy[take],
            "m": m[take], "alive": alive[take], "pid": pid[take],
            "dest": dest[take], "valid": bvalid,
        }
        valid = valid & ~emig

        def accept(slab, buf):
            (x, y, vx, vy, m, alive, valid, pid) = slab
            arr = buf["valid"] & (buf["dest"] == me)
            n_arr = jnp.sum(arr, dtype=jnp.int32)
            # Arrivals first, in buffer order.
            aorder = jnp.argsort(~arr, stable=True)
            free = ~valid
            slot_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
            gather = jnp.minimum(jnp.maximum(slot_rank, 0), bcap - 1)
            fill = free & (slot_rank < n_arr)
            ovf = jnp.maximum(n_arr - jnp.sum(free, dtype=jnp.int32), 0)

            def put(sl, bu):
                return jnp.where(fill, bu[aorder][gather], sl)

            slab = (put(x, buf["x"]), put(y, buf["y"]),
                    put(vx, buf["vx"]), put(vy, buf["vy"]),
                    put(m, buf["m"]),
                    jnp.where(fill, buf["alive"][aorder][gather], alive),
                    valid | fill,
                    jnp.where(fill, buf["pid"][aorder][gather], pid))
            buf = dict(buf)
            buf["valid"] = buf["valid"] & ~arr
            return slab, buf, ovf

        slab = (x, y, vx, vy, m, alive, valid, pid)
        if d > 1:
            # Ring-forward until every emigrant has landed; a psum-gated
            # while_loop pays one hop when only ring neighbors are involved
            # (the physical common case: particles cross one row boundary)
            # and zero collective work happens on quiet steps beyond the
            # pending-count psum. Skipped hops forwarded an all-invalid
            # buffer and accepted nothing, so trajectories are bit-identical
            # to the unconditional D-1-hop formulation. The reference pays
            # one Alltoall every step regardless (mpi/parsim-mpi.cpp:536).
            fwd = _ring_perm(d, 1)
            pending0 = jax.lax.psum(
                jnp.sum(buf["valid"], dtype=jnp.int32), AXIS)

            def mig_cond(c):
                _, _, _, pending, hop = c
                return (pending > 0) & (hop < d - 1)

            def mig_body(c):
                slab, buf, overflow, _, hop = c
                buf = jax.lax.ppermute(buf, AXIS, fwd)
                slab, buf, ovf = accept(slab, buf)
                pending = jax.lax.psum(
                    jnp.sum(buf["valid"], dtype=jnp.int32), AXIS)
                return slab, buf, overflow + ovf, pending, hop + 1

            slab, buf, overflow, _, _ = jax.lax.while_loop(
                mig_cond, mig_body,
                (slab, buf, overflow, pending0, jnp.int32(0)))
        (x, y, vx, vy, m, alive, valid, pid) = slab

        # Cleared slots hold inert values (m=0 freezes them everywhere).
        x = jnp.where(valid, x, 0.0).astype(x.dtype)
        y = jnp.where(valid, y, 0.0).astype(y.dtype)
        m = jnp.where(valid, m, 0.0).astype(m.dtype)
        alive = alive & valid

        # ---- post-move sort + collisions (the one sort per step) ----
        key3, in_range3 = slab_key(x, y, valid)
        key3, pid, x, y, vx, vy, m, alive, valid = binning.sort_by_cell(
            key3, pid, x, y, vx, vy, m, alive, valid)
        pos3, _ = binning.segment_positions(key3)
        kmax3 = binning.max_occupancy(pos3, key3 < ncells)
        count, died = collisions.detect_collisions(
            x, y, alive, key3, pos3, kmax3, EPSILON, ncells)
        m, alive = collisions.apply_deaths(m, alive, died)

        total = jax.lax.psum(count, AXIS)
        panics = jax.lax.psum(
            jnp.sum(valid & ~in_range3, dtype=jnp.int32), AXIS)
        total_ovf = jax.lax.psum(overflow, AXIS)

        return ShardedState(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, valid=valid, pid=pid,
            collisions=state.collisions + total.astype(state.collisions.dtype),
            panics=state.panics + panics,
            overflow=state.overflow + total_ovf,
        )

    spec_arr = P(AXIS)
    spec_scalar = P()
    specs = ShardedState(
        x=spec_arr, y=spec_arr, vx=spec_arr, vy=spec_arr, m=spec_arr,
        alive=spec_arr, valid=spec_arr, pid=spec_arr,
        collisions=spec_scalar, panics=spec_scalar, overflow=spec_scalar)
    return jax.shard_map(local_step, mesh=mesh, in_specs=(specs,),
                         out_specs=specs)


class ShardedEngine:
    """Mesh-parallel engine with the same interface as the single-chip one.

    Two implementations:

    * ``sweep`` — sorted per-shard slabs, neighbor-offset force sweep. The
      f64 parity path (bitwise equal to single-chip; asserted in tests).
    * ``resident`` — slot-resident (local_cells, K) tiles with the fused
      pair kernels and halo-row migration (parallel/sharded_resident.py).
      The FAST-precision default: the same formulation as the
      single-chip resident engine.

    Tile-capacity overflow in the resident impl triggers a lossless retry
    with larger tiles, then escalation to the sweep impl — mirroring the
    single-chip engine's ladder.
    """

    def __init__(self, config: SimConfig, devices=None,
                 impl: str | None = None, kcap: int | None = None):
        self.config = config
        d = config.n_shards
        if devices is None:
            devices = jax.devices()[:d]
        if len(devices) < d:
            raise ValueError(f"need {d} devices, have {len(devices)}")
        self.mesh = Mesh(np.array(devices[:d]), (AXIS,))
        self._band_plan = None  # [(row0, rows, kcap), ...] for impl="banded"
        self._impl_auto = False
        self._sc_factor = None  # super-cell S for impl="supercell"
        if config.precision is Precision.PARITY:
            if not jax.config.jax_enable_x64:
                raise RuntimeError("parity precision requires jax_enable_x64")
            self.dtype = jnp.float64
            self.impl = "sweep"
        else:
            self.dtype = jnp.float32
            if impl is None:
                impl = os.environ.get("PSIM_SHARD_IMPL")
            self._impl_auto = impl is None
            if impl is None:
                # Census auto-routing, mirroring the single-chip engine
                # (engine.Engine.init_state): the sparse regime routes to
                # super-cell tiles here (config-static), the clustered
                # regime to banded in pack_particles (needs the census),
                # everything else stays resident. The reference runs every
                # workload distributed under the one binary
                # (mpi/run_tests.sh:8-16); auto-routing is how this
                # framework matches that without a flag.
                impl = "resident"
                avg = config.n_particles / max(1, config.ncells)
                if avg < 1.5:
                    from particlesimulation_tpu.ops.supercell import (
                        choose_supercell_factor)
                    from particlesimulation_tpu.parallel.sharded_supercell \
                        import supercell_shard_viable
                    s = choose_supercell_factor(config)
                    if supercell_shard_viable(config, s):
                        impl = "supercell"
                        self._sc_factor = s
            self.impl = impl
        # Banded decomposition variant: "cols" (column-sharded, the
        # default — see parallel/sharded_banded_cols.py for why it
        # composes) or "cyclic" (block-cyclic rows,
        # parallel/sharded_banded.py; kept selectable for A/B).
        self.banded_variant = os.environ.get("PSIM_BANDED_SHARD", "cols")
        if self.impl in ("banded-cols", "banded-cyclic"):
            self.banded_variant = self.impl.split("-", 1)[1]
            self.impl = "banded"
        if self.impl not in ("resident", "sweep", "banded", "supercell"):
            raise ValueError(
                f"unknown sharded impl {self.impl!r}; "
                f"valid: resident, sweep, banded, banded-cols, "
                f"banded-cyclic, supercell")
        if self.impl == "supercell" and self._sc_factor is None:
            # Explicitly requested: derive S; decline to resident when the
            # layout doesn't apply (non-divisor S or nsc < n_shards).
            from particlesimulation_tpu.ops.supercell import (
                choose_supercell_factor)
            from particlesimulation_tpu.parallel.sharded_supercell import (
                supercell_shard_viable)
            s = choose_supercell_factor(config)
            if s is not None and not supercell_shard_viable(config, s):
                # Try the largest divisor factor that keeps nsc >= d.
                s = next((f for f in range(s, 1, -1)
                          if config.ncside % f == 0
                          and config.ncside // f >= max(2, config.n_shards)),
                         None)
            if supercell_shard_viable(config, s):
                self._sc_factor = s
            else:
                self.impl = "resident"
        if self.banded_variant not in ("cols", "cyclic"):
            raise ValueError(
                f"unknown banded variant {self.banded_variant!r}; "
                f"valid: cols, cyclic")
        self.kcap = kcap
        self.capacity = (config.shard_capacity
                         or None)  # finalized at init_state from occupancy
        self.bcap = config.migration_capacity or None  # adaptive, see run()
        self._built_key = None
        self._step = None
        self._run = None

    @staticmethod
    def _round_cap(x: float) -> int:
        return max(32, (int(x) + 31) // 32 * 32)

    def _build(self):
        cap = self.capacity or self.config.resolved_shard_capacity()
        self.capacity = cap
        if self.impl == "resident" and self.kcap is None:
            # Snug Poisson-tail bound (engine._heuristic_kcap rationale:
            # measured 16% of the step at the bench shape; overflow
            # retries are lossless).
            avg = max(1.0, self.config.n_particles
                      / max(1, self.config.ncells))
            self.kcap = self._round_cap(avg + 4.5 * avg ** 0.5 + 8)
        if self.impl == "supercell" and self.kcap is None:
            s = self._sc_factor
            nsc = self.config.ncside // s
            avg = max(1.0, self.config.n_particles / max(1, nsc * nsc))
            self.kcap = self._round_cap(avg + 4.5 * avg ** 0.5 + 8)
        if self.impl == "banded":
            if self._band_plan is None:
                # No census (state not from init_state/pack_particles):
                # one whole-grid band at the Poisson cap — banded
                # mechanics, resident economics; real plans arrive
                # through pack_particles.
                avg = max(1.0, self.config.n_particles
                          / max(1, self.config.ncells))
                k = self.kcap or self._round_cap(avg + 4.5 * avg ** 0.5
                                                 + 8)
                self._band_plan = ((0, self.config.ncside, k),)
            self._band_plan = tuple(tuple(p) for p in self._band_plan)
            self.kcap = max(k for _, _, k in self._band_plan)
        if self.bcap is None:
            self.bcap = max(64, cap // 2)
        key = (self.impl, cap, self.bcap,
               self.kcap if self.impl in ("resident", "supercell") else None,
               self._band_plan if self.impl == "banded" else None,
               self.banded_variant if self.impl == "banded" else None,
               self._sc_factor if self.impl == "supercell" else None,
               self.config.row_starts)
        if self._built_key == key and self._run is not None:
            return
        if self.impl == "banded":
            if self.banded_variant == "cols":
                from particlesimulation_tpu.parallel.sharded_banded_cols \
                    import make_sharded_banded_cols_run
                self._run = make_sharded_banded_cols_run(
                    self.config, self.mesh, self._band_plan, cap)
            else:
                from particlesimulation_tpu.parallel.sharded_banded import (
                    make_sharded_banded_run)
                self._run = make_sharded_banded_run(
                    self.config, self.mesh, self._band_plan, cap)
            self._step = None
        elif self.impl == "resident":
            from particlesimulation_tpu.parallel.sharded_resident import (
                make_sharded_resident_run)
            self._run = make_sharded_resident_run(
                self.config, self.mesh, self.kcap, cap)
            self._step = None
        elif self.impl == "supercell":
            from particlesimulation_tpu.parallel.sharded_supercell import (
                make_sharded_supercell_run)
            self._run = make_sharded_supercell_run(
                self.config, self.mesh, self.kcap, cap, self._sc_factor)
            self._step = None
        else:
            self._step = make_sharded_step(self.config, self.mesh, cap,
                                           self.bcap)
            self._run = jax.jit(
                lambda s, nsteps: jax.lax.fori_loop(
                    0, nsteps, lambda i, st: self._step(st), s))
        self._built_key = key

    def _census_route(self, hist) -> None:
        """One-shot clustered/streaming census routing (auto impl only).

        The mesh analog of engine.Engine.init_state's routing: a hot cell
        >> the distribution's bulk routes to the banded engine — on the
        mesh, the column-sharded variant (parallel/sharded_banded_cols
        .py), whose band plan is the unquantized single-chip plan. The
        reference's UNEVEN workload under mpirun pays a ~2x row-split
        imbalance (CPD_2nd_delivery.pdf p.6); here ``UNEVEN --mesh D``
        lands on banded-cols with no --impl flag. Uniform loads whose
        per-shard resident tile state would exceed PSIM_STREAM_BYTES get
        uniform streaming bands instead (engine.Engine.init_state) —
        columns are the mesh axis, so the band plan composes unchanged.
        The sparse regime routed to supercell in __init__ (config-static).
        """
        if not self._impl_auto or self.impl != "resident":
            self._impl_auto = False
            return
        self._impl_auto = False
        cfg = self.config
        d = cfg.n_shards
        hist = np.asarray(hist)
        from particlesimulation_tpu.ops import dense_xla
        from particlesimulation_tpu.ops.tiered import plan_tiers
        tplan = plan_tiers(hist, cfg.ncells, dense_xla.MAX_XLA_KCAP)
        if tplan is not None and tplan[-1][0] >= 2 * tplan[0][0]:
            if self.banded_variant == "cols":
                from particlesimulation_tpu.ops.banded import plan_bands
                bp = plan_bands(hist, cfg.ncside, dense_xla.MAX_XLA_KCAP)
            else:
                from particlesimulation_tpu.ops.banded import (
                    plan_bands_cyclic)
                bp = plan_bands_cyclic(hist, cfg.ncside, d,
                                       dense_xla.MAX_XLA_KCAP)
            if bp is not None:
                self.impl = "banded"
                self._band_plan = tuple(tuple(p) for p in bp)
                return
        occ = int(hist.max()) if hist.size else 1
        kcap_est = self._round_cap(occ * 1.1 + 4)
        shard_bytes = cfg.ncells * kcap_est * 25 // d
        stream_bytes = int(os.environ.get(
            "PSIM_STREAM_BYTES", str(256 << 20)))
        band_bytes = int(os.environ.get(
            "PSIM_STREAM_BAND_BYTES", str(40 << 20)))
        if shard_bytes > stream_bytes:
            row_bytes = max(1, (cfg.ncside // max(1, d)) * kcap_est * 25)
            band_rows = max(1, band_bytes // row_bytes)
            if -(-cfg.ncside // band_rows) >= 2:
                from particlesimulation_tpu.ops.banded import (
                    uniform_band_plan)
                self.impl = "banded"
                self.banded_variant = "cols"
                self._band_plan = uniform_band_plan(
                    cfg.ncside, band_rows, kcap_est)

    def init_state(self, _host=None) -> ShardedState:
        """Host init, then scatter by owner row-block into per-shard slabs.

        The reference initializes everything on rank 0 with the shared RNG
        and distributes by ownership (mpi/parsim-mpi.cpp:344-349,406-465);
        the same split happens here on the host. ``_host`` lets a caller
        that already ran the initializer (Sharded2DEngine's census
        delegation) hand over its (x, y, vx, vy, m) arrays.
        """
        cfg = self.config
        xs, ys, vxs, vys, ms = (_host if _host is not None
                                else init_particles_host(cfg))
        n = cfg.n_particles
        if self._impl_auto:
            # Route BEFORE balance planning: clustered loads go banded
            # (which ignores row boundaries), so balance only plans for
            # loads that stay on the row-block impls.
            w = cfg.side / cfg.ncside
            hx = np.clip((np.asarray(xs) / w).astype(np.int64), 0,
                         cfg.ncside - 1)
            hy = np.clip((np.asarray(ys) / w).astype(np.int64), 0,
                         cfg.ncside - 1)
            self._census_route(np.bincount(hy * cfg.ncside + hx,
                                           minlength=cfg.ncells))
        if (not cfg.row_starts and cfg.n_shards > 1
                and self.impl not in ("banded", "supercell")
                and os.environ.get("PSIM_SHARD_BALANCE", "1") != "0"):
            # (banded skips this: the block-cyclic chunk map balances any
            # spatially coherent load by construction.)
            # Census-weighted row boundaries for clustered loads (the
            # planner declines uniform ones, keeping the balanced-uneven
            # default); see parallel/balance.py.
            from particlesimulation_tpu.parallel.balance import (
                plan_shard_rows)
            w = cfg.side / cfg.ncside
            cy = np.clip((np.asarray(ys) / w).astype(np.int64), 0,
                         cfg.ncside - 1)
            weights = np.bincount(cy, minlength=cfg.ncside)
            starts = plan_shard_rows(weights, cfg.n_shards)
            if starts is not None:
                import dataclasses
                cfg = dataclasses.replace(cfg, row_starts=starts)
                self.config = cfg
        particles = {
            "x": xs, "y": ys, "vx": vxs, "vy": vys, "m": ms,
            "alive": np.ones(n, dtype=bool),
            "pid": np.arange(n, dtype=np.int32),
        }
        return self.pack_particles(particles)

    def pack_particles(self, particles, collisions=0, panics=0,
                       dtype=None) -> ShardedState:
        """Scatter host particle arrays by owner row-block into slabs.

        ``particles`` maps x/y/vx/vy/m/alive/pid to equal-length host
        arrays. Also the checkpoint-restore repack path (a checkpoint from
        a different mesh width or capacity re-enters through here).
        """
        cfg = self.config
        d = cfg.n_shards
        dtype = dtype or self.dtype
        xs, ys = np.asarray(particles["x"]), np.asarray(particles["y"])
        w = cfg.side / cfg.ncside
        cx = (xs / w).astype(np.int32)
        cy = (ys / w).astype(np.int32)
        in_range = ((cx >= 0) & (cx < cfg.ncside) &
                    (cy >= 0) & (cy < cfg.ncside))
        row = np.clip(cy, 0, cfg.ncside - 1)
        self._census_route(np.bincount(
            row[in_range] * cfg.ncside
            + np.clip(cx[in_range], 0, cfg.ncside - 1),
            minlength=cfg.ncells))
        if self.impl == "banded":
            # Plan bands from this census. The "cols" variant shards
            # columns, so the band plan is the unquantized single-chip
            # plan (ops/banded.plan_bands); "cyclic" needs shard-
            # divisible band heights (plan_bands_cyclic). A declined
            # plan (uniform occupancy) falls back to the plain resident
            # impl — simpler and equal there.
            if self._band_plan is None:
                from particlesimulation_tpu.ops import dense_xla
                from particlesimulation_tpu.ops.banded import (
                    plan_bands, plan_bands_cyclic)
                hist = np.bincount(
                    row * cfg.ncside + np.clip(cx, 0, cfg.ncside - 1),
                    minlength=cfg.ncells)
                if self.banded_variant == "cols":
                    bp = plan_bands(hist, cfg.ncside,
                                    dense_xla.MAX_XLA_KCAP)
                else:
                    bp = plan_bands_cyclic(hist, cfg.ncside, d,
                                           dense_xla.MAX_XLA_KCAP)
                if bp is None:
                    self.impl = "resident"
                else:
                    self._band_plan = tuple(tuple(p) for p in bp)
        if self.impl == "banded" and self.banded_variant == "cols":
            from particlesimulation_tpu.parallel.sharded_banded_cols \
                import col_owner
            col = np.clip(cx, 0, cfg.ncside - 1)
            shard = np.where(in_range, col_owner(cfg.ncside, d, col), 0)
        elif self.impl == "banded":
            from particlesimulation_tpu.parallel.sharded_banded import (
                cyclic_owner_of_rows)
            shard = np.where(
                in_range,
                cyclic_owner_of_rows(self._band_plan, d, row), 0)
        elif self.impl == "supercell":
            from particlesimulation_tpu.parallel.sharded_supercell import (
                sc_row_starts)
            s = self._sc_factor
            nsc = cfg.ncside // s
            starts = np.asarray(sc_row_starts(nsc, d))
            scrow = np.clip(row // s, 0, nsc - 1)
            shard = np.where(
                in_range,
                np.clip(np.searchsorted(starts, scrow, side="right") - 1,
                        0, d - 1), 0)
        else:
            shard = np.where(in_range, cfg.shard_of_row(row), 0)

        counts = np.bincount(shard, minlength=d)
        if self.impl == "supercell" and self.kcap is None:
            s = self._sc_factor
            nsc = cfg.ncside // s
            occ = np.bincount(
                np.clip(cy // s, 0, nsc - 1) * nsc
                + np.clip(cx // s, 0, nsc - 1),
                minlength=nsc * nsc).max()
            self.kcap = self._round_cap(occ * 1.1 + 4)
        if self.impl == "resident" and self.kcap is None:
            # Occupancy-informed tile capacity (host-side, no readback);
            # overflow retries are lossless, so size snugly — pair-pass
            # cost scales with kcap².
            occ = np.bincount(
                np.clip(cy, 0, cfg.ncside - 1) * cfg.ncside
                + np.clip(cx, 0, cfg.ncside - 1),
                minlength=cfg.ncells).max()
            self.kcap = self._round_cap(occ * 1.1 + 4)
        if self.capacity is None:
            # Size slabs from actual initial occupancy with migration slack.
            need = int(counts.max() * 1.5) + 16
            self.capacity = max(need, cfg.resolved_shard_capacity())
        if int(counts.max()) > self.capacity:
            self.capacity = self._round_cap(counts.max() * 1.5 + 16)
        cap = self.capacity
        slabs = {k: np.zeros((d, cap), dtype=np.float64)
                 for k in ("x", "y", "vx", "vy", "m")}
        alive = np.zeros((d, cap), dtype=bool)
        valid = np.zeros((d, cap), dtype=bool)
        pids = np.full((d, cap), np.iinfo(np.int32).max, dtype=np.int32)
        for s in range(d):
            idx = np.nonzero(shard == s)[0]
            k = len(idx)
            for name in ("x", "y", "vx", "vy", "m"):
                slabs[name][s, :k] = np.asarray(particles[name])[idx]
            alive[s, :k] = np.asarray(particles["alive"])[idx]
            valid[s, :k] = True
            pids[s, :k] = np.asarray(particles["pid"])[idx]

        ctype = (jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
        sh = NamedSharding(self.mesh, P(AXIS))
        rep = NamedSharding(self.mesh, P())

        def dev(a, dt):
            return jax.device_put(
                jnp.asarray(a.reshape(d * cap), dtype=dt), sh)

        state = ShardedState(
            x=dev(slabs["x"], dtype), y=dev(slabs["y"], dtype),
            vx=dev(slabs["vx"], dtype), vy=dev(slabs["vy"], dtype),
            m=dev(slabs["m"], dtype),
            alive=dev(alive, bool), valid=dev(valid, bool),
            pid=dev(pids, jnp.int32),
            collisions=jax.device_put(
                jnp.asarray(collisions, dtype=ctype), rep),
            panics=jax.device_put(
                jnp.asarray(panics, dtype=jnp.int32), rep),
            overflow=jax.device_put(jnp.zeros((), dtype=jnp.int32), rep),
        )
        # Establish the sorted-slab invariant via one no-op-like sort.
        return self._presort(state)

    def _presort(self, state: ShardedState) -> ShardedState:
        cfg = self.config

        def local(st: ShardedState) -> ShardedState:
            key, _ = binning.cell_keys(st.x, st.y, cfg.side, cfg.ncside)
            key = jnp.where(st.valid, key, jnp.int32(cfg.ncells + 1))
            _, pid, x, y, vx, vy, m, alive, valid = binning.sort_by_cell(
                key, st.pid, st.x, st.y, st.vx, st.vy, st.m, st.alive,
                st.valid)
            return st._replace(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive,
                               valid=valid, pid=pid)

        spec_arr = P(AXIS)
        specs = ShardedState(
            x=spec_arr, y=spec_arr, vx=spec_arr, vy=spec_arr, m=spec_arr,
            alive=spec_arr, valid=spec_arr, pid=spec_arr,
            collisions=P(), panics=P(), overflow=P())
        f = jax.shard_map(local, mesh=self.mesh, in_specs=(specs,),
                          out_specs=specs)
        return jax.jit(f)(state)

    def _grow_state(self, state: ShardedState, new_cap: int) -> ShardedState:
        """Re-lay a slab state out at a larger per-shard capacity.

        New slots append at each shard's tail as invalid (sentinel-key,
        pid=INT32_MAX) entries, preserving the sorted-slab invariant.
        """
        d = self.config.n_shards
        old_cap = state.x.shape[0] // d
        if old_cap >= new_cap:
            return state
        sh = NamedSharding(self.mesh, P(AXIS))

        def grow(a, fill):
            h = np.asarray(a).reshape(d, old_cap)
            g = np.full((d, new_cap), fill, dtype=h.dtype)
            g[:, :old_cap] = h
            return jax.device_put(jnp.asarray(g.reshape(-1)), sh)

        return state._replace(
            x=grow(state.x, 0), y=grow(state.y, 0),
            vx=grow(state.vx, 0), vy=grow(state.vy, 0),
            m=grow(state.m, 0),
            alive=grow(state.alive, False), valid=grow(state.valid, False),
            pid=grow(state.pid, np.iinfo(np.int32).max))

    def run(self, state: ShardedState, n_steps: int) -> ShardedState:
        """Run ``n_steps``; overflow triggers a lossless capacity retry.

        Retry ladder (the run replays from the *input* state; nothing is
        ever dropped — the reference instead PANIC-skips or dies):

        * resident tile-occupancy overflow → grow ``kcap``; if growth
          stops converging, escalate to the sweep impl;
        * slab-capacity exhaustion (CAP_OVF, either impl) → grow the
          per-shard slab and replay;
        * sweep migration-buffer overflow → grow the slab (the migration
          buffer is sized from it) and replay;
        * a stray particle (STRAY_OVF) is an invariant violation → raise.

        The adapted ``impl``/``kcap``/``capacity`` stick for subsequent
        runs of this engine (deliberately: the workload has demonstrated
        the need; re-probing the failed config would recompile and refail).
        """
        for _attempt in range(8):
            if self.capacity is not None:
                state = self._grow_state(state, self.capacity)
            self._build()
            state_in = state._replace(
                overflow=jnp.zeros_like(state.overflow))
            out = self._run(state_in, jnp.int32(n_steps))
            jax.block_until_ready(out)
            need = int(np.asarray(out.overflow))
            if need == 0:
                return out
            if need >= int(STRAY_OVF):
                raise RuntimeError(
                    "sharded slab invariant violation: a particle sits "
                    "outside its owner shard's rows (not capacity-fixable)")
            if need >= int(CAP_OVF):
                deficit = need - int(CAP_OVF)
                cap = self.capacity or self.config.resolved_shard_capacity()
                self.capacity = self._round_cap(cap * 1.5 + deficit)
                continue
            if self.impl == "banded":
                # Tile/halo-lane overflow: grow every band's capacity and
                # replay; if growth stops converging, escalate to the
                # sweep impl — which uses block (not cyclic) ownership,
                # so the slab must be repacked.
                from particlesimulation_tpu.ops import dense_xla
                from particlesimulation_tpu.ops.banded import grow_plan
                self._band_plan = tuple(
                    tuple(p) for p in grow_plan(self._band_plan))
                if (_attempt >= 2
                        or max(k for _, _, k in self._band_plan)
                        > dense_xla.MAX_XLA_KCAP):
                    self.impl = "sweep"
                    self._built_key = None
                    g = self.gather(state)
                    state = self.pack_particles(
                        g, collisions=int(np.asarray(state.collisions)),
                        panics=int(np.asarray(state.panics)))
                continue
            if self.impl not in ("resident", "supercell"):
                # Sweep migration overflow: emigrant buffer (bcap) or
                # landing-slot exhaustion — grow both and replay.
                cap = self.capacity or self.config.resolved_shard_capacity()
                self.capacity = self._round_cap(cap * 1.5 + need)
                self.bcap = self._round_cap((self.bcap or 64) * 2 + need)
                continue
            # Resident/super-cell tile occupancy outgrew the grid: larger
            # tiles, sized to the observed occupancy when it exceeds
            # plain growth.
            self.kcap = max(self._round_cap(need * 1.25 + 1),
                            self._round_cap(self.kcap * 1.5))
            from particlesimulation_tpu.ops import dense_xla
            if _attempt >= 2 or self.kcap > dense_xla.MAX_XLA_KCAP:
                was_supercell = self.impl == "supercell"
                self.impl = "sweep"
                if was_supercell:
                    # Super-cell slabs own by SUPER-row block; the sweep
                    # owns by cell-row block — repack.
                    self._built_key = None
                    g = self.gather(state)
                    state = self.pack_particles(
                        g, collisions=int(np.asarray(state.collisions)),
                        panics=int(np.asarray(state.panics)))
        raise RuntimeError("sharded capacity retries exhausted")

    def ownership_plan(self) -> tuple:
        """Slab-ownership signature for checkpoint as-is placement.

        Column ownership ("cols" variant) depends only on the column
        split (n_shards), so any band plan matches; block-cyclic row
        ownership is a function of the plan itself. Non-banded impls
        own by row block (signature ()). Used by
        utils/checkpointing.restore_sharded — save checkpoints with
        ``band_plan=engine.ownership_plan()`` to enable bit-exact
        as-is resume.
        """
        if self.impl == "supercell":
            # Super-row block ownership: a function of (S, n_shards) only.
            return ((-2, int(self._sc_factor or 0), -2),)
        if self.impl != "banded":
            return ()
        if self.banded_variant == "cols":
            return ((-1, -1, -1),)
        return tuple(tuple(p) for p in (self._band_plan or ()))

    def result(self, state: ShardedState) -> tuple[float, float, int]:
        valid = np.asarray(state.valid)
        pid = np.asarray(state.pid)[valid]
        x = np.asarray(state.x)[valid]
        y = np.asarray(state.y)[valid]
        i = int(np.argmin(pid))
        return float(x[i]), float(y[i]), int(np.asarray(state.collisions))

    def gather(self, state: ShardedState):
        """Full state in original pid order (the reference's Gatherv)."""
        valid = np.asarray(state.valid)
        out = {}
        pid = np.asarray(state.pid)[valid]
        order = np.argsort(pid)
        for name in ("x", "y", "vx", "vy", "m", "alive"):
            out[name] = np.asarray(getattr(state, name))[valid][order]
        out["pid"] = pid[order]
        return out
