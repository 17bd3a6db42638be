"""2D-sharded simulation engine over a (rows × cols) device mesh.

The reference's MPI variant decomposes the grid along rows only and its
report motivates that choice by implementation simplicity — ≤2 neighbors
and a cheap wraparound (g32mpi/CPD_2nd_delivery.pdf §2.1; code
mpi/parsim-mpi.cpp:330-465). The case for a rectangle is traffic, not
the interconnect (four GPUs of one host are joined all to all by NVLink,
so every pair of devices is one hop): a 1D ring of many devices ships
whole grid rows (O(ncside) cells) per halo, while a 2D rectangle ships
its perimeter (O(rows/d_r + cols/d_c)). Each device owns a
``rows × cols`` *rectangle* of cells, the COM halo is the classic
two-phase exchange (rows axis, then cols axis over the row-padded grid so
corners ride along), and particle migration routes dimension-ordered
(rows first, then cols).

Everything the 1D engine guarantees carries over:

* each cell lives wholly on one shard, so per-cell arithmetic order is
  identical to the single-chip engine — f64 parity runs are *bitwise*
  equal to single-chip runs (asserted in tests/test_sharded2d.py), a
  strictly stronger invariant than the reference's 1e-3 cross-variant
  tolerance (mpi/run_tests.sh:41-53);
* only COM monopole data crosses shards in the halo (the reference's
  ghost rule, mpi/parsim-mpi.cpp:670-815) — particle bodies move only at
  migration;
* migration overflow is counted, never dropped, and the engine retries
  losslessly with larger buffers (the reference PANIC-skips or dies).

Decomposition is balanced-uneven per axis (any ``d_r ≤ ncside`` and
``d_c ≤ ncside``), so every reference workload shape runs at any mesh
aspect. ``Sharded2DEngine((1, D))`` or ``((D, 1))`` degenerate to
column-/row-only decompositions; the 1D engine remains the default for
1D meshes (its resident impl is faster per chip).
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

AXIS_R = "rows"
AXIS_C = "cols"
BOTH = (AXIS_R, AXIS_C)


class AxisDecomp:
    """Balanced-uneven contiguous block decomposition of one grid axis.

    The first ``rem`` blocks own ``base + 1`` lines, the rest ``base``
    (same policy as the 1D engine; the reference instead dumps the whole
    remainder on the last rank, mpi/parsim-mpi.cpp:338-342).
    """

    def __init__(self, size: int, nblocks: int):
        if nblocks < 1 or nblocks > size:
            raise ValueError(
                f"need 1 <= nblocks ({nblocks}) <= axis size ({size})")
        self.size = size
        self.nblocks = nblocks
        self.base = size // nblocks
        self.rem = size % nblocks
        self.max_blocks = self.base + (1 if self.rem else 0)

    def first_of(self, s):
        """First global line owned by block ``s`` (python or traced)."""
        if isinstance(s, (int, np.integer)):
            return s * self.base + min(s, self.rem)
        return (s * self.base + jnp.minimum(s, self.rem)).astype(jnp.int32)

    def count_of(self, s):
        """Lines owned by block ``s`` (python or traced)."""
        if isinstance(s, (int, np.integer)):
            return self.base + (1 if s < self.rem else 0)
        return (self.base + (s < self.rem)).astype(jnp.int32)

    def owner_of(self, v, xp=None):
        """Owning block of global line ``v`` (vectorized, numpy or jnp)."""
        if xp is None:
            xp = np
        split = self.rem * (self.base + 1)
        big = v // (self.base + 1)
        small = self.rem + (v - split) // max(1, self.base)
        return xp.where(v < split, big, small)


def _ring_perm(d: int, shift: int):
    return [(i, (i + shift) % d) for i in range(d)]


def stencil_tables_halo2d(Mp, MXp, MYp, side: float, ncside: int,
                          rows_max: int, cols_max: int, row0, col0):
    """Monopole stencil tables for a double-halo-padded local COM grid.

    Mp/MXp/MYp: (rows_max+2, cols_max+2); ring 0 holds the received halos
    (corners included — filled by the two-phase exchange). Mirror offsets
    are applied by the *consumer* from global coordinates, so halo
    payloads are raw COM data, as in the reference where ghosts carry
    plain COM and the mirror resolves at force time
    (mpi/parsim-mpi.cpp:874-935). Returns (ml, mxl, myl): each
    (8, rows_max*cols_max + 1) with a zero sentinel column.
    """
    dt = MXp.dtype
    side_a = jnp.asarray(side, dt)
    zero = jnp.asarray(0.0, dt)
    gxc = col0 + jnp.arange(cols_max, dtype=jnp.int32)[None, :]  # global col
    gyr = row0 + jnp.arange(rows_max, dtype=jnp.int32)[:, None]  # global row

    ml, mxl, myl = [], [], []
    for dx, dy in STENCIL:
        blk = Mp[1 + dy:1 + dy + rows_max, 1 + dx:1 + dx + cols_max]
        blkx = MXp[1 + dy:1 + dy + rows_max, 1 + dx:1 + dx + cols_max]
        blky = MYp[1 + dy:1 + dy + rows_max, 1 + dx:1 + dx + cols_max]
        # Mirror where the *global* neighbor coordinate wraps.
        if dx == 1:
            offx = jnp.where(gxc == ncside - 1, side_a, zero)
        elif dx == -1:
            offx = jnp.where(gxc == 0, -side_a, zero)
        else:
            offx = jnp.zeros((1, 1), dt)
        if dy == 1:
            offy = jnp.where(gyr == ncside - 1, side_a, zero)
        elif dy == -1:
            offy = jnp.where(gyr == 0, -side_a, zero)
        else:
            offy = jnp.zeros((1, 1), dt)
        ml.append(jnp.broadcast_to(blk, (rows_max, cols_max)).reshape(-1))
        mxl.append((offx + blkx).reshape(-1))
        myl.append((offy + blky).reshape(-1))

    pad = jnp.zeros((8, 1), dtype=dt)
    return (jnp.concatenate([jnp.stack(ml), pad], axis=1),
            jnp.concatenate([jnp.stack(mxl), pad], axis=1),
            jnp.concatenate([jnp.stack(myl), pad], axis=1))


def two_phase_com_halo(M2, MX2, MY2, rows_mine, cols_mine, d_r: int,
                       d_c: int):
    """Two-phase COM halo exchange over the (rows, cols) mesh.

    ``M2/MX2/MY2``: (rows_max, cols_max) local COM grids. Rows phase first
    (one ``ppermute`` ring hop per direction along ``AXIS_R``), then the
    cols phase over the *row-padded* grid so corner cells ride the second
    hop — the torus generalization of the reference's one-row ghost
    exchange (mpi/parsim-mpi.cpp:670-815). ``rows_mine/cols_mine`` are the
    traced owned extents (uneven decomposition); a d of 1 on either axis
    self-wraps without a collective. Returns (Mpp, MXpp, MYpp), each
    (rows_max + 2, cols_max + 2) with ring 0 holding the halos.
    """
    rows_max, cols_max = M2.shape

    def last_row(A):
        return jax.lax.dynamic_slice_in_dim(A, rows_mine - 1, 1, axis=0)[0]

    if d_r > 1:
        down = _ring_perm(d_r, 1)
        up = _ring_perm(d_r, -1)
        top = jax.lax.ppermute((last_row(M2), last_row(MX2),
                                last_row(MY2)), AXIS_R, down)
        bot = jax.lax.ppermute((M2[0], MX2[0], MY2[0]), AXIS_R, up)
    else:
        top = (last_row(M2), last_row(MX2), last_row(MY2))
        bot = (M2[0], MX2[0], MY2[0])
    zrow = jnp.zeros((1, cols_max), M2.dtype)

    def padded_rows(A, halo_top, halo_bot):
        Ap = jnp.concatenate([halo_top[None], A, zrow], axis=0)
        return jax.lax.dynamic_update_slice_in_dim(
            Ap, halo_bot[None], rows_mine + 1, axis=0)

    Mp = padded_rows(M2, top[0], bot[0])
    MXp = padded_rows(MX2, top[1], bot[1])
    MYp = padded_rows(MY2, top[2], bot[2])

    def last_col(A):
        return jax.lax.dynamic_slice_in_dim(A, cols_mine - 1, 1,
                                            axis=1)[:, 0]

    if d_c > 1:
        right = _ring_perm(d_c, 1)
        left = _ring_perm(d_c, -1)
        lh = jax.lax.ppermute((last_col(Mp), last_col(MXp),
                               last_col(MYp)), AXIS_C, right)
        rh = jax.lax.ppermute((Mp[:, 0], MXp[:, 0], MYp[:, 0]),
                              AXIS_C, left)
    else:
        lh = (last_col(Mp), last_col(MXp), last_col(MYp))
        rh = (Mp[:, 0], MXp[:, 0], MYp[:, 0])
    zcol = jnp.zeros((rows_max + 2, 1), M2.dtype)

    def padded_cols(Ap, halo_l, halo_r):
        App = jnp.concatenate([halo_l[:, None], Ap, zcol], axis=1)
        return jax.lax.dynamic_update_slice_in_dim(
            App, halo_r[:, None], cols_mine + 1, axis=1)

    return (padded_cols(Mp, lh[0], rh[0]),
            padded_cols(MXp, lh[1], rh[1]),
            padded_cols(MYp, lh[2], rh[2]))


def make_sharded2d_step(config: SimConfig, mesh: Mesh, dec_r: AxisDecomp,
                        dec_c: AxisDecomp, cap: int, bcap: int):
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    d_r, d_c = dec_r.nblocks, dec_c.nblocks
    rows_max, cols_max = dec_r.max_blocks, dec_c.max_blocks
    ncl = rows_max * cols_max  # local COM grid cells (static)
    parity = config.precision is Precision.PARITY
    empty_key = jnp.int32(ncells + 1)

    def slab_key(x, y, valid):
        key, in_range = binning.cell_keys(x, y, side, nc)
        key = jnp.where(valid, key, empty_key)
        return key, in_range

    def _pack_into(dst, dst_valid, src, take, fields):
        """Move ``src`` rows under ``take`` into free ``dst`` slots.

        Arrivals land in source order; rows that don't fit are counted in
        the returned overflow (the retry ladder replays the whole run, so
        counting — not landing — is what must be lossless).
        """
        n_arr = jnp.sum(take, dtype=jnp.int32)
        aorder = jnp.argsort(~take, stable=True)
        free = ~dst_valid
        slot_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
        src_len = take.shape[0]
        gather = jnp.clip(slot_rank, 0, src_len - 1)
        fill = free & (slot_rank < n_arr)
        ovf = jnp.maximum(n_arr - jnp.sum(free, dtype=jnp.int32), 0)
        out = {k: jnp.where(fill, src[k][aorder][gather], dst[k])
               for k in fields}
        return out, dst_valid | fill, ovf

    BUF_FIELDS = ("x", "y", "vx", "vy", "m", "alive", "pid",
                  "dest_r", "dest_c")

    def local_step(state: ShardedState) -> ShardedState:
        mer = jax.lax.axis_index(AXIS_R)
        mec = jax.lax.axis_index(AXIS_C)
        row0 = dec_r.first_of(mer)
        rows_mine = dec_r.count_of(mer)
        col0 = dec_c.first_of(mec)
        cols_mine = dec_c.count_of(mec)
        x, y, vx, vy, m = state.x, state.y, state.vx, state.vy, state.m
        alive, valid, pid = state.alive, state.valid, state.pid

        # ---- binning (slab arrives sorted by this key) ----
        key, _ = slab_key(x, y, valid)
        pos, _ = binning.segment_positions(key)
        kmax = binning.max_occupancy(pos, key < ncells)
        gy = jnp.where(key < ncells, key // nc, jnp.int32(0))
        gx = jnp.where(key < ncells, key - gy * nc, jnp.int32(0))
        lk = jnp.where(key < ncells,
                       (gy - row0) * cols_max + (gx - col0), jnp.int32(ncl))

        # ---- local COM over the rectangle ----
        if parity:
            M, MX, MY = com.com_parity(lk, x, y, m, ncl)
        else:
            M, MX, MY = com.com_fast(lk, x, y, m, ncl)
        M2 = M.reshape(rows_max, cols_max)
        MX2 = MX.reshape(rows_max, cols_max)
        MY2 = MY.reshape(rows_max, cols_max)

        # ---- two-phase COM halo (reference ghost exchange P3,
        # generalized to the torus: rows axis first, then cols over the
        # row-padded grid so corner cells ride the second phase) ----
        Mpp, MXpp, MYpp = two_phase_com_halo(M2, MX2, MY2, rows_mine,
                                             cols_mine, d_r, d_c)

        # ---- forces ----
        ml, mxl, myl = stencil_tables_halo2d(Mpp, MXpp, MYpp, side, nc,
                                             rows_max, cols_max, row0, col0)
        if parity:
            fx, fy = forces.pairwise_forces_parity(x, y, m, alive, key, kmax,
                                                   ncells)
        else:
            fx, fy = forces.pairwise_forces_fast(x, y, m, alive, key, kmax,
                                                 ncells)
        fx, fy = forces.monopole_forces(x, y, m, alive, lk, fx, fy,
                                        ml, mxl, myl, ncl, parity)

        # ---- integrate + wrap ----
        x, y, vx, vy = integrate.integrate(x, y, vx, vy, m, fx, fy, side,
                                           DELTAT)

        # ---- dimension-ordered migration (reference P4, torus-routed) ----
        key2, _ = slab_key(x, y, valid)
        ngy = jnp.where(key2 < ncells, key2 // nc, jnp.int32(0))
        ngx = jnp.where(key2 < ncells, key2 - ngy * nc, jnp.int32(0))
        dest_r = jnp.where(key2 < ncells,
                           dec_r.owner_of(ngy, jnp).astype(jnp.int32), mer)
        dest_c = jnp.where(key2 < ncells,
                           dec_c.owner_of(ngx, jnp).astype(jnp.int32), mec)
        dest_r = jnp.where(valid, dest_r, mer)
        dest_c = jnp.where(valid, dest_c, mec)
        emig = valid & ((dest_r != mer) | (dest_c != mec))
        n_emig = jnp.sum(emig, dtype=jnp.int32)
        overflow = jnp.maximum(n_emig - bcap, 0)

        # Pack emigrants (slab order) into the rows-phase ring buffer.
        order = jnp.argsort(~emig, stable=True)
        take = order[:bcap]
        buf = {
            "x": x[take], "y": y[take], "vx": vx[take], "vy": vy[take],
            "m": m[take], "alive": alive[take], "pid": pid[take],
            "dest_r": dest_r[take], "dest_c": dest_c[take],
            "valid": emig[take],
        }
        valid = valid & ~emig

        # Empty cols-phase buffer (same capacity).
        cbuf = {k: jnp.zeros_like(v) for k, v in buf.items()}

        def slab_accept(slab, src, arr):
            (sx, sy, svx, svy, sm, salive, svalid, spid) = slab
            dst = {"x": sx, "y": sy, "vx": svx, "vy": svy, "m": sm,
                   "alive": salive, "pid": spid}
            out, nvalid, ovf = _pack_into(
                dst, svalid, src, arr,
                ("x", "y", "vx", "vy", "m", "alive", "pid"))
            return (out["x"], out["y"], out["vx"], out["vy"], out["m"],
                    out["alive"], nvalid, out["pid"]), ovf

        def land(slab, buf, cbuf, overflow):
            """Process buffer entries whose row block is this shard's.

            Direct hits (col block matches too) land in the slab; the
            rest transfer to the cols-phase buffer.
            """
            landed = buf["valid"] & (buf["dest_r"] == mer)
            direct = landed & (buf["dest_c"] == mec)
            tocol = landed & (buf["dest_c"] != mec)
            slab, ovf1 = slab_accept(slab, buf, direct)
            cout, cvalid, ovf2 = _pack_into(cbuf, cbuf["valid"], buf, tocol,
                                            BUF_FIELDS)
            cbuf = dict(cout)
            cbuf["valid"] = cvalid
            buf = dict(buf)
            buf["valid"] = buf["valid"] & ~landed
            return slab, buf, cbuf, overflow + ovf1 + ovf2

        slab = (x, y, vx, vy, m, alive, valid, pid)
        # Emigrants already on the right row block move to the cols phase
        # without any rows-axis hop.
        slab, buf, cbuf, overflow = land(slab, buf, cbuf, overflow)

        if d_r > 1:
            fwd_r = _ring_perm(d_r, 1)
            pending0 = jax.lax.psum(
                jnp.sum(buf["valid"], dtype=jnp.int32), BOTH)

            def rcond(c):
                _, _, _, _, pending, hop = c
                return (pending > 0) & (hop < d_r - 1)

            def rbody(c):
                slab, buf, cbuf, overflow, _, hop = c
                buf = jax.lax.ppermute(buf, AXIS_R, fwd_r)
                slab, buf, cbuf, overflow = land(slab, buf, cbuf, overflow)
                pending = jax.lax.psum(
                    jnp.sum(buf["valid"], dtype=jnp.int32), BOTH)
                return slab, buf, cbuf, overflow, pending, hop + 1

            slab, buf, cbuf, overflow, _, _ = jax.lax.while_loop(
                rcond, rbody,
                (slab, buf, cbuf, overflow, pending0, jnp.int32(0)))

        if d_c > 1:
            fwd_c = _ring_perm(d_c, 1)
            cpend0 = jax.lax.psum(
                jnp.sum(cbuf["valid"], dtype=jnp.int32), BOTH)

            def ccond(c):
                _, _, _, pending, hop = c
                return (pending > 0) & (hop < d_c - 1)

            def cbody(c):
                slab, cbuf, overflow, _, hop = c
                cbuf = jax.lax.ppermute(cbuf, AXIS_C, fwd_c)
                arr = cbuf["valid"] & (cbuf["dest_c"] == mec)
                slab, ovf = slab_accept(slab, cbuf, arr)
                cbuf = dict(cbuf)
                cbuf["valid"] = cbuf["valid"] & ~arr
                pending = jax.lax.psum(
                    jnp.sum(cbuf["valid"], dtype=jnp.int32), BOTH)
                return slab, cbuf, overflow + ovf, pending, hop + 1

            slab, cbuf, overflow, _, _ = jax.lax.while_loop(
                ccond, cbody, (slab, cbuf, overflow, cpend0, jnp.int32(0)))

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

        total = jax.lax.psum(count, BOTH)
        panics = jax.lax.psum(
            jnp.sum(valid & ~in_range3, dtype=jnp.int32), BOTH)
        total_ovf = jax.lax.psum(overflow, BOTH)

        return ShardedState(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, valid=valid, pid=pid,
            collisions=state.collisions + total.astype(state.collisions.dtype),
            panics=state.panics + panics,
            overflow=state.overflow + total_ovf,
        )

    spec_arr = P(BOTH)
    spec_scalar = P()
    specs = ShardedState(
        x=spec_arr, y=spec_arr, vx=spec_arr, vy=spec_arr, m=spec_arr,
        alive=spec_arr, valid=spec_arr, pid=spec_arr,
        collisions=spec_scalar, panics=spec_scalar, overflow=spec_scalar)
    return jax.shard_map(local_step, mesh=mesh, in_specs=(specs,),
                         out_specs=specs)


class Sharded2DEngine:
    """Rectangular-mesh engine with the 1D sharded engine's interface.

    ``mesh_shape=(d_r, d_c)`` lays the first ``d_r * d_c`` devices out as
    a (rows, cols) mesh; shard (r, c) owns the cell rectangle
    [row block r] × [col block c].

    Two implementations, mirroring the 1D ``ShardedEngine``:

    * ``sweep`` — sorted per-shard slabs, neighbor-offset force sweep.
      The f64 parity path (bitwise equal to single-chip; asserted in
      tests/test_sharded2d.py).
    * ``resident`` — slot-resident rectangle tiles with the fused pair
      kernels and dimension-ordered halo shipping
      (parallel/sharded2d_resident.py). The FAST-precision default.

    Overflow anywhere triggers a lossless capacity retry (grow tiles /
    slabs / buffers and replay), then escalation to the sweep impl.
    """

    def __init__(self, config: SimConfig, mesh_shape: tuple[int, int],
                 devices=None, impl: str | None = None,
                 kcap: int | None = None):
        self.config = config
        d_r, d_c = int(mesh_shape[0]), int(mesh_shape[1])
        if d_r * d_c != config.n_shards:
            raise ValueError(
                f"mesh_shape {mesh_shape} has {d_r * d_c} devices but "
                f"config.n_shards is {config.n_shards}")
        self.dec_r = AxisDecomp(config.ncside, d_r)
        self.dec_c = AxisDecomp(config.ncside, d_c)
        d = d_r * d_c
        if devices is None:
            devices = jax.devices()[:d]
        if len(devices) < d:
            raise ValueError(f"need {d} devices, have {len(devices)}")
        self.mesh = Mesh(np.array(devices[:d]).reshape(d_r, d_c),
                         (AXIS_R, AXIS_C))
        if config.precision is Precision.PARITY:
            if not jax.config.jax_enable_x64:
                raise RuntimeError("parity precision requires jax_enable_x64")
            self.dtype = jnp.float64
            self.impl = "sweep"
            self._impl_auto = False
        else:
            self.dtype = jnp.float32
            if impl is None:
                impl = os.environ.get("PSIM_SHARD_IMPL")
            # Census auto-routing (round 5): with no impl flag, clustered
            # and sparse loads delegate to the 1D ring over the SAME
            # devices at init_state (banded-cols / supercell are 1D
            # decompositions — a mesh request fixes the device count,
            # the engine picks the decomposition that fits the load,
            # like engine.Engine.init_state on a single chip).
            self._impl_auto = impl is None
            self.impl = impl or "resident"
        if self.impl not in ("resident", "sweep"):
            raise ValueError(
                f"unknown sharded2d impl {self.impl!r}; "
                f"valid: resident, sweep")
        self.kcap = kcap
        self.capacity = config.shard_capacity or None
        self.bcap = config.migration_capacity or None
        self._built_key = None
        self._run = None
        self._delegate = None  # 1D ShardedEngine when census routes away

    @staticmethod
    def _round_cap(x: float) -> int:
        return max(32, (int(x) + 31) // 32 * 32)

    def _build(self):
        cap = self.capacity or self.config.resolved_shard_capacity()
        self.capacity = cap
        if self.impl == "resident" and self.kcap is None:
            # Snug Poisson-tail bound (same rationale as the 1D engine);
            # overflow retries are lossless.
            avg = max(1.0, self.config.n_particles
                      / max(1, self.config.ncells))
            self.kcap = self._round_cap(avg + 4.5 * avg ** 0.5 + 8)
        if self.bcap is None:
            self.bcap = max(64, cap // 2)
        key = (self.impl, cap, self.bcap,
               self.kcap if self.impl == "resident" else None)
        if self._built_key == key and self._run is not None:
            return
        if self.impl == "resident":
            from particlesimulation_tpu.parallel.sharded2d_resident import (
                make_sharded2d_resident_run)
            self._run = make_sharded2d_resident_run(
                self.config, self.mesh, self.dec_r, self.dec_c,
                self.kcap, cap)
        else:
            step = make_sharded2d_step(self.config, self.mesh, self.dec_r,
                                       self.dec_c, cap, self.bcap)
            self._run = jax.jit(
                lambda s, nsteps: jax.lax.fori_loop(
                    0, nsteps, lambda i, st: step(st), s))
        self._built_key = key

    def init_state(self) -> ShardedState:
        """Host init, then scatter by owner rectangle into per-shard slabs.

        Mirrors the reference's rank-0 init + ownership distribution
        (mpi/parsim-mpi.cpp:344-349,406-465), with ownership now a
        (row block, col block) pair.
        """
        cfg = self.config
        host = init_particles_host(cfg)
        if self._impl_auto:
            self._impl_auto = False
            cand = self._route_1d(host)
            if cand is not None:
                self._delegate = cand
                self.impl = cand.impl  # observability (run() forwards)
                return cand.init_state(_host=host)
        xs, ys, vxs, vys, ms = host
        n = cfg.n_particles
        particles = {
            "x": xs, "y": ys, "vx": vxs, "vy": vys, "m": ms,
            "alive": np.ones(n, dtype=bool),
            "pid": np.arange(n, dtype=np.int32),
        }
        return self.pack_particles(particles)

    def _route_1d(self, host):
        """Census-route clustered/sparse loads to the 1D ring (or None).

        banded-cols and supercell are 1D decompositions; the rectangle
        split has no equivalent. A ``--mesh RxC`` request fixes the device
        COUNT; with no impl flag the engine owns the decomposition choice, so the same
        census gates as the 1D ``ShardedEngine`` run here and, on a hit,
        the run executes on the identical chips re-laid as a ring. The
        reference's one-binary mpirun harness is the behavioral model
        (reference mpi/run_tests.sh:8-16): no workload needs a flag to
        run distributed well. Uniform loads return None and stay on the
        2D resident/sweep path.
        """
        import dataclasses

        from particlesimulation_tpu.parallel.sharded import ShardedEngine
        if self.config.n_shards > self.config.ncside:
            # The 1D row-block split needs a grid row per shard (the
            # rectangle split factors the device count across two axes,
            # so an RxC mesh can be valid where the flat ring is not —
            # the reference's 1D MPI split simply breaks there,
            # mpi/parsim-mpi.cpp:338-342).
            return None
        cfg = dataclasses.replace(self.config, mesh_shape=())
        devices = list(self.mesh.devices.reshape(-1))
        cand = ShardedEngine(cfg, devices=devices)
        if cand.impl == "supercell":        # config-static sparse route
            return cand
        if cand._impl_auto:
            w = cfg.side / cfg.ncside
            hx = np.clip((np.asarray(host[0]) / w).astype(np.int64), 0,
                         cfg.ncside - 1)
            hy = np.clip((np.asarray(host[1]) / w).astype(np.int64), 0,
                         cfg.ncside - 1)
            cand._census_route(np.bincount(hy * cfg.ncside + hx,
                                           minlength=cfg.ncells))
            if cand.impl != "resident":
                return cand
        return None

    def pack_particles(self, particles, collisions=0, panics=0,
                       dtype=None) -> ShardedState:
        cfg = self.config
        d_r, d_c = self.dec_r.nblocks, self.dec_c.nblocks
        d = d_r * d_c
        dtype = dtype or self.dtype
        xs, ys = np.asarray(particles["x"]), np.asarray(particles["y"])
        w = cfg.side / cfg.ncside
        cx = (xs / w).astype(np.int32)
        cy = (ys / w).astype(np.int32)
        in_range = ((cx >= 0) & (cx < cfg.ncside) &
                    (cy >= 0) & (cy < cfg.ncside))
        r = self.dec_r.owner_of(np.clip(cy, 0, cfg.ncside - 1))
        c = self.dec_c.owner_of(np.clip(cx, 0, cfg.ncside - 1))
        shard = np.where(in_range, r * d_c + c, 0)

        counts = np.bincount(shard, minlength=d)
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
        sh = NamedSharding(self.mesh, P(BOTH))
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

        spec_arr = P(BOTH)
        specs = ShardedState(
            x=spec_arr, y=spec_arr, vx=spec_arr, vy=spec_arr, m=spec_arr,
            alive=spec_arr, valid=spec_arr, pid=spec_arr,
            collisions=P(), panics=P(), overflow=P())
        f = jax.shard_map(local, mesh=self.mesh, in_specs=(specs,),
                          out_specs=specs)
        return jax.jit(f)(state)

    def _grow_state(self, state: ShardedState, new_cap: int) -> ShardedState:
        d = self.config.n_shards
        old_cap = state.x.shape[0] // d
        if old_cap >= new_cap:
            return state
        sh = NamedSharding(self.mesh, P(BOTH))

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

        Retry ladder (replays from the *input* state; nothing is ever
        dropped — the reference instead PANIC-skips or dies): resident
        tile overflow grows ``kcap`` then escalates to the sweep impl;
        CAP_OVF grows the per-shard slab; sweep migration overflow grows
        slab + buffer; STRAY_OVF is an invariant violation and raises.
        """
        if self._delegate is not None:
            return self._delegate.run(state, n_steps)
        from particlesimulation_tpu.parallel.sharded import (
            CAP_OVF, STRAY_OVF)
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
                    "sharded2d slab invariant violation: a particle sits "
                    "outside its owner shard's rectangle (not "
                    "capacity-fixable)")
            if need >= int(CAP_OVF):
                deficit = need - int(CAP_OVF)
                cap = self.capacity or self.config.resolved_shard_capacity()
                self.capacity = self._round_cap(cap * 1.5 + deficit)
                continue
            if self.impl != "resident":
                # Sweep migration overflow: emigrant buffer (bcap) or
                # landing-slot exhaustion — grow both and replay.
                cap = self.capacity or self.config.resolved_shard_capacity()
                self.capacity = self._round_cap(cap * 1.5 + need)
                self.bcap = self._round_cap((self.bcap or 64) * 2 + need)
                continue
            # Resident tile occupancy outgrew the grid: larger tiles,
            # sized to the observed occupancy when it exceeds plain growth.
            self.kcap = max(self._round_cap(need * 1.25 + 1),
                            self._round_cap(self.kcap * 1.5))
            from particlesimulation_tpu.ops import dense_xla
            if _attempt >= 2 or self.kcap > dense_xla.MAX_XLA_KCAP:
                self.impl = "sweep"
        raise RuntimeError("sharded2d capacity retries exhausted")

    def result(self, state: ShardedState) -> tuple[float, float, int]:
        if self._delegate is not None:
            return self._delegate.result(state)
        valid = np.asarray(state.valid)
        pid = np.asarray(state.pid)[valid]
        x = np.asarray(state.x)[valid]
        y = np.asarray(state.y)[valid]
        i = int(np.argmin(pid))
        return float(x[i]), float(y[i]), int(np.asarray(state.collisions))

    def gather(self, state: ShardedState):
        """Full state in original pid order (the reference's Gatherv)."""
        if self._delegate is not None:
            return self._delegate.gather(state)
        valid = np.asarray(state.valid)
        out = {}
        pid = np.asarray(state.pid)[valid]
        order = np.argsort(pid)
        for name in ("x", "y", "vx", "vy", "m", "alive"):
            out[name] = np.asarray(getattr(state, name))[valid][order]
        out["pid"] = pid[order]
        return out
