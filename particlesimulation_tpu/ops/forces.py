"""Gravitational force computation over the sorted-particle representation.

The reference's hottest loops (reference serial/parsim.cpp:292-377): exact
pairwise gravity between alive particles sharing a cell, with Newton's-third-
law dual update, plus monopole attraction from the eight stencil temp-cells.

Array formulation — the *sorted neighbor-offset sweep*: with particles
sorted by (cell, id), all same-cell partners of particle i sit at offsets
i±o, o < k_max (the max cell occupancy, a dynamic scalar). A ``fori_loop``
over o does masked shifted-array arithmetic across all N lanes at once:
O(N·k) work with no gather/scatter, no buckets, no dynamic shapes.

Parity variant: per particle, the reference accumulates (a) reaction terms
from lower-indexed partners in ascending-partner order, (b) own pair terms in
ascending-partner order, then (c) the 8 stencil terms in stencil order
(SURVEY §2.4 P3). Two sweeps (o descending for (a), o ascending for (b))
followed by the ordered monopole pass reproduce that association order
exactly. The force-magnitude expression keeps the reference's association,
including the detail that the magnitude is computed from the *lower-indexed*
particle's perspective: ``((G*m_lo)*m_hi)/d2`` (serial/parsim.cpp:139).

Fast variant: one sweep, symmetric accumulation, order-free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from particlesimulation_tpu.config import G


def _doubled(a):
    return jnp.concatenate([a, a])


def _shift_up(a2, o, n):
    """a2 = doubled array; returns s with s[i] = a[i+o] for i+o < n."""
    return jax.lax.dynamic_slice_in_dim(a2, o, n)


def _shift_down(a2, o, n):
    """s[i] = a[i-o] for i >= o."""
    return jax.lax.dynamic_slice_in_dim(a2, n - o, n)


def pairwise_forces_parity(x, y, m, alive, key, kmax, ncells: int):
    """Exact-order same-cell pairwise forces. Returns (fx, fy)."""
    n = x.shape[0]
    dt = x.dtype
    g = jnp.asarray(G, dt)
    zero = jnp.asarray(0.0, dt)
    idx = jnp.arange(n, dtype=jnp.int32)
    real = key < ncells
    x2, y2, m2 = _doubled(x), _doubled(y), _doubled(m)
    a2, k2 = _doubled(alive), _doubled(key)

    def lower_body(t, f):
        # o descends kmax-1 .. 1 → reaction terms arrive in ascending-partner
        # order, matching serial/parsim.cpp:356-366's outer-loop order.
        fx, fy = f
        o = kmax - 1 - t
        xp = _shift_up(x2, n - o, n)  # partner i-o via down-shift
        yp = _shift_up(y2, n - o, n)
        mp = _shift_up(m2, n - o, n)
        ap = _shift_up(a2, n - o, n)
        kp = _shift_up(k2, n - o, n)
        mask = (idx >= o) & (key == kp) & real & alive & ap
        # From the lower-indexed partner j' = i-o's perspective
        # (calculateForceBetweenParticles, serial/parsim.cpp:127-148):
        dx = x - xp   # p2->x - x with p2 = self
        dy = y - yp
        d2 = dx * dx + dy * dy
        dist = jnp.sqrt(d2)
        mask = mask & (dist != zero)
        fm = (g * mp) * m / d2
        fxa = fm * (dx / dist)
        fya = fm * (dy / dist)
        # Self is p2: receives the reaction update fx -= fx_add.
        fx = fx - jnp.where(mask, fxa, zero)
        fy = fy - jnp.where(mask, fya, zero)
        return fx, fy

    def upper_body(t, f):
        fx, fy = f
        o = t + 1
        xp = _shift_up(x2, o, n)
        yp = _shift_up(y2, o, n)
        mp = _shift_up(m2, o, n)
        ap = _shift_up(a2, o, n)
        kp = _shift_up(k2, o, n)
        mask = (idx < n - o) & (key == kp) & real & alive & ap
        dx = xp - x   # p2->x - x with self as j
        dy = yp - y
        d2 = dx * dx + dy * dy
        dist = jnp.sqrt(d2)
        mask = mask & (dist != zero)
        fm = (g * m) * mp / d2
        fx = fx + jnp.where(mask, fm * (dx / dist), zero)
        fy = fy + jnp.where(mask, fm * (dy / dist), zero)
        return fx, fy

    nsweep = jnp.maximum(kmax - 1, 0)
    # x*0 (not a zeros literal) keeps the carry's varying-axes type aligned
    # with the loop output under shard_map.
    fx = x * zero
    fy = x * zero
    fx, fy = jax.lax.fori_loop(0, nsweep, lower_body, (fx, fy))
    fx, fy = jax.lax.fori_loop(0, nsweep, upper_body, (fx, fy))
    return fx, fy


def cell_occupancy_per_lane(key_sorted):
    """Occupancy of each lane's cell, for sorted keys (no ncells buffer)."""
    n = key_sorted.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), key_sorted[1:] != key_sorted[:-1]])
    last = jnp.concatenate(
        [key_sorted[1:] != key_sorted[:-1], jnp.ones((1,), dtype=bool)])
    seg_start = jax.lax.cummax(jnp.where(first, idx, jnp.int32(0)))
    seg_end = jnp.flip(jax.lax.cummin(
        jnp.flip(jnp.where(last, idx, jnp.int32(0x7FFFFFFF)))))
    return seg_end - seg_start + 1


def pairwise_forces_parity_blocked(x, y, m, alive, key, kmax, ncells: int,
                                   block: int = 2048):
    """Occupancy-tiered variant of :func:`pairwise_forces_parity`.

    Bit-identical reformulation: lanes are processed in blocks of ``block``,
    and each block's offset loops run only to its own max cell occupancy
    (a dynamic ``fori_loop`` bound → while loop) instead of the global
    ``kmax``. Cost drops from ``N·kmax_global`` to ``Σ_blocks B·kmax_block``
    ≈ ``Σ_cells k_c²`` — the win is large exactly where the reference's
    harness is hardest (clustered high-occupancy vectors, e.g.
    serial/run_tests.sh's ncside=50 × 500-step and ncside=5 × 10⁴-step
    vectors, where one hot cell drives kmax far above the mean).

    Bit-exactness argument: for a lane with cell occupancy c, offsets
    o ≥ c are fully masked and contribute a literal ±0.0 — ``fx - 0.0`` is
    an exact IEEE no-op, and ``fx + 0.0`` is a no-op unless fx is -0.0,
    which cannot arise here (force terms are products of positive
    magnitudes with ``dx/dist`` quotients whose zeros are +0.0, sums that
    cancel exactly round to +0.0, and the accumulator starts at
    ``x*0 = +0.0`` for the in-domain x ≥ 0). Skipping those offsets
    therefore reproduces the global sweep's bits; asserted per-config by
    tests/test_ops.py and end-to-end by the golden vectors.
    """
    n = x.shape[0]
    dt = x.dtype
    g = jnp.asarray(G, dt)
    zero = jnp.asarray(0.0, dt)
    b = int(min(block, max(128, n)))
    n_pad = -(-n // b) * b
    pad = n_pad - n

    occ = cell_occupancy_per_lane(key)
    if pad:
        # Pad lanes: sentinel key (masked as self via real, as partner via
        # ap) and zero occupancy (never raises a block's trip count).
        key_p = jnp.concatenate([key, jnp.full((pad,), ncells, key.dtype)])
        occ_p = jnp.concatenate([occ, jnp.zeros((pad,), occ.dtype)])
        x_p = jnp.concatenate([x, jnp.zeros((pad,), dt)])
        y_p = jnp.concatenate([y, jnp.zeros((pad,), dt)])
        m_p = jnp.concatenate([m, jnp.zeros((pad,), dt)])
        a_p = jnp.concatenate([alive, jnp.zeros((pad,), bool)])
    else:
        key_p, occ_p, x_p, y_p, m_p, a_p = key, occ, x, y, m, alive

    nb = n_pad // b
    kmax_b = occ_p.reshape(nb, b).max(axis=1)

    x2, y2, m2 = _doubled(x_p), _doubled(y_p), _doubled(m_p)
    a2, k2 = _doubled(a_p), _doubled(key_p)
    bidx = jnp.arange(b, dtype=jnp.int32)
    npad32 = jnp.int32(n_pad)

    def block_fn(bi):
        s0 = bi * b
        kb = kmax_b[bi]
        xb = jax.lax.dynamic_slice_in_dim(x_p, s0, b)
        yb = jax.lax.dynamic_slice_in_dim(y_p, s0, b)
        mb = jax.lax.dynamic_slice_in_dim(m_p, s0, b)
        ab = jax.lax.dynamic_slice_in_dim(a_p, s0, b)
        keyb = jax.lax.dynamic_slice_in_dim(key_p, s0, b)
        idx = s0.astype(jnp.int32) + bidx
        real = keyb < ncells

        def lower_body(t, f):
            # o descends kb-1 .. 1 — same real-term order as the global
            # sweep (serial/parsim.cpp:356-366's outer-loop order).
            fx, fy = f
            o = kb - 1 - t
            st = s0 + npad32 - o
            xp = jax.lax.dynamic_slice_in_dim(x2, st, b)
            yp = jax.lax.dynamic_slice_in_dim(y2, st, b)
            mp = jax.lax.dynamic_slice_in_dim(m2, st, b)
            ap = jax.lax.dynamic_slice_in_dim(a2, st, b)
            kp = jax.lax.dynamic_slice_in_dim(k2, st, b)
            mask = (idx >= o) & (keyb == kp) & real & ab & ap
            dx = xb - xp
            dy = yb - yp
            d2 = dx * dx + dy * dy
            dist = jnp.sqrt(d2)
            mask = mask & (dist != zero)
            fm = (g * mp) * mb / d2
            fx = fx - jnp.where(mask, fm * (dx / dist), zero)
            fy = fy - jnp.where(mask, fm * (dy / dist), zero)
            return fx, fy

        def upper_body(t, f):
            fx, fy = f
            o = t + 1
            st = s0 + o
            xp = jax.lax.dynamic_slice_in_dim(x2, st, b)
            yp = jax.lax.dynamic_slice_in_dim(y2, st, b)
            mp = jax.lax.dynamic_slice_in_dim(m2, st, b)
            ap = jax.lax.dynamic_slice_in_dim(a2, st, b)
            kp = jax.lax.dynamic_slice_in_dim(k2, st, b)
            mask = (idx < n - o) & (keyb == kp) & real & ab & ap
            dx = xp - xb
            dy = yp - yb
            d2 = dx * dx + dy * dy
            dist = jnp.sqrt(d2)
            mask = mask & (dist != zero)
            fm = (g * mb) * mp / d2
            fx = fx + jnp.where(mask, fm * (dx / dist), zero)
            fy = fy + jnp.where(mask, fm * (dy / dist), zero)
            return fx, fy

        nsweep = jnp.maximum(kb - 1, 0)
        fx = xb * zero
        fy = xb * zero
        fx, fy = jax.lax.fori_loop(0, nsweep, lower_body, (fx, fy))
        fx, fy = jax.lax.fori_loop(0, nsweep, upper_body, (fx, fy))
        return fx, fy

    fxs, fys = jax.lax.map(block_fn, jnp.arange(nb, dtype=jnp.int32))
    return fxs.reshape(-1)[:n], fys.reshape(-1)[:n]


def pairwise_forces_fast(x, y, m, alive, key, kmax, ncells: int):
    """Order-free same-cell pairwise forces: one sweep, symmetric update."""
    n = x.shape[0]
    dt = x.dtype
    g = jnp.asarray(G, dt)
    zero = jnp.asarray(0.0, dt)
    idx = jnp.arange(n, dtype=jnp.int32)
    real = key < ncells
    x2, y2, m2 = _doubled(x), _doubled(y), _doubled(m)
    a2, k2 = _doubled(alive), _doubled(key)

    def body(t, f):
        fx, fy = f
        o = t + 1
        xp = _shift_up(x2, o, n)
        yp = _shift_up(y2, o, n)
        mp = _shift_up(m2, o, n)
        ap = _shift_up(a2, o, n)
        kp = _shift_up(k2, o, n)
        mask = (idx < n - o) & (key == kp) & real & alive & ap
        dx = xp - x
        dy = yp - y
        d2 = dx * dx + dy * dy
        mask = mask & (d2 > zero)
        inv = jnp.where(d2 > zero, jax.lax.rsqrt(d2), zero)
        # F/d = G*m1*m2/d^3 = G*m1*m2 * inv^3
        s = jnp.where(mask, (g * m) * mp * (inv * inv * inv), zero)
        tx = s * dx
        ty = s * dy
        fx = fx + tx
        fy = fy + ty
        # Newton's 3rd law on the partner side, via a down-shift.
        txd = _shift_down(_doubled(tx), o, n)
        tyd = _shift_down(_doubled(ty), o, n)
        back = idx >= o
        fx = fx - jnp.where(back, txd, zero)
        fy = fy - jnp.where(back, tyd, zero)
        return fx, fy

    nsweep = jnp.maximum(kmax - 1, 0)
    fx = x * zero
    fy = x * zero
    fx, fy = jax.lax.fori_loop(0, nsweep, body, (fx, fy))
    return fx, fy


def monopole_forces(x, y, m, alive, key, fx, fy, ml, mxl, myl,
                    ncells: int, exact_order: bool):
    """Add the 8 neighbor-COM monopole terms (serial/parsim.cpp:109-125).

    ``exact_order`` keeps the reference's per-term association (parity);
    the fast path uses the same loop (it is only 8 static iterations) with
    rsqrt-free math preserved for simplicity — the cost is dominated by the
    pairwise sweep.
    """
    dt = x.dtype
    g = jnp.asarray(G, dt)
    zero = jnp.asarray(0.0, dt)
    kc = jnp.minimum(key, jnp.int32(ncells))  # sentinel column for invalid
    real = key < ncells
    for l in range(8):
        cm = jnp.take(ml[l], kc)
        cmx = jnp.take(mxl[l], kc)
        cmy = jnp.take(myl[l], kc)
        dx = cmx - x
        dy = cmy - y
        d2 = dx * dx + dy * dy
        dist = jnp.sqrt(d2)
        mask = alive & real & (dist != zero)
        fm = (g * m) * cm / jnp.where(d2 > zero, d2, jnp.asarray(1.0, dt))
        fx = fx + jnp.where(mask, fm * (dx / jnp.where(dist > zero, dist, jnp.asarray(1.0, dt))), zero)
        fy = fy + jnp.where(mask, fm * (dy / jnp.where(dist > zero, dist, jnp.asarray(1.0, dt))), zero)
    return fx, fy
