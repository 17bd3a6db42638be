"""Dense per-cell-tile force/collision passes in pure XLA.

The (ncells, K) slot-tile pair passes of every tile engine, expressed as
a ``lax.map`` over blocks of cells so XLA bounds the (CB, Ic, K) pair
intermediates instead of materializing the full (ncells, K, K) tensor.

Replaces the per-offset sweep (O(k) separate shifted passes over HBM) with
blockwise all-pairs arithmetic — the pair work becomes compute-bound
instead of HBM/latency-bound.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from particlesimulation_tpu.config import G

# Cells per lax.map iteration. Each iteration is a separate device launch;
# with fused elementwise+reduce bodies nothing K²-sized materializes, so
# bigger blocks amortize launch overhead. Untuned default carried over
# from the first target; not tuned on the H100.
CELL_BLOCK = int(os.environ.get("PSIM_CELL_BLOCK", "1024"))

# Dense-tile capacity bound. The lax.map bodies chunk their pair
# intermediates as (CB, ichunk, K) — nothing (K, K)-sized exists — so
# high-occupancy grids (the reference's MEDIUM workload runs k≈2500 per
# cell) stay on the dense path instead of falling back to the much slower
# sweep. Cell blocks scale down with K (_eff_cb) to keep the per-iteration
# intermediate footprint constant.
MAX_XLA_KCAP = int(os.environ.get("PSIM_MAX_XLA_KCAP", "4096"))


# Matmul precision of every contraction in the fast engines: true f32.
# At the default precision an f32 matmul on the GPU may run in TF32 (a
# 10-bit mantissa): a one-hot gather of coordinates up to 1e4 then moves
# them by whole length units (ops/supercell.py), and v4's cancelling
# force form would lose its digits wherever XLA picks the tensor cores.
F32_MATMUL = jax.lax.Precision.HIGHEST

# Below this domain size the contraction force form (fused_pairs_v4) is
# NOT the default: its contraction-cancellation error (~1e-3 relative on
# near-EPSILON pairs) would exceed the f32 coordinate-quantization error
# every fast-path variant already carries. At side >= ~84 the shared
# quantization floor ulp(side)/EPSILON ~ side*6e-8/0.005 >= 1e-3 dwarfs
# v4's extra term (at side=5000 both v2 and v4 sit at ~2-5% vs f64 truth
# on near pairs while their mutual delta is <=2.5e-4 —
# tests/test_dense_kernels.py quantization study). Tiny boxes (golden
# N1/N2, side=0.05) stay on v2 where it is genuinely ~1000x more
# accurate near EPSILON.
V4_MIN_SIDE = float(os.environ.get("PSIM_V4_MIN_SIDE", "100"))

# Receiver-chunk width for the chunked pair passes (v2/v4/v5). Untuned
# default carried over from the first target (not tuned on the H100);
# env-tunable for A/B sweeps.
PAIR_ICHUNK = int(os.environ.get("PSIM_PAIR_ICHUNK", "32"))


def resolve_pair_impl(name: str | None = None, side: float | None = None):
    """Fused-pair-pass variant selector (shared by every tile engine).

    Default: v4 (contraction force form) when the domain is large enough
    that f32 coordinate quantization already floors the near-pair force
    error (side >= V4_MIN_SIDE; see the derivation above), else v2 — the
    exact per-pair form. PSIM_PAIR_IMPL overrides; v1/v3/v5
    stay selectable for A/B runs. An unknown name raises a ValueError
    naming the valid options instead of a bare KeyError.
    """
    if name is None:
        name = os.environ.get("PSIM_PAIR_IMPL")
    if name is None:
        name = "v4" if (side is not None and side >= V4_MIN_SIDE) else "v2"
    table = {"v1": fused_pairs, "v2": fused_pairs_v2, "v3": fused_pairs_v3,
             "v4": fused_pairs_v4, "v5": fused_pairs_v5}
    fn = table.get(name)
    if fn is None:
        raise ValueError(
            f"unknown pair impl {name!r} (PSIM_PAIR_IMPL); "
            f"valid: {sorted(table)}")
    return fn


# Sentinel range for a compact-collision hit-capacity overflow in the
# engine overflow channel: values in [HIT_OVF, 2*HIT_OVF) encode
# "HIT_OVF + needed flagged-slot count" (engine.RANK_OVF = 1<<30 sits
# just above, so the three overflow kinds stay distinguishable; genuine
# tile-capacity needs are bounded far below 1<<29).
HIT_OVF = 1 << 29


def resolve_collide_mode() -> str:
    """Collision-resolution mode for the tile engines.

    ``block`` — the fused pair pass runs the first-pair rank machinery
    inside each cell block under a hit-gated ``lax.cond`` (the round-2
    design). ``compact`` — the pair pass emits per-slot hit-endpoint
    flags only (one lean d² sweep, no branch machinery) and the exact
    reference count is computed once per step by compact_collision_count
    over the few flagged slots. Both are exact; their economics differ
    with collision density. PSIM_COLLIDE overrides.
    """
    mode = os.environ.get("PSIM_COLLIDE", "block")
    if mode not in ("block", "compact"):
        raise ValueError(
            f"unknown collision mode {mode!r} (PSIM_COLLIDE); "
            f"valid: ['block', 'compact']")
    return mode


def compact_collision_count(xf, yf, cellf, pidf, flagf, eps: float,
                            hcap: int):
    """Exact reference collision count from hit-endpoint flags.

    Inputs are flat 1-D slot arrays in any tile layout: f32 coordinates,
    int32 same-cell domain ids (tile row index — pairs interact only
    within one id), int32 pid keys whose ascending order within a cell
    equals the reference bucket order (raw pids: the blocked path's
    pid-RANK keys are a strictly monotone per-cell transform of them, so
    every min/lexicographic comparison agrees — order-isomorphism), and
    the bool flags from a flags-mode fused pair pass.

    The flagged slots (all hit-pair endpoints — both endpoints of any
    hit pair are flagged by construction) are compacted into ``hcap``
    slots with a cumsum+scatter, then one (hcap, hcap) pass applies the
    reference set rule (serial/parsim.cpp:392-418): re-derive hit pairs
    (same cell, d² < eps² — bit-identical f32 values, so the same pairs),
    key each by (min pid, max pid) lexicographic, find each endpoint's
    first pair, and count pairs that are first for BOTH endpoints —
    exactly fused_pairs_v2's blocked rank rule.

    Returns (count:int32, hovf:int32); hovf > 0 = more than hcap slots
    flagged (count is then unreliable — callers must retry losslessly
    with a bigger hcap; the engines encode this as HIT_OVF + hovf in
    their overflow channel).
    """
    INF = jnp.int32(0x7FFFFFFF)
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    fi = flagf.astype(jnp.int32)
    pos = jnp.cumsum(fi) - fi                     # exclusive prefix
    H = pos[-1] + fi[-1]
    hovf = jnp.where(H > hcap, H, jnp.int32(0))
    tgt = jnp.where(flagf, pos, jnp.int32(hcap))  # hcap -> dropped

    def put(v, fill):
        base = jnp.full((hcap,), fill, v.dtype)
        return base.at[tgt].set(v, mode="drop")

    cx = put(xf, jnp.float32(0.0))
    cy = put(yf, jnp.float32(0.0))
    cc = put(cellf, jnp.int32(-1))
    cp = put(pidf, INF)
    k = jnp.arange(hcap, dtype=jnp.int32)
    vld = k < jnp.minimum(H, hcap)
    pm = (vld[:, None] & vld[None, :]
          & (k[:, None] < k[None, :])
          & (cc[:, None] == cc[None, :]))
    dx = cx[None, :] - cx[:, None]
    dy = cy[None, :] - cy[:, None]
    pm = pm & (dx * dx + dy * dy < eps2)
    kmin = jnp.minimum(cp[:, None], cp[None, :])
    kmax = jnp.maximum(cp[:, None], cp[None, :])
    km = jnp.where(pm, kmin, INF)
    p1 = jnp.minimum(jnp.min(km, axis=1), jnp.min(km, axis=0))
    kx_a = jnp.where(pm & (kmin == p1[:, None]), kmax, INF)
    kx_b = jnp.where(pm & (kmin == p1[None, :]), kmax, INF)
    p2 = jnp.minimum(jnp.min(kx_a, axis=1), jnp.min(kx_b, axis=0))
    first = (pm & (kmin == p1[:, None]) & (kmax == p2[:, None])
             & (kmin == p1[None, :]) & (kmax == p2[None, :]))
    cnt = jnp.sum(first, dtype=jnp.int32)
    return cnt, hovf


def default_hcap() -> int:
    return int(os.environ.get("PSIM_HCAP", "1024"))


def _eff_cb(cb: int, kcap: int) -> int:
    if kcap <= 192:
        return cb
    return max(8, (cb * 192 // kcap) // 8 * 8)


def _snug_cb(cb: int, ncells: int) -> int:
    """Rebalance the cell-block size to the actual cell count.

    Keeps the block count ceil(ncells / cb) but shrinks the block so the
    last block carries at most 7 padded cell rows instead of up to
    cb - 1. Exact by construction: every per-cell output (forces, ranks,
    counts) is computed within its own (K, K) row — block boundaries
    group whole cell rows and never mix them — so the result is bitwise
    independent of cb. A padded cell row costs the full K² lanes of its
    block; at D=8 the column-sharded banded engine's per-shard bands are
    13 columns wide, so without this every band rounded up to a full
    1024-row block — 2.96x the single-chip pair lanes on the UNEVEN
    compose config.
    """
    nb = max(1, -(-ncells // cb))
    return min(cb, max(8, (-(-ncells // nb) + 7) // 8 * 8))


def _blocked(a, cb):
    nb = -(-a.shape[0] // cb)
    pad = nb * cb - a.shape[0]
    if pad:
        a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
    return a.reshape(nb, cb, *a.shape[1:])


def dense_pairwise_forces(xd, yd, md, ml_t, mxl_t, myl_t, ncells: int,
                          kcap: int, cb: int = CELL_BLOCK):
    """(ncells, K) tiles + (ncells, 8) stencil → per-slot (fx, fy)."""
    cb = _snug_cb(_eff_cb(cb, kcap), ncells)
    g = jnp.float32(G)

    def block(args):
        x, y, m, ml, mxl, myl = args          # (cb, K), (cb, 8)
        gm = g * m
        dx = x[:, None, :] - x[:, :, None]    # (cb, K, K) — fused by XLA
        dy = y[:, None, :] - y[:, :, None]
        d2 = dx * dx + dy * dy
        nz = d2 > 0.0
        inv = jnp.where(nz, jax.lax.rsqrt(jnp.where(nz, d2, 1.0)), 0.0)
        s = gm[:, :, None] * m[:, None, :] * (inv * inv * inv)
        fx = jnp.sum(s * dx, axis=2)
        fy = jnp.sum(s * dy, axis=2)
        for l in range(8):
            cm = ml[:, l:l + 1]
            dxl = mxl[:, l:l + 1] - x
            dyl = myl[:, l:l + 1] - y
            d2l = dxl * dxl + dyl * dyl
            nzl = d2l > 0.0
            invl = jnp.where(nzl, jax.lax.rsqrt(jnp.where(nzl, d2l, 1.0)),
                             0.0)
            sl = gm * cm * (invl * invl * invl)
            fx = fx + sl * dxl
            fy = fy + sl * dyl
        return fx, fy

    args = tuple(_blocked(a, cb) for a in (xd, yd, md, ml_t, mxl_t, myl_t))
    fx, fy = jax.lax.map(block, args)
    fx = fx.reshape(-1, kcap)[:ncells]
    fy = fy.reshape(-1, kcap)[:ncells]
    return fx, fy


def _pid_ranks(pid, alive):
    """Alive-pid rank per slot: #{alive j in the cell : pid_j < pid_i}.

    The reference's collision set rule visits pairs in *bucket* order =
    ascending pid (serial/parsim.cpp:393-411). The resident impl's slot
    order departs from pid order after migration (movers land in free
    slots), so slot-index ranks could resolve chain/triangle tie-breaks
    differently; ranking by pid restores the exact bucket-order semantics.
    An O(K²) int compare-sum, fused into the already-K² pair pass.
    """
    less = (alive[:, None, :] > 0) & (pid[:, None, :] < pid[:, :, None])
    return jnp.sum(less, axis=2, dtype=jnp.int32)


def _pair_ranks(pid, alive, i_idx, j_idx, base):
    if pid is None:
        return i_idx * base + j_idx
    pr = _pid_ranks(pid, alive)
    ri = pr[:, :, None]
    rj = pr[:, None, :]
    return jnp.minimum(ri, rj) * base + jnp.maximum(ri, rj)


def fused_pairs(xd, yd, mfd, alived, ncells: int, kcap: int, eps: float,
                collide: bool = True, cb: int = CELL_BLOCK, pid=None):
    """One pair sweep producing both step t's collisions and step t+1's
    pairwise forces.

    The collision pass over post-move positions and the next step's pairwise
    force pass iterate the *same* pair distances, so a single kernel computes
    d² once per pair and emits: (fxd, fyd, count, ftd). Forces use masses
    with this pass's deaths already applied (exactly the reference ordering:
    merged particles are massless for the next step's forces,
    serial/parsim.cpp:414-418 then :292-377).

    mfd: physics masses (limbo-masked); alived: int32 collision-alive mask.
    With ``collide=False`` (run prologue) no pairs collide and masses pass
    through unchanged.
    """
    cb = _snug_cb(_eff_cb(cb, kcap), ncells)
    g = jnp.float32(G)
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    INF = jnp.int32(0x7FFFFFFF)
    base = jnp.int32(kcap + 1)

    def block(args):
        x, y, mf, alive = args[:4]
        pd = args[4] if pid is not None else None
        dx = x[:, None, :] - x[:, :, None]
        dy = y[:, None, :] - y[:, :, None]
        d2 = dx * dx + dy * dy
        if collide:
            pair_alive = (alive[:, :, None] * alive[:, None, :]) > 0
            i_idx = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
            j_idx = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
            hit = pair_alive & (d2 < eps2) & (j_idx > i_idx)
            rank = _pair_ranks(pd, alive, i_idx, j_idx, base)
            cand = jnp.where(hit, rank, INF)
            ft = jnp.minimum(jnp.min(cand, axis=2), jnp.min(cand, axis=1))
            first_both = (hit & (ft[:, :, None] == cand)
                          & (ft[:, None, :] == cand))
            cnt = jnp.sum(first_both, dtype=jnp.int32)
            m_post = jnp.where(ft != INF, jnp.float32(0.0), mf)
        else:
            ft = jnp.full(x.shape, INF, dtype=jnp.int32)
            cnt = jnp.int32(0)
            m_post = mf
        nz = d2 > 0.0
        inv = jnp.where(nz, jax.lax.rsqrt(jnp.where(nz, d2, 1.0)), 0.0)
        s = (g * m_post)[:, :, None] * m_post[:, None, :] * (inv * inv * inv)
        fx = jnp.sum(s * dx, axis=2)
        fy = jnp.sum(s * dy, axis=2)
        return fx, fy, ft, cnt

    ins = (xd, yd, mfd, alived) + ((pid,) if pid is not None else ())
    args = tuple(_blocked(a, cb) for a in ins)
    fx, fy, ft, cnts = jax.lax.map(block, args)
    return (fx.reshape(-1, kcap)[:ncells], fy.reshape(-1, kcap)[:ncells],
            jnp.sum(cnts, dtype=jnp.int32), ft.reshape(-1, kcap)[:ncells])


def fused_pairs_v2(xd, yd, mfd, alived, ncells: int, kcap: int, eps: float,
                   collide: bool | str = True, cb: int = CELL_BLOCK,
                   pid=None, ichunk: int | None = None, sub=None):
    """Occupancy-adaptive fused pair pass (same contract as fused_pairs).

    ``collide`` is mode-typed: ``True``/``False`` run/skip the blocked
    first-pair rank machinery and return int32 first-pair ranks (INF =
    no hit) in the 4th slot; the sentinel string ``"flags"`` (compact
    collision resolution, PSIM_COLLIDE=compact) instead returns **bool
    hit-endpoint flags** in that slot with the count fixed at 0 — the
    caller derives deaths directly from the flags and computes the exact
    count via ``compact_collision_count``.

    ``sub`` (optional int32 (ncells, K) tiles): same-cell labels for
    super-cell rows (ops/supercell.py), where one tile row covers S²
    physical cells. When given, a pair interacts / can collide only if
    both slots carry the same label — the reference's same-cell-only rule
    (serial/parsim.cpp:356-366,393-411) at sub-row granularity. The
    collision set rule decomposes exactly per label: hits never span
    labels, so each particle's first-colliding-pair rank involves only
    its own cell's pairs, and the row-wide pid ranks preserve the
    within-cell pid order the tie-break depends on.

    Two structural optimizations over the flat K² formulation, both exact:

    * **i-chunk skipping** — per block, receiver chunks run only up to
      ``kb`` = the highest used slot index in the block (a dynamic
      ``fori_loop`` bound). Slots past kb are empty (m=0, alive=0): their
      force rows are zero and they form no pairs, so skipping them changes
      nothing. Arrivals fill the lowest free slots (ops/resident.py), so
      kb tracks real occupancy, not capacity — this reclaims most of the
      K_cap² ≫ Σk_c² padding waste.
    * **hit-gated collision bookkeeping** — a cheap d² pass first computes
      a per-block "any pair within ε" flag; the rank/min/count machinery
      (including the pid-rank tie-break pass) runs under a ``lax.cond``
      only for blocks that actually have a hit — rare by construction
      (collisions per step ≪ blocks per step). The branch *recomputes*
      pair data from the (CB, K) tiles rather than closing over (CB, K, K)
      intermediates — a closed-over hit tensor becomes a branch operand
      and costs more than it saves.
    * **hit-chunk skipping** — the d² pass also records WHICH receiver
      chunks contain a hit endpoint (a (nb_i,) flag vector); inside the
      gated branch, the min/count candidate sweeps run per receiver chunk
      under a per-trip ``lax.cond`` on that flag. Both endpoints of a hit
      pair lie within ε of each other, so both are hit slots and every
      hit pair's receiver chunk is flagged — skipped chunks contribute
      only INF/zero, making the skip exact. This is what keeps the
      machinery cheap on *collision-dense* workloads (at N=1e7 there are
      ~1.6 expected hits per block ⇒ ~80% of blocks enter the branch
      every step, but only ~1 of nb_i receiver chunks is flagged).
    """
    cb = _snug_cb(_eff_cb(cb, kcap), ncells)
    g = jnp.float32(G)
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    INF = jnp.int32(0x7FFFFFFF)
    base = jnp.int32(kcap + 1)
    # Chunk width must divide kcap (overlapping clamped slices would double-
    # count pairs); engine kcaps are multiples of 32, tests use tiny kcaps.
    ichunk = PAIR_ICHUNK if ichunk is None else ichunk
    ichunk = min(ichunk, kcap)
    while kcap % ichunk:
        ichunk //= 2
    nb_i = -(-kcap // ichunk)

    def block(args):
        x, y, mf, alive = args[:4]
        rest = list(args[4:])
        pd = rest.pop(0) if pid is not None else None
        sb = rest.pop(0) if sub is not None else None
        lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
        used = (mf > 0.0) | (alive > 0)
        kb = jnp.max(jnp.where(used, lane + 1, 0))
        trips = jnp.minimum((kb + ichunk - 1) // ichunk, nb_i)

        def islice(a, i0, width=ichunk):
            return jax.lax.dynamic_slice_in_dim(a, i0, width, axis=1)

        def same_cell(i0):
            if sb is None:
                return None
            return islice(sb, i0)[:, :, None] == sb[:, None, :]

        if collide == "flags":
            # Flags mode (PSIM_COLLIDE=compact): one lean d² sweep emits
            # per-slot hit-ENDPOINT flags and NO rank machinery runs here.
            # Deaths are exactly the flags (the reference kills every
            # member of a cell's collision set, serial/parsim.cpp:414-418
            # == every endpoint of some hit pair), so post-death masses —
            # and therefore the force pass below — are bit-identical to
            # the blocked path's. The collision COUNT (which needs the
            # first-pair rank rule) is computed by the caller from the
            # flags via compact_collision_count — a single tiny O(H²)
            # pass over the few flagged slots instead of per-block branch
            # machinery on every hit block (collision-dense workloads run
            # ~80% of blocks through the branch every step).
            def flag_body(t, fl):
                i0 = t * ichunk
                xi = islice(x, i0)
                yi = islice(y, i0)
                ai = islice(alive, i0)
                dx = x[:, None, :] - xi[:, :, None]
                dy = y[:, None, :] - yi[:, :, None]
                d2 = dx * dx + dy * dy
                pa = (ai[:, :, None] * alive[:, None, :]) > 0
                ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i0
                jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                hit = pa & (d2 < eps2) & (jj > ii)
                sc = same_cell(i0)
                if sc is not None:
                    hit = hit & sc
                fl = fl | jnp.any(hit, axis=1)               # j endpoints
                fi = islice(fl, i0) | jnp.any(hit, axis=2)   # i endpoints
                return jax.lax.dynamic_update_slice_in_dim(fl, fi, i0,
                                                           axis=1)

            flags = jax.lax.fori_loop(0, trips, flag_body,
                                      jnp.zeros(x.shape, jnp.bool_))
            ft = flags
            cnt = jnp.int32(0)
            m_post = jnp.where(flags, jnp.float32(0.0), mf)
        elif collide:
            # Pass 1 — per-receiver-chunk hit flags (cheapest pair scan).
            def hit_body(t, hc):
                i0 = t * ichunk
                xi = islice(x, i0)
                yi = islice(y, i0)
                ai = islice(alive, i0)
                dx = x[:, None, :] - xi[:, :, None]
                dy = y[:, None, :] - yi[:, :, None]
                d2 = dx * dx + dy * dy
                pa = (ai[:, :, None] * alive[:, None, :]) > 0
                ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i0
                jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                hit = pa & (d2 < eps2) & (jj > ii)
                sc = same_cell(i0)
                if sc is not None:
                    hit = hit & sc
                return hc.at[t].set(jnp.any(hit))

            hc = jax.lax.fori_loop(0, trips, hit_body,
                                   jnp.zeros((nb_i,), jnp.bool_))
            any_hit = jnp.any(hc)

            def do_collide(_):
                pr = (None if pd is None else _pid_ranks(pd, alive))

                def cand_chunk(i0):
                    xi = islice(x, i0)
                    yi = islice(y, i0)
                    ai = islice(alive, i0)
                    dx = x[:, None, :] - xi[:, :, None]
                    dy = y[:, None, :] - yi[:, :, None]
                    d2 = dx * dx + dy * dy
                    pa = (ai[:, :, None] * alive[:, None, :]) > 0
                    ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i0
                    jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                    hit = pa & (d2 < eps2) & (jj > ii)
                    sc = same_cell(i0)
                    if sc is not None:
                        hit = hit & sc
                    if pr is None:
                        rank = ii * base + jj
                    else:
                        ri = islice(pr, i0)[:, :, None]
                        rj = pr[:, None, :]
                        rank = jnp.minimum(ri, rj) * base + jnp.maximum(ri, rj)
                    return jnp.where(hit, rank, INF), hit

                # Receiver chunks with no hit endpoint are skipped per
                # trip (hc flag): a hit pair's BOTH endpoints are hit
                # slots, so its receiver chunk is always flagged, and an
                # unflagged chunk's candidates are all INF / fb all
                # false — skipping is exact.
                def min_body(t, carry):
                    def live(c):
                        fti, ftj = c
                        i0 = t * ichunk
                        cand, _ = cand_chunk(i0)
                        fti = jax.lax.dynamic_update_slice_in_dim(
                            fti, jnp.min(cand, axis=2), i0, axis=1)
                        ftj = jnp.minimum(ftj, jnp.min(cand, axis=1))
                        return fti, ftj

                    return jax.lax.cond(hc[t], live, lambda c: c, carry)

                ftINF = jnp.full(x.shape, INF, dtype=jnp.int32)
                fti, ftj = jax.lax.fori_loop(0, trips, min_body,
                                             (ftINF, ftINF))
                ft = jnp.minimum(fti, ftj)

                def cnt_body(t, cnt):
                    def live(c):
                        i0 = t * ichunk
                        cand, hit = cand_chunk(i0)
                        fti_c = islice(ft, i0)
                        fb = (hit & (fti_c[:, :, None] == cand)
                              & (ft[:, None, :] == cand))
                        return c + jnp.sum(fb, dtype=jnp.int32)

                    return jax.lax.cond(hc[t], live, lambda c: c, cnt)

                cnt = jax.lax.fori_loop(0, trips, cnt_body, jnp.int32(0))
                return ft, cnt

            def no_collide(_):
                return jnp.full(x.shape, INF, dtype=jnp.int32), jnp.int32(0)

            ft, cnt = jax.lax.cond(any_hit, do_collide, no_collide, None)
            m_post = jnp.where(ft != INF, jnp.float32(0.0), mf)
        else:
            ft = jnp.full(x.shape, INF, dtype=jnp.int32)
            cnt = jnp.int32(0)
            m_post = mf

        # Pass 2 — forces over i-chunks (dynamic trip count).
        gm = g * m_post

        def force_body(t, carry):
            fx, fy = carry
            i0 = t * ichunk
            xi = islice(x, i0)
            yi = islice(y, i0)
            gmi = islice(gm, i0)
            dx = x[:, None, :] - xi[:, :, None]
            dy = y[:, None, :] - yi[:, :, None]
            d2 = dx * dx + dy * dy
            nz = d2 > 0.0
            sc = same_cell(i0)
            if sc is not None:
                nz = nz & sc
            inv = jnp.where(nz, jax.lax.rsqrt(jnp.where(nz, d2, 1.0)), 0.0)
            s = gmi[:, :, None] * m_post[:, None, :] * (inv * inv * inv)
            fx = jax.lax.dynamic_update_slice_in_dim(
                fx, jnp.sum(s * dx, axis=2), i0, axis=1)
            fy = jax.lax.dynamic_update_slice_in_dim(
                fy, jnp.sum(s * dy, axis=2), i0, axis=1)
            return fx, fy

        fx0 = jnp.zeros_like(x)
        fx, fy = jax.lax.fori_loop(0, trips, force_body, (fx0, fx0))
        return fx, fy, ft, cnt

    ins = ((xd, yd, mfd, alived) + ((pid,) if pid is not None else ())
           + ((sub,) if sub is not None else ()))
    args = tuple(_blocked(a, cb) for a in ins)
    fx, fy, ft, cnts = jax.lax.map(block, args)
    return (fx.reshape(-1, kcap)[:ncells], fy.reshape(-1, kcap)[:ncells],
            jnp.sum(cnts, dtype=jnp.int32), ft.reshape(-1, kcap)[:ncells])


def fused_pairs_v3(xd, yd, mfd, alived, ncells: int, kcap: int, eps: float,
                   collide: bool = True, cb: int = CELL_BLOCK, pid=None,
                   ichunk: int | None = None):
    """One-sweep fused pair pass (same contract and bit-identical outputs
    as fused_pairs_v2). NOT the default; see below.

    v2 pays two chunked pair sweeps per block every step: a d²-only
    hit-flag pass, then the force pass. v3 folds the hit flag into the
    force sweep (three extra cheap ops per pair) and computes forces with
    *pre-collision* masses; only blocks whose flag fired — rare by
    construction, collisions per step ≪ blocks per step — enter a
    ``lax.cond`` that runs the collision rank machinery and *recomputes*
    the block's forces from the (CB, K) tiles with post-death masses.
    Recompute-not-correct keeps results bit-identical to v2: a no-hit
    block's m_post == mf so the pre-mass forces are already exact, and a
    hit block's forces are rebuilt with the same formula v2 uses. Branch
    operands stay (CB, K)-sized (closing over (CB, K, K) intermediates
    costs more than it saves).

    It lost to v2 on the first target (the cond's operand materialization
    plus double-swept hit blocks cost more than the d²-only hit pass they
    replace); not measured on the H100. Kept as a selectable variant
    (PSIM_PAIR_IMPL=v3); its bit-equality with v2 is pinned in
    tests/test_dense_kernels.py.
    """
    cb = _snug_cb(_eff_cb(cb, kcap), ncells)
    g = jnp.float32(G)
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    INF = jnp.int32(0x7FFFFFFF)
    base = jnp.int32(kcap + 1)
    ichunk = PAIR_ICHUNK if ichunk is None else ichunk
    ichunk = min(ichunk, kcap)
    while kcap % ichunk:
        ichunk //= 2
    nb_i = -(-kcap // ichunk)

    def block(args):
        x, y, mf, alive = args[:4]
        pd = args[4] if pid is not None else None
        lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
        used = (mf > 0.0) | (alive > 0)
        kb = jnp.max(jnp.where(used, lane + 1, 0))
        trips = jnp.minimum((kb + ichunk - 1) // ichunk, nb_i)

        def islice(a, i0, width=ichunk):
            return jax.lax.dynamic_slice_in_dim(a, i0, width, axis=1)

        def force_sweep(gm, m_partner, with_hit):
            """Chunked force accumulation; optionally also the hit flag."""
            def body(t, carry):
                fx, fy, anyhit = carry
                i0 = t * ichunk
                xi = islice(x, i0)
                yi = islice(y, i0)
                gmi = islice(gm, i0)
                dx = x[:, None, :] - xi[:, :, None]
                dy = y[:, None, :] - yi[:, :, None]
                d2 = dx * dx + dy * dy
                nz = d2 > 0.0
                inv = jnp.where(nz, jax.lax.rsqrt(jnp.where(nz, d2, 1.0)),
                                0.0)
                s = (gmi[:, :, None] * m_partner[:, None, :]
                     * (inv * inv * inv))
                fx = jax.lax.dynamic_update_slice_in_dim(
                    fx, jnp.sum(s * dx, axis=2), i0, axis=1)
                fy = jax.lax.dynamic_update_slice_in_dim(
                    fy, jnp.sum(s * dy, axis=2), i0, axis=1)
                if with_hit:
                    ai = islice(alive, i0)
                    pa = (ai[:, :, None] * alive[:, None, :]) > 0
                    ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i0
                    jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                    anyhit = anyhit | jnp.any(pa & (d2 < eps2) & (jj > ii))
                return fx, fy, anyhit

            z = jnp.zeros_like(x)
            return jax.lax.fori_loop(0, trips, body,
                                     (z, z, jnp.bool_(False)))

        fx0, fy0, any_hit = force_sweep(g * mf, mf, with_hit=collide)

        if collide:
            pr_none = pd is None

            def cand_chunk(pr, i0):
                xi = islice(x, i0)
                yi = islice(y, i0)
                ai = islice(alive, i0)
                dx = x[:, None, :] - xi[:, :, None]
                dy = y[:, None, :] - yi[:, :, None]
                d2 = dx * dx + dy * dy
                pa = (ai[:, :, None] * alive[:, None, :]) > 0
                ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i0
                jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                hit = pa & (d2 < eps2) & (jj > ii)
                if pr_none:
                    rank = ii * base + jj
                else:
                    ri = islice(pr, i0)[:, :, None]
                    rj = pr[:, None, :]
                    rank = jnp.minimum(ri, rj) * base + jnp.maximum(ri, rj)
                return jnp.where(hit, rank, INF), hit

            def do_collide(_):
                pr = (None if pr_none else _pid_ranks(pd, alive))

                def min_body(t, carry):
                    fti, ftj = carry
                    i0 = t * ichunk
                    cand, _ = cand_chunk(pr, i0)
                    fti = jax.lax.dynamic_update_slice_in_dim(
                        fti, jnp.min(cand, axis=2), i0, axis=1)
                    ftj = jnp.minimum(ftj, jnp.min(cand, axis=1))
                    return fti, ftj

                ftINF = jnp.full(x.shape, INF, dtype=jnp.int32)
                fti, ftj = jax.lax.fori_loop(0, trips, min_body,
                                             (ftINF, ftINF))
                ft = jnp.minimum(fti, ftj)

                def cnt_body(t, cnt):
                    i0 = t * ichunk
                    cand, hit = cand_chunk(pr, i0)
                    fti_c = islice(ft, i0)
                    fb = (hit & (fti_c[:, :, None] == cand)
                          & (ft[:, None, :] == cand))
                    return cnt + jnp.sum(fb, dtype=jnp.int32)

                cnt = jax.lax.fori_loop(0, trips, cnt_body, jnp.int32(0))
                m_post = jnp.where(ft != INF, jnp.float32(0.0), mf)
                fx2, fy2, _ = force_sweep(g * m_post, m_post, with_hit=False)
                return ft, cnt, fx2, fy2

            def no_hit(_):
                return (jnp.full(x.shape, INF, dtype=jnp.int32),
                        jnp.int32(0), fx0, fy0)

            ft, cnt, fx, fy = jax.lax.cond(any_hit, do_collide, no_hit, None)
        else:
            ft = jnp.full(x.shape, INF, dtype=jnp.int32)
            cnt = jnp.int32(0)
            fx, fy = fx0, fy0
        return fx, fy, ft, cnt

    ins = (xd, yd, mfd, alived) + ((pid,) if pid is not None else ())
    args = tuple(_blocked(a, cb) for a in ins)
    fx, fy, ft, cnts = jax.lax.map(block, args)
    return (fx.reshape(-1, kcap)[:ncells], fy.reshape(-1, kcap)[:ncells],
            jnp.sum(cnts, dtype=jnp.int32), ft.reshape(-1, kcap)[:ncells])


def fused_pairs_v4(xd, yd, mfd, alived, ncells: int, kcap: int, eps: float,
                   collide: bool | str = True, cb: int = CELL_BLOCK,
                   pid=None, ichunk: int | None = None, sub=None):
    """Contraction-form pair pass (same contract as fused_pairs_v2,
    including the ``collide="flags"`` mode's bool-endpoint-flag return).

    Rewrites the force reduction as two contractions per chunk:

        fx_i = G·m_i·( Σ_j w_ij·xl_j − xl_i·Σ_j w_ij ),  w_ij = m_j/d³

    with xl = x recentered by the row mean (any per-row constant cancels
    exactly in the algebra; recentering bounds the cancellation). The
    per-pair ``s·dx`` multiplies + tree reductions become einsums, run at
    ``F32_MATMUL`` (true f32: a reduced-precision matmul would wreck the
    cancelling difference below).

    Adoption is gated on the cancellation study: for a
    near-EPSILON pair the two contraction terms are ~w·|xl| each while
    their difference is ~w·d, so the relative force error grows like
    |xl|/d ≈ cell_width/EPSILON ULPs (tests/test_dense_kernels.py); the
    collision machinery is v2's exactly (d² never enters a contraction).
    """
    cb = _snug_cb(_eff_cb(cb, kcap), ncells)
    g = jnp.float32(G)
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    INF = jnp.int32(0x7FFFFFFF)
    base = jnp.int32(kcap + 1)
    ichunk = PAIR_ICHUNK if ichunk is None else ichunk
    ichunk = min(ichunk, kcap)
    while kcap % ichunk:
        ichunk //= 2
    nb_i = -(-kcap // ichunk)

    def block(args):
        x, y, mf, alive = args[:4]
        rest = list(args[4:])
        pd = rest.pop(0) if pid is not None else None
        sb = rest.pop(0) if sub is not None else None
        lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
        used = (mf > 0.0) | (alive > 0)
        kb = jnp.max(jnp.where(used, lane + 1, 0))
        trips = jnp.minimum((kb + ichunk - 1) // ichunk, nb_i)

        def islice(a, i0, width=ichunk):
            return jax.lax.dynamic_slice_in_dim(a, i0, width, axis=1)

        def same_cell(i0):
            if sb is None:
                return None
            return islice(sb, i0)[:, :, None] == sb[:, None, :]

        # ---- collision machinery: identical to fused_pairs_v2 ----------
        if collide == "flags":
            # Flags mode — see fused_pairs_v2: endpoint flags only, deaths
            # == flags, count computed by the caller (compact rule pass).
            def flag_body(t, fl):
                i0 = t * ichunk
                xi = islice(x, i0)
                yi = islice(y, i0)
                ai = islice(alive, i0)
                dx = x[:, None, :] - xi[:, :, None]
                dy = y[:, None, :] - yi[:, :, None]
                d2 = dx * dx + dy * dy
                pa = (ai[:, :, None] * alive[:, None, :]) > 0
                ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i0
                jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                hit = pa & (d2 < eps2) & (jj > ii)
                sc = same_cell(i0)
                if sc is not None:
                    hit = hit & sc
                fl = fl | jnp.any(hit, axis=1)               # j endpoints
                fi = islice(fl, i0) | jnp.any(hit, axis=2)   # i endpoints
                return jax.lax.dynamic_update_slice_in_dim(fl, fi, i0,
                                                           axis=1)

            flags = jax.lax.fori_loop(0, trips, flag_body,
                                      jnp.zeros(x.shape, jnp.bool_))
            ft = flags
            cnt = jnp.int32(0)
            m_post = jnp.where(flags, jnp.float32(0.0), mf)
        elif collide:
            def hit_body(t, hc):
                i0 = t * ichunk
                xi = islice(x, i0)
                yi = islice(y, i0)
                ai = islice(alive, i0)
                dx = x[:, None, :] - xi[:, :, None]
                dy = y[:, None, :] - yi[:, :, None]
                d2 = dx * dx + dy * dy
                pa = (ai[:, :, None] * alive[:, None, :]) > 0
                ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i0
                jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                hit = pa & (d2 < eps2) & (jj > ii)
                sc = same_cell(i0)
                if sc is not None:
                    hit = hit & sc
                return hc.at[t].set(jnp.any(hit))

            hc = jax.lax.fori_loop(0, trips, hit_body,
                                   jnp.zeros((nb_i,), jnp.bool_))
            any_hit = jnp.any(hc)

            def do_collide(_):
                pr = (None if pd is None else _pid_ranks(pd, alive))

                def cand_chunk(i0):
                    xi = islice(x, i0)
                    yi = islice(y, i0)
                    ai = islice(alive, i0)
                    dx = x[:, None, :] - xi[:, :, None]
                    dy = y[:, None, :] - yi[:, :, None]
                    d2 = dx * dx + dy * dy
                    pa = (ai[:, :, None] * alive[:, None, :]) > 0
                    ii = (jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
                          + i0)
                    jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                    hit = pa & (d2 < eps2) & (jj > ii)
                    sc = same_cell(i0)
                    if sc is not None:
                        hit = hit & sc
                    if pr is None:
                        rank = ii * base + jj
                    else:
                        ri = islice(pr, i0)[:, :, None]
                        rj = pr[:, None, :]
                        rank = (jnp.minimum(ri, rj) * base
                                + jnp.maximum(ri, rj))
                    return jnp.where(hit, rank, INF), hit

                # Per-trip hc gating: see fused_pairs_v2 (exactness
                # argument identical — both hit endpoints are flagged).
                def min_body(t, carry):
                    def live(c):
                        fti, ftj = c
                        i0 = t * ichunk
                        cand, _ = cand_chunk(i0)
                        fti = jax.lax.dynamic_update_slice_in_dim(
                            fti, jnp.min(cand, axis=2), i0, axis=1)
                        ftj = jnp.minimum(ftj, jnp.min(cand, axis=1))
                        return fti, ftj

                    return jax.lax.cond(hc[t], live, lambda c: c, carry)

                ftINF = jnp.full(x.shape, INF, dtype=jnp.int32)
                fti, ftj = jax.lax.fori_loop(0, trips, min_body,
                                             (ftINF, ftINF))
                ft = jnp.minimum(fti, ftj)

                def cnt_body(t, cnt):
                    def live(c):
                        i0 = t * ichunk
                        cand, hit = cand_chunk(i0)
                        fti_c = islice(ft, i0)
                        fb = (hit & (fti_c[:, :, None] == cand)
                              & (ft[:, None, :] == cand))
                        return c + jnp.sum(fb, dtype=jnp.int32)

                    return jax.lax.cond(hc[t], live, lambda c: c, cnt)

                cnt = jax.lax.fori_loop(0, trips, cnt_body, jnp.int32(0))
                return ft, cnt

            def no_collide(_):
                return jnp.full(x.shape, INF, dtype=jnp.int32), jnp.int32(0)

            ft, cnt = jax.lax.cond(any_hit, do_collide, no_collide, None)
            m_post = jnp.where(ft != INF, jnp.float32(0.0), mf)
        else:
            ft = jnp.full(x.shape, INF, dtype=jnp.int32)
            cnt = jnp.int32(0)
            m_post = mf

        # ---- contraction force form ------------------------------------
        nrow = jnp.maximum(jnp.sum(m_post > 0, axis=1,
                                   dtype=jnp.int32), 1).astype(jnp.float32)
        cx0 = jnp.sum(jnp.where(m_post > 0, x, 0.0), axis=1) / nrow
        cy0 = jnp.sum(jnp.where(m_post > 0, y, 0.0), axis=1) / nrow
        xl = x - cx0[:, None]
        yl = y - cy0[:, None]
        gm = g * m_post
        # PSIM_V4_STACK=1: one (CB,Ic,K)x(CB,K,3) contraction instead of
        # three traversals of w (sx, sy, sum) — same math per output
        # element, different only in XLA's reduction scheduling.
        stacked = os.environ.get("PSIM_V4_STACK") == "1"
        rhs = (jnp.stack([xl, yl, jnp.ones_like(xl)], axis=-1)
               if stacked else None)

        def force_body(t, carry):
            fx, fy = carry
            i0 = t * ichunk
            xi = islice(xl, i0)
            yi = islice(yl, i0)
            gmi = islice(gm, i0)
            dx = xl[:, None, :] - xi[:, :, None]
            dy = yl[:, None, :] - yi[:, :, None]
            d2 = dx * dx + dy * dy
            nz = d2 > 0.0
            sc = same_cell(i0)
            if sc is not None:
                nz = nz & sc
            inv = jnp.where(nz, jax.lax.rsqrt(jnp.where(nz, d2, 1.0)), 0.0)
            w = m_post[:, None, :] * (inv * inv * inv)     # (CB, Ic, K)
            if stacked:
                s3 = jnp.einsum("cik,ckd->cid", w, rhs,
                                precision=F32_MATMUL)
                sx, sy, sw = s3[..., 0], s3[..., 1], s3[..., 2]
            else:
                sx = jnp.einsum("cik,ck->ci", w, xl, precision=F32_MATMUL)
                sy = jnp.einsum("cik,ck->ci", w, yl, precision=F32_MATMUL)
                sw = jnp.sum(w, axis=2)
            fx = jax.lax.dynamic_update_slice_in_dim(
                fx, gmi * (sx - xi * sw), i0, axis=1)
            fy = jax.lax.dynamic_update_slice_in_dim(
                fy, gmi * (sy - yi * sw), i0, axis=1)
            return fx, fy

        fx0 = jnp.zeros_like(x)
        fx, fy = jax.lax.fori_loop(0, trips, force_body, (fx0, fx0))
        return fx, fy, ft, cnt

    ins = ((xd, yd, mfd, alived) + ((pid,) if pid is not None else ())
           + ((sub,) if sub is not None else ()))
    args = tuple(_blocked(a, cb) for a in ins)
    fx, fy, ft, cnts = jax.lax.map(block, args)
    return (fx.reshape(-1, kcap)[:ncells], fy.reshape(-1, kcap)[:ncells],
            jnp.sum(cnts, dtype=jnp.int32), ft.reshape(-1, kcap)[:ncells])


def fused_pairs_v5(xd, yd, mfd, alived, ncells: int, kcap: int, eps: float,
                   collide: bool = True, cb: int = CELL_BLOCK, pid=None,
                   ichunk: int | None = None, jchunk: int | None = None,
                   sub=None):
    """Newton's-3rd-law triangular pair pass (same contract as
    fused_pairs_v2). MEASURED NEGATIVE RESULT - selectable, not default.

    v2 enumerates every *ordered* pair: each receiver chunk sweeps the
    full K partner axis, so each unordered pair is computed twice. This
    variant sweeps (ichunk x jchunk) chunk *tiles* restricted to the
    upper triangle (inner loop starts at the j-tile containing i0),
    computing each unordered pair once and accumulating the force to both
    endpoints with opposite signs - the dual-update trick of the
    reference's inner loop (serial/parsim.cpp:127-148:
    ``fx += ...; p2->fx -= ...``). Pair-slot count falls from kb*kcap
    toward ~kb^2/2 per cell as kcap grows past jchunk.

    The slot axis pads to a jchunk multiple with inert slots (m=0,
    alive=0: no force terms, no hits); jchunk=None keeps tiles symmetric
    (jchunk=ichunk). Each pair's term is the bitwise-same expression as
    v2's (negation/multiplication are exact), so collision outputs
    (count, ft) are bit-identical and forces differ only in f32 summation
    order. The rare collision-rank branch (hit-gated) keeps v2's chunked
    machinery.

    On the first target the halved pair arithmetic lost to v2 on every
    shape but clustered UNEVEN: the dual-sided accumulation's four
    read-modify-write slice updates per tile force the (cb, K) force
    carries to materialize every iteration, where v2's single full-width
    reduce fuses into one pass. Not measured on the H100. Kept selectable
    (PSIM_PAIR_IMPL=v5) with correctness pinned; not the default.
    """
    cb = _snug_cb(_eff_cb(cb, kcap), ncells)
    g = jnp.float32(G)
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    INF = jnp.int32(0x7FFFFFFF)
    ichunk = PAIR_ICHUNK if ichunk is None else ichunk
    jchunk = ichunk if jchunk is None else max(ichunk, jchunk)
    Kp = -(-kcap // jchunk) * jchunk
    ichunk = min(ichunk, Kp)
    while Kp % ichunk:
        ichunk //= 2
    nb_i = Kp // ichunk
    nb_j = Kp // jchunk
    # Hits never involve padded slots (alive=0), so rank components stay
    # below kcap and v2's base keeps ft values bit-identical across Kp.
    base = jnp.int32(kcap + 1)

    def padk(a):
        if a is None or Kp == kcap:
            return a
        pad = jnp.zeros((a.shape[0], Kp - kcap), a.dtype)
        return jnp.concatenate([a, pad], axis=1)

    xd, yd, mfd = padk(xd), padk(yd), padk(mfd)
    alived, pid, sub = padk(alived), padk(pid), padk(sub)

    def block(args):
        x, y, mf, alive = args[:4]
        rest = list(args[4:])
        pd = rest.pop(0) if pid is not None else None
        sb = rest.pop(0) if sub is not None else None
        lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
        used = (mf > 0.0) | (alive > 0)
        kb = jnp.max(jnp.where(used, lane + 1, 0))
        trips_i = jnp.minimum((kb + ichunk - 1) // ichunk, nb_i)
        trips_j = jnp.minimum((kb + jchunk - 1) // jchunk, nb_j)

        def islice(a, i0, width=ichunk):
            return jax.lax.dynamic_slice_in_dim(a, i0, width, axis=1)

        def tile_mask(i0, j0, shape):
            """j > i (each unordered pair once; excludes self-pairs) plus
            the same-cell label mask for super-cell rows."""
            ii = jax.lax.broadcasted_iota(jnp.int32, shape, 1) + i0
            jj = jax.lax.broadcasted_iota(jnp.int32, shape, 2) + j0
            msk = jj > ii
            if sb is not None:
                msk = msk & (islice(sb, i0)[:, :, None]
                             == islice(sb, j0, jchunk)[:, None, :])
            return msk

        if collide:
            # Triangular hit-flag sweep (the always-on cost).
            def hit_outer(ti, anyhit):
                i0 = ti * ichunk
                xi = islice(x, i0)
                yi = islice(y, i0)
                ai = islice(alive, i0)

                def hit_inner(tj, ah):
                    j0 = tj * jchunk
                    dx = islice(x, j0, jchunk)[:, None, :] - xi[:, :, None]
                    dy = islice(y, j0, jchunk)[:, None, :] - yi[:, :, None]
                    d2 = dx * dx + dy * dy
                    pa = (ai[:, :, None]
                          * islice(alive, j0, jchunk)[:, None, :]) > 0
                    hit = pa & (d2 < eps2) & tile_mask(i0, j0, d2.shape)
                    return ah | jnp.any(hit)

                return jax.lax.fori_loop(i0 // jchunk, trips_j, hit_inner,
                                         anyhit)

            any_hit = jax.lax.fori_loop(0, trips_i, hit_outer,
                                        jnp.bool_(False))

            # Rare path: v2's chunked rank scan, verbatim semantics.
            def same_cell(i0):
                if sb is None:
                    return None
                return islice(sb, i0)[:, :, None] == sb[:, None, :]

            def do_collide(_):
                pr = (None if pd is None else _pid_ranks(pd, alive))

                def cand_chunk(i0):
                    xi = islice(x, i0)
                    yi = islice(y, i0)
                    ai = islice(alive, i0)
                    dx = x[:, None, :] - xi[:, :, None]
                    dy = y[:, None, :] - yi[:, :, None]
                    d2 = dx * dx + dy * dy
                    pa = (ai[:, :, None] * alive[:, None, :]) > 0
                    ii = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1) + i0
                    jj = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
                    hit = pa & (d2 < eps2) & (jj > ii)
                    sc = same_cell(i0)
                    if sc is not None:
                        hit = hit & sc
                    if pr is None:
                        rank = ii * base + jj
                    else:
                        ri = islice(pr, i0)[:, :, None]
                        rj = pr[:, None, :]
                        rank = jnp.minimum(ri, rj) * base + jnp.maximum(ri,
                                                                        rj)
                    return jnp.where(hit, rank, INF), hit

                def min_body(t, carry):
                    fti, ftj = carry
                    i0 = t * ichunk
                    cand, _ = cand_chunk(i0)
                    fti = jax.lax.dynamic_update_slice_in_dim(
                        fti, jnp.min(cand, axis=2), i0, axis=1)
                    ftj = jnp.minimum(ftj, jnp.min(cand, axis=1))
                    return fti, ftj

                ftINF = jnp.full(x.shape, INF, dtype=jnp.int32)
                fti, ftj = jax.lax.fori_loop(0, trips_i, min_body,
                                             (ftINF, ftINF))
                ft = jnp.minimum(fti, ftj)

                def cnt_body(t, cnt):
                    i0 = t * ichunk
                    cand, hit = cand_chunk(i0)
                    fti_c = islice(ft, i0)
                    fb = (hit & (fti_c[:, :, None] == cand)
                          & (ft[:, None, :] == cand))
                    return cnt + jnp.sum(fb, dtype=jnp.int32)

                cnt = jax.lax.fori_loop(0, trips_i, cnt_body, jnp.int32(0))
                return ft, cnt

            def no_collide(_):
                return jnp.full(x.shape, INF, dtype=jnp.int32), jnp.int32(0)

            ft, cnt = jax.lax.cond(any_hit, do_collide, no_collide, None)
            m_post = jnp.where(ft != INF, jnp.float32(0.0), mf)
        else:
            ft = jnp.full(x.shape, INF, dtype=jnp.int32)
            cnt = jnp.int32(0)
            m_post = mf

        # Triangular N3L force sweep: each tile computes s.dx once and
        # applies it +to the i-chunk rows, -to the j-chunk rows.
        gm = g * m_post

        def force_outer(ti, carry):
            i0 = ti * ichunk
            xi = islice(x, i0)
            yi = islice(y, i0)
            gmi = islice(gm, i0)

            def force_inner(tj, carry):
                fx, fy = carry
                j0 = tj * jchunk
                dx = islice(x, j0, jchunk)[:, None, :] - xi[:, :, None]
                dy = islice(y, j0, jchunk)[:, None, :] - yi[:, :, None]
                d2 = dx * dx + dy * dy
                msk = (d2 > 0.0) & tile_mask(i0, j0, d2.shape)
                inv = jnp.where(msk, jax.lax.rsqrt(jnp.where(msk, d2, 1.0)),
                                0.0)
                s = (gmi[:, :, None]
                     * islice(m_post, j0, jchunk)[:, None, :]
                     * (inv * inv * inv))
                sdx = s * dx
                sdy = s * dy
                fx = jax.lax.dynamic_update_slice_in_dim(
                    fx, islice(fx, i0) + jnp.sum(sdx, axis=2), i0, axis=1)
                fx = jax.lax.dynamic_update_slice_in_dim(
                    fx, islice(fx, j0, jchunk) - jnp.sum(sdx, axis=1), j0,
                    axis=1)
                fy = jax.lax.dynamic_update_slice_in_dim(
                    fy, islice(fy, i0) + jnp.sum(sdy, axis=2), i0, axis=1)
                fy = jax.lax.dynamic_update_slice_in_dim(
                    fy, islice(fy, j0, jchunk) - jnp.sum(sdy, axis=1), j0,
                    axis=1)
                return fx, fy

            return jax.lax.fori_loop(i0 // jchunk, trips_j, force_inner,
                                     carry)

        z = jnp.zeros_like(x)
        fx, fy = jax.lax.fori_loop(0, trips_i, force_outer, (z, z))
        return fx, fy, ft, cnt

    ins = ((xd, yd, mfd, alived) + ((pid,) if pid is not None else ())
           + ((sub,) if sub is not None else ()))
    args = tuple(_blocked(a, cb) for a in ins)
    fx, fy, ft, cnts = jax.lax.map(block, args)
    return (fx.reshape(-1, Kp)[:ncells, :kcap],
            fy.reshape(-1, Kp)[:ncells, :kcap],
            jnp.sum(cnts, dtype=jnp.int32),
            ft.reshape(-1, Kp)[:ncells, :kcap])


# bf16 far-field A/B: the monopole terms are the
# smooth long-range part of the force — each is a COM attraction at >= one
# cell width, so the per-term relative error bf16 introduces (~2^-8) sits
# on a term that is itself an O(cell/r)^2-truncated approximation of the
# far field. Off by default pending the statistical-parity gate; the
# deltas (dx, dy) stay f32 (catastrophic cancellation near cell borders
# would otherwise blow past the quantization floor) — only the
# rsqrt/scale algebra drops to bf16.
MONO_BF16 = os.environ.get("PSIM_MONO_BF16", "0") == "1"


def monopole_tile_forces(xd, yd, mfd, ml_t, mxl_t, myl_t):
    """8 stencil monopole terms per slot, directly on tiles (elementwise)."""
    g = jnp.float32(G)
    gm = g * mfd
    fx = jnp.zeros_like(xd)
    fy = jnp.zeros_like(xd)
    for l in range(8):
        cm = ml_t[:, l:l + 1]
        dxl = mxl_t[:, l:l + 1] - xd
        dyl = myl_t[:, l:l + 1] - yd
        d2l = dxl * dxl + dyl * dyl
        nzl = d2l > 0.0
        if MONO_BF16:
            d2b = jnp.where(nzl, d2l, 1.0).astype(jnp.bfloat16)
            invb = jnp.where(nzl, jax.lax.rsqrt(d2b),
                             jnp.bfloat16(0.0))
            sl = (gm * cm
                  * (invb * invb * invb).astype(jnp.float32))
        else:
            invl = jnp.where(nzl, jax.lax.rsqrt(jnp.where(nzl, d2l, 1.0)),
                             0.0)
            sl = gm * cm * (invl * invl * invl)
        fx = fx + sl * dxl
        fy = fy + sl * dyl
    return fx, fy


def dense_collisions(xd, yd, alived, ncells: int, kcap: int, eps: float,
                     cb: int = CELL_BLOCK, pid=None):
    """(ncells, K) tiles → (count, ft int32 per slot).

    Same first-colliding-pair formulation as ops/collisions.py (exact
    reference set-rule semantics); ``pid`` tiles restore bucket-order
    tie-breaks when slot order ≠ pid order (resident impl).
    """
    cb = _snug_cb(_eff_cb(cb, kcap), ncells)
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    INF = jnp.int32(0x7FFFFFFF)
    base = jnp.int32(kcap + 1)

    def block(args):
        x, y, alive = args[:3]
        pd = args[3] if pid is not None else None
        dx = x[:, None, :] - x[:, :, None]
        dy = y[:, None, :] - y[:, :, None]
        d2 = dx * dx + dy * dy
        pair_alive = (alive[:, :, None] * alive[:, None, :]) > 0
        i_idx = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        j_idx = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
        hit = pair_alive & (d2 < eps2) & (j_idx > i_idx)
        rank = _pair_ranks(pd, alive, i_idx, j_idx, base)
        cand = jnp.where(hit, rank, INF)
        ft = jnp.minimum(jnp.min(cand, axis=2), jnp.min(cand, axis=1))
        first_both = hit & (ft[:, :, None] == cand) & (ft[:, None, :] == cand)
        cnt = jnp.sum(first_both, dtype=jnp.int32)
        return ft, cnt

    ins = (xd, yd, alived) + ((pid,) if pid is not None else ())
    args = tuple(_blocked(a, cb) for a in ins)
    ft, cnts = jax.lax.map(block, args)
    return jnp.sum(cnts, dtype=jnp.int32), ft.reshape(-1, kcap)[:ncells]
