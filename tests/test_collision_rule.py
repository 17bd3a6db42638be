"""Targeted tests of the set-based collision counting rule.

Reference rule (serial/parsim.cpp:388-420): scan same-cell pairs in (j, k)
bucket order; count a colliding pair only if neither endpoint is already in
the cell's collision set; all set members die. The vectorized formulation
counts pairs that are the lexicographically-first colliding pair for both
endpoints — these tests pin the equivalence on hand-built configurations.
"""

import jax.numpy as jnp
import numpy as np

from particlesimulation_tpu.config import EPSILON
from particlesimulation_tpu.ops import binning, collisions


def _detect(xs, ys, side=10.0, nc=2, alive=None):
    n = len(xs)
    x = jnp.asarray(xs, dtype=jnp.float64)
    y = jnp.asarray(ys, dtype=jnp.float64)
    alive = jnp.ones(n, dtype=bool) if alive is None else jnp.asarray(alive)
    pid = jnp.arange(n, dtype=jnp.int32)
    key, _ = binning.cell_keys(x, y, side, nc)
    key, pid, x, y, alive = binning.sort_by_cell(key, pid, x, y, alive)
    pos, _ = binning.segment_positions(key)
    kmax = binning.max_occupancy(pos, key < nc * nc)
    count, died = collisions.detect_collisions(
        x, y, alive, key, pos, kmax, EPSILON, nc * nc)
    order = np.argsort(np.asarray(pid))
    return int(count), np.asarray(died)[order]


def test_isolated_pair():
    count, died = _detect([1.0, 1.001, 3.0], [1.0, 1.0, 1.0])
    assert count == 1
    assert died.tolist() == [True, True, False]


def test_chain_counts_once():
    # A-B close, B-C close, A-C not: scan order (A,B),(A,C),(B,C) → 1.
    count, died = _detect([1.0, 1.004, 1.008], [1.0, 1.0, 1.0])
    assert count == 1
    assert died.tolist() == [True, True, True]


def test_triangle_counts_once():
    count, died = _detect([1.0, 1.002, 1.001], [1.0, 1.0, 1.001])
    assert count == 1
    assert died.all()


def test_two_disjoint_pairs_count_twice():
    count, died = _detect([1.0, 1.001, 2.0, 2.001], [1.0] * 4)
    assert count == 2
    assert died.all()


def test_bridged_pairs_scan_order_dependent():
    # Pairs (0,1) and (2,3) collide, and (1,2) also collides. Scan order
    # (0,1),(0,2)x,(0,3)x,(1,2),(1,3)x,(2,3): (0,1) counts; (1,2) has 1 in
    # set → no count, adds 2; (2,3) has 2 in set → no count. Total 1.
    count, died = _detect([1.0, 1.004, 1.008, 1.012], [1.0] * 4)
    assert count == 1
    assert died.all()


def test_dead_particles_ignored():
    count, died = _detect([1.0, 1.001], [1.0, 1.0], alive=[True, False])
    assert count == 0
    assert not died.any()


def test_coincident_particles_collide():
    # dist == 0 < EPSILON counts (no dist-0 skip in checkCollisions).
    count, died = _detect([1.0, 1.0], [1.0, 1.0])
    assert count == 1
    assert died.all()


def test_cross_cell_pairs_never_collide():
    # Same-cell only (SURVEY §7.3 #5): straddling a cell boundary at < EPSILON.
    count, died = _detect([4.999, 5.001], [1.0, 1.0], side=10.0, nc=2)
    assert count == 0
    assert not died.any()


def test_strictly_less_than_epsilon():
    # At x=0 the distance EPSILON is computed exactly (sqrt(x*x) == |x|),
    # pinning the strict `<` of the reference (serial/parsim.cpp:400).
    count, _ = _detect([0.0, EPSILON], [1.0, 1.0])
    assert count == 0


def _tile_counts(mod, slots_pid, positions, kcap=8):
    """Run a backend's collision pass on a single hand-built cell tile."""
    import jax.numpy as jnp

    n = len(slots_pid)
    xd = jnp.zeros((1, kcap), jnp.float32)
    yd = jnp.zeros((1, kcap), jnp.float32)
    ad = jnp.zeros((1, kcap), jnp.int32)
    pd = jnp.zeros((1, kcap), jnp.int32)
    for s, (p, (px, py)) in enumerate(zip(slots_pid, positions)):
        xd = xd.at[0, s].set(px)
        yd = yd.at[0, s].set(py)
        ad = ad.at[0, s].set(1)
        pd = pd.at[0, s].set(p)
    cnt_pid, _ = mod.dense_collisions(xd, yd, ad, 1, kcap, EPSILON, pid=pd)
    cnt_slot, _ = mod.dense_collisions(xd, yd, ad, 1, kcap, EPSILON)
    return int(cnt_pid), int(cnt_slot)


# The divergence geometry: a chain A-B-C-D (consecutive pairs collide,
# |AB|=|BC|=|CD|=0.8ε, everything else ≥ 1.6ε). In pid (bucket) order the
# scan visits (A,B),(B,C),(C,D): (A,B) counts, B blocks (B,C), C blocks
# (C,D) → count = 1 (the reference answer). In slot order [A, D, C, B] the
# slot-pair scan visits (A,B)=(0,3) then (D,C)=(1,2) — two disjoint pairs
# counted before the blocked (C,B)=(2,3) → count = 2.
_D = EPSILON * 0.8
_TIE_POSITIONS = {0: (0.0, 0.0),        # A
                  1: (0.0, _D),         # B
                  2: (0.0, 2 * _D),     # C
                  3: (0.0, 3 * _D)}     # D
_TIE_SLOTS = [0, 3, 2, 1]               # slot order A, D, C, B


def test_tile_tiebreak_ranks_by_pid_not_slot():
    """Post-migration situation: resident slot order departs from pid order.
    pid ranks must reproduce the reference bucket-order count (1), where
    slot ranks would give 2."""
    from particlesimulation_tpu.ops import dense_xla

    positions = [_TIE_POSITIONS[p] for p in _TIE_SLOTS]
    cnt_pid, cnt_slot = _tile_counts(dense_xla, _TIE_SLOTS, positions)
    assert cnt_pid == 1   # reference bucket-order semantics
    assert cnt_slot == 2  # what slot ranks would have done


def test_tile_tiebreak_fused_pairs_matches():
    from particlesimulation_tpu.ops import dense_xla

    kcap = 8
    xs = [_TIE_POSITIONS[p][0] for p in _TIE_SLOTS] + [0.0] * 4
    ys = [_TIE_POSITIONS[p][1] for p in _TIE_SLOTS] + [0.0] * 4
    xd = jnp.asarray([xs], jnp.float32)
    yd = jnp.asarray([ys], jnp.float32)
    md = jnp.asarray([[1.0] * 4 + [0.0] * 4], jnp.float32)
    ad = jnp.asarray([[1, 1, 1, 1, 0, 0, 0, 0]], jnp.int32)
    pd = jnp.asarray([_TIE_SLOTS + [0] * 4], jnp.int32)
    _, _, cnt, ftd = dense_xla.fused_pairs(xd, yd, md, ad, 1, kcap, EPSILON,
                                           collide=True, pid=pd)
    assert int(cnt) == 1
    # All four are endpoints of some colliding pair: all die.
    assert (np.asarray(ftd)[0, :4] != 0x7FFFFFFF).all()
    assert (np.asarray(ftd)[0, 4:] == 0x7FFFFFFF).all()
