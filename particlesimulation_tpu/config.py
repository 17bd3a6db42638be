"""Simulation configuration.

The reference drives everything from five positional CLI args and four
``#define`` physics constants (reference ``serial/parsim.cpp:13-16,461-469``).
Here the same surface is a frozen dataclass plus a dtype/precision policy and
mesh parameters for the sharded engine.
"""

from __future__ import annotations

import dataclasses
import enum

# Physics constants — identical across all reference variants
# (reference serial/parsim.cpp:13-16).
G = 6.67408e-11
EPSILON = 0.005
EPSILON2 = 0.005 * 0.005
DELTAT = 0.1


class Precision(enum.Enum):
    """Compute precision policy.

    PARITY: float64 with the exact operation order of the serial oracle.
        Bit-reproduces the reference trajectories (XLA path; runs on CPU or
        any backend with native f64).
    FAST: float32, order-free reductions, slot-tile engines on the GPU.
        The performance path; physics is identical but FP association
        differs.
    """

    PARITY = "parity"
    FAST = "fast"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static parameters of one simulation.

    Mirrors the reference CLI contract
    ``parsim <seed> <side_length> <grid_size> <n_particles> <n_timesteps>``
    (reference serial/parsim.cpp:461-469); ``n_timesteps`` is a run-time
    argument, not part of the config.
    """

    seed: int
    side: float
    ncside: int
    n_particles: int
    precision: Precision = Precision.FAST

    # Sharded-engine parameters (single-chip engines ignore these).
    n_shards: int = 1
    # Per-shard particle-slot capacity; 0 = auto (ceil(n/n_shards) * slack).
    shard_capacity: int = 0
    # Per-step migration buffer entries per shard; 0 = auto.
    migration_capacity: int = 0
    # Optional 2D mesh layout (d_rows, d_cols) for the rectangular
    # decomposition (parallel/sharded2d.py). Empty = 1D row decomposition.
    # Must multiply to n_shards; each factor must be <= ncside. The
    # reference is 1D-only (its report picks rows for simplicity,
    # CPD_2nd_delivery.pdf §2.1); a rectangle ships its perimeter per halo
    # instead of whole grid rows.
    mesh_shape: tuple = ()
    # Optional census-planned shard row boundaries (first owned global row
    # per shard, ascending, starting at 0). Empty = the balanced uneven
    # split below. Clustered (normal-mode blob) workloads concentrate
    # particles in a few grid rows; equal-rows decomposition then loads one
    # shard with most of the pair work — the reference's own report
    # documents exactly this on UNEVEN (CPD_2nd_delivery.pdf p.6, 9.69x of
    # a possible ~22x). ``parallel/balance.py`` plans these from the
    # initial census.
    row_starts: tuple = ()

    def __post_init__(self):
        if self.row_starts:
            rs = tuple(int(r) for r in self.row_starts)
            if (len(rs) != self.n_shards or rs[0] != 0
                    or any(b <= a for a, b in zip(rs, rs[1:]))
                    or rs[-1] >= self.ncside):
                raise ValueError(
                    f"row_starts {rs} must be {self.n_shards} strictly "
                    f"increasing rows starting at 0, below ncside="
                    f"{self.ncside}")
            object.__setattr__(self, "row_starts", rs)
        if self.ncside < 1:
            raise ValueError("ncside must be >= 1")
        if self.n_particles < 1:
            raise ValueError("n_particles must be >= 1")
        if self.side <= 0:
            raise ValueError("side must be > 0")
        if self.mesh_shape:
            ms = tuple(int(v) for v in self.mesh_shape)
            if len(ms) != 2 or ms[0] < 1 or ms[1] < 1:
                raise ValueError(f"mesh_shape {ms} must be (d_rows, d_cols)")
            if ms[0] * ms[1] != self.n_shards:
                raise ValueError(
                    f"mesh_shape {ms} has {ms[0] * ms[1]} devices but "
                    f"n_shards is {self.n_shards}")
            if ms[0] > self.ncside or ms[1] > self.ncside:
                raise ValueError(
                    f"mesh_shape {ms} needs at least one grid row and "
                    f"column per shard (ncside={self.ncside})")
            object.__setattr__(self, "mesh_shape", ms)
        elif self.n_shards > self.ncside:
            raise ValueError(
                f"n_shards ({self.n_shards}) must be <= ncside "
                f"({self.ncside}): the row-block decomposition needs at "
                f"least one grid row per shard"
            )

    @property
    def ncells(self) -> int:
        return self.ncside * self.ncside

    @property
    def cell_width(self) -> float:
        # The reference computes side_length / grid_size as an f64 division
        # at every use site (serial/parsim.cpp:268); keep it a single f64.
        return self.side / self.ncside

    # Balanced uneven row decomposition: the first ``rows_rem`` shards own
    # ``rows_base + 1`` rows, the rest ``rows_base``. The reference instead
    # floors rows_per_proc and lets the LAST rank absorb the whole remainder
    # (mpi/parsim-mpi.cpp:338-342), which can nearly double its load; the
    # balanced split keeps shard loads within one row of each other while
    # still supporting every ncside / n_shards combination the reference's
    # published workloads use (e.g. ncside=1300 on 12 procs).

    @property
    def rows_base(self) -> int:
        return self.ncside // self.n_shards

    @property
    def rows_rem(self) -> int:
        return self.ncside % self.n_shards

    def _row_counts(self) -> tuple:
        """Rows owned per shard under explicit ``row_starts``."""
        ends = self.row_starts[1:] + (self.ncside,)
        return tuple(e - s for s, e in zip(self.row_starts, ends))

    @property
    def rows_max(self) -> int:
        """Static per-shard row-grid height (shard_map needs one shape)."""
        if self.row_starts:
            return max(self._row_counts())
        return self.rows_base + (1 if self.rows_rem else 0)

    def shard_of_row(self, row, xp=None):
        """Owning shard of a global grid row.

        ``xp``: array namespace (numpy for host code, jax.numpy in-graph);
        defaults to numpy. Scalars work through numpy broadcasting.
        """
        if xp is None:
            import numpy as xp
        if self.row_starts:
            starts = xp.asarray(self.row_starts)
            return xp.searchsorted(starts, row, side="right") - 1
        split = self.rows_rem * (self.rows_base + 1)
        big = row // (self.rows_base + 1)
        small = self.rows_rem + (row - split) // max(1, self.rows_base)
        return xp.where(row < split, big, small)

    def row0_of_shard(self, s):
        """First global row owned by shard ``s`` (python/traced ints)."""
        import jax.numpy as _jnp
        if self.row_starts:
            if isinstance(s, int):
                return self.row_starts[s]
            return _jnp.asarray(self.row_starts, _jnp.int32)[s]
        if isinstance(s, int):
            return s * self.rows_base + min(s, self.rows_rem)
        return s * self.rows_base + _jnp.minimum(s, self.rows_rem)

    def rows_of_shard(self, s):
        """Rows owned by shard ``s`` (python/traced ints)."""
        import jax.numpy as _jnp
        if self.row_starts:
            if isinstance(s, int):
                return self._row_counts()[s]
            return _jnp.asarray(self._row_counts(), _jnp.int32)[s]
        if isinstance(s, int):
            return self.rows_base + (1 if s < self.rows_rem else 0)
        return self.rows_base + (s < self.rows_rem).astype(_jnp.int32)

    def resolved_shard_capacity(self) -> int:
        if self.shard_capacity:
            return self.shard_capacity
        per = -(-self.n_particles // self.n_shards)  # ceil
        cap = int(per * 1.5) + 16
        return min(cap, self.n_particles) if self.n_shards == 1 else cap

    def resolved_migration_capacity(self) -> int:
        if self.migration_capacity:
            return self.migration_capacity
        return max(64, self.resolved_shard_capacity() // 4)
