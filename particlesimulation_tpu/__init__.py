"""particlesimulation_tpu — a JAX N-body particle simulation framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``MiguelParece/ParticleSimulation`` project (2D gravitational N-body with a
particle-in-cell force approximation, periodic boundaries and EPSILON-distance
collision merging; see reference ``serial/parsim.cpp``).

Architecture (accelerator-first, not a port):

* the whole simulation step is one pure function ``step: SimState -> SimState``
  over fixed-shape arrays, jitted once and driven by ``lax.fori_loop`` — no host
  round-trips inside a run;
* the reference's pointer-bucket cell lists become a single stable sort by
  (cell key, particle id) per step feeding contiguous-segment formulations;
* parallelism is a sharding annotation: a 1D ``jax.sharding.Mesh`` over grid
  rows with ``shard_map``, a ``lax.ppermute`` COM halo ring, and
  ``lax.psum`` collision reduction replace the reference's MPI layer;
* two engines share one state schema: a bit-exact f64 *parity* engine that
  reproduces the serial oracle's trajectories on the CPU, and a f32 *fast*
  engine whose slot-tile pair passes carry the O(N·k) hot loops on the GPU.
"""

__version__ = "0.1.0"

from particlesimulation_tpu.config import SimConfig, Precision
from particlesimulation_tpu.state import SimState

__all__ = ["SimConfig", "Precision", "SimState", "__version__"]
