"""Mesh-parallel engine: the reference's MPI layer in JAX.

Mapping (SURVEY §2.2):
  P2 row-wise domain decomposition  → 1D jax.sharding.Mesh over grid rows
  P3 ghost-cell halo Isend/Irecv    → lax.ppermute one-row COM halo
  P4 particle migration Alltoall    → ring-forwarded fixed-capacity buffers
  P5 MPI_Reduce / Gatherv           → lax.psum / host gather at read-out
  P7 MPI wire datatypes             → arrays are already the wire format
"""
