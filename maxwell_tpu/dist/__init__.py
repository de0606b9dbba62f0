"""Distributed layer: block-row partitioning over a jax.sharding.Mesh,
ppermute halo exchange, psum reductions (SURVEY.md §2 C8/C14/C15).

The reference distributes with MPI (rank loops + Isend/Irecv halo import +
Allreduce); here the same math is ONE SPMD program under `shard_map`: the
device count is a mesh property, and every cross-device interaction is an
XLA collective — NCCL on GPUs (SURVEY.md §7.4 rule 1).
"""

from maxwell_tpu.dist.mesh import make_mesh, mesh_topology_report  # noqa: F401
from maxwell_tpu.dist.partition import DistPencil, partition_problem  # noqa: F401
