"""maxwell_tpu — a sparse eigensolver framework for accelerators, in JAX.

A from-scratch re-design of the capabilities of the reference ``bauerca/maxwell``
(C++/MPI edge-element cavity eigensolver; see SURVEY.md) for an NVIDIA GPU:

- Matrix storage: tiled block-sparse-row (BSR, blocked-ELL) in device memory
  (reference: Epetra-style CSR — SURVEY.md §2 C3).
- SpMV/SpMM: a Pallas (Triton) blocked-ELL kernel, or the XLA einsum
  reference (reference: MPI rank loops — SURVEY.md §2 C4/C5).
- Orthogonalization: batched dense SVQB / Rayleigh-Ritz on the device
  (reference: LAPACK — SURVEY.md §2 C6).
- Eigensolvers: Lanczos (plain + shift-invert) and LOBPCG written once as
  jit-ed SPMD loops over an abstract operator; device count is a mesh
  property, not a code path (reference: MPI driver loops — SURVEY.md §2
  C9/C11/C14).
- Distribution: block-row sharding over a ``jax.sharding.Mesh`` with
  ``shard_map``; halo exchange via ``ppermute`` and reductions via ``psum``,
  which XLA hands to NCCL (reference: MPI p2p + Allreduce — SURVEY.md §2
  C8/C14).

The reference mount was empty at survey time (SURVEY.md §0), so reference
citations throughout this package point at SURVEY.md / BASELINE.json rather
than reference file:line.
"""

__version__ = "0.1.0"


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    JAX_COMPILATION_CACHE_DIR when it is set, else `.jax_cache` at the root
    of the checkout (the directory holding this package)."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )


def _enable_persistent_compile_cache():
    """Persistent XLA compilation cache (round-3 VERDICT item 3): a solver
    loop compiles once per (machine, shape), not once per process."""
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_persistent_compile_cache()

from maxwell_tpu.sparse.bsr import BSRMatrix  # noqa: F401
from maxwell_tpu.solvers.results import EigenResult  # noqa: F401
from maxwell_tpu.api import solve  # noqa: F401
