"""Operator abstraction consumed by all solvers (SURVEY.md §1: L5 consumes
L3/L4 through an abstract operator apply — the Epetra/Anasazi-style contract,
rebuilt as JAX pytrees so one SPMD program serves any device count).

A `Pencil` bundles the stiffness K, mass M, and the gradient-nullspace
projector as a pytree; solvers receive it as a traced jit argument (its
arrays are never baked into the compiled program as constants) and call its
methods, which dispatch to the configured SpMV/SpMM implementation
("ref" = pure-jnp einsum, "triton" = maxwell_tpu.kernels.spmm; chosen by
kernels.spmm.resolve_kernel).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from maxwell_tpu.kernels.spmm import matmat_fn, resolve_kernel
from maxwell_tpu.sparse.bsr import BSRMatrix
from maxwell_tpu.solvers.cg import cg
from maxwell_tpu.solvers.deflation import GradientProjector


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Pencil:
    """The matrix pencil (K, M) plus nullspace projector.

    M may be None (standard eigenproblem; mass = identity).
    proj may be None (no nullspace deflation).
    kernel: static — which SpMM implementation to use ("ref" | "triton").
    """

    K: BSRMatrix
    M: BSRMatrix | None = None
    proj: GradientProjector | None = None
    kernel: str = "ref"
    mass_tol: float = 1e-12
    mass_iters: int = 300
    # exact tensor-product nodal solver for the projector (vacuum PEC brick
    # problems; round-1 VERDICT item 4): replaces the projector's ~100-CG
    # inner loop with six dense 1D transforms
    fastproj: "object | None" = None

    def tree_flatten(self):
        return (self.K, self.M, self.proj, self.fastproj), (
            self.kernel,
            self.mass_tol,
            self.mass_iters,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        K, M, proj, fastproj = children
        return cls(
            K=K, M=M, proj=proj, fastproj=fastproj,
            kernel=aux[0], mass_tol=aux[1], mass_iters=aux[2],
        )

    # --- shapes -----------------------------------------------------------
    @property
    def n(self) -> int:
        return self.K.n

    @property
    def n_padded(self) -> int:
        return self.K.n_padded

    @property
    def dtype(self):
        return self.K.blocks.dtype

    # --- reductions (overridden with psum variants by DistPencil) ---------
    def weigh(self, x: jax.Array) -> jax.Array:
        """Row ownership weights for inner products. Identity here; sharded
        operators with REPLICATED interface rows (e.g. the slab-sharded
        stencil pencil) override this to zero the non-owned copies so
        global reductions count each DOF once."""
        return x

    def dot_mm(self, A: jax.Array, B: jax.Array) -> jax.Array:
        """(m, k) <- A^T B over the row axis — THE cross-device reduction
        of Gram/RR matrices (psum over the mesh in the distributed pencil,
        SURVEY.md §2 C7)."""
        return A.T @ self.weigh(B)

    def dot_cols(self, A: jax.Array, B: jax.Array) -> jax.Array:
        """(m,) <- column-wise inner products."""
        return jnp.sum(A * self.weigh(B), axis=0)

    def dot_vv(self, x: jax.Array, y: jax.Array) -> jax.Array:
        return jnp.vdot(x, self.weigh(y))

    def reduce_rows(self, v: jax.Array) -> jax.Array:
        """Finish a partial row-contraction (identity on one device)."""
        return v

    def col_norms(self, A: jax.Array) -> jax.Array:
        return jnp.sqrt(jnp.maximum(self.dot_cols(A, A), 0.0))

    # --- applies (padded in, padded out) ----------------------------------
    def _mm(self, A: BSRMatrix, X: jax.Array) -> jax.Array:
        vec = X.ndim == 1
        Y = matmat_fn(self.kernel)(A, X[:, None] if vec else X)
        return Y[:, 0] if vec else Y

    def K_mm(self, X: jax.Array) -> jax.Array:
        return self._mm(self.K, X)

    def M_mm(self, X: jax.Array) -> jax.Array:
        if self.M is None:
            return X
        return self._mm(self.M, X)

    def KM_mm(self, X: jax.Array):
        """(K @ X, M @ X); DistPencil overrides with collective fencing."""
        return self.K_mm(X), self.M_mm(X)

    def Minv_mm(self, X: jax.Array) -> jax.Array:
        """M^-1 X via CG (mass matrices are well-conditioned)."""
        if self.M is None:
            return X
        return cg(
            self.M_mm,
            X,
            tol=self.mass_tol,
            maxiter=self.mass_iters,
            dot=self.dot_cols,
        )

    def project(self, X: jax.Array) -> jax.Array:
        """M-orthogonal projection off the gradient nullspace (no-op if
        the pencil has no projector)."""
        if self.proj is None:
            return X
        if self.fastproj is not None:
            vec = X.ndim == 1
            Xl = X[:, None] if vec else X
            rhs = self.proj.gt_mm(self.M_mm(Xl))
            out = Xl - self.proj.g_mm(self.fastproj.solve(rhs))
            return out[:, 0] if vec else out
        return self.proj.project(self.M_mm, X)

    # --- host-side constructors ------------------------------------------
    @staticmethod
    def from_problem(
        problem,
        block: int | None = None,
        kernel: str = "auto",
        dtype=jnp.float32,
    ) -> "Pencil":
        """Build from a cavity problem (RectCavity2D / BrickCavity3D).

        block default: layout study (round-1 log) — b=4 with tight slot
        alignment stores ~2.7x fewer padded bytes than b=8.
        kernel: "auto" | "ref" | "triton" (kernels.spmm.resolve_kernel).
        """
        kernel = resolve_kernel(kernel)
        block = block or 4
        K = BSRMatrix.from_csr(
            problem.K, block=block, align_slots=4, dtype=dtype
        )
        M = BSRMatrix.from_csr(
            problem.M, block=block, align_slots=4, dtype=dtype
        )
        proj = GradientProjector.from_gradient(problem.G, K.n_padded, dtype=dtype)
        # exact tensor-product projector solve for vacuum PEC bricks — the
        # base problem's interior-node order (i-major, k-fastest, matching
        # cavity3d's meshgrid) is exactly FastPoisson3D's layout, and row
        # permutations (PermutedProblem) don't touch the NODE space, so the
        # fast solve stays valid for RCM-reordered pencils too.
        fastproj = None
        base = getattr(problem, "base", problem)
        if (
            getattr(base, "nz", None) is not None
            and getattr(base, "bc", "pec") == "pec"
            and getattr(base, "eps_r", None) is None
            and getattr(base, "mu_r", None) is None
        ):
            from maxwell_tpu.solvers.fast_poisson import FastPoisson3D

            fastproj = FastPoisson3D.build(
                base.a, base.b, base.c, base.nx, base.ny, base.nz,
                dtype=dtype,
            )
        return Pencil(K=K, M=M, proj=proj, kernel=kernel, fastproj=fastproj)
