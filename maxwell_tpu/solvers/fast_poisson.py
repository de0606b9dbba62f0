"""Exact tensor-product fast solver for the projector's nodal system
(SURVEY.md §7.5 hard part 2, performance path).

On a uniform tensor grid the nodal operator L = G^T M G (interior nodes,
Dirichlet) is SEPARABLE:

    L = A_x (x) M_y (x) M_z + M_x (x) A_y (x) M_z + M_x (x) M_y (x) A_z

with 1D hat stiffness A_d and mass M_d. Solving the generalized 1D
eigenproblems A_d V_d = M_d V_d Lam_d (V_d^T M_d V_d = I, host-side, once)
diagonalizes L: q = V (Lam_x (+) Lam_y (+) Lam_z)^-1 V^T r, where each V
factor is a DENSE (n_d-1 x n_d-1) transform applied along one grid axis —
batched dense matmuls. The solve is EXACT to
roundoff and costs O(n * (nx+ny+nz)) instead of ~10^2 CG iterations of
sparse applies.

Valid for uniform (vacuum / constant-coefficient) mass matrices only;
material-loaded pencils keep the CG projector.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg


def _modes_1d(n_cells: int, h: float):
    """Generalized eigenpairs of the 1D interior hat (A, M):
    A = (1/h) tridiag(-1, 2, -1), M = (h/6) tridiag(1, 4, 1), size n-1."""
    k = n_cells - 1
    A = (1.0 / h) * (
        2 * np.eye(k) - np.eye(k, k=1) - np.eye(k, k=-1)
    )
    M = (h / 6.0) * (4 * np.eye(k) + np.eye(k, k=1) + np.eye(k, k=-1))
    lam, V = scipy.linalg.eigh(A, M)  # V^T M V = I
    return lam, V


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class FastPoisson3D:
    """q = L^-1 r for interior-node grids r of shape ((nx-1)(ny-1)(nz-1), m),
    row-major (i, j, k)."""

    Vx: jax.Array
    Vy: jax.Array
    Vz: jax.Array
    inv_lam: jax.Array  # (nx-1, ny-1, nz-1)
    nx: int
    ny: int
    nz: int

    def tree_flatten(self):
        return (self.Vx, self.Vy, self.Vz, self.inv_lam), (
            self.nx, self.ny, self.nz,
        )

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch, *aux)

    @staticmethod
    def build(a, b, c, nx, ny, nz, dtype=jnp.float64) -> "FastPoisson3D":
        lx, Vx = _modes_1d(nx, a / nx)
        ly, Vy = _modes_1d(ny, b / ny)
        lz, Vz = _modes_1d(nz, c / nz)
        lam = (
            lx[:, None, None] + ly[None, :, None] + lz[None, None, :]
        )
        return FastPoisson3D(
            Vx=jnp.asarray(Vx, dtype),
            Vy=jnp.asarray(Vy, dtype),
            Vz=jnp.asarray(Vz, dtype),
            inv_lam=jnp.asarray(1.0 / lam, dtype),
            nx=nx, ny=ny, nz=nz,
        )

    def solve(self, r: jax.Array) -> jax.Array:
        kx, ky, kz = self.nx - 1, self.ny - 1, self.nz - 1
        m = r.shape[1]
        R = r.reshape(kx, ky, kz, m)
        # forward transform: R~ = (Vx^T x Vy^T x Vz^T) R
        R = jnp.einsum("ia,ajkm->ijkm", self.Vx.T, R)
        R = jnp.einsum("jb,ibkm->ijkm", self.Vy.T, R)
        R = jnp.einsum("kc,ijcm->ijkm", self.Vz.T, R)
        R = R * self.inv_lam[:, :, :, None]
        # back transform: q = (Vx x Vy x Vz) R~
        R = jnp.einsum("ia,ajkm->ijkm", self.Vx, R)
        R = jnp.einsum("jb,ibkm->ijkm", self.Vy, R)
        R = jnp.einsum("kc,ijcm->ijkm", self.Vz, R)
        return R.reshape(kx * ky * kz, m)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class FastPoisson2D:
    """2D variant for StencilPencil2D (interior nodes (nx-1)(ny-1), i-major)."""

    Vx: jax.Array
    Vy: jax.Array
    inv_lam: jax.Array
    nx: int
    ny: int

    def tree_flatten(self):
        return (self.Vx, self.Vy, self.inv_lam), (self.nx, self.ny)

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch, *aux)

    @staticmethod
    def build(a, b, nx, ny, dtype=jnp.float64) -> "FastPoisson2D":
        lx, Vx = _modes_1d(nx, a / nx)
        ly, Vy = _modes_1d(ny, b / ny)
        lam = lx[:, None] + ly[None, :]
        return FastPoisson2D(
            Vx=jnp.asarray(Vx, dtype),
            Vy=jnp.asarray(Vy, dtype),
            inv_lam=jnp.asarray(1.0 / lam, dtype),
            nx=nx, ny=ny,
        )

    def solve(self, r: jax.Array) -> jax.Array:
        kx, ky = self.nx - 1, self.ny - 1
        m = r.shape[1]
        R = r.reshape(kx, ky, m)
        R = jnp.einsum("ia,ajm->ijm", self.Vx.T, R)
        R = jnp.einsum("jb,ibm->ijm", self.Vy.T, R)
        R = R * self.inv_lam[:, :, None]
        R = jnp.einsum("ia,ajm->ijm", self.Vx, R)
        R = jnp.einsum("jb,ibm->ijm", self.Vy, R)
        return R.reshape(kx * ky, m)
