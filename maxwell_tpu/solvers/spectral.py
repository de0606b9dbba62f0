"""Exact spectral solve of (K + alpha*M) W = R for vacuum-PEC brick
cavities — the production LOBPCG preconditioner at scale (round-2 VERDICT
items 2/10).

Math. On a uniform tensor grid the lowest-order Nedelec pencil
diagonalizes in a mixed sine/cosine tensor basis: per axis, let
(An, Mn) be the interior-node 1D stiffness/mass pair with Mn-orthonormal
generalized eigenvectors s_k (discrete sines), eigenvalues lam_k, and let
u_k = D s_k / sqrt(lam_k) (discrete cosines on cells, Mc-orthonormal,
Mc = h*I; An = D^T Mc D makes the normalization exact), plus u_0 = const.
Component bases:

    Ex: u(kx) (x) s(ky) (x) s(kz),   Ey: s (x) u (x) s,   Ez: s (x) s (x) u

With sig_k = sqrt(lam_k) (sig_0 = 0), the transformed pencil per mode
triple (kx, ky, kz) is EXACTLY the continuous symbol

    M^ = I,     K^ = |sig|^2 I - sig sig^T,   sig = (sig_kx, sig_ky, sig_kz)

(verified numerically against the assembled matrices in
tests/unit/test_spectral.py — including the gradient nullspace K^ sig = 0).
Hence with beta = alpha + |sig|^2, Sherman-Morrison gives the closed form

    (K^ + alpha I)^-1 = I/beta + sig sig^T / (alpha * beta)

so the whole solve is: forward axis transforms (dense (n, n) contractions),
two elementwise grids, inverse transforms. No inner CG, no
iteration-count-vs-grid coupling: LOBPCG with this preconditioner
converges in O(10) iterations at ANY grid size. For loaded cavities
(eps/mu != 1) the vacuum solve remains a strong approximate
preconditioner.

Cost at 64^3, m=8: ~4.7 GFLOP of dense contractions per application vs
~48 CG sweeps x 2 tap applies for the shifted-CG preconditioner at equal
quality — two orders of magnitude less work.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _axis_1d(n: int, h: float):
    """Interior-node sine basis + cell cosine basis for one axis.

    Returns (S (n-1, n-1), U (n, n), sig (n,)): S columns Mn-orthonormal,
    U columns Mc-orthonormal, sig[k] = sqrt(lam_k) with sig[0] = 0 (the
    constant cell mode pairs with no sine)."""
    import scipy.linalg

    q = n - 1
    Mn = (h / 6.0) * (
        4.0 * np.eye(q) + np.eye(q, k=1) + np.eye(q, k=-1)
    )
    An = (1.0 / h) * (
        2.0 * np.eye(q) - np.eye(q, k=1) - np.eye(q, k=-1)
    )
    lam, S = scipy.linalg.eigh(An, Mn)  # S^T Mn S = I
    # cell derivative of interior hats: (D phi)_c = (phi_{c+1}-phi_c)/h
    D = np.zeros((n, q))
    for c in range(n):
        if c < q:
            D[c, c] = 1.0 / h  # node c+1 = interior index c
        if c - 1 >= 0:
            D[c, c - 1] = -1.0 / h
    sig = np.sqrt(lam)
    U = np.zeros((n, n))
    U[:, 0] = 1.0 / np.sqrt(n * h)
    U[:, 1:] = (D @ S) / sig[None, :]
    return S, U, np.concatenate([[0.0], sig])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SpectralShiftSolver:
    """W = (K + alpha*M)^-1 R on the stencil flat layout (vacuum PEC)."""

    Sx: jax.Array
    Sy: jax.Array
    Sz: jax.Array
    Ux: jax.Array
    Uy: jax.Array
    Uz: jax.Array
    sigx: jax.Array  # (nx,) etc., sig[0] = 0
    sigy: jax.Array
    sigz: jax.Array
    alpha: float
    nx: int
    ny: int
    nz: int
    n: int
    n_padded: int

    def tree_flatten(self):
        return (
            self.Sx, self.Sy, self.Sz, self.Ux, self.Uy, self.Uz,
            self.sigx, self.sigy, self.sigz,
        ), (self.alpha, self.nx, self.ny, self.nz, self.n, self.n_padded)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @staticmethod
    def build(a, b, c, nx, ny, nz, alpha, n_padded, dtype=jnp.float32):
        hx, hy, hz = a / nx, b / ny, c / nz
        Sx, Ux, sigx = _axis_1d(nx, hx)
        Sy, Uy, sigy = _axis_1d(ny, hy)
        Sz, Uz, sigz = _axis_1d(nz, hz)
        sxs = nx * (ny + 1) * (nz + 1)
        sys_ = (nx + 1) * ny * (nz + 1)
        szs = (nx + 1) * (ny + 1) * nz
        return SpectralShiftSolver(
            Sx=jnp.asarray(Sx, dtype), Sy=jnp.asarray(Sy, dtype),
            Sz=jnp.asarray(Sz, dtype),
            Ux=jnp.asarray(Ux, dtype), Uy=jnp.asarray(Uy, dtype),
            Uz=jnp.asarray(Uz, dtype),
            sigx=jnp.asarray(sigx, dtype), sigy=jnp.asarray(sigy, dtype),
            sigz=jnp.asarray(sigz, dtype),
            alpha=float(alpha), nx=nx, ny=ny, nz=nz,
            n=sxs + sys_ + szs, n_padded=n_padded,
        )

    # ------------------------------------------------------------------
    def _grids(self, X):
        nx, ny, nz = self.nx, self.ny, self.nz
        m = X.shape[1]
        sx = nx * (ny + 1) * (nz + 1)
        sy = (nx + 1) * ny * (nz + 1)
        Ex = X[:sx].reshape(nx, ny + 1, nz + 1, m)
        Ey = X[sx : sx + sy].reshape(nx + 1, ny, nz + 1, m)
        Ez = X[sx + sy : self.n].reshape(nx + 1, ny + 1, nz, m)
        return Ex, Ey, Ez

    @staticmethod
    def _tr3(G, Ax, Ay, Az):
        """Contract grid (X, Y, Z, m) with per-axis transform matrices:
        out[k,l,p,m] = sum A_x[i,k] A_y[j,l] A_z[q,p] G[i,j,q,m]."""
        hi = jax.lax.Precision.HIGHEST
        G = jnp.einsum("ik,ijqm->kjqm", Ax, G, precision=hi)
        G = jnp.einsum("jl,kjqm->klqm", Ay, G, precision=hi)
        return jnp.einsum("qp,klqm->klpm", Az, G, precision=hi)

    def solve(self, R: jax.Array) -> jax.Array:
        """(K + alpha M)^-1 R, R (n_padded, m) flat stencil layout.
        Rows outside the PEC-interior tensor structure (masked boundary
        edges, padding) pass through as zeros."""
        return self._solve_alpha(R, self.alpha)

    def _solve_alpha(self, R: jax.Array, alpha) -> jax.Array:
        vec = R.ndim == 1
        Rl = R[:, None] if vec else R
        m = Rl.shape[1]
        nx, ny, nz = self.nx, self.ny, self.nz
        Ex, Ey, Ez = self._grids(Rl)
        # interior tensor blocks (PEC: tangential boundary rows are masked)
        ex = Ex[:, 1:ny, 1:nz]  # (nx, ny-1, nz-1, m)
        ey = Ey[1:nx, :, 1:nz]
        ez = Ez[1:nx, 1:ny, :]

        # forward: r^ = P^T r — _tr3 contracts A[i,k] over the grid axis i,
        # i.e. multiplies by A^T on that axis, so pass S/U directly
        rx = self._tr3(ex, self.Ux, self.Sy, self.Sz)
        ry = self._tr3(ey, self.Sx, self.Uy, self.Sz)
        rz = self._tr3(ez, self.Sx, self.Sy, self.Uz)
        # rx: (nx, ny-1, nz-1, m) on lattice (kx in 0.., ky in 1.., kz in 1..)

        # mode lattice (nx, ny, nz): position 0 on each SINE axis is absent
        # -> zero padding; sig vectors already carry sig[0] = 0
        pad = lambda g, px, py, pz: jnp.pad(
            g, ((px, 0), (py, 0), (pz, 0), (0, 0))
        )
        Rx = pad(rx, 0, 1, 1)
        Ry = pad(ry, 1, 0, 1)
        Rz = pad(rz, 1, 1, 0)
        sx_ = self.sigx[:, None, None, None]
        sy_ = self.sigy[None, :, None, None]
        sz_ = self.sigz[None, None, :, None]
        beta = alpha + sx_**2 + sy_**2 + sz_**2
        dot = sx_ * Rx + sy_ * Ry + sz_ * Rz
        coef = dot / (alpha * beta)
        Hx = Rx / beta + sx_ * coef
        Hy = Ry / beta + sy_ * coef
        Hz = Rz / beta + sz_ * coef

        # inverse: w = P h (contract the COLUMN index => pass A^T to _tr3)
        hx = Hx[:, 1:, 1:]
        hy = Hy[1:, :, 1:]
        hz = Hz[1:, 1:, :]
        wx = self._tr3(hx, self.Ux.T, self.Sy.T, self.Sz.T)
        wy = self._tr3(hy, self.Sx.T, self.Uy.T, self.Sz.T)
        wz = self._tr3(hz, self.Sx.T, self.Sy.T, self.Uz.T)

        Yx = jnp.zeros_like(Ex).at[:, 1:ny, 1:nz].set(wx)
        Yy = jnp.zeros_like(Ey).at[1:nx, :, 1:nz].set(wy)
        Yz = jnp.zeros_like(Ez).at[1:nx, 1:ny, :].set(wz)
        out = jnp.concatenate(
            [Yx.reshape(-1, m), Yy.reshape(-1, m), Yz.reshape(-1, m)],
            axis=0,
        )
        pad_rows = self.n_padded - self.n
        if pad_rows:
            out = jnp.pad(out, ((0, pad_rows), (0, 0)))
        return out[:, 0] if vec else out


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DistSpectralShift:
    """(K + alpha*M)^-1 for the SLAB-SHARDED stencil pencil
    (dist/stencil_dist.DistStencilPencil3D, vacuum PEC) — the distributed
    LOBPCG preconditioner at pod scale.

    y/z transforms are shard-local (those axes are unsharded). The x
    transform is a global contraction: each shard contracts its OWN
    x-planes (ownership-weighted, so replicated interface planes count
    once) against its rows of the replicated 1D transform matrices, and
    one psum over the row axis completes the mode grid; the inverse
    transform back to local planes is then purely local. Comm = one psum
    of the mode-coefficient volume per application (O(n·m)) —
    bought back many times over by the grid-independent iteration count
    and the removal of the CG-sweep preconditioner's 2-apply-per-sweep
    cost. All leaves are REPLICATED (1D matrices + sigma vectors).

    Sx_full/Uy.../: sine matrices padded with zero rows at the Dirichlet
    boundary nodes so local row slices are direct dynamic slices."""

    Sx_full: jax.Array  # (nx+1, nx-1) interior sines, zero boundary rows
    Sy_full: jax.Array  # (ny+1, ny-1)
    Sz_full: jax.Array  # (nz+1, nz-1)
    Ux: jax.Array  # (nx, nx)
    Uy: jax.Array
    Uz: jax.Array
    sigx: jax.Array
    sigy: jax.Array
    sigz: jax.Array
    alpha: float
    nx: int
    ny: int
    nz: int
    cells: int
    axis: str = "rows"

    def tree_flatten(self):
        return (
            self.Sx_full, self.Sy_full, self.Sz_full,
            self.Ux, self.Uy, self.Uz,
            self.sigx, self.sigy, self.sigz,
        ), (self.alpha, self.nx, self.ny, self.nz, self.cells, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def partition_specs(self):
        from jax.sharding import PartitionSpec as P

        ch, aux = self.tree_flatten()
        return self.tree_unflatten(aux, tuple(P() for _ in ch))

    @staticmethod
    def build(sp, alpha: float, dtype=None):
        """From a DistStencilPencil3D (vacuum PEC)."""
        if sp.inv_mu is not None or sp.eps is not None:
            raise ValueError("distributed spectral solve is vacuum-only")
        dtype = dtype or sp.dtype
        hx, hy, hz = sp.ax / sp.nx, sp.by / sp.ny, sp.cz / sp.nz
        Sx, Ux, sigx = _axis_1d(sp.nx, hx)
        Sy, Uy, sigy = _axis_1d(sp.ny, hy)
        Sz, Uz, sigz = _axis_1d(sp.nz, hz)

        def full(S, n):
            F = np.zeros((n + 1, n - 1))
            F[1:n] = S
            return F

        return DistSpectralShift(
            Sx_full=jnp.asarray(full(Sx, sp.nx), dtype),
            Sy_full=jnp.asarray(full(Sy, sp.ny), dtype),
            Sz_full=jnp.asarray(full(Sz, sp.nz), dtype),
            Ux=jnp.asarray(Ux, dtype), Uy=jnp.asarray(Uy, dtype),
            Uz=jnp.asarray(Uz, dtype),
            sigx=jnp.asarray(sigx, dtype), sigy=jnp.asarray(sigy, dtype),
            sigz=jnp.asarray(sigz, dtype),
            alpha=float(alpha), nx=sp.nx, ny=sp.ny, nz=sp.nz,
            cells=sp.cells, axis=sp.axis,
        )

    # ------------------------------------------------------------------
    def solve(self, sp, R: jax.Array) -> jax.Array:
        """Local view (inside shard_map): R (n_loc_pad, m) -> same."""
        return self._solve_alpha(sp, R, self.alpha)

    def _solve_alpha(self, sp, R: jax.Array, alpha) -> jax.Array:
        hi = jax.lax.Precision.HIGHEST
        vec = R.ndim == 1
        Rl = R[:, None] if vec else R
        m = Rl.shape[1]
        c, ny, nz = self.cells, self.ny, self.nz
        # ownership-weighted so the psum counts interface planes once
        Rw = Rl * (sp.mask * sp.w_dot)[:, None]
        ex, ey, ez = sp._to_grids(Rw)

        d = jax.lax.axis_index(self.axis)
        Uxl = jax.lax.dynamic_slice(
            self.Ux, (d * c, jnp.int32(0)), (c, self.nx)
        )
        Sxl = jax.lax.dynamic_slice(
            self.Sx_full, (d * c, jnp.int32(0)), (c + 1, self.nx - 1)
        )

        tr = SpectralShiftSolver._tr3
        Syi = self.Sy_full[1:ny]  # interior rows (ny-1, ny-1)
        Szi = self.Sz_full[1:nz]
        # forward: interior y/z slices, local x rows; psum completes kx
        rx = jax.lax.psum(
            tr(ex[:, 1:ny, 1:nz], Uxl, Syi, Szi), self.axis
        )
        ry = jax.lax.psum(
            tr(ey[:, :, 1:nz], Sxl, self.Uy, Szi), self.axis
        )
        rz = jax.lax.psum(
            tr(ez[:, 1:ny, :], Sxl, Syi, self.Uz), self.axis
        )
        # rx: (nx, ny-1, nz-1, m) etc — replicated mode grids

        pad = lambda g, px, py, pz: jnp.pad(
            g, ((px, 0), (py, 0), (pz, 0), (0, 0))
        )
        Rx = pad(rx, 0, 1, 1)
        Ry = pad(ry, 1, 0, 1)
        Rz = pad(rz, 1, 1, 0)
        sx_ = self.sigx[:, None, None, None]
        sy_ = self.sigy[None, :, None, None]
        sz_ = self.sigz[None, None, :, None]
        beta = alpha + sx_**2 + sy_**2 + sz_**2
        dot = sx_ * Rx + sy_ * Ry + sz_ * Rz
        coef = dot / (alpha * beta)
        Hx = (Rx / beta + sx_ * coef)[:, 1:, 1:]
        Hy = (Ry / beta + sy_ * coef)[1:, :, 1:]
        Hz = (Rz / beta + sz_ * coef)[1:, 1:, :]

        # inverse: local planes from the replicated mode grids (consistent
        # on both copies of an interface plane by construction)
        wx = tr(Hx, Uxl.T, Syi.T, Szi.T)
        wy = tr(Hy, Sxl.T, self.Uy.T, Szi.T)
        wz = tr(Hz, Sxl.T, Syi.T, self.Uz.T)

        Yx = jnp.zeros_like(ex).at[:, 1:ny, 1:nz].set(wx)
        Yy = jnp.zeros_like(ey).at[:, :, 1:nz].set(wy)
        Yz = jnp.zeros_like(ez).at[:, 1:ny, :].set(wz)
        out = jnp.concatenate(
            [Yx.reshape(-1, m), Yy.reshape(-1, m), Yz.reshape(-1, m)],
            axis=0,
        )
        padr = sp.n_loc_pad - sp.n_loc
        if padr:
            out = jnp.pad(out, ((0, padr), (0, 0)))
        out = out * sp.mask[:, None]
        return out[:, 0] if vec else out


def spectral_preconditioner(pencil, alpha: float = 15.0):
    """(K + alpha M)^-1 preconditioner for a PEC StencilPencil3D.

    EXACT for the vacuum pencil (tap path). For LOADED PEC cavities
    (eps_r/mu_r != 1, field-coefficient taps) the VACUUM solve is used as
    a strong APPROXIMATE preconditioner — spectrally equivalent with
    constants bounded by the material contrast, so LOBPCG iteration
    counts stay bounded as the grid refines (round-3 VERDICT item 9;
    verified at 32^3 with a dielectric fill in
    tests/integration/test_dielectric.py). PMC pencils are rejected: the
    interior-sine tensor basis encodes PEC walls."""
    if (
        getattr(pencil, "nz", None) is None
        or getattr(pencil, "bc", "pec") != "pec"
        or (
            getattr(pencil, "taps", None) is None
            and getattr(pencil, "ftaps_meta", None) is None
        )
    ):
        raise ValueError(
            "spectral preconditioner needs a 3D PEC tap/ftap pencil"
        )
    sol = SpectralShiftSolver.build(
        pencil.a, pencil.b, pencil.c, pencil.nx, pencil.ny, pencil.nz,
        alpha, pencil.n_padded, dtype=pencil.dtype,
    )
    return jax.tree_util.Partial(_spectral_apply, sol)


def _spectral_apply(sol: SpectralShiftSolver, R: jax.Array) -> jax.Array:
    return sol.solve(R)
