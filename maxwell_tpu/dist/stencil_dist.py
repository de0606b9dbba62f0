"""Slab-sharded assembly-free 3D pencil (SURVEY.md §2 C2+C8 combined: the
matrix-free speed-of-light apply at pod scale).

Decomposition: the x-axis cell range splits into D slabs of `cells` cells.
Per device, edge fields live on local grids

    Ex (cells,   ny+1, nz+1)   — x-edges are cell-centered in x: fully owned
    Ey (cells+1, ny,   nz+1)   — y/z-edges live on x-planes; the interface
    Ez (cells+1, ny+1, nz)       plane is REPLICATED with the right neighbor

and similarly nodes (cells+1, ny+1, nz+1). The apply needs NO input halo
(cells touch only their own planes); instead the OUTPUT partial sums at the
two interface planes are combined by one neighbor ppermute pair per field —
the FEM overlapping-slab scheme. Inner products weight the replicated plane
to zero (`weigh`), so every DOF counts once in psums.

The gradient projector runs on slab-distributed node vectors with the same
interface-sum exchange and ownership weights — nothing is replicated
globally, so memory and comm scale with the slab surface, not the volume.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from maxwell_tpu.dist.partition import _after
from maxwell_tpu.solvers.cg import cg


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DistStencilPencil3D:
    """Slab-sharded matrix-free pencil. Array leaves are stacked over shards
    outside shard_map and local inside; methods are written for the local
    view."""

    mask: jax.Array  # (D*n_loc_pad,) PEC mask per local edge
    w_dot: jax.Array  # (D*n_loc_pad,) ownership weight (iface plane = 0)
    Ke: jax.Array  # (12,12) replicated
    Me: jax.Array
    head: jax.Array  # (D*n_loc_pad,) local node id per edge (ghost=nn_loc)
    tail: jax.Array
    gweight: jax.Array  # (D*n_loc_pad,) +-1/h gradient weights (0 on pad)
    node_mask: jax.Array  # (D*nn_loc,) interior-node mask
    node_w: jax.Array  # (D*nn_loc,) node ownership weight
    # optional per-cell materials, slab-stacked: (D*cells, ny, nz)
    inv_mu: jax.Array | None
    eps: jax.Array | None
    ax: float
    by: float
    cz: float
    nx: int
    ny: int
    nz: int
    cells: int  # slab width (cells per device)
    D: int
    n_loc: int  # local edge count (unpadded)
    n_loc_pad: int
    nn_loc: int  # local node count
    axis: str = "rows"
    mass_tol: float = 1e-12
    mass_iters: int = 300
    proj_tol: float = 1e-10
    proj_iters: int = 150
    # EXACT distributed nodal Poisson solve for the gradient projector
    # (vacuum only; round-4): tensor eigentransforms of L = G^T M G, the
    # x-transform completed by one psum — same structure as the spectral
    # preconditioner. Replaces the ~150-iteration nodal CG that dominated
    # per-iteration cost at 64^3.
    fpVx_full: jax.Array | None = None  # (nx+1, nx-1), zero boundary rows
    fpVy: jax.Array | None = None  # (ny-1, ny-1)
    fpVz: jax.Array | None = None
    fp_inv_lam: jax.Array | None = None  # (nx-1, ny-1, nz-1)
    # translation-invariant taps (vacuum PEC — problems/stencil3d
    # _derive_taps): enables the GATHER-form slab apply (one ghost
    # x-plane per component per side, no interface partial sums) — the
    # per-iteration hot path at 64^3 (round 4; the scatter-form element
    # apply stays as the materials fallback). Static floats -> aux.
    taps: tuple | None = None

    def tree_flatten(self):
        ch = (
            self.mask, self.w_dot, self.Ke, self.Me, self.head, self.tail,
            self.gweight, self.node_mask, self.node_w, self.inv_mu, self.eps,
            self.fpVx_full, self.fpVy, self.fpVz, self.fp_inv_lam,
        )
        aux = (
            self.ax, self.by, self.cz, self.nx, self.ny, self.nz,
            self.cells, self.D, self.n_loc, self.n_loc_pad, self.nn_loc,
            self.axis, self.mass_tol, self.mass_iters, self.proj_tol,
            self.proj_iters, self.taps,
        )
        return ch, aux

    @classmethod
    def tree_unflatten(cls, aux, ch):
        # children carry the four fp* leaves at the END (appended in round
        # 4), but the dataclass declares them after the defaulted aux
        # fields — assign by keyword, not position
        return cls(
            *ch[:11], *aux[:-1], taps=aux[-1],
            fpVx_full=ch[11], fpVy=ch[12], fpVz=ch[13], fp_inv_lam=ch[14],
        )

    def partition_specs(self):
        from jax.sharding import PartitionSpec as P

        row, rep = P(self.axis), P()
        return DistStencilPencil3D(
            mask=row, w_dot=row, Ke=rep, Me=rep, head=row, tail=row,
            gweight=row, node_mask=row, node_w=row,
            inv_mu=None if self.inv_mu is None else row,
            eps=None if self.eps is None else row,
            fpVx_full=None if self.fpVx_full is None else rep,
            fpVy=None if self.fpVy is None else rep,
            fpVz=None if self.fpVz is None else rep,
            fp_inv_lam=None if self.fp_inv_lam is None else rep,
            ax=self.ax, by=self.by, cz=self.cz, nx=self.nx, ny=self.ny,
            nz=self.nz, cells=self.cells, D=self.D, n_loc=self.n_loc,
            n_loc_pad=self.n_loc_pad, nn_loc=self.nn_loc, axis=self.axis,
            mass_tol=self.mass_tol, mass_iters=self.mass_iters,
            proj_tol=self.proj_tol, proj_iters=self.proj_iters,
            taps=self.taps,
        )

    # --- protocol: shapes/dtype -------------------------------------------
    @property
    def n_padded(self):
        return self.n_loc_pad

    @property
    def n(self):
        return self.n_loc

    @property
    def dtype(self):
        return self.mask.dtype

    # --- reductions --------------------------------------------------------
    def weigh(self, x):
        w = self.w_dot if x.ndim == 1 else self.w_dot[:, None]
        return w * x

    def dot_mm(self, A, B):
        return jax.lax.psum(A.T @ self.weigh(B), self.axis)

    def dot_cols(self, A, B):
        return jax.lax.psum(jnp.sum(A * self.weigh(B), axis=0), self.axis)

    def dot_vv(self, x, y):
        return jax.lax.psum(jnp.vdot(x, self.weigh(y)), self.axis)

    def reduce_rows(self, v):
        return jax.lax.psum(v, self.axis)

    def col_norms(self, A):
        return jnp.sqrt(jnp.maximum(self.dot_cols(A, A), 0.0))

    # --- grids -------------------------------------------------------------
    @property
    def _sizes(self):
        c, ny, nz = self.cells, self.ny, self.nz
        return (
            c * (ny + 1) * (nz + 1),
            (c + 1) * ny * (nz + 1),
            (c + 1) * (ny + 1) * nz,
        )

    def _to_grids(self, X):
        c, ny, nz = self.cells, self.ny, self.nz
        sx, sy, sz = self._sizes
        m = X.shape[1]
        Ex = X[:sx].reshape(c, ny + 1, nz + 1, m)
        Ey = X[sx : sx + sy].reshape(c + 1, ny, nz + 1, m)
        Ez = X[sx + sy : self.n_loc].reshape(c + 1, ny + 1, nz, m)
        return Ex, Ey, Ez

    def _from_grids(self, Ex, Ey, Ez, m):
        out = jnp.concatenate(
            [Ex.reshape(-1, m), Ey.reshape(-1, m), Ez.reshape(-1, m)], axis=0
        )
        pad = self.n_loc_pad - self.n_loc
        if pad:
            out = jnp.pad(out, ((0, pad), (0, 0)))
        return out

    # --- interface partial-sum exchange ------------------------------------
    def _iface_sum(self, A, dep=None):
        """A (c+1, ..., m) holds partial sums whose first/last planes are
        shared with neighbors; one ppermute pair completes them on BOTH
        copies (invariant: interface planes stay consistent)."""
        right_perm = [(d, d + 1) for d in range(self.D - 1)]
        left_perm = [(d + 1, d) for d in range(self.D - 1)]
        last = A[-1]
        if dep is not None:
            last = _after(last, dep)
        from_left = jax.lax.ppermute(last, self.axis, right_perm)
        from_right = jax.lax.ppermute(
            _after(A[0], from_left), self.axis, left_perm
        )
        return A.at[0].add(from_left).at[-1].add(from_right), from_right

    # --- gather-form tap apply (vacuum PEC; round 4) ------------------------
    def _ghost_planes(self, Ex, Ey, Ez):
        """One ghost x-plane per component per side via TWO packed
        ppermutes. Sent planes: to the RIGHT neighbor goes what it needs
        as its left ghost (our Ex[-1], Ey[-2], Ez[-2] — its plane -1 in
        each component's local x index); to the LEFT goes our (Ex[0],
        Ey[1], Ez[1]). Chain ends receive zeros — exactly the zero
        padding the single-device tap apply uses at the domain boundary.
        Interface planes (replicated, consistent) need no exchange."""
        m = Ex.shape[-1]

        def pack(ex_pl, ey_pl, ez_pl):
            return jnp.concatenate(
                [ex_pl.reshape(-1, m), ey_pl.reshape(-1, m),
                 ez_pl.reshape(-1, m)], axis=0
            )

        def unpack(buf):
            ny, nz = self.ny, self.nz
            a = (ny + 1) * (nz + 1)
            b = ny * (nz + 1)
            ex = buf[:a].reshape(1, ny + 1, nz + 1, m)
            ey = buf[a : a + b].reshape(1, ny, nz + 1, m)
            ez = buf[a + b :].reshape(1, ny + 1, nz, m)
            return ex, ey, ez

        right_perm = [(d, d + 1) for d in range(self.D - 1)]
        left_perm = [(d + 1, d) for d in range(self.D - 1)]
        to_right = pack(Ex[-1], Ey[-2], Ez[-2])
        to_left = pack(Ex[0], Ey[1], Ez[1])
        from_left = jax.lax.ppermute(to_right, self.axis, right_perm)
        from_right = jax.lax.ppermute(
            _after(to_left, from_left), self.axis, left_perm
        )
        return unpack(from_left), unpack(from_right)

    def _taps_apply_slab(self, X, want_K, want_M):
        """Gather-form tap apply on ghost-extended local grids: every
        owned output row (including the replicated interface planes,
        computed identically on both copies) sees its full neighborhood,
        so there is NO output partial-sum exchange — comm is two packed
        one-plane ppermutes issued before the (much larger) tap
        arithmetic. Same shifted-slice structure as the single-device
        StencilPencil3D._taps_apply; the x-axis zero padding is replaced
        by the ghost planes."""
        vec = X.ndim == 1
        Xl = (X[:, None] if vec else X) * self.mask[:, None]
        m = Xl.shape[1]
        grids = self._to_grids(Xl)
        (glx, gly, glz), (grx, gry, grz) = self._ghost_planes(*grids)
        ext = (
            jnp.concatenate([glx, grids[0], grx], axis=0),
            jnp.concatenate([gly, grids[1], gry], axis=0),
            jnp.concatenate([glz, grids[2], grz], axis=0),
        )
        shapes = [g.shape for g in grids]
        # m-leading, zero-pad y/z by 1; x is already ghost-extended by 1
        P = [
            jnp.pad(
                jnp.moveaxis(g, -1, 0), ((0, 0), (0, 0), (1, 1), (1, 1))
            )
            for g in ext
        ]
        outK, outM = [], []
        for alpha in range(3):
            s_ = shapes[alpha]
            accK = jnp.zeros((m,) + tuple(s_[:-1]), Xl.dtype)
            accM = accK
            for beta, (dx, dy, dz), cK, cM in self.taps[alpha]:
                sl = P[beta][
                    :,
                    1 + dx : 1 + dx + s_[0],
                    1 + dy : 1 + dy + s_[1],
                    1 + dz : 1 + dz + s_[2],
                ]
                if want_K and cK != 0.0:
                    accK = accK + cK * sl
                if want_M and cM != 0.0:
                    accM = accM + cM * sl
            outK.append(accK)
            outM.append(accM)

        def pack_out(Ys):
            Ys = [jnp.moveaxis(Y, 0, -1) for Y in Ys]
            out = self._from_grids(*Ys, m) * self.mask[:, None]
            return out[:, 0] if vec else out

        return (
            pack_out(outK) if want_K else None,
            pack_out(outM) if want_M else None,
        )

    # --- element apply -----------------------------------------------------
    def _element_apply_multi(self, E, X, scales=None):
        """Stacked element apply ((12k, 12) E -> k outputs) with ONE panel
        gather and one interface exchange round per output field. scales:
        per-output per-cell (cells, ny, nz) material coefficients."""
        Xl = X * self.mask[:, None]
        m = Xl.shape[1]
        c, ny, nz = self.cells, self.ny, self.nz
        k = E.shape[0] // 12
        if scales is None:
            scales = (None,) * k
        Ex, Ey, Ez = self._to_grids(Xl)

        panels = [
            Ex[:, 0:ny, 0:nz], Ex[:, 1 : ny + 1, 0:nz],
            Ex[:, 0:ny, 1 : nz + 1], Ex[:, 1 : ny + 1, 1 : nz + 1],
            Ey[0:c, :, 0:nz], Ey[1 : c + 1, :, 0:nz],
            Ey[0:c, :, 1 : nz + 1], Ey[1 : c + 1, :, 1 : nz + 1],
            Ez[0:c, 0:ny, :], Ez[1 : c + 1, 0:ny, :],
            Ez[0:c, 1 : ny + 1, :], Ez[1 : c + 1, 1 : ny + 1, :],
        ]
        G = jnp.stack(panels)
        Y = jnp.einsum(
            "ab,bxyzm->axyzm", E, G, preferred_element_type=G.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )

        outs = []
        dep = None
        for j in range(k):
            Yj = Y[12 * j : 12 * (j + 1)]
            if scales[j] is not None:
                Yj = Yj * scales[j][None, :, :, :, None]
            Yx = jnp.zeros_like(Ex)
            Yy = jnp.zeros_like(Ey)
            Yz = jnp.zeros_like(Ez)
            Yx = Yx.at[:, 0:ny, 0:nz].add(Yj[0])
            Yx = Yx.at[:, 1 : ny + 1, 0:nz].add(Yj[1])
            Yx = Yx.at[:, 0:ny, 1 : nz + 1].add(Yj[2])
            Yx = Yx.at[:, 1 : ny + 1, 1 : nz + 1].add(Yj[3])
            Yy = Yy.at[0:c, :, 0:nz].add(Yj[4])
            Yy = Yy.at[1 : c + 1, :, 0:nz].add(Yj[5])
            Yy = Yy.at[0:c, :, 1 : nz + 1].add(Yj[6])
            Yy = Yy.at[1 : c + 1, :, 1 : nz + 1].add(Yj[7])
            Yz = Yz.at[0:c, 0:ny, :].add(Yj[8])
            Yz = Yz.at[1 : c + 1, 0:ny, :].add(Yj[9])
            Yz = Yz.at[0:c, 1 : ny + 1, :].add(Yj[10])
            Yz = Yz.at[1 : c + 1, 1 : ny + 1, :].add(Yj[11])

            # complete the interface partial sums (sequenced collectives)
            Yy, dep = self._iface_sum(Yy, dep=dep)
            Yz, dep = self._iface_sum(Yz, dep=dep)

            outs.append(self._from_grids(Yx, Yy, Yz, m) * self.mask[:, None])
        return jnp.stack(outs)

    def _element_apply(self, E, X, scale=None):
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        out = self._element_apply_multi(E, Xl, scales=(scale,))[0]
        return out[:, 0] if vec else out

    def _cell_grid(self, arr):
        if arr is None:
            return None
        return arr.reshape(self.cells, self.ny, self.nz)

    def K_mm(self, X):
        if self.taps is not None:
            return self._taps_apply_slab(X, True, False)[0]
        return self._element_apply(
            self.Ke, X, scale=self._cell_grid(self.inv_mu)
        )

    def M_mm(self, X):
        if self.taps is not None:
            return self._taps_apply_slab(X, False, True)[1]
        return self._element_apply(self.Me, X, scale=self._cell_grid(self.eps))

    def KM_mm(self, X):
        if self.taps is not None:
            # fused taps: shared ghost exchange + shared slices for K and M
            return self._taps_apply_slab(X, True, True)
        # fused: one panel gather + one (24x12) contraction for K and M
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        E2 = jnp.concatenate([self.Ke, self.Me], axis=0)
        Y2 = self._element_apply_multi(
            E2, Xl,
            scales=(self._cell_grid(self.inv_mu), self._cell_grid(self.eps)),
        )
        if vec:
            return Y2[0][:, 0], Y2[1][:, 0]
        return Y2[0], Y2[1]

    def Minv_mm(self, X):
        return cg(
            self.M_mm, X, tol=self.mass_tol, maxiter=self.mass_iters,
            dot=self.dot_cols,
        )

    # --- gradient projector (slab-distributed nodes) ------------------------
    def _node_dot(self, x, y):
        w = self.node_w if x.ndim == 1 else self.node_w[:, None]
        return jax.lax.psum(jnp.sum(x * w * y, axis=0), self.axis)

    def _g_mm(self, phi):
        """(n_loc_pad, m) <- G phi, phi (nn_loc, m) interface-consistent.

        GRID form (round 4): finite-difference slices on the local node
        grid — the head/tail gather formulation cost ~50 ms per apply at
        64^3 on-chip (unaligned row gathers), the single largest term of
        every distributed LOBPCG iteration."""
        vec = phi.ndim == 1
        ph = phi[:, None] if vec else phi
        c, ny, nz = self.cells, self.ny, self.nz
        m = ph.shape[1]
        hx = self.ax / self.nx
        hy = self.by / self.ny
        hz = self.cz / self.nz
        P = ph.reshape(c + 1, ny + 1, nz + 1, m) * self.node_mask.reshape(
            c + 1, ny + 1, nz + 1
        )[..., None]
        Ex = (P[1:] - P[:-1]) / hx
        Ey = (P[:, 1:] - P[:, :-1]) / hy
        Ez = (P[:, :, 1:] - P[:, :, :-1]) / hz
        out = self._from_grids(Ex, Ey, Ez, m)
        return out[:, 0] if vec else out

    def _gt_mm(self, y):
        """(nn_loc, m) <- G^T y with interface partial-sum exchange.

        The scatter is OWNERSHIP-weighted (w_dot): interface y/z edges are
        duplicated in both neighboring slabs with consistent values, so an
        unweighted scatter counts them twice after _iface_sum — that made
        G^T here the adjoint of a slightly different operator than G, i.e.
        an OBLIQUE (non-M-self-adjoint) gradient projector. LOBPCG tolerated
        the obliqueness; Lanczos did not (round-2 distributed shift-invert
        debugging)."""
        vec = y.ndim == 1
        yl = y[:, None] if vec else y
        own = self.w_dot[:, None]
        m = yl.shape[1]
        c, ny, nz = self.cells, self.ny, self.nz
        hx = self.ax / self.nx
        hy = self.by / self.ny
        hz = self.cz / self.nz
        # grid form (see _g_mm): pad each edge grid by a zero layer on
        # its own axis, difference onto the node grid
        Ex, Ey, Ez = self._to_grids(yl * own)
        zx = jnp.zeros((1,) + Ex.shape[1:], yl.dtype)
        Exp = jnp.concatenate([zx, Ex, zx], axis=0)  # (c+2, ny+1, nz+1, m)
        Eyp = jnp.pad(Ey, ((0, 0), (1, 1), (0, 0), (0, 0)))
        Ezp = jnp.pad(Ez, ((0, 0), (0, 0), (1, 1), (0, 0)))
        acc = (Exp[:-1] - Exp[1:]) / hx
        acc = acc + (Eyp[:, :-1] - Eyp[:, 1:]) / hy
        acc = acc + (Ezp[:, :, :-1] - Ezp[:, :, 1:]) / hz
        grid = acc.reshape(c + 1, (ny + 1) * (nz + 1), m)
        grid, _ = self._iface_sum(grid)
        out = grid.reshape(self.nn_loc, m)
        out = out * self.node_mask[:, None]
        return out[:, 0] if vec else out

    def _fast_nodal_solve(self, r):
        """EXACT q = (G^T M G)^-1 r on the slab-sharded interior-node grid
        (vacuum): per-axis generalized-hat eigentransforms; the x-axis
        contraction is ownership-weighted and completed by one psum (the
        mode grid is then replicated, so the inverse transform is purely
        local and interface-consistent by construction)."""
        c, ny, nz = self.cells, self.ny, self.nz
        m = r.shape[1]
        G = (r * self.node_w[:, None]).reshape(c + 1, ny + 1, nz + 1, m)
        g_int = G[:, 1:ny, 1:nz]  # (c+1, ny-1, nz-1, m)

        d = jax.lax.axis_index(self.axis)
        Vxl = jax.lax.dynamic_slice(
            self.fpVx_full, (d * c, jnp.int32(0)), (c + 1, self.nx - 1)
        )
        from maxwell_tpu.solvers.spectral import SpectralShiftSolver

        tr = SpectralShiftSolver._tr3
        Rt = jax.lax.psum(
            tr(g_int, Vxl, self.fpVy, self.fpVz), self.axis
        )
        Rt = Rt * self.fp_inv_lam[:, :, :, None]
        q_int = tr(Rt, Vxl.T, self.fpVy.T, self.fpVz.T)
        out = jnp.zeros((c + 1, ny + 1, nz + 1, m), r.dtype)
        out = out.at[:, 1:ny, 1:nz].set(q_int)
        return out.reshape(self.nn_loc, m) * self.node_mask[:, None]

    def project(self, X):
        vec = X.ndim == 1
        Xm = (X[:, None] if vec else X) * self.mask[:, None]
        nmask = self.node_mask[:, None]

        rhs = nmask * self._gt_mm(self.M_mm(Xm))
        if self.fpVx_full is not None:
            q = self._fast_nodal_solve(rhs)
        else:

            def L_mm(phi):
                return nmask * self._gt_mm(
                    self.M_mm(self._g_mm(nmask * phi))
                )

            q = cg(
                L_mm, rhs, tol=self.proj_tol, maxiter=self.proj_iters,
                dot=self._node_dot,
            )
        out = Xm - self._g_mm(q) * self.mask[:, None]
        return out[:, 0] if vec else out

    # --- construction -------------------------------------------------------
    @staticmethod
    def build(
        a=1.0, b=1.0, c_len=1.0, nx=8, ny=8, nz=8, D=8,
        dtype=jnp.float32, block: int = 8, axis: str = "rows",
        eps_r=None, mu_r=None,
    ) -> "DistStencilPencil3D":
        from maxwell_tpu.problems.cavity3d import hex_element_matrices

        from maxwell_tpu.sparse.bsr import ensure_x64_for

        ensure_x64_for(dtype)
        if nx % D != 0:
            raise ValueError("nx must be divisible by the shard count")
        cells = nx // D
        hx, hy, hz = a / nx, b / ny, c_len / nz
        Ke, Me = hex_element_matrices(hx, hy, hz)

        sx = cells * (ny + 1) * (nz + 1)
        sy = (cells + 1) * ny * (nz + 1)
        sz = (cells + 1) * (ny + 1) * nz
        n_loc = sx + sy + sz
        n_loc_pad = _round_up(n_loc, block * max(128 // block, 1))
        nn_loc = (cells + 1) * (ny + 1) * (nz + 1)

        dt = np.dtype(dtype)
        mask = np.zeros((D, n_loc_pad), dtype=dt)
        w_dot = np.zeros((D, n_loc_pad), dtype=dt)
        head = np.full((D, n_loc_pad), nn_loc, dtype=np.int32)
        tail = np.full((D, n_loc_pad), nn_loc, dtype=np.int32)
        gweight = np.zeros((D, n_loc_pad), dtype=dt)
        node_mask = np.zeros((D, nn_loc), dtype=dt)
        node_w = np.zeros((D, nn_loc), dtype=dt)

        # local index helpers (row-major as in _to_grids)
        def ex_id(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        def ey_id(i, j, k):
            return sx + (i * ny + j) * (nz + 1) + k

        def ez_id(i, j, k):
            return sx + sy + (i * (ny + 1) + j) * nz + k

        def node_id(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        for d in range(D):
            x0 = d * cells  # global x-plane of local plane 0
            # --- Ex: local cell rows i -> global cell x0+i ----------------
            xi, xj, xk = np.meshgrid(
                np.arange(cells), np.arange(ny + 1), np.arange(nz + 1),
                indexing="ij",
            )
            ids = ex_id(xi, xj, xk).reshape(-1)
            keep = (
                (xj != 0) & (xj != ny) & (xk != 0) & (xk != nz)
            ).reshape(-1)
            mask[d, ids] = keep
            w_dot[d, ids] = keep  # fully owned
            head[d, ids] = node_id(xi + 1, xj, xk).reshape(-1)
            tail[d, ids] = node_id(xi, xj, xk).reshape(-1)
            gweight[d, ids] = keep / hx
            # --- Ey: local planes i -> global plane x0+i -------------------
            yi, yj, yk = np.meshgrid(
                np.arange(cells + 1), np.arange(ny), np.arange(nz + 1),
                indexing="ij",
            )
            gx = yi + x0
            ids = ey_id(yi, yj, yk).reshape(-1)
            keep = (
                (gx != 0) & (gx != nx) & (yk != 0) & (yk != nz)
            ).reshape(-1)
            mask[d, ids] = keep
            owned = keep & (yi != cells).reshape(-1)
            w_dot[d, ids] = owned
            head[d, ids] = node_id(yi, yj + 1, yk).reshape(-1)
            tail[d, ids] = node_id(yi, yj, yk).reshape(-1)
            gweight[d, ids] = keep / hy
            # --- Ez --------------------------------------------------------
            zi, zj, zk = np.meshgrid(
                np.arange(cells + 1), np.arange(ny + 1), np.arange(nz),
                indexing="ij",
            )
            gx = zi + x0
            ids = ez_id(zi, zj, zk).reshape(-1)
            keep = (
                (gx != 0) & (gx != nx) & (zj != 0) & (zj != ny)
            ).reshape(-1)
            mask[d, ids] = keep
            owned = keep & (zi != cells).reshape(-1)
            w_dot[d, ids] = owned
            head[d, ids] = node_id(zi, zj, zk + 1).reshape(-1)
            tail[d, ids] = node_id(zi, zj, zk).reshape(-1)
            gweight[d, ids] = keep / hz
            # --- nodes -----------------------------------------------------
            ni, nj, nk = np.meshgrid(
                np.arange(cells + 1), np.arange(ny + 1), np.arange(nz + 1),
                indexing="ij",
            )
            gx = ni + x0
            ids = node_id(ni, nj, nk).reshape(-1)
            interior = (
                (gx > 0) & (gx < nx)
                & (nj > 0) & (nj < ny)
                & (nk > 0) & (nk < nz)
            ).reshape(-1)
            node_mask[d, ids] = interior
            node_w[d, ids] = interior & (ni != cells).reshape(-1)

        # per-cell materials: cells are disjoint across slabs — plain
        # (D*cells, ny, nz) stacking IS the shard layout
        inv_mu = (
            None
            if mu_r is None
            else jnp.asarray(1.0 / np.asarray(mu_r), dtype=dtype).reshape(
                D * cells, ny, nz
            )
        )
        eps = (
            None
            if eps_r is None
            else jnp.asarray(np.asarray(eps_r), dtype=dtype).reshape(
                D * cells, ny, nz
            )
        )
        # translation-invariant taps (vacuum PEC): the gather-form slab
        # apply; derived from the dtype-CAST element matrices so the tap
        # and element paths agree at the production dtype
        taps = None
        if inv_mu is None and eps is None:
            from maxwell_tpu.problems.stencil3d import _derive_taps

            np_dt = np.dtype(jnp.zeros((), dtype).dtype)
            taps = _derive_taps(
                np.asarray(Ke, np_dt), np.asarray(Me, np_dt)
            )
        # exact nodal Poisson eigentransforms (vacuum only): the
        # projector's fast path (see _fast_nodal_solve)
        fpVx_full = fpVy = fpVz = fp_inv_lam = None
        if inv_mu is None and eps is None:
            from maxwell_tpu.solvers.fast_poisson import _modes_1d

            lx, Vx = _modes_1d(nx, a / nx)
            ly, Vy = _modes_1d(ny, b / ny)
            lz, Vz = _modes_1d(nz, c_len / nz)
            Vx_full = np.zeros((nx + 1, nx - 1))
            Vx_full[1:nx] = Vx
            fpVx_full = jnp.asarray(Vx_full, dtype)
            fpVy = jnp.asarray(Vy, dtype)
            fpVz = jnp.asarray(Vz, dtype)
            fp_inv_lam = jnp.asarray(
                1.0
                / (
                    lx[:, None, None] + ly[None, :, None]
                    + lz[None, None, :]
                ),
                dtype,
            )
        return DistStencilPencil3D(
            mask=jnp.asarray(mask.reshape(-1)),
            w_dot=jnp.asarray(w_dot.reshape(-1)),
            Ke=jnp.asarray(Ke, dtype=dtype),
            Me=jnp.asarray(Me, dtype=dtype),
            head=jnp.asarray(head.reshape(-1)),
            tail=jnp.asarray(tail.reshape(-1)),
            gweight=jnp.asarray(gweight.reshape(-1)),
            node_mask=jnp.asarray(node_mask.reshape(-1)),
            node_w=jnp.asarray(node_w.reshape(-1)),
            inv_mu=inv_mu,
            eps=eps,
            fpVx_full=fpVx_full, fpVy=fpVy, fpVz=fpVz,
            fp_inv_lam=fp_inv_lam,
            taps=taps,
            ax=a, by=b, cz=c_len, nx=nx, ny=ny, nz=nz,
            cells=cells, D=D, n_loc=n_loc, n_loc_pad=n_loc_pad,
            nn_loc=nn_loc, axis=axis,
        )

    # --- host-side driver support -------------------------------------------
    @property
    def global_rows(self) -> int:
        return self.D * self.n_loc_pad

    @property
    def n_full(self) -> int:
        nx, ny, nz = self.nx, self.ny, self.nz
        return (
            nx * (ny + 1) * (nz + 1)
            + (nx + 1) * ny * (nz + 1)
            + (nx + 1) * (ny + 1) * nz
        )

    def _scatter_idx(self):
        """Device gather map for the global->stacked layout (cached on
        the instance, host-side attribute): stacked row r reads global
        row idx[r] (or is padding where valid == 0). Built once by
        pushing an index vector through scatter_vector. Lets make_block /
        inject_vectors run as a DEVICE gather instead of a host scatter —
        the old path cost two full-block host transfers per call
        (download the random block, upload the scattered one) on every
        distributed solve (round 4)."""
        cached = self.__dict__.get("_scatter_idx_cache")
        if cached is None:
            marker = self.scatter_vector(
                np.arange(1, self.n_full + 1, dtype=np.float64)
            )
            idx = np.asarray(marker, np.int64) - 1
            valid = idx >= 0
            cached = (
                jnp.asarray(np.maximum(idx, 0).astype(np.int32)),
                jnp.asarray(valid.astype(np.dtype(self.dtype))),
            )
            object.__setattr__(self, "_scatter_idx_cache", cached)
        return cached

    def make_block(self, key, m: int):
        """Random start block: generated in the GLOBAL stencil layout
        (so interface copies are consistent) and scattered ON DEVICE."""
        idx, valid = self._scatter_idx()
        xg = jax.random.normal(key, (self.n_full, m), dtype=self.dtype)
        return xg[idx] * valid[:, None]

    def extract_vectors(self, X_stacked: np.ndarray) -> np.ndarray:
        return self.gather_vector(np.asarray(X_stacked))

    def inject_vectors(self, X_orig):
        """Original (global stencil) ordering -> stacked local layout
        (device gather: one upload, no host scatter round-trip)."""
        idx, valid = self._scatter_idx()
        X = jnp.asarray(np.asarray(X_orig), dtype=self.dtype)
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        out = Xl[idx] * valid[:, None]
        return out[:, 0] if vec else out

    # --- host-side layout conversion ----------------------------------------
    def scatter_vector(self, x_full: np.ndarray) -> np.ndarray:
        """Global StencilPencil3D-layout (n_full, m) -> stacked local
        (D*n_loc_pad, m) with consistent interface copies."""
        nx, ny, nz, c = self.nx, self.ny, self.nz, self.cells
        sxg = nx * (ny + 1) * (nz + 1)
        syg = (nx + 1) * ny * (nz + 1)
        x_full = np.asarray(x_full)
        m = x_full.shape[1] if x_full.ndim > 1 else 1
        xf = x_full.reshape(-1, m)
        Ex = xf[:sxg].reshape(nx, ny + 1, nz + 1, m)
        Ey = xf[sxg : sxg + syg].reshape(nx + 1, ny, nz + 1, m)
        Ez = xf[sxg + syg :].reshape(nx + 1, ny + 1, nz, m)
        out = np.zeros((self.D, self.n_loc_pad, m), dtype=xf.dtype)
        for d in range(self.D):
            x0 = d * c
            loc = np.concatenate(
                [
                    Ex[x0 : x0 + c].reshape(-1, m),
                    Ey[x0 : x0 + c + 1].reshape(-1, m),
                    Ez[x0 : x0 + c + 1].reshape(-1, m),
                ],
                axis=0,
            )
            out[d, : self.n_loc] = loc
        out = out.reshape(self.D * self.n_loc_pad, m)
        return out[:, 0] if x_full.ndim == 1 else out

    def gather_vector(self, x_stacked: np.ndarray) -> np.ndarray:
        """Inverse of scatter_vector (owned entries win)."""
        nx, ny, nz, c = self.nx, self.ny, self.nz, self.cells
        xs = np.asarray(x_stacked)
        m = xs.shape[1] if xs.ndim > 1 else 1
        xs2 = xs.reshape(self.D, self.n_loc_pad, m)
        sx, sy, sz = self._sizes
        Ex = np.zeros((nx, ny + 1, nz + 1, m), dtype=xs.dtype)
        Ey = np.zeros((nx + 1, ny, nz + 1, m), dtype=xs.dtype)
        Ez = np.zeros((nx + 1, ny + 1, nz, m), dtype=xs.dtype)
        for d in range(self.D):
            x0 = d * c
            loc = xs2[d]
            Ex[x0 : x0 + c] = loc[:sx].reshape(c, ny + 1, nz + 1, m)
            Ey[x0 : x0 + c + 1] = loc[sx : sx + sy].reshape(
                c + 1, ny, nz + 1, m
            )
            Ez[x0 : x0 + c + 1] = loc[sx + sy : self.n_loc].reshape(
                c + 1, ny + 1, nz, m
            )
        out = np.concatenate(
            [Ex.reshape(-1, m), Ey.reshape(-1, m), Ez.reshape(-1, m)], axis=0
        )
        return out[:, 0] if xs.ndim == 1 else out
