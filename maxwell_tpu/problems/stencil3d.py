"""Assembly-free curl-curl/mass apply for the 3D brick cavity — the flagship
speed-of-light path (SURVEY.md §2 C2; BASELINE.json "assembly-free storage",
config 4's operator).

Edge fields on their natural grids: Ex (nx, ny+1, nz+1), Ey (nx+1, ny, nz+1),
Ez (nx+1, ny+1, nz). One apply = 12 static slice-gathers -> a (12 x 12)
element-matrix contraction batched over all cells (one matrix product) -> 12 slice
scatter-adds. No matrix in memory: HBM traffic is just the field (re)reads,
so effective nnz/s is compute-bound, far above the SpMV roofline.

Exactness vs the assembled BrickCavity3D operators is tested in
tests/unit/test_stencil.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from maxwell_tpu.solvers.cg import cg
from maxwell_tpu.solvers.deflation import GradientProjector


def _round_up(x, m):
    return ((x + m - 1) // m) * m


# Local edge table for the hex element (matches the panel order in
# _element_apply_multi / problems.cavity3d.hex_element_matrices):
# (component, cell-relative offset): locals 0-3 are x-edges at (0, b, g),
# 4-7 y-edges at (a, 0, g), 8-11 z-edges at (a, b, 0) for a,b,g in {0,1}.
_LOCAL_EDGES = (
    (0, (0, 0, 0)), (0, (0, 1, 0)), (0, (0, 0, 1)), (0, (0, 1, 1)),
    (1, (0, 0, 0)), (1, (1, 0, 0)), (1, (0, 0, 1)), (1, (1, 0, 1)),
    (2, (0, 0, 0)), (2, (1, 0, 0)), (2, (0, 1, 0)), (2, (1, 1, 0)),
)


def _derive_taps(Ke, Me):
    """Collapse the per-cell (12x12) element apply into a translation-
    invariant tap stencil (gather form).

    For output edge p of component alpha, each element pair (a, b) with
    comp(a)=alpha contributes E[a,b] * X_{comp(b)}[p + (o_b - o_a)] from the
    cell at p - o_a.  Grouping by (beta, delta) is exact on every UNMASKED
    PEC row: a row is unmasked iff all its adjacent cells exist, so every
    grouped pair's cell is valid there; masked rows are zeroed afterwards
    anyway.  (PMC keeps boundary rows live -> fast path disabled there.)

    Returns: tuple over alpha in (x,y,z) of tuples
    (beta, (dx,dy,dz), coefK, coefM), taps with both coefficients zero
    dropped.  ~33 taps per component (matches the assembled row nnz).
    """
    taps = []
    for alpha in range(3):
        acc = {}
        for a, (ca, oa) in enumerate(_LOCAL_EDGES):
            if ca != alpha:
                continue
            for b, (cb, ob) in enumerate(_LOCAL_EDGES):
                d = (ob[0] - oa[0], ob[1] - oa[1], ob[2] - oa[2])
                k = (cb, d)
                cK, cM = acc.get(k, (0.0, 0.0))
                acc[k] = (cK + float(Ke[a, b]), cM + float(Me[a, b]))
        taps.append(
            tuple(
                (beta, d, cK, cM)
                for (beta, d), (cK, cM) in sorted(acc.items())
                if cK != 0.0 or cM != 0.0
            )
        )
    return tuple(taps)


def _derive_field_taps(Ke, Me, nx, ny, nz, scaleK, scaleM, dtype=None):
    """Position-dependent tap stencil: the fast path for LOADED cavities and
    PMC walls (round-1 VERDICT item 9).

    Same grouping as _derive_taps, but each (alpha, beta, delta) tap carries
    a coefficient GRID instead of a scalar:

        C[p] = sum over element pairs (a, b) of E[a,b] * scale[p - o_a]

    with the per-cell scale grid (1/mu_r for K, eps_r for M) ZERO-padded
    outside the domain. The zero padding makes the formula exact on EVERY
    row — including PMC boundary rows whose element sum only runs over the
    cells that exist — so one mechanism covers materials, PMC, and their
    combination. Storage: ~33 edge-grid-sized coefficient fields per
    component per operator (~264 B/row total) — still far below assembled
    BSR, and the apply stays gather-free static slices.

    Returns (meta, Kgrids, Mgrids): meta = tuple over alpha of
    tuples (beta, (dx,dy,dz), iK, iM) with iK/iM indices into the flat
    grid lists (or -1 when that operator has no such tap). Grids are
    accumulated in f64 and cast to `dtype` (default: Ke's dtype).
    """
    Ke = np.asarray(Ke, np.float64)
    Me = np.asarray(Me, np.float64)
    np_dt = np.dtype(dtype) if dtype is not None else Ke.dtype
    shapes = (
        (nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz)
    )
    padK = np.zeros((nx + 2, ny + 2, nz + 2), dtype=np.float64)
    padK[1:-1, 1:-1, 1:-1] = scaleK
    padM = np.zeros_like(padK)
    padM[1:-1, 1:-1, 1:-1] = scaleM
    meta, Kgrids, Mgrids = [], [], []
    for alpha in range(3):
        s = shapes[alpha]
        acc = {}
        for a, (ca, oa) in enumerate(_LOCAL_EDGES):
            if ca != alpha:
                continue
            # scale grid of the cell p - o_a, as an array over edge index p
            win = tuple(
                slice(1 - oa[ax], 1 - oa[ax] + s[ax]) for ax in range(3)
            )
            sK = padK[win]
            sM = padM[win]
            for b_, (cb, ob) in enumerate(_LOCAL_EDGES):
                d = (ob[0] - oa[0], ob[1] - oa[1], ob[2] - oa[2])
                k = (cb, d)
                cK, cM = acc.get(k, (0.0, 0.0))
                acc[k] = (
                    cK + float(Ke[a, b_]) * sK,
                    cM + float(Me[a, b_]) * sM,
                )
        entries = []
        for (beta, d), (cK, cM) in sorted(acc.items()):
            hasK = np.any(np.asarray(cK) != 0.0)
            hasM = np.any(np.asarray(cM) != 0.0)
            if not hasK and not hasM:
                continue
            iK = iM = -1
            if hasK:
                iK = len(Kgrids)
                Kgrids.append(jnp.asarray(np.asarray(cK).astype(np_dt)))
            if hasM:
                iM = len(Mgrids)
                Mgrids.append(jnp.asarray(np.asarray(cM).astype(np_dt)))
            entries.append((beta, d, iK, iM))
        meta.append(tuple(entries))
    return tuple(meta), tuple(Kgrids), tuple(Mgrids)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class StencilPencil3D:
    """Matrix-free 3D pencil on the FULL edge set (PEC via masking).

    Flat layout: [Ex (nx, ny+1, nz+1) | Ey (nx+1, ny, nz+1) |
    Ez (nx+1, ny+1, nz)], each row-major, then pad.
    """

    mask: jax.Array
    Ke: jax.Array  # (12, 12)
    Me: jax.Array
    proj: GradientProjector | None
    a: float
    b: float
    c: float
    nx: int
    ny: int
    nz: int
    n: int
    n_padded: int
    mass_tol: float = 1e-12
    mass_iters: int = 300
    # optional per-cell materials (nx, ny, nz): curl (1/mu_r) curl E =
    # k^2 eps_r E
    inv_mu: jax.Array | None = None
    eps: jax.Array | None = None
    # exact tensor-product nodal solver (vacuum only) — replaces the
    # projector's CG with six dense 1D transforms (solvers/fast_poisson.py)
    fastproj: "object | None" = None
    # translation-invariant tap stencil (vacuum + PEC only; see
    # _derive_taps). Static python floats -> lives in pytree aux data.
    taps: tuple | None = None
    # field-coefficient taps (materials / PMC; see _derive_field_taps):
    # meta is static structure (aux), the coefficient grids are traced
    ftaps_meta: tuple | None = None
    ftaps_K: tuple | None = None
    ftaps_M: tuple | None = None
    # boundary condition ("pec" | "pmc"): the spectral solver's interior
    # sine/cosine tensor basis is valid for PEC only — loaded (eps/mu)
    # PEC pencils may use the VACUUM spectral solve as an approximate
    # preconditioner, PMC may not
    bc: str = "pec"

    def tree_flatten(self):
        return (
            self.mask, self.Ke, self.Me, self.proj, self.inv_mu, self.eps,
            self.fastproj, self.ftaps_K, self.ftaps_M,
        ), (
            self.a, self.b, self.c, self.nx, self.ny, self.nz,
            self.n, self.n_padded, self.mass_tol, self.mass_iters,
            self.taps, self.ftaps_meta, self.bc,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        mask, Ke, Me, proj, inv_mu, eps, fastproj, ftaps_K, ftaps_M = (
            children
        )
        return cls(
            mask, Ke, Me, proj, *aux[:-3], inv_mu=inv_mu, eps=eps,
            fastproj=fastproj, taps=aux[-3], ftaps_meta=aux[-2],
            bc=aux[-1], ftaps_K=ftaps_K, ftaps_M=ftaps_M,
        )

    @property
    def dtype(self):
        return self.mask.dtype

    # --- reductions -------------------------------------------------------
    def weigh(self, x):
        return x

    def dot_mm(self, A, B):
        return A.T @ B

    def dot_cols(self, A, B):
        return jnp.sum(A * B, axis=0)

    def dot_vv(self, x, y):
        return jnp.vdot(x, y)

    def reduce_rows(self, v):
        return v

    def col_norms(self, A):
        return jnp.sqrt(jnp.maximum(self.dot_cols(A, A), 0.0))

    # --- packing ----------------------------------------------------------
    @property
    def _sizes(self):
        nx, ny, nz = self.nx, self.ny, self.nz
        return (
            nx * (ny + 1) * (nz + 1),
            (nx + 1) * ny * (nz + 1),
            (nx + 1) * (ny + 1) * nz,
        )

    def _to_grids(self, X):
        nx, ny, nz = self.nx, self.ny, self.nz
        sx, sy, sz = self._sizes
        m = X.shape[1]
        Ex = X[:sx].reshape(nx, ny + 1, nz + 1, m)
        Ey = X[sx : sx + sy].reshape(nx + 1, ny, nz + 1, m)
        Ez = X[sx + sy : self.n].reshape(nx + 1, ny + 1, nz, m)
        return Ex, Ey, Ez

    def _from_grids(self, Ex, Ey, Ez, m):
        out = jnp.concatenate(
            [Ex.reshape(-1, m), Ey.reshape(-1, m), Ez.reshape(-1, m)], axis=0
        )
        pad = self.n_padded - self.n
        if pad:
            out = jnp.pad(out, ((0, pad), (0, 0)))
        return out

    # --- the element apply (shared by K and M) ----------------------------
    def _element_apply_multi(self, E, X, scales=None):
        """Y_j = A_j X for each stacked (12x12) element matrix (E is
        (12k, 12)); one panel gather serves all k operators. scales: tuple
        of per-cell (nx, ny, nz) material coefficients (or None) per output.
        Local edge order MUST match problems.cavity3d.hex_element_matrices:
        0-3 x(b,g), 4-7 y(a,g), 8-11 z(a,b). Returns (k, n_padded, m)."""
        Xl = X * self.mask[:, None]
        m = Xl.shape[1]
        nx, ny, nz = self.nx, self.ny, self.nz
        k = E.shape[0] // 12
        if scales is None:
            scales = (None,) * k
        Ex, Ey, Ez = self._to_grids(Xl)

        panels = [
            Ex[:, 0:ny, 0:nz], Ex[:, 1 : ny + 1, 0:nz],
            Ex[:, 0:ny, 1 : nz + 1], Ex[:, 1 : ny + 1, 1 : nz + 1],
            Ey[0:nx, :, 0:nz], Ey[1 : nx + 1, :, 0:nz],
            Ey[0:nx, :, 1 : nz + 1], Ey[1 : nx + 1, :, 1 : nz + 1],
            Ez[0:nx, 0:ny, :], Ez[1 : nx + 1, 0:ny, :],
            Ez[0:nx, 1 : ny + 1, :], Ez[1 : nx + 1, 1 : ny + 1, :],
        ]
        G = jnp.stack(panels)  # (12, nx, ny, nz, m)
        Y = jnp.einsum(
            "ab,bxyzm->axyzm", E, G, preferred_element_type=G.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )

        outs = []
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
            Yy = Yy.at[0:nx, :, 0:nz].add(Yj[4])
            Yy = Yy.at[1 : nx + 1, :, 0:nz].add(Yj[5])
            Yy = Yy.at[0:nx, :, 1 : nz + 1].add(Yj[6])
            Yy = Yy.at[1 : nx + 1, :, 1 : nz + 1].add(Yj[7])
            Yz = Yz.at[0:nx, 0:ny, :].add(Yj[8])
            Yz = Yz.at[1 : nx + 1, 0:ny, :].add(Yj[9])
            Yz = Yz.at[0:nx, 1 : ny + 1, :].add(Yj[10])
            Yz = Yz.at[1 : nx + 1, 1 : ny + 1, :].add(Yj[11])
            outs.append(self._from_grids(Yx, Yy, Yz, m) * self.mask[:, None])
        return jnp.stack(outs)

    def _element_apply(self, E, X, scale=None):
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        out = self._element_apply_multi(E, Xl, scales=(scale,))[0]
        return out[:, 0] if vec else out

    # --- the tap-stencil fast path (vacuum + PEC) --------------------------
    def _taps_apply(self, X, want_K, want_M):
        """Fused shifted-slice apply: no panel stack, no scatter — every tap
        is a static slice of a once-padded field, so XLA fuses each output
        component into one elementwise loop with zero intermediate HBM traffic.
        Returns (YK or None, YM or None)."""
        vec = X.ndim == 1
        Xl = (X[:, None] if vec else X) * self.mask[:, None]
        m = Xl.shape[1]
        grids = self._to_grids(Xl)
        shapes = [g.shape for g in grids]
        # lead with m so every tap is a shifted slice along the contiguous
        # z axis of one (m, x, y, z) field
        P = [
            jnp.pad(
                jnp.moveaxis(g, -1, 0), ((0, 0), (1, 1), (1, 1), (1, 1))
            )
            for g in grids
        ]
        outK, outM = [], []
        for alpha in range(3):
            s = shapes[alpha]
            # zero init: a component with no surviving taps (possible if the
            # element matrices change) must yield zeros, not crash pack()
            accK = jnp.zeros((m,) + tuple(s[:-1]), Xl.dtype)
            accM = accK
            for beta, (dx, dy, dz), cK, cM in self.taps[alpha]:
                sl = P[beta][
                    :,
                    1 + dx : 1 + dx + s[0],
                    1 + dy : 1 + dy + s[1],
                    1 + dz : 1 + dz + s[2],
                ]
                if want_K and cK != 0.0:
                    t = cK * sl
                    accK = t if accK is None else accK + t
                if want_M and cM != 0.0:
                    t = cM * sl
                    accM = t if accM is None else accM + t
            outK.append(accK)
            outM.append(accM)

        def pack(Ys):
            Ys = [jnp.moveaxis(Y, 0, -1) for Y in Ys]
            out = self._from_grids(*Ys, m) * self.mask[:, None]
            return out[:, 0] if vec else out

        return (
            pack(outK) if want_K else None,
            pack(outM) if want_M else None,
        )

    # --- field-coefficient taps (materials / PMC) --------------------------
    def _ftaps_apply(self, X, want_K, want_M):
        """Gather-free shifted-slice apply with position-dependent tap
        coefficients (_derive_field_taps): exact for per-cell eps/mu and on
        PMC boundary rows. Same slice structure as _taps_apply; each tap
        adds one elementwise multiply by its coefficient grid."""
        vec = X.ndim == 1
        Xl = (X[:, None] if vec else X) * self.mask[:, None]
        m = Xl.shape[1]
        grids = self._to_grids(Xl)
        shapes = [g.shape for g in grids]
        P = [
            jnp.pad(
                jnp.moveaxis(g, -1, 0), ((0, 0), (1, 1), (1, 1), (1, 1))
            )
            for g in grids
        ]
        outK, outM = [], []
        for alpha in range(3):
            s = shapes[alpha]
            accK = jnp.zeros((m,) + tuple(s[:-1]), Xl.dtype)
            accM = accK
            for beta, (dx, dy, dz), iK, iM in self.ftaps_meta[alpha]:
                sl = P[beta][
                    :,
                    1 + dx : 1 + dx + s[0],
                    1 + dy : 1 + dy + s[1],
                    1 + dz : 1 + dz + s[2],
                ]
                if want_K and iK >= 0:
                    accK = accK + self.ftaps_K[iK][None] * sl
                if want_M and iM >= 0:
                    accM = accM + self.ftaps_M[iM][None] * sl
            outK.append(accK)
            outM.append(accM)

        def pack(Ys):
            Ys = [jnp.moveaxis(Y, 0, -1) for Y in Ys]
            out = self._from_grids(*Ys, m) * self.mask[:, None]
            return out[:, 0] if vec else out

        return (
            pack(outK) if want_K else None,
            pack(outM) if want_M else None,
        )

    def K_mm(self, X):
        if self.taps is not None:
            return self._taps_apply(X, True, False)[0]
        if self.ftaps_meta is not None:
            return self._ftaps_apply(X, True, False)[0]
        return self._element_apply(self.Ke, X, scale=self.inv_mu)

    def M_mm(self, X):
        if self.taps is not None:
            return self._taps_apply(X, False, True)[1]
        if self.ftaps_meta is not None:
            return self._ftaps_apply(X, False, True)[1]
        return self._element_apply(self.Me, X, scale=self.eps)

    def KM_mm(self, X):
        if self.taps is not None:
            # fused taps: the shared slices are loaded once for K and M
            return self._taps_apply(X, True, True)
        if self.ftaps_meta is not None:
            return self._ftaps_apply(X, True, True)
        # fused: one panel gather + one (24x12) contraction for K and M
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        E2 = jnp.concatenate([self.Ke, self.Me], axis=0)
        Y2 = self._element_apply_multi(E2, Xl, scales=(self.inv_mu, self.eps))
        if vec:
            return Y2[0][:, 0], Y2[1][:, 0]
        return Y2[0], Y2[1]

    def Minv_mm(self, X):
        return cg(
            self.M_mm, X, tol=self.mass_tol, maxiter=self.mass_iters,
            dot=self.dot_cols,
        )

    # --- grid-form discrete gradient (round 4) -----------------------------
    # The generic GradientProjector applies G via head/tail index
    # gather/scatter, which is scattered (n, m) row traffic in every
    # LOBPCG iteration. On the tensor grid G is a finite-difference
    # operator: pure static slices.
    def _g_grid(self, q):
        """(n_padded, m) <- G q for q ((nx-1)(ny-1)(nz-1), m) interior
        nodal values (row-major), PEC edge mask applied."""
        nx, ny, nz = self.nx, self.ny, self.nz
        hx, hy, hz = self.a / nx, self.b / ny, self.c / nz
        m = q.shape[1]
        phin = jnp.zeros((nx + 1, ny + 1, nz + 1, m), q.dtype)
        phin = phin.at[1:nx, 1:ny, 1:nz].set(
            q.reshape(nx - 1, ny - 1, nz - 1, m)
        )
        Ex = (phin[1:] - phin[:-1]) / hx
        Ey = (phin[:, 1:] - phin[:, :-1]) / hy
        Ez = (phin[:, :, 1:] - phin[:, :, :-1]) / hz
        return self._from_grids(Ex, Ey, Ez, m) * self.mask[:, None]

    def _gt_grid(self, Y):
        """((nx-1)(ny-1)(nz-1), m) <- G^T Y over interior nodes."""
        nx, ny, nz = self.nx, self.ny, self.nz
        hx, hy, hz = self.a / nx, self.b / ny, self.c / nz
        Yl = Y * self.mask[:, None]
        Ex, Ey, Ez = self._to_grids(Yl)
        acc = (Ex[:-1, 1:ny, 1:nz] - Ex[1:, 1:ny, 1:nz]) / hx
        acc = acc + (Ey[1:nx, :-1, 1:nz] - Ey[1:nx, 1:, 1:nz]) / hy
        acc = acc + (Ez[1:nx, 1:ny, :-1] - Ez[1:nx, 1:ny, 1:]) / hz
        return acc.reshape(-1, Y.shape[1])

    def project(self, X):
        Xm = X * (self.mask if X.ndim == 1 else self.mask[:, None])
        if self.proj is None:
            return Xm
        if self.fastproj is not None:
            vec = Xm.ndim == 1
            Xl = Xm[:, None] if vec else Xm
            rhs = self._gt_grid(self.M_mm(Xl))
            q = self.fastproj.solve(rhs)
            out = Xl - self._g_grid(q)
            return out[:, 0] if vec else out
        return self.proj.project(self.M_mm, Xm)

    # --- construction -----------------------------------------------------
    @staticmethod
    def build(
        a=1.0, b=1.0, c=1.0, nx=8, ny=8, nz=8,
        dtype=jnp.float32, block: int = 8,
        eps_r=None, mu_r=None, bc: str = "pec",
    ) -> "StencilPencil3D":
        import scipy.sparse as sp

        from maxwell_tpu.problems.cavity3d import hex_element_matrices

        from maxwell_tpu.sparse.bsr import ensure_x64_for

        ensure_x64_for(dtype)
        hx, hy, hz = a / nx, b / ny, c / nz
        Ke, Me = hex_element_matrices(hx, hy, hz)

        sx = nx * (ny + 1) * (nz + 1)
        sy = (nx + 1) * ny * (nz + 1)
        sz = (nx + 1) * (ny + 1) * nz
        n = sx + sy + sz
        n_padded = _round_up(n, block * max(128 // block, 1))

        # masks (PEC: tangential edges on walls removed)
        mask = np.zeros(n_padded, dtype=np.dtype(dtype))
        xi, xj, xk = np.meshgrid(
            np.arange(nx), np.arange(ny + 1), np.arange(nz + 1), indexing="ij"
        )
        mask[:sx] = (
            ((xj != 0) & (xj != ny) & (xk != 0) & (xk != nz))
            if bc == "pec"
            else np.ones_like(xj, bool)
        ).reshape(-1)
        yi, yj, yk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny), np.arange(nz + 1), indexing="ij"
        )
        mask[sx : sx + sy] = (
            ((yi != 0) & (yi != nx) & (yk != 0) & (yk != nz))
            if bc == "pec"
            else np.ones_like(yi, bool)
        ).reshape(-1)
        zi, zj, zk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), np.arange(nz), indexing="ij"
        )
        mask[sx + sy : n] = (
            ((zi != 0) & (zi != nx) & (zj != 0) & (zj != ny))
            if bc == "pec"
            else np.ones_like(zi, bool)
        ).reshape(-1)

        # discrete gradient (interior nodes), stencil layout, masked rows
        def node(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        rows, cols, vals = [], [], []
        eid_x = ((xi * (ny + 1) + xj) * (nz + 1) + xk).reshape(-1)
        for head, sgn in (
            (node(xi + 1, xj, xk), 1.0 / hx),
            (node(xi, xj, xk), -1.0 / hx),
        ):
            rows.append(eid_x)
            cols.append(head.reshape(-1))
            vals.append(np.full(eid_x.size, sgn))
        eid_y = sx + ((yi * ny + yj) * (nz + 1) + yk).reshape(-1)
        for head, sgn in (
            (node(yi, yj + 1, yk), 1.0 / hy),
            (node(yi, yj, yk), -1.0 / hy),
        ):
            rows.append(eid_y)
            cols.append(head.reshape(-1))
            vals.append(np.full(eid_y.size, sgn))
        eid_z = sx + sy + ((zi * (ny + 1) + zj) * nz + zk).reshape(-1)
        for head, sgn in (
            (node(zi, zj, zk + 1), 1.0 / hz),
            (node(zi, zj, zk), -1.0 / hz),
        ):
            rows.append(eid_z)
            cols.append(head.reshape(-1))
            vals.append(np.full(eid_z.size, sgn))

        n_nodes = (nx + 1) * (ny + 1) * (nz + 1)
        G_full = sp.coo_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(n, n_nodes),
        ).tocsr()
        G_full = sp.diags(mask[:n].astype(float)) @ G_full
        ni, nj, nk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1),
            indexing="ij",
        )
        ni, nj, nk = ni.reshape(-1), nj.reshape(-1), nk.reshape(-1)
        if bc == "pec":
            interior = (
                (ni > 0) & (ni < nx) & (nj > 0) & (nj < ny)
                & (nk > 0) & (nk < nz)
            )
        else:
            # natural BC: the gradient nullspace spans ALL nodal hats modulo
            # the constant — ground node 0 (matches stencil2d)
            interior = node(ni, nj, nk) != 0
        G = G_full[:, node(ni, nj, nk)[interior]]
        proj = GradientProjector.from_gradient(G.tocsr(), n_padded, dtype=dtype)

        fastproj = None
        if eps_r is None and bc == "pec":
            # the tensor-product fast solve assumes Dirichlet interior nodes
            from maxwell_tpu.solvers.fast_poisson import FastPoisson3D

            fastproj = FastPoisson3D.build(a, b, c, nx, ny, nz, dtype=dtype)
        # tap-stencil fast path: exact only when every unmasked row has all
        # adjacent cells valid (PEC) and coefficients are cell-independent
        # derive taps from the dtype-CAST element matrices so the tap and
        # panel paths agree at the production dtype (f32), not only at f64
        # (advisor finding, round 1)
        np_dt = np.dtype(jnp.zeros((), dtype).dtype)
        taps = (
            _derive_taps(np.asarray(Ke, np_dt), np.asarray(Me, np_dt))
            if (eps_r is None and mu_r is None and bc == "pec")
            else None
        )
        # loaded cavities / PMC keep a (field-coefficient) fast path too
        # (round-1 VERDICT item 9)
        ftaps_meta = ftaps_K = ftaps_M = None
        if taps is None:
            ones = np.ones((nx, ny, nz), np.float64)
            sK = (
                ones if mu_r is None
                else 1.0 / np.asarray(mu_r, np.float64)
            )
            sM = ones if eps_r is None else np.asarray(eps_r, np.float64)
            ftaps_meta, ftaps_K, ftaps_M = _derive_field_taps(
                Ke, Me, nx, ny, nz, sK, sM, dtype=np_dt,
            )
        return StencilPencil3D(
            mask=jnp.asarray(mask),
            Ke=jnp.asarray(Ke, dtype=dtype),
            Me=jnp.asarray(Me, dtype=dtype),
            proj=proj,
            a=a, b=b, c=c, nx=nx, ny=ny, nz=nz, n=n, n_padded=n_padded,
            inv_mu=None if mu_r is None else jnp.asarray(
                1.0 / np.asarray(mu_r), dtype=dtype
            ),
            eps=None if eps_r is None else jnp.asarray(eps_r, dtype=dtype),
            fastproj=fastproj,
            taps=taps,
            ftaps_meta=ftaps_meta, ftaps_K=ftaps_K, ftaps_M=ftaps_M,
            bc=bc,
        )
