"""Block-row partitioner and the distributed pencil (SURVEY.md §2 C8/C14/C15;
§3.5 distributed SpMV).

Host side (`partition_problem`): split the blocked-ELL matrices into D
contiguous block-row shards, compute the uniform halo depth H (max off-shard
block-row distance referenced by any shard — Epetra-style import lists,
precomputed as DATA, SURVEY.md §7.4 rule 4), and REMAP each shard's column
indices into its local buffer layout

    [ own rows (L) | left halo (H) | right halo (H) | zero slot (1) ]

so the device-side SpMM is identical to the single-chip kernel, just fed a
halo-extended X buffer.

Device side (`DistPencil`, used INSIDE shard_map): halo exchange is two
`ppermute`s (neighbor-sparse — the context-parallel analog, SURVEY.md §5.7);
all reductions are `psum` over the row axis (SURVEY.md §2 C7). The nodal
vectors of the gradient projector are REPLICATED: gather is local, scatter
finishes with a psum (correct for any D; node-sharding is a later
optimization).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from maxwell_tpu.kernels.spmm import matmat_fn, resolve_kernel
from maxwell_tpu.sparse.bsr import BSRMatrix
from maxwell_tpu.solvers.cg import cg
from maxwell_tpu.solvers.deflation import GradientProjector


def _after(x, dep):
    """Schedule-order fence: return x, not computable before dep.

    Collectives that are INDEPENDENT in the dataflow graph may execute in
    different orders on different devices; XLA:CPU's cross-module rendezvous
    keys collide when that happens (deadlock in the simulated mesh). Chaining
    every pair of otherwise-independent collectives through this barrier
    keeps all devices in one deterministic collective order. On the GPU
    the barrier only fixes an order XLA would otherwise choose itself.
    """
    x, _ = jax.lax.optimization_barrier((x, dep))
    return x


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DistPencil:
    """Row-sharded pencil. Array leaves are GLOBAL (stacked over shards)
    outside shard_map and LOCAL inside it; methods are written for the local
    view. aux fields are static and identical on every shard."""

    K_blocks: jax.Array  # INTERIOR part: (D*L, Si, b, b) / local (L, Si, b, b)
    K_cols: jax.Array  # (D*L, Si) int32 in [0, L] (L = zero slot)
    K_blocks_bnd: jax.Array  # BOUNDARY part: (D*L, Sb, b, b)
    K_cols_bnd: jax.Array  # (D*L, Sb) int32 into the halo-extended layout
    M_blocks: jax.Array
    M_cols: jax.Array
    M_blocks_bnd: jax.Array
    M_cols_bnd: jax.Array
    head: jax.Array  # (D*L*b,) int32 global node ids (ghost = n_nodes)
    tail: jax.Array
    weight: jax.Array  # (D*L*b,)
    D: int
    L: int  # block rows per shard
    H: int  # halo depth in block rows (each side)
    b: int
    n_nodes: int
    n: int  # global logical dimension
    axis: str = "rows"
    kernel: str = "ref"
    mass_tol: float = 1e-12
    mass_iters: int = 300
    proj_tol: float = 1e-10
    proj_iters: int = 150
    # link classes of the 1-D halo topology (round-3 VERDICT item 8):
    # positions p where the (p, p+1) neighbor link crosses hosts ("dcn").
    # The halo schedule issues those permutes FIRST so their larger
    # latency hides under both the intra-host permutes and the interior
    # SpMM.
    # Derived from dist.mesh.mesh_topology_report (or injected
    # synthetically in tests).
    dcn_links: tuple = ()

    _CHILD_FIELDS = (
        "K_blocks", "K_cols", "K_blocks_bnd", "K_cols_bnd",
        "M_blocks", "M_cols", "M_blocks_bnd", "M_cols_bnd",
        "head", "tail", "weight",
    )
    _AUX_FIELDS = (
        "D", "L", "H", "b", "n_nodes", "n", "axis", "kernel",
        "mass_tol", "mass_iters", "proj_tol", "proj_iters", "dcn_links",
    )

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._CHILD_FIELDS)
        aux = tuple(getattr(self, f) for f in self._AUX_FIELDS)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        kw = dict(zip(cls._CHILD_FIELDS, children))
        kw.update(zip(cls._AUX_FIELDS, aux))
        return cls(**kw)

    # --- shard_map plumbing ----------------------------------------------
    def partition_specs(self):
        """PartitionSpec pytree matching tree_flatten children (row-sharded
        leading axis everywhere; absent (None) leaves stay None)."""
        from jax.sharding import PartitionSpec as P

        row = P(self.axis)
        children, aux = self.tree_flatten()
        specs = tuple(None if c is None else row for c in children)
        return self.tree_unflatten(aux, specs)

    # --- host-side driver support -----------------------------------------
    @property
    def global_rows(self) -> int:
        return self.D * self.L * self.b

    def make_block(self, key, m: int):
        """Random start block in the stacked global layout (host side)."""
        X0 = jax.random.normal(key, (self.global_rows, m), dtype=self.dtype)
        return X0.at[self.n :].set(0.0)

    def extract_vectors(self, X_stacked: np.ndarray) -> np.ndarray:
        """Stacked global solution rows -> original problem ordering."""
        vecs = np.asarray(X_stacked)[: self.n]
        perm = getattr(self, "perm", None)
        if perm is not None:
            from maxwell_tpu.sparse.reorder import unpermute_rows

            vecs = unpermute_rows(vecs, perm)
        return vecs

    def inject_vectors(self, X_orig: np.ndarray):
        """Inverse of extract_vectors: original ordering -> stacked rows
        (for checkpoint resume)."""
        X = np.asarray(X_orig)
        perm = getattr(self, "perm", None)
        if perm is not None:
            X = X[perm]
        out = np.zeros((self.global_rows,) + X.shape[1:], X.dtype)
        out[: self.n] = X
        return jnp.asarray(out, dtype=self.dtype)

    # --- local shapes (inside shard_map) ----------------------------------
    @property
    def n_local(self) -> int:
        return self.L * self.b

    # Pencil-protocol aliases so solver loops can treat Dist/single pencils
    # uniformly (the solver only sees local row counts under shard_map).
    @property
    def n_padded(self) -> int:
        return self.n_local

    @property
    def dtype(self):
        return self.K_blocks.dtype

    # --- reductions --------------------------------------------------------
    def weigh(self, x):
        return x  # block-row sharding has no replicated rows

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

    # --- halo exchange (SURVEY.md §3.5) ------------------------------------
    def exchange_halos(self, X: jax.Array) -> jax.Array:
        """X (n_local, m) -> halo-extended buffer ((L+2H+1)*b, m).

        Two neighbor ppermutes; devices at the chain ends receive zeros
        (banded matrices never reference past the ends)."""
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        Hb = self.H * self.b
        Lb = self.L * self.b
        m = Xl.shape[1]
        zero = jnp.zeros((self.b, m), Xl.dtype)
        if Hb == 0:
            out = jnp.concatenate([Xl, zero], axis=0)
        elif self.H <= self.L:
            if self.dcn_links:
                # host-aware schedule (round-3 VERDICT item 8): links that
                # cross hosts get their permutes issued FIRST, so the slow
                # transfers overlap both the intra-host permutes and the
                # interior SpMM (_local_mm has no dataflow dependence on
                # any of these). Disjoint target sets -> merging by
                # addition is exact (non-targets receive zeros).
                dcn = set(self.dcn_links)
                rp_d = [(d, d + 1) for d in range(self.D - 1) if d in dcn]
                lp_d = [(d + 1, d) for d in range(self.D - 1) if d in dcn]
                rp_i = [(d, d + 1) for d in range(self.D - 1) if d not in dcn]
                lp_i = [(d + 1, d) for d in range(self.D - 1) if d not in dcn]
                left_d = jax.lax.ppermute(Xl[-Hb:], self.axis, rp_d)
                right_d = jax.lax.ppermute(
                    _after(Xl[:Hb], left_d), self.axis, lp_d
                )
                left_i = jax.lax.ppermute(
                    _after(Xl[-Hb:], right_d), self.axis, rp_i
                )
                right_i = jax.lax.ppermute(
                    _after(Xl[:Hb], left_i), self.axis, lp_i
                )
                out = jnp.concatenate(
                    [Xl, left_d + left_i, right_d + right_i, zero], axis=0
                )
            else:
                # fast path: halos reach only the adjacent shard
                right_perm = [(d, d + 1) for d in range(self.D - 1)]
                left_perm = [(d + 1, d) for d in range(self.D - 1)]
                # left halo = previous shard's LAST H block rows
                left = jax.lax.ppermute(Xl[-Hb:], self.axis, right_perm)
                # right halo = next shard's FIRST H block rows (fenced after
                # the left permute — see _after)
                right = jax.lax.ppermute(
                    _after(Xl[:Hb], left), self.axis, left_perm
                )
                out = jnp.concatenate([Xl, left, right, zero], axis=0)
        else:
            # deep-halo fallback (halo spans multiple shards, e.g. tiny
            # test problems): all_gather the vector and slice the window.
            # Real problems should be RCM-reordered so H <= L.
            Xg = jax.lax.all_gather(Xl, self.axis, tiled=True, axis=0)
            Xp = jnp.pad(Xg, ((Hb, Hb), (0, 0)))
            d = jax.lax.axis_index(self.axis)
            start = (d * Lb).astype(jnp.int32)
            win = jax.lax.dynamic_slice(
                Xp, (start, jnp.int32(0)), (Lb + 2 * Hb, m)
            )  # = global rows [lo-H, hi+H) with zero fill at the ends
            left = win[:Hb]
            right = win[Hb + Lb :]
            out = jnp.concatenate([Xl, left, right, zero], axis=0)
        return out[:, 0] if vec else out

    def exchange_halos_reference(self, X: jax.Array) -> jax.Array:
        """Oracle halo exchange via all_gather + window slice — the
        "checksum mode" of SURVEY.md §5.2: XLA programs are deterministic,
        so the remaining race surface is the halo path itself; asserting
        fast-path == gather-path is the moral equivalent of a sanitizer."""
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        Hb = self.H * self.b
        Lb = self.L * self.b
        m = Xl.shape[1]
        zero = jnp.zeros((self.b, m), Xl.dtype)
        Xg = jax.lax.all_gather(Xl, self.axis, tiled=True, axis=0)
        Xp = jnp.pad(Xg, ((Hb, Hb), (0, 0)))
        d = jax.lax.axis_index(self.axis)
        start = (d * Lb).astype(jnp.int32)
        win = jax.lax.dynamic_slice(Xp, (start, jnp.int32(0)), (Lb + 2 * Hb, m))
        out = jnp.concatenate([Xl, win[:Hb], win[Hb + Lb :], zero], axis=0)
        return out[:, 0] if vec else out

    def halo_checksum(self, X: jax.Array) -> jax.Array:
        """Max |fast halo path - gather oracle| (replicated scalar)."""
        a = self.exchange_halos(X)
        b = self.exchange_halos_reference(_after(X, a))
        return jax.lax.pmax(jnp.max(jnp.abs(a - b)), self.axis)

    # --- operator applies --------------------------------------------------
    def _mm(self, blocks, cols, X):
        A = BSRMatrix(blocks=blocks, cols=cols, n=self.n_local)
        return matmat_fn(self.kernel)(A, X)

    def _local_mm(self, blocks_int, cols_int, blocks_bnd, cols_bnd, X):
        """Overlapped apply (SURVEY.md §3.5): the interior product reads only
        own rows (+ a zero slot) — no dataflow dependence on the halo
        permutes — so XLA's scheduler can run the exchange concurrently;
        the boundary product lands on the halo-extended buffer afterwards."""
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        zero = jnp.zeros((self.b, Xl.shape[1]), Xl.dtype)
        Xz = jnp.concatenate([Xl, zero], axis=0)
        Y = self._mm(blocks_int, cols_int, Xz)
        Xf = self.exchange_halos(Xl)
        Y = Y + self._mm(blocks_bnd, cols_bnd, Xf)
        return Y[:, 0] if vec else Y

    def K_mm(self, X):
        return self._local_mm(
            self.K_blocks, self.K_cols, self.K_blocks_bnd, self.K_cols_bnd, X
        )

    def M_mm(self, X):
        return self._local_mm(
            self.M_blocks, self.M_cols, self.M_blocks_bnd, self.M_cols_bnd, X
        )

    def KM_mm(self, X):
        """(K @ X, M @ X) with the two halo exchanges deterministically
        ordered (see _after)."""
        KX = self.K_mm(X)
        MX = self.M_mm(_after(X, KX))
        return KX, MX

    def Minv_mm(self, X):
        return cg(
            self.M_mm,
            X,
            tol=self.mass_tol,
            maxiter=self.mass_iters,
            dot=self.dot_cols,
        )

    # --- gradient projector (replicated node vectors) ----------------------
    def _g_mm(self, phi):
        """(n_local, m) <- G phi for replicated phi (n_nodes, m)."""
        w = self.weight if phi.ndim == 1 else self.weight[:, None]
        zero = jnp.zeros((1,) + phi.shape[1:], phi.dtype)
        phi_ext = jnp.concatenate([phi, zero], axis=0)
        return w * (phi_ext[self.head] - phi_ext[self.tail])

    def _gt_mm(self, y):
        """(n_nodes, m) <- G^T y, replicated (psum-finished scatter)."""
        w = self.weight if y.ndim == 1 else self.weight[:, None]
        wy = w * y
        shape = (self.n_nodes + 1,) + y.shape[1:]
        out = jnp.zeros(shape, y.dtype)
        out = out.at[self.head].add(wy)
        out = out.at[self.tail].add(-wy)
        return jax.lax.psum(out[:-1], self.axis)

    def project(self, X):
        vec = X.ndim == 1
        Xl = X[:, None] if vec else X
        L_mm = lambda phi: self._gt_mm(self.M_mm(self._g_mm(phi)))
        rhs = self._gt_mm(self.M_mm(Xl))
        # node vectors are replicated -> plain local dots inside CG
        q = cg(L_mm, rhs, tol=self.proj_tol, maxiter=self.proj_iters)
        out = Xl - self._g_mm(q)
        return out[:, 0] if vec else out


def partition_problem(
    problem,
    n_shards: int,
    block: int | None = None,
    kernel: str = "auto",
    dtype=jnp.float32,
    axis: str = "rows",
    reorder: bool = True,
    mesh=None,
    dcn_links: tuple | None = None,
) -> DistPencil:
    """Host-side partitioner: problem (RectCavity2D / BrickCavity3D) -> row
    -sharded DistPencil with remapped local column indices.

    reorder=True applies RCM so halos are shallow (SURVEY.md §2 C15); the
    permutation is stored on the returned pencil as `.perm` (host-side
    attribute, not part of the pytree) for eigenvector un-permutation.

    mesh / dcn_links: link classes for the DCN-aware halo schedule —
    pass the Mesh the pencil will run on (DCN positions derived via
    mesh_topology_report), or inject positions directly (tests).
    """
    if dcn_links is None and mesh is not None:
        from maxwell_tpu.dist.mesh import mesh_topology_report

        dcn_links = tuple(
            p for p in mesh_topology_report(mesh, axis)[
                "dcn_link_positions"
            ] if p < n_shards - 1
        )
    dcn_links = tuple(dcn_links or ())
    kernel = resolve_kernel(kernel)
    block = block or 4  # layout study, round-1 log
    perm = None
    if reorder:
        from maxwell_tpu.sparse.reorder import PermutedProblem

        problem = PermutedProblem(problem)
        perm = problem.perm
    row_tile = max(128 // block, 1)
    K = BSRMatrix.from_csr(
        problem.K, block=block, dtype=dtype, row_align=n_shards * row_tile
    )
    M = BSRMatrix.from_csr(
        problem.M, block=block, dtype=dtype, row_align=n_shards * row_tile
    )
    if K.n_brows != M.n_brows or K.slots != M.slots:
        # unify slot counts so both use one halo layout
        S = max(K.slots, M.slots)

        def widen(A):
            pad = S - A.slots
            if pad == 0:
                return A
            blocks = jnp.pad(A.blocks, ((0, 0), (0, pad), (0, 0), (0, 0)))
            cols = jnp.pad(A.cols, ((0, 0), (0, pad)))
            return BSRMatrix(blocks=blocks, cols=cols, n=A.n)

        K, M = widen(K), widen(M)

    D, b = n_shards, block
    nbr = K.n_brows
    L = nbr // D

    K_cols_np = np.asarray(K.cols)
    M_cols_np = np.asarray(M.cols)
    K_blocks_np = np.asarray(K.blocks)
    M_blocks_np = np.asarray(M.blocks)

    # halo depth: max distance of any REAL (nonzero) block from its shard
    H = 0
    nz_K = np.abs(K_blocks_np).max(axis=(2, 3)) > 0  # (nbr, S)
    nz_M = np.abs(M_blocks_np).max(axis=(2, 3)) > 0
    for d in range(D):
        lo, hi = d * L, (d + 1) * L
        for cols_np, nz in ((K_cols_np, nz_K), (M_cols_np, nz_M)):
            cs = cols_np[lo:hi][nz[lo:hi]]
            if cs.size:
                H = max(H, int(max(lo - cs.min(), cs.max() - (hi - 1))))
    H = max(H, 0)

    # remap columns to the local layout per shard
    def remap(cols_np, nz):
        out = np.full_like(cols_np, L + 2 * H)  # default: zero slot
        for d in range(D):
            lo, hi = d * L, (d + 1) * L
            c = cols_np[lo:hi]
            m_ = nz[lo:hi]
            local = np.full_like(c, L + 2 * H)
            own = (c >= lo) & (c < hi)
            local[own & m_] = (c - lo)[own & m_]
            lft = (c >= lo - H) & (c < lo)
            local[lft & m_] = (L + (c - (lo - H)))[lft & m_]
            rgt = (c >= hi) & (c < hi + H)
            local[rgt & m_] = (L + H + (c - hi))[rgt & m_]
            bad = m_ & ~(own | lft | rgt)
            if bad.any():
                raise AssertionError("halo depth miscomputed")
            out[lo:hi] = local
        return out

    K_cols_local = remap(K_cols_np, nz_K)
    M_cols_local = remap(M_cols_np, nz_M)

    # split interior (own-row cols -> overlappable with the halo exchange)
    # from boundary (halo cols) — SURVEY.md §3.5 comm/compute overlap
    def split_int_bnd(blocks_np, cols_local, nz):
        nrows = cols_local.shape[0]
        int_mask = (cols_local < L) & nz
        bnd_mask = (cols_local >= L) & (cols_local < L + 2 * H) & nz

        def pack(mask, pad_col):
            counts = mask.sum(axis=1)
            Sm = max(int(counts.max()) if nrows else 1, 1)
            bi = np.zeros((nrows, Sm, b, b), dtype=blocks_np.dtype)
            ci = np.full((nrows, Sm), pad_col, dtype=np.int32)
            r_idx, s_idx = np.nonzero(mask)
            first = np.zeros(nrows + 1, dtype=np.int64)
            np.cumsum(counts, out=first[1:])
            pos = np.arange(len(r_idx)) - first[r_idx]
            ci[r_idx, pos] = cols_local[r_idx, s_idx]
            bi[r_idx, pos] = blocks_np[r_idx, s_idx]
            return bi, ci

        # interior zero slot = L (the Xz layout [own | zero]);
        # boundary zero slot = L + 2H (the halo-extended layout)
        bi, ci = pack(int_mask, L)
        bb, cb = pack(bnd_mask, L + 2 * H)
        return bi, ci, bb, cb

    K_bi, K_ci, K_bb, K_cb = split_int_bnd(K_blocks_np, K_cols_local, nz_K)
    M_bi, M_ci, M_bb, M_cb = split_int_bnd(M_blocks_np, M_cols_local, nz_M)

    # per-edge projector data, sharded by row: global ids padded to nbr*b
    proj = GradientProjector.from_gradient(problem.G, nbr * b, dtype=dtype)
    n = problem.K.shape[0]
    n_nodes = proj.n_nodes
    head = np.full(nbr * b, n_nodes, dtype=np.int32)
    tail = np.full(nbr * b, n_nodes, dtype=np.int32)
    weight = np.zeros(nbr * b, dtype=np.dtype(dtype))
    head[:n] = np.asarray(proj.head)
    tail[:n] = np.asarray(proj.tail)
    weight[:n] = np.asarray(proj.weight)

    dp = DistPencil(
        K_blocks=jnp.asarray(K_bi, dtype=dtype),
        K_cols=jnp.asarray(K_ci),
        K_blocks_bnd=jnp.asarray(K_bb, dtype=dtype),
        K_cols_bnd=jnp.asarray(K_cb),
        M_blocks=jnp.asarray(M_bi, dtype=dtype),
        M_cols=jnp.asarray(M_ci),
        M_blocks_bnd=jnp.asarray(M_bb, dtype=dtype),
        M_cols_bnd=jnp.asarray(M_cb),
        head=jnp.asarray(head),
        tail=jnp.asarray(tail),
        weight=jnp.asarray(weight),
        D=D,
        L=L,
        H=H,
        b=b,
        n_nodes=n_nodes,
        n=n,
        axis=axis,
        kernel=kernel,
        dcn_links=dcn_links,
    )
    # host-side metadata (survives on this instance only, not through pytree
    # transforms — used by drivers to un-permute returned eigenvectors)
    object.__setattr__(dp, "perm", perm)
    return dp
