"""Level-scheduled sparse triangular solve on device (SURVEY.md §2 C10,
§7.5 hard part 1).

Forward/backward substitution has sequential row dependencies — hostile to
wide SIMD hardware. The classic parallel formulation is LEVEL SCHEDULING:
rows are grouped into dependency levels (row i's level = 1 + max level of the
columns it references), and all rows within one level solve in parallel.

The factor is stored per-level in ELL form (rows, padded col ids, padded
values), built once on host from a scipy CSR factor. The device solve is a
static Python loop over levels inside jit — each level is a batched
gather + reduction + scatter that XLA fuses. Matches the reference
capability "sparse factorization + triangular solves" with a
device-native execution strategy (BASELINE.json config 3).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """One triangular factor, level-scheduled with UNIFORM level padding.

    Levels are padded to a common (Rmax, Smax) so the device solve is a
    single `lax.fori_loop` over a stacked (n_levels, Rmax, Smax) tensor —
    one compiled loop body regardless of level count (compile time O(1) in
    n_levels; the padding waste is elementwise throughput, which is cheap).

    rows: (nL, Rmax) int32 — rows solved per level; padding = n (ghost row).
    cols: (nL, Rmax, Smax) int32 — dependency columns; padding = n.
    vals: (nL, Rmax, Smax) — off-diagonal values (padding = 0).
    diag: (n,) — diagonal entries (ones for unit-lower factors).
    """

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    diag: jax.Array
    n: int
    lower: bool

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals, self.diag), (self.n, self.lower)

    @classmethod
    def tree_unflatten(cls, aux, children):
        rows, cols, vals, diag = children
        return cls(rows=rows, cols=cols, vals=vals, diag=diag, n=aux[0], lower=aux[1])

    @property
    def n_levels(self):
        return self.rows.shape[0]

    @staticmethod
    def from_csr(T: sp.spmatrix, lower: bool) -> "LevelSchedule":
        """Build the level schedule from a triangular scipy matrix.

        Level computation runs in the native C++ extension when available
        (maxwell_tpu/native); packing is vectorized numpy.
        """
        T = sp.csr_matrix(T)
        T.sort_indices()
        n = T.shape[0]
        indptr, indices, data = T.indptr, T.indices, T.data

        diag = np.ones(n, dtype=T.dtype)
        dvals = T.diagonal()
        diag[dvals != 0] = dvals[dvals != 0]

        # dependency levels
        level = None
        try:
            from maxwell_tpu import native

            if native.HAVE_NATIVE:
                level, _ = native.level_schedule_levels(
                    indptr, indices, n, lower
                )
        except Exception:
            level = None
        if level is None:
            level = np.zeros(n, dtype=np.int64)
            order = range(n) if lower else range(n - 1, -1, -1)
            for i in order:
                cs = indices[indptr[i] : indptr[i + 1]]
                cs = cs[cs < i] if lower else cs[cs > i]
                level[i] = 1 + max((level[c] for c in cs), default=-1)

        # off-diagonal entries, grouped per row (vectorized packing)
        nnz = len(indices)
        entry_row = np.repeat(np.arange(n), np.diff(indptr))
        off = indices < entry_row if lower else indices > entry_row
        e_row = entry_row[off]
        e_col = indices[off].astype(np.int32)
        e_val = data[off]
        row_nnz = np.bincount(e_row, minlength=n)
        # position of each entry within its row
        row_first = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(row_nnz, out=row_first[1:])
        e_pos = np.arange(len(e_row)) - row_first[e_row]

        n_levels = int(level.max()) + 1 if n else 0
        lvl_count = np.bincount(level, minlength=max(n_levels, 1))
        Rmax = int(lvl_count.max()) if n else 1
        Smax = max(int(row_nnz.max()) if n else 0, 1)

        # row's position within its level: stable argsort by level
        order_rows = np.argsort(level, kind="stable")
        pos_in_level = np.empty(n, dtype=np.int64)
        lvl_start = np.zeros(n_levels + 1, dtype=np.int64)
        np.cumsum(lvl_count, out=lvl_start[1:])
        pos_in_level[order_rows] = np.arange(n) - lvl_start[level[order_rows]]

        rows_a = np.full((n_levels, Rmax), n, dtype=np.int32)
        cols_a = np.full((n_levels, Rmax, Smax), n, dtype=np.int32)
        vals_a = np.zeros((n_levels, Rmax, Smax), dtype=T.dtype)
        rows_a[level, pos_in_level] = np.arange(n, dtype=np.int32)
        cols_a[level[e_row], pos_in_level[e_row], e_pos] = e_col
        vals_a[level[e_row], pos_in_level[e_row], e_pos] = e_val
        return LevelSchedule(
            rows=jnp.asarray(rows_a),
            cols=jnp.asarray(cols_a),
            vals=jnp.asarray(vals_a),
            diag=jnp.asarray(diag),
            n=n,
            lower=lower,
        )

    def solve(self, b: jax.Array) -> jax.Array:
        """x = T^-1 b, (n,) or (n, m). One fori_loop over levels."""
        vec = b.ndim == 1
        B = b[:, None] if vec else b
        m = B.shape[1]
        # ghost row n: reads 0, absorbs padded writes
        Xe = jnp.zeros((self.n + 1, m), B.dtype)
        Be = jnp.concatenate([B, jnp.zeros((1, m), B.dtype)], axis=0)
        dinv = jnp.concatenate(
            [1.0 / self.diag, jnp.ones((1,), self.diag.dtype)]
        )[:, None]

        def body(l, Xe):
            rws = self.rows[l]  # (Rmax,)
            cls_ = self.cols[l]  # (Rmax, Smax)
            vls = self.vals[l]
            acc = jnp.einsum("rs,rsm->rm", vls, Xe[cls_])
            upd = (Be[rws] - acc) * dinv[rws]
            return Xe.at[rws].set(upd)

        Xe = jax.lax.fori_loop(0, self.n_levels, body, Xe)
        X = Xe[: self.n]
        return X[:, 0] if vec else X


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SparseLUDevice:
    """Device-resident sparse LU: x = Pc (U^-1 (L^-1 (Pr b))).

    Built from scipy splu (host numeric factorization, SURVEY.md §7.5:
    "host factorization + device level-scheduled solve").
    """

    L: LevelSchedule
    U: LevelSchedule
    perm_r: jax.Array  # row permutation (apply to b)
    perm_c: jax.Array  # column permutation (apply to x)
    n: int

    def tree_flatten(self):
        return (self.L, self.U, self.perm_r, self.perm_c), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        L, U, perm_r, perm_c = children
        return cls(L=L, U=U, perm_r=perm_r, perm_c=perm_c, n=aux[0])

    @staticmethod
    def from_splu(lu) -> "SparseLUDevice":
        """lu: scipy.sparse.linalg.SuperLU object (from splu)."""
        n = lu.shape[0]
        # scipy: Pr A Pc = L U with (Pr b)[perm_r[i]] = b[i] — equivalently
        # y = b[inv_perm_r]; and x = z[perm_c-inverse]: x[perm_c[i]] = z[i].
        inv_perm_r = np.empty(n, dtype=np.int32)
        inv_perm_r[lu.perm_r] = np.arange(n, dtype=np.int32)
        return SparseLUDevice(
            L=LevelSchedule.from_csr(lu.L.tocsr(), lower=True),
            U=LevelSchedule.from_csr(lu.U.tocsr(), lower=False),
            perm_r=jnp.asarray(inv_perm_r),
            perm_c=jnp.asarray(lu.perm_c.astype(np.int32)),
            n=n,
        )

    def solve(self, b: jax.Array) -> jax.Array:
        vec = b.ndim == 1
        B = b[:, None] if vec else b
        Bp = B[self.perm_r]  # perm_r holds the INVERSE row permutation
        Y = self.L.solve(Bp)
        Z = self.U.solve(Y)
        X = Z[self.perm_c]  # verified vs scipy: x = z[perm_c]
        return X[:, 0] if vec else X


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SparseLDLTDevice:
    """Device-resident sparse LDL^T: x = P^T (L^-T (D^-1 (L^-1 (P b)))).

    Factored by the native C++ up-looking LDL^T (maxwell_tpu/native) after a
    fill-reducing symmetric permutation; solves are level-scheduled on
    device (SURVEY.md §2 C10 — the fully in-house factorization path;
    SparseLUDevice/splu is the scipy-backed alternative).
    """

    L: LevelSchedule  # unit lower
    Lt: LevelSchedule  # its transpose (unit upper)
    dinv: jax.Array
    perm: jax.Array  # x_perm[i] = x_orig[perm[i]]
    iperm: jax.Array
    n: int

    def tree_flatten(self):
        return (self.L, self.Lt, self.dinv, self.perm, self.iperm), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        L, Lt, dinv, perm, iperm = children
        return cls(L=L, Lt=Lt, dinv=dinv, perm=perm, iperm=iperm, n=aux[0])

    @staticmethod
    def factor(A: sp.spmatrix, perm: np.ndarray | None = None) -> "SparseLDLTDevice":
        """Factor symmetric A (any triangle storage; full matrix expected)."""
        from maxwell_tpu import native

        if not native.HAVE_NATIVE:
            raise RuntimeError("native extension unavailable")
        A = sp.csr_matrix(A)
        n = A.shape[0]
        if perm is None:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = np.asarray(
                reverse_cuthill_mckee(A, symmetric_mode=True)
            )
        Ap = A[perm][:, perm].tocsc()
        Lp, Li, Lx, D = native.ldlt_factor(sp.triu(Ap).tocsc())
        L = sp.csc_matrix((Lx, Li, Lp), shape=(n, n)).tocsr()
        iperm = np.empty(n, dtype=np.int32)
        iperm[perm] = np.arange(n, dtype=np.int32)
        return SparseLDLTDevice(
            L=LevelSchedule.from_csr(L, lower=True),
            Lt=LevelSchedule.from_csr(L.T.tocsr(), lower=False),
            dinv=jnp.asarray(1.0 / D),
            perm=jnp.asarray(perm.astype(np.int32)),
            iperm=jnp.asarray(iperm),
            n=n,
        )

    def solve(self, b: jax.Array) -> jax.Array:
        vec = b.ndim == 1
        B = b[:, None] if vec else b
        Bp = B[self.perm]
        Y = self.L.solve(Bp)
        Z = Y * self.dinv[:, None]
        W = self.Lt.solve(Z)
        X = W[self.iperm]
        return X[:, 0] if vec else X
