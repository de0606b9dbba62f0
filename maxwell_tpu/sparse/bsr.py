"""Tiled BSR ("blocked-ELL") sparse matrix storage in device memory.

Replacement for the reference's Epetra-style CSR (SURVEY.md §2 C3;
BASELINE.json: "Epetra-style CSR -> tiled BSR in HBM"). Design rationale
(SURVEY.md §7.4):

- Dense b x b blocks turn SpMV/SpMM into streams of small dense products
  with one column index per block instead of one per entry.
- Each block-row stores a FIXED number S of blocks (ELL padding, "pad don't
  branch"): values have static shape (n_brows, S, b, b) and block-column
  indices (n_brows, S) int32. Padding entries point at block-column 0 with
  all-zero values, so no masking is needed on the compute path.
- The per-block-row contraction is y_r = sum_s B[r,s] @ X[cols[r,s]].

The logical dimension n is zero-padded up to n_brows*b. Padded rows/cols are
all-zero in the values, so vectors whose padding entries are zero stay
zero-padded under matvec and linear combinations — solvers rely on this
invariant instead of masking (see maxwell_tpu/solvers/).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


def ensure_x64_for(dtype) -> None:
    """Enable jax x64 when a 64-bit dtype is requested — otherwise
    jnp.asarray silently truncates to f32 and 'f64' workflows run in f32
    (review finding, round 1)."""
    if np.dtype(dtype).itemsize == 8:
        import jax

        jax.config.update("jax_enable_x64", True)  # idempotent


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Blocked-ELL sparse matrix.

    Attributes:
      blocks: (n_brows, S, b, b) float array — dense blocks, zero-padded.
      cols:   (n_brows, S) int32 — block-column index per slot (0 for padding).
      n:      logical square dimension (rows = cols = n).
    """

    blocks: jax.Array
    cols: jax.Array
    n: int

    # --- pytree plumbing -------------------------------------------------
    def tree_flatten(self):
        return (self.blocks, self.cols), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        blocks, cols = children
        return cls(blocks=blocks, cols=cols, n=aux[0])

    # --- derived shapes --------------------------------------------------
    @property
    def b(self) -> int:
        return self.blocks.shape[-1]

    @property
    def n_brows(self) -> int:
        return self.blocks.shape[0]

    @property
    def slots(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_padded(self) -> int:
        return self.n_brows * self.b

    @property
    def nnz_dense(self) -> int:
        """Stored (dense-block) entry count — the bandwidth-relevant nnz."""
        return self.blocks.size

    # --- construction ----------------------------------------------------
    @staticmethod
    def from_csr(
        A: sp.spmatrix,
        block: int = 8,
        align_slots: int | None = None,
        dtype=jnp.float32,
        row_align: int | None = None,
    ) -> "BSRMatrix":
        """Convert a scipy sparse matrix to blocked-ELL.

        align_slots: round the slot count S up to this multiple (default:
        chosen so S*b is a multiple of 128).
        row_align: round the block-row count up to this multiple (default:
        128 scalar rows; pass n_shards * that so the matrix splits evenly
        into shards — SURVEY.md §2 C15).
        """
        ensure_x64_for(dtype)
        A = sp.csr_matrix(A)
        n = A.shape[0]
        if A.shape[0] != A.shape[1]:
            raise ValueError("square matrices only")
        b = block
        if row_align is None:
            row_align = max(128 // b, 1)
        n_pad = _round_up(max(n, 1), b)
        n_brows = _round_up(n_pad // b, row_align)
        n_pad = n_brows * b
        if align_slots is None:
            align_slots = max(128 // b, 1)

        A_pad = sp.csr_matrix((A.data, A.indices, A.indptr), shape=(n, n))
        A_pad.resize((n_pad, n_pad))

        # fast path: native C++ converter (maxwell_tpu/native)
        try:
            from maxwell_tpu import native

            have_native = native.HAVE_NATIVE
        except Exception:
            have_native = False
        if have_native:
            # exact blocks/row via a 1-D integer-key unique (fast; the
            # 2-column np.unique(axis=0) variant is an order of magnitude
            # slower on large nnz)
            brow = np.repeat(
                np.arange(n_pad, dtype=np.int64) // b, np.diff(A_pad.indptr)
            )
            key = brow * np.int64(n_brows + 1) + (
                A_pad.indices.astype(np.int64) // b
            )
            uniq = np.unique(key)
            per_row = (
                np.bincount(
                    (uniq // np.int64(n_brows + 1)).astype(np.int64),
                    minlength=n_brows,
                )
                if uniq.size
                else np.zeros(n_brows, dtype=np.int64)
            )
            S = max(
                _round_up(max(int(per_row.max()) if len(per_row) else 1, 1), align_slots),
                align_slots,
            )
            blocks, cols, _ = native.bell_from_csr(
                A_pad.indptr, A_pad.indices, A_pad.data, n_pad, b, S
            )
            return BSRMatrix(
                blocks=jnp.asarray(blocks, dtype=dtype),
                cols=jnp.asarray(cols),
                n=n,
            )

        # fallback: scipy BSR + python packing
        Ab = A_pad.tobsr(blocksize=(b, b))
        Ab.sort_indices()
        indptr, indices, data = Ab.indptr, Ab.indices, Ab.data

        per_row = np.diff(indptr)
        S = int(per_row.max()) if per_row.size else 1
        S = max(_round_up(max(S, 1), align_slots), align_slots)

        blocks = np.zeros((n_brows, S, b, b), dtype=np.dtype(dtype))
        cols = np.zeros((n_brows, S), dtype=np.int32)
        for r in range(n_brows):
            lo, hi = indptr[r], indptr[r + 1]
            k = hi - lo
            blocks[r, :k] = data[lo:hi]
            cols[r, :k] = indices[lo:hi]
        return BSRMatrix(
            blocks=jnp.asarray(blocks, dtype=dtype),
            cols=jnp.asarray(cols),
            n=n,
        )

    def to_csr(self) -> sp.csr_matrix:
        """Round-trip back to scipy CSR (testing)."""
        b, S, nbr = self.b, self.slots, self.n_brows
        blocks = np.asarray(self.blocks)
        cols = np.asarray(self.cols)
        indptr = np.arange(nbr + 1) * S
        A = sp.bsr_matrix(
            (blocks.reshape(-1, b, b), cols.ravel(), indptr),
            shape=(self.n_padded, self.n_padded),
        ).tocsr()
        A.eliminate_zeros()
        return A[: self.n, : self.n].tocsr()

    # --- vector packing ---------------------------------------------------
    def pad_vec(self, x: jax.Array) -> jax.Array:
        """Zero-pad a logical (n,) or (n, m) array to n_padded rows."""
        pad = self.n_padded - self.n
        if pad == 0:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    def unpad_vec(self, x: jax.Array) -> jax.Array:
        return x[: self.n]


# ---------------------------------------------------------------------------
# Reference (pure-jnp) SpMV / SpMM. The kernel in maxwell_tpu/kernels/spmm.py
# is a drop-in replacement validated against these.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=())
def bsr_matmat_ref(A: BSRMatrix, X: jax.Array) -> jax.Array:
    """Y = A @ X for X of shape (n_padded, m). Pure-jnp blocked-ELL product.

    Gathers X block-rows per slot (materialising an (nbr, S, b, m) array)
    then contracts with one einsum.
    """
    b = A.b
    # X may be TALLER than A's row space (halo-extended local buffers in the
    # distributed pencil); cols index into X's block rows.
    Xb = X.reshape(-1, b, X.shape[-1])  # (x_brows, b, m)
    Xg = Xb[A.cols]  # (nbr, S, b, m)
    # accumulate at (at least) input precision; HIGHEST keeps f32 out of TF32
    acc = jnp.result_type(A.blocks.dtype, X.dtype)
    Y = jnp.einsum(
        "rsij,rsjm->rim", A.blocks, Xg,
        preferred_element_type=acc, precision=jax.lax.Precision.HIGHEST,
    )
    return Y.reshape(A.n_padded, -1)


def bsr_matvec_ref(A: BSRMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x for x of shape (n_padded,)."""
    return bsr_matmat_ref(A, x[:, None])[:, 0]
