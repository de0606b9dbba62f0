"""Blocked-ELL SpMM kernel for the GPU (Pallas through Triton), and the one
place where the operator apply is chosen (SURVEY.md §2 C4/C5).

Layout recap (maxwell_tpu/sparse/bsr.py): blocks (nbr, S, b, b), cols
(nbr, S) int32, padding slots point at block-column 0 with zero values.

The plain XLA apply (`bsr_matmat_ref`) first materialises the gathered
panel array X[cols] of shape (nbr, S, b, m) in device memory, then
contracts it. This kernel gathers each (b, m) panel of X straight into
registers instead, so device memory sees the matrix values, the column
indices, X (mostly served from L2) and Y once each.

One program owns P = TR*b output rows (TR block-rows). It loads its own
column indices (there is no scalar prefetch on the GPU), and for each slot
s and block column j accumulates  Y[p, :] += B[r(p), s, i(p), j] *
X[cols[r(p), s]*b + j, :]  as elementwise FMAs in the output dtype. No
tensor-core product is involved, so f32 stays f32 (no TF32) and f64 runs
natively. All refs are passed flat so the kernel computes its own offsets
in int32; masks cover a partial last tile and widths m that are not powers
of two.

The kernel loses to XLA on a single vector, which is what Lanczos and
every matvec send: at m=1 XLA's apply needs no gathered temporary (48^3
on an H100: 0.101 ms against the kernel's 0.186 ms in f32). From m=2 on
XLA materialises the gathered panels and the kernel wins by 5-7x (0.130
against 0.723 ms at m=2). So the GPU apply (`bsr_matmat_gpu`) picks per
call, from shapes known at trace time: the kernel from TRITON_MIN_WIDTH
columns up, XLA below it and wherever the kernel cannot take the
operands (`triton_unsupported`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from maxwell_tpu.sparse.bsr import BSRMatrix, bsr_matmat_ref

KERNELS = ("ref", "triton")
# narrowest X the GPU apply sends to the Triton kernel (see module doc)
TRITON_MIN_WIDTH = 2
_INT32_LIMIT = 2**31


def resolve_kernel(kernel: str = "auto", platform: str | None = None) -> str:
    """The operator apply for `kernel` on `platform` (default: the first
    JAX device's). "auto" is the GPU apply ("triton": the Triton kernel or
    XLA, per call, see `bsr_matmat_gpu`) on a GPU and the XLA reference
    elsewhere; "triton" anywhere but a GPU is an error (it has no CPU
    lowering; tests call the kernel in interpret mode directly)."""
    if platform is None:
        platform = jax.devices()[0].platform
    if kernel == "auto":
        return "triton" if platform == "gpu" else "ref"
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected auto|ref|triton")
    if kernel == "triton" and platform != "gpu":
        raise ValueError(f"kernel='triton' needs a GPU, not {platform!r}")
    return kernel


def matmat_fn(kernel: str):
    """Y = A @ X implementation for a resolved kernel name."""
    if kernel == "ref":
        return bsr_matmat_ref
    if kernel == "triton":
        return bsr_matmat_gpu
    raise ValueError(f"unresolved kernel {kernel!r}")


def triton_unsupported(A: BSRMatrix, x_rows: int, m: int) -> str | None:
    """Why the Triton kernel cannot compute A @ X for an (x_rows, m) X, or
    None if it can: it needs a power-of-two block, and its int32 flat
    offsets into the blocks, X and the tile-padded Y must stay below
    2^31."""
    b = A.b
    if b & (b - 1):
        return f"needs a power-of-two block, got {b}"
    TR = _tile_rows(b, pl.next_power_of_2(m)) // b
    y_rows = pl.cdiv(A.n_brows, TR) * TR * b
    largest = max(A.blocks.size, x_rows * m, y_rows * m)
    if largest >= _INT32_LIMIT:
        return f"a flat offset reaches {largest} >= 2^31 (int32 offsets)"
    return None


def choose_apply(A: BSRMatrix, X) -> str:
    """"triton" or "ref": the apply the GPU path uses for these shapes."""
    x_rows, m = X.shape
    if m < TRITON_MIN_WIDTH or triton_unsupported(A, x_rows, m):
        return "ref"
    return "triton"


def bsr_matmat_gpu(A: BSRMatrix, X: jax.Array) -> jax.Array:
    """Y = A @ X on the GPU: the Triton kernel or the XLA reference, as
    `choose_apply` says for these shapes."""
    if choose_apply(A, X) == "triton":
        return bsr_matmat_triton(A, X)
    return bsr_matmat_ref(A, X)


def _bsr_kernel(cols_ref, blocks_ref, x_ref, y_ref, *, nbr, TR, S, b, m, mp):
    P = TR * b
    i = pl.program_id(0)
    p = jnp.arange(P, dtype=jnp.int32)
    r = i * TR + p // b  # block row of each output row
    ii = p % b  # row inside the block
    col = jnp.arange(mp, dtype=jnp.int32)
    rmask = r < nbr if nbr % TR else None
    cmask = col < m if mp != m else None
    xmask = cmask[None, :] if cmask is not None else None
    masked = {} if xmask is None else {"mask": xmask, "other": 0}
    if rmask is not None:
        r = jnp.where(rmask, r, 0)
    dtype = y_ref.dtype

    def slot(s, acc):
        c = plgpu.load(cols_ref.at[r * S + s])
        base = (r * S + s) * (b * b) + ii * b
        for j in range(b):
            a = plgpu.load(blocks_ref.at[base + j]).astype(dtype)
            rows = c * b + j
            xg = plgpu.load(
                x_ref.at[rows[:, None] * m + col[None, :]], **masked
            ).astype(dtype)
            acc = acc + a[:, None] * xg
        return acc

    acc = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(S), slot, jnp.zeros((P, mp), dtype)
    )
    out = (i * P + p)[:, None] * m + col[None, :]
    mask = xmask
    if rmask is not None:
        mask = rmask[:, None] if mask is None else rmask[:, None] & mask
    plgpu.store(y_ref.at[out], acc, mask=mask)


def _tile_rows(b: int, mp: int) -> int:
    """Output rows per program: about 4k accumulator entries, so one
    program keeps its (P, mp) sum in the registers of 4 warps."""
    return min(max(4096 // mp, 64, b), 512)


@functools.partial(jax.jit, static_argnames=("interpret",))
def bsr_matmat_triton(
    A: BSRMatrix, X: jax.Array, interpret: bool = False
) -> jax.Array:
    """Y = A @ X through the Triton kernel. X: (x_rows, m) with x_rows >=
    A.n_padded (halo-extended local buffers index past A's own rows)."""
    nbr, S, b = A.n_brows, A.slots, A.b
    why = triton_unsupported(A, *X.shape)
    if why:
        raise ValueError(f"triton SpMM {why}")
    m = X.shape[1]
    mp = pl.next_power_of_2(m)
    P = _tile_rows(b, mp)
    TR = P // b
    dtype = jnp.result_type(A.blocks.dtype, X.dtype)
    kernel = functools.partial(
        _bsr_kernel, nbr=nbr, TR=TR, S=S, b=b, m=m, mp=mp
    )
    y = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(nbr, TR),),
        out_shape=jax.ShapeDtypeStruct((nbr * b * m,), dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="bsr_matmat_triton",
    )(A.cols.reshape(-1), A.blocks.reshape(-1), X.reshape(-1))
    return y.reshape(nbr * b, m)
