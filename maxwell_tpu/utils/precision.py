"""fp32-true matmul precision for the solver path (SURVEY.md §7.5 hard
part 4 — "Lanczos numerical stability at 1e-8").

On the GPU, JAX's DEFAULT matmul precision lets XLA run f32 products on
the tensor cores in TF32, which keeps about three decimal digits. Krylov
eigensolvers build Gram matrices, orthonormalize bases and rotate Ritz
blocks with those matmuls; at that precision LOBPCG stalls orders of
magnitude above the f32 floor instead of converging to 1e-6.

Every solver entry point therefore traces its jit-ed loop under
`jax.default_matmul_precision("highest")` (true f32 products). The
context is part of JAX's jit cache key, so wrapping the *call* is
sufficient: the compiled loop keeps the precision it was traced with.
Operator applies (BSR einsum, the Triton SpMM, stencil applies) set their
precision at the product site instead, so they are exact regardless of
the caller's context. f64 products are unaffected.
"""

from __future__ import annotations

import functools

import jax


def solver_precision():
    """Context manager: trace solver code fp32-true."""
    return jax.default_matmul_precision("highest")


def fp32_true(fn):
    """Decorator: run (and hence trace) `fn` under solver precision."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with solver_precision():
            return fn(*args, **kwargs)

    return wrapper
