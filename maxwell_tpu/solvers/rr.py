"""Rayleigh-Ritz and block M-orthonormalization (SURVEY.md §2 C6/C13).

The reference does these with LAPACK (sygv-class and QR/Gram-Schmidt); here
the small dense eigenproblems run on-device via `jnp.linalg.eigh` and the
tall-skinny orthonormalization is CholQR/SVQB — Gram-matrix based, so the
only distributed primitive needed is a psum of a (m x m) Gram matrix, and the
n-dimensional work is tall-skinny matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def eigh_gen(A: jax.Array, B: jax.Array, eps: float = 1e-12):
    """Small dense generalized symmetric eigensolve A c = theta B c.

    B SPD (up to roundoff). Reduction via Cholesky: with B = L L^T,
    solve eigh(L^-1 A L^-T), then back-transform. Returns (theta, C) with
    C^T B C = I, theta ascending. Runs on-device inside jit.
    """
    m = A.shape[0]
    B = B + eps * jnp.trace(B) / m * jnp.eye(m, dtype=B.dtype)
    L = jnp.linalg.cholesky(B)
    Ainv = solve_triangular(L, A, lower=True)  # L^-1 A
    At = solve_triangular(L, Ainv.T, lower=True)  # L^-1 A^T L^-T  (= sym)
    At = 0.5 * (At + At.T)
    theta, V = jnp.linalg.eigh(At)
    C = solve_triangular(L.T, V, lower=False)  # L^-T V
    return theta, C


def svqb(S: jax.Array, MS: jax.Array, dot_mm=None, eps: float | None = None):
    """SVQB M-orthonormalization of a block S (n x m), given MS = M @ S.

    Returns (S_orth, MS_orth, rank_mask, T) with S_orth = S @ T; callers can
    rotate auxiliary blocks (e.g. KS) by the same T. Columns with Gram
    eigenvalue below eps * max are replaced by zeros (rank_mask = 0 there).
    More robust than CholQR in fp32 near convergence (SURVEY.md §7.5 hard
    part 4). dot_mm: (A, B) -> A^T B with global reduction under shard_map.
    """
    if dot_mm is None:
        dot_mm = lambda A, B: A.T @ B
    if eps is None:
        # rank cutoff just above the Gram-matrix noise floor of the dtype
        eps = 100.0 * float(jnp.finfo(S.dtype).eps)
    G = dot_mm(S, MS)
    G = 0.5 * (G + G.T)
    # mask dead columns (zero/negligible diagonal) at the scaling step with
    # a RELATIVE cutoff — an absolute floor like finfo.tiny overflows to
    # inf*0=NaN in 1/sqrt on backends that flush small constants to zero
    dg = jnp.diag(G)
    ok = dg > jnp.max(dg) * jnp.finfo(G.dtype).eps ** 2
    Dinv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, dg, 1.0)), 0.0)
    Gs = G * Dinv[:, None] * Dinv[None, :]
    theta, V = jnp.linalg.eigh(Gs)
    good = theta > eps * jnp.max(theta)
    inv_sqrt = jnp.where(good, 1.0 / jnp.sqrt(jnp.abs(theta)), 0.0)
    T = (Dinv[:, None] * V) * inv_sqrt[None, :]
    return S @ T, MS @ T, good, T


def cholqr(S: jax.Array, MS: jax.Array, dot_mm=None, eps: float = 1e-12):
    """Cholesky-QR M-orthonormalization: S <- S R^-1 with S^T M S = R^T R.

    One Gram + one triangular solve; cheaper than SVQB but less robust for
    ill-conditioned blocks. Returns (S_orth, MS_orth).
    """
    if dot_mm is None:
        dot_mm = lambda A, B: A.T @ B
    G = dot_mm(S, MS)
    G = 0.5 * (G + G.T)
    m = G.shape[0]
    G = G + eps * jnp.trace(G) / m * jnp.eye(m, dtype=G.dtype)
    R = jnp.linalg.cholesky(G).T  # upper
    Si = solve_triangular(R, S.T, lower=False, trans="T").T
    MSi = solve_triangular(R, MS.T, lower=False, trans="T").T
    return Si, MSi


def rayleigh_ritz(
    S: jax.Array, KS: jax.Array, MS: jax.Array, nev: int, dot_mm=None
):
    """Project K, M onto span(S) and solve the small generalized problem.

    Returns (theta[:nev], C[:, :nev]) — Ritz values ascending and primitive
    Ritz coefficient columns (S @ C are the Ritz vectors). SURVEY.md §3.3 RR.
    """
    if dot_mm is None:
        dot_mm = lambda A, B: A.T @ B
    A = dot_mm(S, KS)
    B = dot_mm(S, MS)
    A = 0.5 * (A + A.T)
    B = 0.5 * (B + B.T)
    theta, C = eigh_gen(A, B)
    return theta[:nev], C[:, :nev]
