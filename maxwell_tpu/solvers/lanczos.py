"""Lanczos eigensolver for the generalized problem K x = lambda M x
(SURVEY.md §2 C9, §3.2; BASELINE.json configs 1 and 3).

Design (accelerator-first, SURVEY.md §7.4):
- The Krylov factorization is ONE jit-ed `lax.fori_loop` with a fixed
  iteration count and statically-shaped basis buffers; the operator apply,
  M-inner products, and full reorthogonalization (two-pass blocked
  Gram-Schmidt, tall matmuls) all live inside it.
- The operator is abstract: `apply_op(x)` must be M-self-adjoint. For the
  direct mode it is P M^-1 K (P = gradient-nullspace projector); for
  shift-invert (config 3) it is P (K - sigma M)^-1 M, supplied by
  maxwell_tpu.solvers.shift_invert.
- Only the tiny tridiagonal eigensolve runs on host (float64 — Lanczos fp32
  stability, SURVEY.md §7.5 hard part 4); Ritz vector assembly V @ Y and
  residuals go back on device.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

from maxwell_tpu.solvers.operator import Pencil
from maxwell_tpu.solvers.results import EigenResult


from maxwell_tpu.utils.precision import fp32_true

def _direct_apply(pencil: Pencil, x: jax.Array) -> jax.Array:
    """Operator for the direct generalized mode: P M^-1 K x."""
    return pencil.project(pencil.Minv_mm(pencil.K_mm(x)))


def _mass_apply(pencil: Pencil, x: jax.Array) -> jax.Array:
    return pencil.M_mm(x)


def _project_apply(pencil: Pencil, x: jax.Array) -> jax.Array:
    return pencil.project(x)


@partial(jax.jit, static_argnames=("maxiter",))
def lanczos_factorization(
    apply_op: Callable,
    pencil: Pencil,
    v0: jax.Array,
    maxiter: int,
    post: Callable | None = None,
):
    """Run `maxiter` Lanczos steps in the M-inner product.

    apply_op: `jax.tree_util.Partial` closure (pytree arg, so the operator's
    matrices are traced, not baked in as compile-time constants). The pencil
    supplies M applies and the cross-row reductions (psum-ing variants in the
    distributed pencil). Returns (alphas (k,), betas (k,), V (k+1, n),
    MV (k+1, n)). V rows are M-orthonormal; T = tridiag(betas[:-1], alphas)
    is the projected operator. Full two-pass reorthogonalization each step.
    """
    M_mm = pencil.M_mm
    dot = pencil.dot_vv
    n = v0.shape[0]
    k = maxiter

    Mv0 = M_mm(v0)
    beta0 = jnp.sqrt(dot(v0, Mv0))
    v = v0 / beta0
    Mv = Mv0 / beta0

    V = jnp.zeros((k + 1, n), v0.dtype).at[0].set(v)
    MV = jnp.zeros((k + 1, n), v0.dtype).at[0].set(Mv)
    alphas = jnp.zeros((k,), v0.dtype)
    betas = jnp.zeros((k,), v0.dtype)

    def body(j, state):
        V, MV, alphas, betas = state
        vj = V[j]
        w = apply_op(vj)
        alpha = dot(w, MV[j])
        alphas = alphas.at[j].set(alpha)

        # two-pass full reorthogonalization against all basis vectors so far
        # (mask columns > j); MV rows are zero there so masking is free.
        def reorth(w):
            # (k+1,) partial contraction over local rows; rows > j are zero
            coeffs = pencil.reduce_rows(MV @ pencil.weigh(w))
            return w - V.T @ coeffs

        w = reorth(reorth(w))
        if post is not None:
            # re-apply the nullspace projection: roundoff regenerates
            # gradient components that the operator then annihilates,
            # polluting the small end of the Ritz spectrum.
            w = post(w)

        Mw = M_mm(w)
        beta = jnp.sqrt(jnp.maximum(dot(w, Mw), 0.0))
        betas = betas.at[j].set(beta)
        safe = jnp.where(beta > 0, beta, 1.0)
        V = V.at[j + 1].set(w / safe)
        MV = MV.at[j + 1].set(Mw / safe)
        return V, MV, alphas, betas

    V, MV, alphas, betas = jax.lax.fori_loop(0, k, body, (V, MV, alphas, betas))
    return alphas, betas, V, MV


def ritz_extract(
    alphas: np.ndarray,
    betas: np.ndarray,
    nev: int,
    tol: float,
    mode: str,
    sigma: float = 0.0,
):
    """Host-side Ritz selection from the tridiagonal T (shared by the
    single-device and distributed drivers).

    Returns (lams (nev,), Y_selected (keff, nev), keff). Keeps only
    converged pairs (classic bound |beta_k y_k,i|); in direct mode drops
    the residual lambda~0 nullspace junk that roundoff re-introduces.
    """
    a = np.asarray(alphas, dtype=np.float64)
    b = np.asarray(betas, dtype=np.float64)
    maxiter = len(a)

    # effective Krylov size: stop at first (near-)breakdown
    keff = maxiter
    tiny = 1e-12 * max(np.abs(a).max(), 1.0)
    for j in range(maxiter - 1):
        if b[j] <= tiny:
            keff = j + 1
            break
    theta, Y = scipy.linalg.eigh_tridiagonal(a[:keff], b[: keff - 1])

    beta_last = b[keff - 1] if keff >= 1 else 0.0
    est = np.abs(beta_last * Y[-1, :])
    theta_max = max(np.abs(theta).max(), 1.0)
    conv = est <= np.maximum(1e3 * tol * np.abs(theta), 1e-12 * theta_max)

    if mode == "direct":
        keep = conv & (theta > 1e-10 * theta_max)
        idx = np.where(keep)[0]
        order = idx[np.argsort(theta[idx])][:nev]
        lams = theta[order]
    elif mode == "shift_invert":
        keep = conv & (np.abs(theta) > 1e-12 * theta_max)
        idx = np.where(keep)[0]
        order = idx[np.argsort(-np.abs(theta[idx]))][:nev]
        lams = sigma + 1.0 / theta[order]
        asc = np.argsort(lams)
        order, lams = order[asc], lams[asc]
    else:
        raise ValueError(mode)
    if len(order) < nev:
        # not enough CONVERGED pairs: fall back to the best unconverged
        # candidates (flagged via residuals/converged) — but keep the
        # nullspace/junk filter and the mode's ranking, and re-sort the
        # final set ascending like the converged path does.
        pool = np.where(
            (theta > 1e-10 * theta_max)
            if mode == "direct"
            else (np.abs(theta) > 1e-12 * theta_max)
        )[0]
        ranked = pool[
            np.argsort(theta[pool] if mode == "direct" else -np.abs(theta[pool]))
        ]
        rest = ranked[~np.isin(ranked, order)][: nev - len(order)]
        order = np.concatenate([order, rest]).astype(int)
        lams = (
            theta[order] if mode == "direct" else sigma + 1.0 / theta[order]
        )
        asc = np.argsort(lams)
        order, lams = order[asc], lams[asc]
    return lams, Y[:, order], keff


@fp32_true
def lanczos(
    pencil: Pencil,
    nev: int = 5,
    maxiter: int = 100,
    tol: float = 1e-8,
    key: jax.Array | None = None,
    mode: str = "direct",
    apply_op: Callable | None = None,
    sigma: float = 0.0,
) -> EigenResult:
    """Solve K x = lambda M x for the `nev` smallest (direct mode) or the
    `nev` closest-to-sigma (shift-invert mode) eigenpairs.

    mode="direct": operator P M^-1 K; eigenvalues are theta directly.
    mode="shift_invert": caller supplies apply_op = P (K-sigma M)^-1 M;
      eigenvalues are sigma + 1/theta, largest |theta| first (SURVEY.md §3.4).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    n_pad, n = pencil.n_padded, pencil.n

    v0 = jax.random.normal(key, (n_pad,), dtype=pencil.dtype)
    v0 = v0.at[n:].set(0.0)  # keep the zero-padding invariant
    v0 = pencil.project(v0)

    if apply_op is None:
        if mode != "direct":
            raise ValueError("supply apply_op for non-direct modes")
        apply_op = jax.tree_util.Partial(_direct_apply, pencil)

    post = (
        jax.tree_util.Partial(_project_apply, pencil)
        if pencil.proj is not None
        else None
    )
    alphas, betas, V, MV = lanczos_factorization(
        apply_op, pencil, v0, maxiter, post
    )
    lams, Y_sel, keff = ritz_extract(
        np.asarray(alphas), np.asarray(betas), nev, tol, mode, sigma
    )
    Yd = jnp.asarray(Y_sel, dtype=pencil.dtype)
    X = (V[:keff].T @ Yd)  # (n_pad, nev) Ritz vectors

    KX = pencil.K_mm(X)
    MX = pencil.M_mm(X)
    lam_d = jnp.asarray(lams, dtype=pencil.dtype)
    R = KX - MX * lam_d[None, :]
    scale = pencil.col_norms(KX) + jnp.abs(lam_d) * pencil.col_norms(MX)
    res = np.asarray(pencil.col_norms(R) / jnp.maximum(scale, 1e-30))

    return EigenResult(
        eigenvalues=np.asarray(lams),
        eigenvectors=np.asarray(X[:n]),
        residuals=res,
        iterations=keff,
        converged=bool(np.all(res <= tol)),
    )
