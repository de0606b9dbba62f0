"""MINRES for symmetric (possibly indefinite) systems — the iterative
shift-invert backend (SURVEY.md §7.5 option (c)): K - sigma*M is symmetric
indefinite for sigma above the smallest eigenvalue, so CG is out; MINRES
minimizes the residual over the Krylov space with a three-term Lanczos
recurrence + Givens QR, all jit-able (`lax.while_loop`, no data-dependent
Python control flow).

For very large 3D problems where direct-factorization fill explodes, this
path keeps shift-invert matrix-free end to end (usable with the stencil
pencils, which never assemble a matrix at all).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def minres(
    A_mv: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    tol: float = 1e-10,
    maxiter: int = 200,
    dot: Callable | None = None,
) -> jax.Array:
    """Solve A x = b for symmetric A (single right-hand side).

    dot: inner product with global reduction under shard_map.
    """
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v)

    eps = float(jnp.finfo(b.dtype).eps)
    # tol may arrive as a traced scalar (Partial operand inside jit)
    tol_eff = jnp.maximum(tol, 16.0 * eps)

    beta1 = jnp.sqrt(jnp.maximum(dot(b, b), 0.0))
    safe_beta1 = jnp.where(beta1 > 0, beta1, 1.0)
    v = b / safe_beta1

    x = jnp.zeros_like(b)
    v_old = jnp.zeros_like(b)
    w = jnp.zeros_like(b)
    w_old = jnp.zeros_like(b)

    # Givens state: (c, s) current and previous
    state = dict(
        k=0,
        x=x,
        v=v,
        v_old=v_old,
        w=w,
        w_old=w_old,
        beta=beta1,
        eta=beta1,
        c1=jnp.asarray(1.0, b.dtype),
        c0=jnp.asarray(1.0, b.dtype),
        s1=jnp.asarray(0.0, b.dtype),
        s0=jnp.asarray(0.0, b.dtype),
        resid=beta1,
    )
    keys = list(state)

    def cond(s):
        return jnp.logical_and(
            s["k"] < maxiter, s["resid"] > tol_eff * beta1
        )

    def body(s):
        Av = A_mv(s["v"])
        alpha = dot(s["v"], Av)
        r = Av - alpha * s["v"] - s["beta"] * s["v_old"]
        beta_new = jnp.sqrt(jnp.maximum(dot(r, r), 0.0))
        safe_bn = jnp.where(beta_new > 0, beta_new, 1.0)
        v_new = r / safe_bn

        # apply previous rotations to the new tridiagonal column
        delta = s["c1"] * alpha - s["c0"] * s["s1"] * s["beta"]
        rho2 = s["s1"] * alpha + s["c0"] * s["c1"] * s["beta"]
        rho3 = s["s0"] * s["beta"]
        rho1 = jnp.sqrt(delta * delta + beta_new * beta_new)
        safe_r1 = jnp.where(rho1 > 0, rho1, 1.0)
        c_new = delta / safe_r1
        s_new = beta_new / safe_r1

        w_new = (s["v"] - rho3 * s["w_old"] - rho2 * s["w"]) / safe_r1
        x_new = s["x"] + c_new * s["eta"] * w_new
        eta_new = -s_new * s["eta"]

        return dict(
            k=s["k"] + 1,
            x=x_new,
            v=v_new,
            v_old=s["v"],
            w=w_new,
            w_old=s["w"],
            beta=beta_new,
            eta=eta_new,
            c1=c_new,
            c0=s["c1"],
            s1=s_new,
            s0=s["s1"],
            resid=jnp.abs(eta_new),
        )

    out = jax.lax.while_loop(cond, body, state)
    return out["x"]

