"""LOBPCG block eigensolver for K x = lambda M x — the flagship solver
(SURVEY.md §2 C11, §3.3; BASELINE.json configs 2 and 5).

Accelerator-first design (SURVEY.md §7.4, §7.5):
- The whole iteration — SpMM, deflation, SVQB basis orthonormalization,
  3m x 3m Rayleigh-Ritz, convergence flags — is ONE jit-ed
  `lax.while_loop` with static shapes; host sync only at exit.
- Basis handling follows Duersch-Shao-Yang's robust LOBPCG: the search basis
  S = [X, W, P] is M-orthonormalized by SVQB (Gram matrix + small eigh —
  distributed-friendly: the only cross-device primitive is a psum of an
  (3m x 3m) Gram), after which Rayleigh-Ritz is an ORDINARY eigh of S^T K S.
  Rank-deficient basis columns (e.g. the empty P on iteration 0, or collapsed
  directions near convergence) are masked by SVQB and pushed to the top of
  the spectrum with a large diagonal shift so they never pollute the wanted
  smallest eigenvalues. This is more robust in fp32 than CholQR chains
  (SURVEY.md §7.5 hard part 4).
- The gradient nullspace (K's lambda=0 cluster) is removed by projecting the
  initial block and every new search direction with the pencil's
  GradientProjector (SURVEY.md §7.5 hard part 2).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from maxwell_tpu.solvers.operator import Pencil
from maxwell_tpu.solvers.results import EigenResult
from maxwell_tpu.solvers.rr import svqb



from maxwell_tpu.utils.precision import fp32_true

def _save_inloop(path, prev_iters, it, theta, X, shard=None):
    """Host callback: persist the CURRENT Ritz block from inside the
    compiled loop (SURVEY.md §5.4 "save every k iterations"; round-1
    VERDICT item 8 — a killed jit loop no longer loses everything).
    Distributed runs write one file per shard (suffix .shardN); the
    resume path reassembles them (utils/checkpoint.load_sharded_state)."""
    from maxwell_tpu.utils.checkpoint import save_state

    p = path if shard is None else f"{path}.shard{int(shard)}"
    save_state(
        p, X=X, theta=theta, iteration=int(prev_iters) + int(it) + 1
    )


def _emit_progress(it, res_max, theta0):
    import json as _json

    print(
        _json.dumps(
            {
                "iter": int(it),
                "max_rel_res": float(res_max),
                "theta_min": float(theta0),
            }
        ),
        flush=True,
    )


@partial(
    jax.jit,
    static_argnames=(
        "maxiter", "nev", "log_every", "checkpoint_every",
        "checkpoint_path", "stall_window", "lock_tol",
    ),
)
def lobpcg_run(
    pencil: Pencil,
    X0: jax.Array,
    maxiter: int,
    tol: float,
    precond=None,
    nev: int | None = None,
    Qlock: jax.Array | None = None,
    MQlock: jax.Array | None = None,
    log_every: int = 0,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    prev_iters: int = 0,
    stall_window: int = 0,
    lock_tol: float = 0.0,
):
    """Jit-ed LOBPCG loop. X0: (n_padded, m), already projected off the
    nullspace (zero-padding invariant holds). Convergence is tested on the
    first `nev` columns (default: all m).

    Qlock/MQlock: optional locked M-orthonormal eigenvectors (and M @ Qlock)
    to deflate against — hard deflation for incremental multi-eigenpair
    solves (SURVEY.md §2 C12, §3.3 "deflate(R, locked)").

    lock_tol > 0 enables IN-LOOP soft locking (SURVEY.md §3.3 "lock
    converged columns"; round-4 VERDICT item 8) with a STATIC-shape mask —
    no recompile: once a tracked column's residual reaches lock_tol it is
    frozen bit-exactly (X/KX/MX/theta pinned by jnp.where), its W and P
    contributions are zeroed so the search space stops spending directions
    on it, and it stays in the RR basis so active Ritz vectors remain
    M-orthogonal against it (classic soft locking). This stops converged
    columns from drifting at the f32 floor while the rest of the block
    catches up; the structural FLOP reduction from a NARROWER block is the
    staged `batch` path's job (hard locking + one recompile per stage).
    Returns (theta, X, res, iters, res_hist)."""
    n, m = X0.shape
    dtype = X0.dtype
    if nev is None:
        nev = m

    def K_mm(Z):
        return pencil.K_mm(Z)

    def M_mm(Z):
        return pencil.M_mm(Z)

    dot_mm = pencil.dot_mm

    def deflate(Z):
        if Qlock is None:
            return Z
        return Z - Qlock @ dot_mm(MQlock, Z)

    X0 = deflate(X0)

    # initial M-orthonormalization of X
    X, MX, _, _ = svqb(X0, M_mm(X0), dot_mm=dot_mm)
    KX = K_mm(X)
    theta = pencil.dot_cols(X, KX)  # Ritz values of orthonormal X

    P = jnp.zeros_like(X)
    KP = jnp.zeros_like(X)
    MP = jnp.zeros_like(X)

    res0 = jnp.full((m,), jnp.inf, dtype)
    hist = jnp.zeros((maxiter,), dtype)
    # best-iterate tracking for the f32 floor regime (see lobpcg doc):
    # (best max-residual, iters since meaningful improvement, best X,
    # best theta, best per-column residuals)
    best0 = (
        jnp.array(jnp.inf, dtype), jnp.array(0, jnp.int32),
        X, theta, res0,
    )

    def residuals(KX, MX, theta, X):
        R = KX - MX * theta[None, :]
        # one fused psum for all three norms (deterministic collective order)
        loc = jnp.stack(
            [
                jnp.sum(KX * pencil.weigh(KX), axis=0),
                jnp.sum(MX * pencil.weigh(MX), axis=0),
                jnp.sum(R * pencil.weigh(R), axis=0),
            ]
        )
        nKX, nMX, nR = jnp.sqrt(jnp.maximum(pencil.reduce_rows(loc), 0.0))
        scale = nKX + jnp.abs(theta) * nMX
        return R, nR / jnp.maximum(scale, 1e-30)

    def cond(state):
        it, X, KX, MX, theta, P, KP, MP, res, hist, best, locked = state
        go = jnp.logical_and(it < maxiter, jnp.max(res[:nev]) > tol)
        if stall_window > 0:
            go = jnp.logical_and(go, best[1] < stall_window)
        return go

    def body(state):
        it, X, KX, MX, theta, P, KP, MP, res, hist, best, locked = state

        R, _ = residuals(KX, MX, theta, X)
        W = precond(R) if precond is not None else R
        # remove locked/nullspace directions from the correction
        W = pencil.project(W)
        W = deflate(W)
        W = W - X @ dot_mm(MX, W)  # cheap X-deflation improves Gram conditioning
        if lock_tol > 0.0:
            # soft locking: no new search direction for frozen columns
            W = W * (~locked).astype(dtype)[None, :]

        KW, MW = pencil.KM_mm(W)

        S = jnp.concatenate([X, W, P], axis=1)  # (n, 3m)
        KS = jnp.concatenate([KX, KW, KP], axis=1)
        MS = jnp.concatenate([MX, MW, MP], axis=1)

        # M-orthonormalize the basis (dead columns masked out) and rotate
        # KS by the same transform — no extra SpMM needed.
        S, MS, good, T = svqb(S, MS, dot_mm=dot_mm)
        KS = KS @ T

        A = dot_mm(S, KS)
        A = 0.5 * (A + A.T)
        # push SVQB-masked (dead) columns above the wanted spectrum — the
        # shift must stay moderate relative to ||A|| or it destroys the
        # small eigenvalues in fp32 eigh (dtype-relative, not absolute).
        dead_shift = 10.0 * jnp.max(jnp.abs(jnp.diag(A))) + 1.0
        A = A + jnp.diag(jnp.where(good, 0.0, dead_shift).astype(dtype))
        thetaS, C = jnp.linalg.eigh(A)
        Cx = C[:, :m]  # smallest m Ritz pairs
        theta_new = thetaS[:m]

        X_new = S @ Cx
        KX_new = KS @ Cx
        MX_new = MS @ Cx

        # implicit P: drop the X-block rows of the Ritz rotation
        Cp = Cx.at[:m, :].set(0.0)
        P_new = S @ Cp
        KP_new = KS @ Cp
        MP_new = MS @ Cp

        if lock_tol > 0.0:
            # pin frozen columns bit-exactly (they remain IN the RR
            # basis above, so the active Ritz vectors come out
            # M-orthogonal against them — the pin only stops f32 drift
            # of an already-converged representative)
            lk = locked[None, :]
            X_new = jnp.where(lk, X, X_new)
            KX_new = jnp.where(lk, KX, KX_new)
            MX_new = jnp.where(lk, MX, MX_new)
            theta_new = jnp.where(locked, theta, theta_new)

        _, res_new = residuals(KX_new, MX_new, theta_new, X_new)
        if lock_tol > 0.0:
            ready = res_new <= lock_tol
            # CLUSTER-AWARE gate: within a degenerate cluster the RR
            # basis rotates freely between iterations, so pinning ONE
            # member while its siblings keep taking fresh Ritz vectors
            # destroys their mutual M-orthogonality (measured round 5:
            # the 6-fold 59.36 cluster of config5 collapsed to rank
            # deficiency). Locking a WHOLE cluster at once is sound: the
            # pinned set spans the same eigenspace RR would return, and
            # Ritz vectors of other eigenvalues are M-orthogonal to that
            # subspace regardless of the intra-cluster basis choice.
            th_scale = jnp.maximum(
                jnp.max(jnp.abs(theta_new)), 1e-30
            )
            close = (
                jnp.abs(theta_new[:, None] - theta_new[None, :])
                <= 1e-3 * th_scale
            )
            cluster_ok = jnp.logical_not(
                jnp.any(
                    jnp.logical_and(close, ~ready[:, None]), axis=0
                )
            )
            newly = jnp.logical_and(
                jnp.logical_and(ready, cluster_ok),
                jnp.arange(m) < nev,
            )
            if Qlock is not None:
                # a column drifting onto a hard-deflated eigenpair has a
                # genuinely SMALL eigen-residual (it IS an eigenvector —
                # deflation, not the residual, excludes it); locking it
                # would freeze the false state forever. Gate on the
                # M-overlap with the deflated block: true deflated-solve
                # pairs sit at roundoff (~1e-6), duplicates at O(1).
                defect = jnp.linalg.norm(
                    dot_mm(MQlock, X_new), axis=0
                )
                newly = jnp.logical_and(newly, defect <= 1e-3)
            locked = jnp.logical_or(locked, newly)
            act = (~locked).astype(dtype)[None, :]
            P_new = P_new * act
            KP_new = KP_new * act
            MP_new = MP_new * act
        # history tracks the CONVERGENCE-RELEVANT residual (first nev
        # columns) — guard vectors would otherwise dominate the max and
        # contradict the converged report
        hist = hist.at[it].set(jnp.max(res_new[:nev]))
        # best-iterate update: near the f32 residual floor the iterate
        # BOUNCES (measured: 1e-5 -> 6e-4 -> 1e-5 at 32^3); keep the best
        # block seen and count iterations without a >=10% improvement so
        # the stall cut-off (if enabled) fires at the floor
        cur = jnp.max(res_new[:nev])
        improved = cur < 0.9 * best[0]
        best = (
            jnp.where(improved, cur, best[0]),
            jnp.where(improved, 0, best[1] + 1).astype(jnp.int32),
            jnp.where(improved, X_new, best[2]),
            jnp.where(improved, theta_new, best[3]),
            jnp.where(improved, res_new, best[4]),
        )
        if log_every > 0:
            # live JSON-line progress from inside the compiled loop
            # (SURVEY.md §5.5); host callback fires every log_every iters
            jax.lax.cond(
                (it % log_every) == 0,
                lambda args: jax.debug.callback(_emit_progress, *args),
                lambda args: None,
                (it, jnp.max(res_new[:nev]), theta_new[0]),
            )
        if checkpoint_every > 0 and checkpoint_path is not None:
            # periodic in-loop save; distributed pencils (with an .axis
            # name) write per-shard files
            shard = (
                (jax.lax.axis_index(pencil.axis),)
                if getattr(pencil, "axis", None) is not None
                else ()
            )
            save_cb = partial(_save_inloop, checkpoint_path)
            jax.lax.cond(
                (it + 1) % checkpoint_every == 0,
                lambda args: jax.debug.callback(save_cb, *args),
                lambda args: None,
                (prev_iters, it, theta_new, X_new, *shard),
            )
        return (
            it + 1,
            X_new,
            KX_new,
            MX_new,
            theta_new,
            P_new,
            KP_new,
            MP_new,
            res_new,
            hist,
            best,
            locked,
        )

    locked0 = jnp.zeros((m,), bool)
    state = (0, X, KX, MX, theta, P, KP, MP, res0, hist, best0, locked0)
    (
        it, X, KX, MX, theta, P, KP, MP, res, hist, best, locked
    ) = jax.lax.while_loop(cond, body, state)
    # floor-bounce regime (stall_window > 0 opts in): return the BEST
    # iterate seen, not the last. Gated so plain callers get the final
    # iterate that matches in-loop checkpoints and iteration metadata
    # (round-3 advisor finding).
    if stall_window > 0:
        take_best = best[0] < jnp.max(res[:nev])
        theta = jnp.where(take_best, best[3], theta)
        X = jnp.where(take_best, best[2], X)
        res = jnp.where(take_best, best[4], res)
    return theta, X, res, it, hist


@fp32_true
def lobpcg(
    pencil: Pencil,
    nev: int = 5,
    m: int | None = None,
    maxiter: int = 200,
    tol: float = 1e-8,
    key: jax.Array | None = None,
    precond: Callable | None = None,
    X0: jax.Array | None = None,
    checkpoint: str | None = None,
    checkpoint_every: int = 0,
    deflate_Q: jax.Array | None = None,
    log_every: int = 0,
    stall_window: int = 0,
    batch: int | None = None,
    return_device: bool = False,
    lock: bool = True,
) -> EigenResult:
    """Solve for the `nev` smallest nonzero eigenpairs of K x = lambda M x.

    m: block size (default nev + max(4, nev//2) guard vectors). Convergence is
    tested on the first nev columns; the result keeps the first nev.
    checkpoint: optional state file — resumes X0 from it if present and
    saves the final Ritz block to it (SURVEY.md §5.4).
    deflate_Q: (n, q) previously-converged M-orthonormal eigenvectors to
    hard-deflate; the solve returns the next nev pairs ABOVE them (C12).
    stall_window: if > 0, stop once `stall_window` consecutive iterations
    pass without a >=10% improvement of the best residual, and return the
    BEST iterate seen. This is the f32-floor cut-off: at large grids the
    f32 apply roundoff floor (prop. to eps*||K||/lambda ~ eps/h^2) sits
    above any fixed tol, where the iterate bounces instead of converging
    (measured at 32^3/64^3); the caller then chains into f64 refinement.
    batch: if set (< nev), solve incrementally in stages of `batch` pairs,
    hard-locking each stage's block out of the next stage's active
    SpMM/RR (SURVEY.md §2 C12 "locking"): per-iteration cost drops as
    pairs lock, at the price of one recompile per stage (amortized by
    the persistent compilation cache).
    return_device: keep the eigenvector block ON DEVICE — eigenvectors is
    a (n_padded, nev) jax.Array in the pencil's padded layout, suitable
    for a zero-transfer handoff to refine_f64_pencil (round-4 VERDICT
    item 1).
    Ignored by the staged `batch` path (stages concatenate on host).
    lock: in-loop soft locking (on by default) — converged tracked
    columns are frozen bit-exactly inside the compiled loop while the
    rest of the block iterates (see lobpcg_run lock_tol). Output pairs
    are re-sorted ascending on exit (a pinned column can in principle be
    overtaken by a later-converging smaller eigenvalue).
    """
    if batch is not None and batch < nev:
        Q = deflate_Q
        vals, vecs, resids, histories = [], [], [], []
        iters = 0
        done = 0
        stage = 0
        if key is None:
            key = jax.random.PRNGKey(0)
        while done < nev:
            k = min(batch, nev - done)
            r = lobpcg(
                pencil, nev=k, m=None, maxiter=maxiter, tol=tol,
                key=jax.random.fold_in(key, stage), precond=precond,
                deflate_Q=Q, log_every=log_every,
                stall_window=stall_window,
            )
            vals.append(r.eigenvalues)
            vecs.append(r.eigenvectors)
            resids.append(r.residuals)
            histories.extend(
                {**h, "iter": iters + h["iter"], "stage": stage}
                for h in r.history
            )
            iters += r.iterations
            Qn = jnp.asarray(r.eigenvectors, pencil.dtype)
            Q = Qn if Q is None else jnp.concatenate(
                [jnp.asarray(Q, pencil.dtype), Qn], axis=1
            )
            done += k
            stage += 1
        lam = np.concatenate(vals)
        order = np.argsort(lam)
        return EigenResult(
            eigenvalues=lam[order],
            eigenvectors=np.concatenate(vecs, axis=1)[:, order],
            residuals=np.concatenate(resids)[order],
            iterations=iters,
            converged=bool(np.concatenate(resids).max() <= tol),
            history=histories,
        )
    if m is None:
        m = nev + max(4, nev // 2)
    if key is None:
        key = jax.random.PRNGKey(0)
    n_pad, n = pencil.n_padded, pencil.n
    dtype = pencil.dtype

    prev_iters = 0
    if X0 is None and checkpoint is not None:
        from maxwell_tpu.utils.checkpoint import load_state

        state = load_state(checkpoint)
        # accept both exit-time (n, m) and in-loop (n_pad, m) snapshots
        if state is not None and state["X"].shape in ((n, m), (n_pad, m)):
            Xs = jnp.asarray(state["X"], dtype)[:n]
            X0 = jnp.zeros((n_pad, m), dtype).at[:n].set(Xs)
            prev_iters = state["iteration"]
    if X0 is None:
        X0 = jax.random.normal(key, (n_pad, m), dtype=dtype)
        X0 = X0.at[n:].set(0.0)
    X0 = pencil.project(X0)

    if precond is not None and not isinstance(
        precond, jax.tree_util.Partial
    ):
        # wrap ONLY plain callables: jax.tree_util.Partial of an
        # already-Partial demotes the inner bound args (the pencil's
        # ARRAYS) to static aux — they then lower as HLO CONSTANTS
        # (measured: 4.83 GB of constants at 48^3, and the round-4
        # HTTP-413 remote-compile failures trace to the same wrap)
        precond = jax.tree_util.Partial(precond)

    Qlock = MQlock = None
    if deflate_Q is not None:
        q = deflate_Q.shape[1]
        Qlock = jnp.zeros((n_pad, q), dtype).at[:n].set(
            jnp.asarray(deflate_Q, dtype)
        )
        MQlock = pencil.M_mm(Qlock)

    theta, X, res, it, hist = lobpcg_run(
        pencil, X0, maxiter, tol, precond, nev=nev,
        Qlock=Qlock, MQlock=MQlock, log_every=log_every,
        checkpoint_every=checkpoint_every if checkpoint else 0,
        checkpoint_path=checkpoint, prev_iters=prev_iters,
        stall_window=stall_window, lock_tol=tol * 1e-2 if lock else 0.0,
    )
    # ascending order of the tracked pairs (no-op without locking; with
    # locking a frozen column can be overtaken by a smaller late pair)
    order = np.argsort(np.asarray(theta)[:nev])
    if not np.all(order == np.arange(nev)):
        order_d = jnp.asarray(order)
        theta = theta.at[:nev].set(theta[order_d])
        X = X.at[:, :nev].set(X[:, order_d])
        res = res.at[:nev].set(res[order_d])

    if checkpoint is not None:
        from maxwell_tpu.utils.checkpoint import save_state

        save_state(
            checkpoint,
            X=np.asarray(X[:n]),
            theta=np.asarray(theta),
            iteration=prev_iters + int(it),
        )

    theta = np.asarray(theta)[:nev]
    history = [
        {"iter": prev_iters + i, "max_rel_res": float(h)}
        for i, h in enumerate(np.asarray(hist)[: int(it)])
    ]
    vecs = X[:, :nev] if return_device else np.asarray(X[:n, :nev])
    return EigenResult(
        eigenvalues=theta,
        eigenvectors=vecs,
        residuals=np.asarray(res)[:nev],
        iterations=prev_iters + int(it),
        converged=bool(np.asarray(res)[:nev].max() <= tol),
        history=history,
    )
