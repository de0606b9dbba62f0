"""Distributed solver drivers: the SAME lobpcg_run / lanczos_factorization
loops, shard_mapped over a row mesh (SURVEY.md §2 C9/C11 "jit-ed shard_map
solver loop"; BASELINE.json configs 4 and 5).

The DistPencil supplies psum-ing reductions and ppermute halo exchange, so
no solver code changes — device count really is a mesh property
(SURVEY.md §7.4 rule 1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from maxwell_tpu.dist.partition import DistPencil
from maxwell_tpu.solvers.lanczos import (
    _direct_apply,
    _project_apply,
    lanczos_factorization,
    ritz_extract,
)
from maxwell_tpu.solvers.lobpcg import lobpcg_run
from maxwell_tpu.solvers.precond import _precond_apply
from maxwell_tpu.solvers.results import EigenResult


from maxwell_tpu.utils.precision import fp32_true

def _spectral_dist_apply(solver, pencil, R):
    return solver.solve(pencil, R)


def _run_local(
    pencil, X0, spectral, Qlock, maxiter, tol, nev, precond_alpha,
    precond_iters, checkpoint_every=0, checkpoint_path=None, prev_iters=0,
    stall_window=0, lock_tol=0.0,
):
    """Body executed per shard: project the start block, build the local
    preconditioner (exact distributed spectral solve when provided), run
    the shared LOBPCG loop. Qlock: optional shard-local rows of previously
    locked M-orthonormal eigenvectors — hard deflation at pod scale
    (SURVEY.md §2 C12; round-3 VERDICT item 4). M @ Qlock is recomputed
    locally (one sharded apply) rather than shipped."""
    X0 = pencil.project(X0)
    precond = None
    if spectral is not None:
        precond = jax.tree_util.Partial(
            _spectral_dist_apply, spectral, pencil
        )
    elif precond_alpha is not None:
        precond = jax.tree_util.Partial(
            _precond_apply, pencil, precond_alpha, precond_iters
        )
    MQlock = None if Qlock is None else pencil.M_mm(Qlock)
    return lobpcg_run(
        pencil, X0, maxiter, tol, precond, nev=nev,
        Qlock=Qlock, MQlock=MQlock,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        prev_iters=prev_iters, stall_window=stall_window,
        lock_tol=lock_tol,
    )


@fp32_true
def lobpcg_dist(
    dpencil: DistPencil,
    mesh,
    nev: int = 5,
    m: int | None = None,
    maxiter: int = 200,
    tol: float = 1e-8,
    key: jax.Array | None = None,
    precond_alpha: float | None = None,
    precond_iters: int = 20,
    checkpoint: str | None = None,
    checkpoint_every: int = 0,
    precond: str = "auto",
    deflate_Q: np.ndarray | None = None,
    batch: int | None = None,
    stall_window: int = 0,
    return_device: bool = False,
    lock: bool = True,
    stage_polish=None,
    X0=None,
) -> EigenResult:
    """Distributed LOBPCG over a 1-D row mesh. Returns a host EigenResult
    with gathered eigenvectors. checkpoint: resume/save the Ritz block
    (SURVEY.md §5.4) — the exit-time file stores vectors in the ORIGINAL
    problem ordering (portable across shard counts); checkpoint_every > 0
    additionally writes per-shard in-loop snapshots every k iterations
    (kill-mid-solve recovery, same shard count).

    precond: "auto" uses the EXACT distributed spectral (K + alpha M)^-1
    (solvers/spectral.DistSpectralShift — grid-independent iterations)
    when the pencil is a vacuum slab-sharded stencil pencil (alpha
    defaults to 15.0 when precond_alpha is None — round-3 advisor
    finding: alpha=None must not silently disable "auto"), else the
    shifted-CG sweeps (those need an explicit precond_alpha); "cg" forces
    the sweeps; "spectral" requires the spectral path.

    deflate_Q: (n, q) previously-converged eigenvectors in the ORIGINAL
    problem ordering — hard-deflated, the solve returns the next nev
    pairs above them (SURVEY.md §2 C12 at distributed scale).
    batch: if set, solve nev pairs INCREMENTALLY in stages of `batch`,
    hard-locking each stage's converged block before the next (the
    reference-class "deflated 20-eigenpair solve" workflow,
    BASELINE.json:11): later stages iterate a smaller active block, so
    per-iteration cost drops as pairs lock.
    return_device: keep the eigenvector block ON DEVICE — eigenvectors is
    the sharded (D*n_loc_pad, nev) jax.Array in the STACKED layout, the
    zero-transfer handoff format of X0 (round-4 VERDICT item 1). Ignored
    by the staged `batch` path.
    stage_polish: optional (EigenResult, Q) -> EigenResult hook applied
    to EACH stage's converged block before it joins the deflation basis
    (staged runs only); Q is the basis of the earlier stages (original
    ordering) or None. Deflation quality equals the basis block's
    residual, and an f32-floor stage (~1e-5) seeds duplicate eigenpairs
    that grow ~2x per iteration under the preconditioner — polishing
    each stage to tol (refine.refine_f64_dist) removes that failure
    mode (round 5).
    X0: warm-start block of k <= m columns (random columns fill the
    rest): a jax.Array is taken in the STACKED layout (as return_device
    gives it), a host array in the original ordering. A checkpoint that
    resumes takes precedence."""
    if batch is not None and batch < nev:
        return _lobpcg_dist_staged(
            dpencil, mesh, nev=nev, batch=batch, m=m, maxiter=maxiter,
            tol=tol, key=key, precond_alpha=precond_alpha,
            precond_iters=precond_iters, precond=precond,
            deflate_Q=deflate_Q, stall_window=stall_window,
            stage_polish=stage_polish,
        )
    if m is None:
        m = nev + max(4, nev // 2)
    if key is None:
        key = jax.random.PRNGKey(0)
    axis = dpencil.axis
    X_start, X0 = X0, None
    prev_iters = 0
    if checkpoint is not None:
        from maxwell_tpu.utils.checkpoint import (
            load_sharded_state,
            load_state,
        )

        state = load_state(checkpoint)
        if state is not None and state["X"].shape[1] == m:
            X0 = dpencil.inject_vectors(state["X"])
            prev_iters = state["iteration"]
        else:
            # fall back to in-loop per-shard snapshots (stacked layout)
            sstate = load_sharded_state(checkpoint, dpencil.D)
            if sstate is not None and sstate["X"].shape[1] == m:
                X0 = jnp.asarray(sstate["X"], dpencil.dtype)
                prev_iters = sstate["iteration"]
    if X0 is None and X_start is not None:
        if not isinstance(X_start, jax.Array):
            X_start = dpencil.inject_vectors(np.asarray(X_start))
        X0 = jnp.asarray(X_start, dpencil.dtype)
        if X0.ndim == 1:
            X0 = X0[:, None]
        if X0.shape[1] < m:
            X0 = jnp.concatenate(
                [X0, dpencil.make_block(key, m - X0.shape[1])], axis=1
            )
    if X0 is None:
        X0 = dpencil.make_block(key, m)

    spectral = None
    if precond != "cg":
        from maxwell_tpu.solvers.spectral import DistSpectralShift

        alpha_eff = 15.0 if precond_alpha is None else precond_alpha
        try:
            spectral = DistSpectralShift.build(dpencil, alpha_eff)
        except (ValueError, AttributeError):
            if precond == "spectral":
                raise

    Qfull = None
    if deflate_Q is not None:
        Qfull = dpencil.inject_vectors(
            np.asarray(deflate_Q, dpencil.dtype)
        )

    spec_specs = (
        None if spectral is None else spectral.partition_specs()
    )
    q_spec = None if Qfull is None else P(axis, None)
    solve_fn = _lobpcg_dist_mapped(
        mesh, dpencil.partition_specs(), spec_specs, q_spec, axis,
        maxiter, tol, nev, precond_alpha, precond_iters,
        checkpoint_every if checkpoint else 0, checkpoint,
        prev_iters, stall_window, tol * 1e-2 if lock else 0.0,
    )
    theta, X, res, it, hist = solve_fn(dpencil, X0, spectral, Qfull)

    if checkpoint is not None:
        from maxwell_tpu.utils.checkpoint import save_state

        save_state(
            checkpoint,
            X=dpencil.extract_vectors(np.asarray(X)),
            theta=np.asarray(theta),
            iteration=prev_iters + int(it),
        )

    theta = np.asarray(theta)[:nev]
    res = np.asarray(res)[:nev]
    history = [
        {"iter": prev_iters + i, "max_rel_res": float(h)}
        for i, h in enumerate(np.asarray(hist)[: int(it)])
    ]
    # slice to the wanted columns ON DEVICE before the host fetch — the
    # guard columns never need to leave the device (round 4)
    if return_device:
        vecs = X[:, :nev]
    else:
        vecs = dpencil.extract_vectors(np.asarray(X[:, :nev]))
    return EigenResult(
        eigenvalues=theta,
        eigenvectors=vecs,
        residuals=res,
        iterations=prev_iters + int(it),
        converged=bool(res.max() <= tol),
        history=history,
    )


@functools.lru_cache(maxsize=32)
def _lobpcg_dist_mapped(
    mesh, pspecs, spec_specs, q_spec, axis, maxiter, tol, nev,
    precond_alpha, precond_iters, checkpoint_every, checkpoint_path,
    prev_iters, stall_window, lock_tol=0.0,
):
    """Cached jitted sharded LOBPCG driver (stable function identity ->
    jit trace-cache HITS across calls). Building a fresh
    jax.jit(jax.shard_map(...)) closure per call forced a full retrace +
    compile-cache replay on EVERY invocation (round 5)."""
    run = functools.partial(
        _run_local,
        maxiter=maxiter,
        tol=tol,
        nev=nev,
        precond_alpha=precond_alpha,
        precond_iters=precond_iters,
        checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path,
        prev_iters=prev_iters,
        stall_window=stall_window,
        lock_tol=lock_tol,
    )
    mapped = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(pspecs, P(axis, None), spec_specs, q_spec),
        out_specs=(P(), P(axis, None), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def _lobpcg_dist_staged(
    dpencil, mesh, nev, batch, m, maxiter, tol, key, precond_alpha,
    precond_iters, precond, deflate_Q, stall_window=0, stage_polish=None,
):
    """Incremental deflated multi-eigenpair solve (SURVEY.md §3.3 "lock
    converged columns"; BASELINE.json:11 "deflated 20-eigenpair solve").

    Stage s solves the next `batch` pairs with every earlier stage's block
    hard-deflated (Qlock in lobpcg_run freezes them out of the active
    SpMM/RR entirely), so the active block is `batch + guards` wide instead
    of `nev + guards` — per-iteration SpMM/RR cost drops as pairs lock.
    Stages recompile (shapes shrink), a one-time cost amortized by the
    persistent compilation cache."""
    if key is None:
        key = jax.random.PRNGKey(0)
    Q = None if deflate_Q is None else np.asarray(deflate_Q)
    vals, vecs, resids, hist = [], [], [], []
    iters = 0
    done = 0
    stage = 0
    while done < nev:
        k = min(batch, nev - done)
        res = lobpcg_dist(
            dpencil, mesh, nev=k, m=None if m is None else min(m, k + 4),
            maxiter=maxiter, tol=tol, key=jax.random.fold_in(key, stage),
            precond_alpha=precond_alpha, precond_iters=precond_iters,
            precond=precond, deflate_Q=Q, stall_window=stall_window,
        )
        if stage_polish is not None:
            pol = stage_polish(res, Q)
            pol.history = list(res.history) + [
                dict(h, iter=res.iterations + h["iter"], phase="refine")
                for h in pol.history
            ]
            pol.iterations += res.iterations
            res = pol
        vals.append(res.eigenvalues)
        vecs.append(res.eigenvectors)
        resids.append(res.residuals)
        hist.extend(
            {**h, "iter": iters + h["iter"], "stage": stage}
            for h in res.history
        )
        iters += res.iterations
        Q = (
            res.eigenvectors
            if Q is None
            else np.concatenate([Q, res.eigenvectors], axis=1)
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
        history=hist,
    )


@fp32_true
def lanczos_dist(
    dpencil: DistPencil,
    mesh,
    nev: int = 5,
    maxiter: int = 100,
    tol: float = 1e-8,
    key: jax.Array | None = None,
) -> EigenResult:
    """Distributed direct-mode Lanczos: the SAME jit-ed factorization loop,
    shard_mapped over the row mesh (SURVEY.md §2 C9; config-1 math at
    config-4/5 scale)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    axis = dpencil.axis
    v0 = dpencil.make_block(key, 1)[:, 0]

    def body(p, v0_local):
        v0p = p.project(v0_local)
        apply_op = jax.tree_util.Partial(_direct_apply, p)
        post = jax.tree_util.Partial(_project_apply, p)
        return lanczos_factorization(apply_op, p, v0p, maxiter, post)

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(dpencil.partition_specs(), P(axis)),
        out_specs=(P(), P(), P(None, axis), P(None, axis)),
        check_vma=False,
    )
    alphas, betas, V, MV = jax.jit(mapped)(dpencil, v0)

    lams, Y_sel, keff = ritz_extract(
        np.asarray(alphas), np.asarray(betas), nev, tol, "direct"
    )
    Yd = jnp.asarray(Y_sel, dtype=dpencil.dtype)
    X = V[:keff].T @ Yd  # (n_pad_g, nev), fully addressable on host
    res = _dist_residuals(dpencil, mesh, X, lams)

    vecs = dpencil.extract_vectors(np.asarray(X))
    return EigenResult(
        eigenvalues=np.asarray(lams),
        eigenvectors=vecs,
        residuals=res,
        iterations=keff,
        converged=bool(np.all(res <= tol)),
    )


def _dist_residuals(dpencil, mesh, X, lams):
    """Relative eigen-residuals of gathered Ritz vectors via sharded SpMMs."""
    KX = spmm_dist(dpencil, mesh, X, which="K")
    MX = spmm_dist(dpencil, mesh, X, which="M")
    lam_d = jnp.asarray(lams, dtype=dpencil.dtype)
    R = KX - MX * lam_d[None, :]
    scale = jnp.linalg.norm(KX, axis=0) + jnp.abs(lam_d) * jnp.linalg.norm(
        MX, axis=0
    )
    return np.asarray(
        jnp.linalg.norm(R, axis=0) / jnp.maximum(scale, 1e-30)
    )


@fp32_true
def shift_invert_lanczos_dist(
    dpencil: DistPencil,
    mesh,
    sigma: float,
    nev: int = 5,
    maxiter: int = 60,
    tol: float = 1e-8,
    key: jax.Array | None = None,
    inner_tol: float = 1e-11,
    inner_iters: int = 400,
) -> EigenResult:
    """Distributed shift-invert Lanczos (config-3 math at config-4/5 scale;
    SURVEY.md §3.4, §2 C10/C14 — round-1 VERDICT item 6).

    The shift-invert apply is the matrix-free MINRES backend
    (solvers/shift_invert._si_apply_iterative): every inner MINRES step is a
    sharded K/M apply + psum dots, so the whole operator runs under the SAME
    shard_map as the Lanczos loop — no factorization, works on both
    DistPencil and DistStencilPencil3D."""
    from maxwell_tpu.solvers.shift_invert import _si_apply_iterative

    if key is None:
        key = jax.random.PRNGKey(0)
    axis = dpencil.axis
    v0 = dpencil.make_block(key, 1)[:, 0]

    def body(p, v0_local):
        v0p = p.project(v0_local)
        apply_op = jax.tree_util.Partial(
            _si_apply_iterative, p, sigma, inner_tol, inner_iters
        )
        post = jax.tree_util.Partial(_project_apply, p)
        return lanczos_factorization(apply_op, p, v0p, maxiter, post)

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(dpencil.partition_specs(), P(axis)),
        out_specs=(P(), P(), P(None, axis), P(None, axis)),
        check_vma=False,
    )
    alphas, betas, V, MV = jax.jit(mapped)(dpencil, v0)

    lams, Y_sel, keff = ritz_extract(
        np.asarray(alphas), np.asarray(betas), nev, tol, "shift_invert",
        sigma,
    )
    Yd = jnp.asarray(Y_sel, dtype=dpencil.dtype)
    X = V[:keff].T @ Yd
    res = _dist_residuals(dpencil, mesh, X, lams)

    vecs = dpencil.extract_vectors(np.asarray(X))
    return EigenResult(
        eigenvalues=np.asarray(lams),
        eigenvectors=vecs,
        residuals=res,
        iterations=keff,
        converged=bool(np.all(res <= tol)),
    )


@functools.lru_cache(maxsize=64)
def _spmm_mapped(mesh, specs, axis, which):
    """Cached jitted sharded SpMM (stable function identity -> one compile
    per (mesh, layout) instead of one per call)."""

    def body(p, Xl):
        return p.K_mm(Xl) if which == "K" else p.M_mm(Xl)

    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(specs, P(axis, None)),
            out_specs=P(axis, None),
            check_vma=False,
        )
    )


def spmm_dist(dpencil: DistPencil, mesh, X: jax.Array, which: str = "K"):
    """Sharded Y = K @ X (or M @ X): X global (n_pad, m)."""
    fn = _spmm_mapped(mesh, dpencil.partition_specs(), dpencil.axis, which)
    return fn(dpencil, X)
