"""Top-level convenience API: solve a cavity eigenproblem in one call with
sensible defaults (SURVEY.md §2 C17 — the library-facing driver).

    import maxwell_tpu
    res = maxwell_tpu.solve(RectCavity2D(nx=64, ny=64), nev=10)
"""

from __future__ import annotations

import jax.numpy as jnp

from maxwell_tpu.utils.precision import fp32_true


@fp32_true
def solve(
    problem,
    nev: int = 5,
    tol: float = 1e-8,
    solver: str = "lobpcg",
    sigma: float | None = None,
    maxiter: int | None = None,
    dtype=jnp.float64,
    block: int | None = None,
    kernel: str = "auto",
    distributed: bool = False,
    n_shards: int | None = None,
    refine: bool | str = "auto",
    **kwargs,
):
    """Solve K x = lambda M x for `problem` (RectCavity2D / BrickCavity3D /
    PermutedProblem).

    solver: "lobpcg" (default; preconditioned, alpha auto-tuned from the
    analytic oracle when available), "lanczos", or "shift_invert" (needs
    sigma). kernel: "auto" (default; kernels.spmm.resolve_kernel), "ref"
    or "triton".
    distributed=True shards over all visible devices (or n_shards).

    refine: mixed-precision polish (solvers/refine.py). "auto" (default)
    kicks in when dtype is f32 and tol is below the fp32 floor (1e-6):
    the device solves to 1e-5, then f64 Rayleigh-quotient-shifted
    inverse-iteration sweeps on the host reach tol (SURVEY.md §6). With
    dtype=f64 (the default) the device solves to tol in native f64.
    """
    import jax

    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)

    want_refine = refine is True or (
        refine == "auto" and dtype == jnp.float32 and tol < 1e-6
    )
    device_tol = max(tol, 1e-5) if want_refine else tol

    # auto preconditioner shift: the scale of the smallest wanted mode
    alpha = kwargs.pop("precond_alpha", None)
    if alpha is None:
        try:
            alpha = float(problem.analytic_eigenvalues(1)[0])
        except Exception:
            alpha = 1.0

    if distributed:
        from maxwell_tpu.dist import make_mesh, partition_problem
        from maxwell_tpu.solvers.dist_solve import lobpcg_dist

        if solver != "lobpcg":
            raise ValueError("distributed convenience path is LOBPCG-only")
        D = n_shards or len(jax.devices())
        dp = partition_problem(
            problem, D, block=block, kernel=kernel, dtype=dtype
        )
        mesh = make_mesh(D)
        res = lobpcg_dist(
            dp, mesh, nev=nev, maxiter=maxiter or 200, tol=device_tol,
            precond_alpha=alpha, **kwargs,
        )
        return _maybe_refine(problem, res, tol, want_refine)

    from maxwell_tpu.solvers.operator import Pencil

    pencil = Pencil.from_problem(
        problem, block=block, kernel=kernel, dtype=dtype
    )
    if solver == "lobpcg":
        from maxwell_tpu.solvers import lobpcg
        from maxwell_tpu.solvers.precond import shifted_cg_preconditioner

        pc = shifted_cg_preconditioner(pencil, alpha=alpha, iters=20)
        res = lobpcg(
            pencil, nev=nev, maxiter=maxiter or 200, tol=device_tol,
            precond=pc, **kwargs,
        )
        return _maybe_refine(problem, res, tol, want_refine)
    if solver == "lanczos":
        from maxwell_tpu.solvers import lanczos

        res = lanczos(
            pencil, nev=nev, maxiter=maxiter or 300, tol=device_tol, **kwargs
        )
        return _maybe_refine(problem, res, tol, want_refine)
    if solver == "shift_invert":
        if sigma is None:
            raise ValueError("shift_invert needs sigma")
        from maxwell_tpu.solvers.shift_invert import shift_invert_lanczos

        return shift_invert_lanczos(
            pencil, sigma=sigma, nev=nev, maxiter=maxiter or 60, tol=tol,
            **kwargs,
        )
    raise ValueError(f"unknown solver {solver!r}")


def _maybe_refine(problem, res, tol, want_refine):
    if not want_refine or res.eigenvectors is None:
        return res
    from maxwell_tpu.solvers.refine import refine_f64
    from maxwell_tpu.solvers.results import EigenResult

    ref = refine_f64(
        problem, res.eigenvectors, theta=res.eigenvalues, tol=tol
    )
    return EigenResult(
        eigenvalues=ref.eigenvalues,
        eigenvectors=ref.eigenvectors,
        residuals=ref.residuals,
        iterations=res.iterations + ref.iterations,
        converged=ref.converged,
        history=list(res.history) + ref.history,
    )
