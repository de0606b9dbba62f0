"""Mixed-precision refinement (solvers/refine.py): f32 device solve +
f64 host inverse-subspace-iteration polish reaches the 1e-8 residual
contract (SURVEY.md §6) that fp32 alone cannot.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import maxwell_tpu
from maxwell_tpu.problems import RectCavity2D
from maxwell_tpu.solvers import lobpcg
from maxwell_tpu.solvers.operator import Pencil
from maxwell_tpu.solvers.precond import shifted_cg_preconditioner
from maxwell_tpu.solvers.refine import refine_f64


@pytest.fixture(scope="module")
def cavity():
    return RectCavity2D(a=1.0, b=1.0, nx=24, ny=24)


def _residuals_f64(problem, theta, X):
    K = problem.K.astype(np.float64)
    M = problem.M.astype(np.float64)
    KX, MX = K @ X, M @ X
    R = KX - MX * theta[None, :]
    scale = np.linalg.norm(KX, axis=0) + np.abs(theta) * np.linalg.norm(
        MX, axis=0
    )
    return np.linalg.norm(R, axis=0) / scale


def test_refine_reaches_1e8(cavity):
    pencil = Pencil.from_problem(cavity, dtype=jnp.float32)
    pc = shifted_cg_preconditioner(pencil, alpha=10.0, iters=16)
    res = lobpcg(pencil, nev=4, maxiter=80, tol=2e-5, precond=pc)
    assert res.converged

    ref = refine_f64(cavity, res.eigenvectors, theta=res.eigenvalues, tol=1e-8)
    assert ref.converged
    # independent f64 residual check (not the solver's own report)
    r = _residuals_f64(cavity, ref.eigenvalues, ref.eigenvectors)
    assert r.max() <= 1e-8
    # eigenvalues match the analytic TE modes to discretization accuracy
    exact = cavity.analytic_eigenvalues(4)
    np.testing.assert_allclose(ref.eigenvalues, exact, rtol=2e-2)
    # refinement must not move the eigenvalues beyond the f32 error scale
    np.testing.assert_allclose(ref.eigenvalues, res.eigenvalues, rtol=1e-4)


def test_solve_auto_refine(cavity):
    res = maxwell_tpu.solve(
        cavity, nev=4, tol=1e-8, dtype=jnp.float32, maxiter=80
    )
    assert res.converged
    r = _residuals_f64(cavity, res.eigenvalues, res.eigenvectors)
    assert r.max() <= 1e-8


def test_refine_f64_pencil_matrix_free():
    """Matrix-free refine (VERDICT round-1 item 3): f32 stencil solve ->
    warm-started f64 LOBPCG reaches 1e-8 without ever assembling K.
    Residuals verified against an independently assembled f64 oracle."""
    from maxwell_tpu.problems import BrickCavity3D
    from maxwell_tpu.problems.stencil3d import StencilPencil3D
    from maxwell_tpu.solvers.precond import shifted_cg_preconditioner
    from maxwell_tpu.solvers.refine import refine_f64_pencil

    stp32 = StencilPencil3D.build(nx=5, ny=5, nz=5, dtype=jnp.float32)
    pc = shifted_cg_preconditioner(stp32, alpha=15.0, iters=12)
    res32 = lobpcg(stp32, nev=3, maxiter=120, tol=5e-5, precond=pc)
    assert res32.converged

    ref = refine_f64_pencil(
        lambda: StencilPencil3D.build(nx=5, ny=5, nz=5, dtype=jnp.float64),
        res32.eigenvectors,
        tol=1e-8,
        maxiter=40,
    )
    assert ref.converged
    assert ref.residuals.max() <= 1e-8

    # oracle check with the assembled f64 operator (test-only assembly) —
    # map cavity edge numbering -> stencil grid-major numbering
    nx = ny = nz = 5
    cav = BrickCavity3D(nx=nx, ny=ny, nz=nz)
    n_xe = nx * (ny + 1) * (nz + 1)
    n_ye = (nx + 1) * ny * (nz + 1)

    def cav_edge_to_stencil(e):
        if e < n_xe:
            i = e % nx
            j = (e // nx) % (ny + 1)
            k = e // (nx * (ny + 1))
            return (i * (ny + 1) + j) * (nz + 1) + k
        e2 = e - n_xe
        if e2 < n_ye:
            i = e2 % (nx + 1)
            j = (e2 // (nx + 1)) % ny
            k = e2 // ((nx + 1) * ny)
            return n_xe + (i * ny + j) * (nz + 1) + k
        e3 = e2 - n_ye
        i = e3 % (nx + 1)
        j = (e3 // (nx + 1)) % (ny + 1)
        k = e3 // ((nx + 1) * (ny + 1))
        return n_xe + n_ye + (i * (ny + 1) + j) * nz + k

    idx = np.array([cav_edge_to_stencil(e) for e in cav.keep])
    X = ref.eigenvectors[idx]
    r = _residuals_f64(cav, ref.eigenvalues, X)
    assert r.max() <= 5e-8
