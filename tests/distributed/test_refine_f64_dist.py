"""Distributed native-f64 polish (solvers/refine.refine_f64_dist) on the
simulated 8-device mesh: f32 distributed LOBPCG block -> warm-started f64
LOBPCG on the f64 twin of the slab pencil -> residual <= 1e-8 verified
against an independent single-device f64 pencil."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxwell_tpu.dist import make_mesh
from maxwell_tpu.dist.stencil_dist import DistStencilPencil3D
from maxwell_tpu.problems.analytic import cavity_eigenvalues_3d
from maxwell_tpu.problems.stencil3d import StencilPencil3D
from maxwell_tpu.solvers.dist_solve import lobpcg_dist
from maxwell_tpu.solvers.refine import refine_f64_dist

D = 8
N = 16


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= D
    return make_mesh(D)


def _build(dtype, n=N, d=D):
    return DistStencilPencil3D.build(nx=n, ny=n, nz=n, D=d, dtype=dtype)


def _f64_residuals(X, theta, n=N):
    """Relative residuals of host eigenvectors X (global stencil ordering)
    under an independently built single-device f64 pencil."""
    p64 = StencilPencil3D.build(nx=n, ny=n, nz=n, dtype=jnp.float64)
    Xd = jnp.zeros((p64.n_padded, X.shape[1]), jnp.float64).at[: p64.n].set(
        jnp.asarray(X[: p64.n], jnp.float64)
    )
    KX = np.asarray(p64.K_mm(Xd))[: p64.n]
    MX = np.asarray(p64.M_mm(Xd))[: p64.n]
    R = KX - MX * theta[None, :]
    scale = np.linalg.norm(KX, axis=0) + np.abs(theta) * np.linalg.norm(
        MX, axis=0
    )
    return np.linalg.norm(R, axis=0) / scale


@pytest.mark.parametrize("handoff", ["host", "device"])
def test_refine_f64_dist_reaches_1e8(mesh, handoff):
    """The f32 block goes to the polish either as host vectors in the
    original ordering or as the stacked device block (no host round
    trip); both reach 1e-8 in f64."""
    dsp = _build(jnp.float32)
    res32 = lobpcg_dist(
        dsp, mesh, nev=4, maxiter=60, tol=1e-5, precond="spectral",
        precond_alpha=15.0, return_device=handoff == "device",
    )
    if handoff == "device":
        assert isinstance(res32.eigenvectors, jax.Array)
        assert res32.eigenvectors.shape == (dsp.global_rows, 4)
    assert res32.residuals.max() < 1e-2

    out = refine_f64_dist(
        lambda: _build(jnp.float64), mesh, res32.eigenvectors, tol=1e-8
    )
    assert out.converged, f"residuals {out.residuals}"
    assert out.eigenvectors.shape == (dsp.n_full, 4)
    assert out.eigenvectors.dtype == np.float64
    rel = _f64_residuals(out.eigenvectors, out.eigenvalues)
    assert rel.max() <= 2e-8, f"f64-verified residual {rel.max():.2e}"
    ana = cavity_eigenvalues_3d(1.0, 1.0, 1.0, 4)
    np.testing.assert_allclose(np.sort(out.eigenvalues), ana, rtol=0.05)


def test_staged_polish_deflates_each_stage(mesh):
    """A staged f32 solve whose stages are polished in f64 with the
    earlier stages deflated: every pair reaches 1e-8, none is found twice,
    and the set equals a plain f64 solve's."""
    n, d = 8, 2
    mesh2 = make_mesh(d)
    dsp = _build(jnp.float32, n, d)
    res = lobpcg_dist(
        dsp, mesh2, nev=6, batch=3, maxiter=80, tol=1e-5,
        precond_alpha=15.0, stall_window=15,
        stage_polish=lambda r, Q: refine_f64_dist(
            lambda: _build(jnp.float64, n, d), mesh2, r.eigenvectors,
            tol=1e-8, deflate_Q=Q,
        ),
    )
    assert res.converged and res.residuals.max() <= 1e-8
    rel = _f64_residuals(res.eigenvectors, res.eigenvalues, n)
    assert rel.max() <= 2e-8, f"f64-verified residual {rel.max():.2e}"
    ref = lobpcg_dist(
        _build(jnp.float64, n, d), mesh2, nev=6, maxiter=80, tol=1e-8,
        precond_alpha=15.0,
    )
    np.testing.assert_allclose(
        np.sort(res.eigenvalues), np.sort(ref.eigenvalues), rtol=1e-7
    )


def test_dryrun_multichip_entry_point():
    """The multichip dry-run entry point runs end to end on 4 devices."""
    path = os.path.join(
        os.path.dirname(__file__), "..", "..", "__graft_entry__.py"
    )
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(4)
