"""Distributed blocked-ELL apply with the Triton SpMM kernel INSIDE
shard_map — interior/boundary split, halo collectives, psum reductions —
parity vs the single-device reference pencil and a full distributed
eigensolve (SURVEY.md §3.5; BASELINE.json config 4). The kernel runs in
interpret mode here; chip_smoke.py --four runs it compiled."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import maxwell_tpu.dist.partition as partition
from maxwell_tpu.dist import make_mesh, partition_problem
from maxwell_tpu.kernels.spmm import bsr_matmat_triton, matmat_fn
from maxwell_tpu.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu.solvers import Pencil
from maxwell_tpu.solvers.dist_solve import lobpcg_dist, spmm_dist

D = 8


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    return make_mesh(D)


@pytest.fixture
def triton_interpret(monkeypatch):
    """Route kernel="triton" to the interpret-mode kernel on the CPU."""
    interp = functools.partial(bsr_matmat_triton, interpret=True)
    monkeypatch.setattr(
        partition, "matmat_fn",
        lambda k: interp if k == "triton" else matmat_fn(k),
    )


def _triton(cav, **kw):
    dp = partition_problem(cav, D, kernel="ref", dtype=jnp.float32, **kw)
    out = dataclasses.replace(dp, kernel="triton")
    object.__setattr__(out, "perm", dp.perm)
    return out


@pytest.mark.parametrize("reorder", [False, True])
def test_sharded_union_spmm_parity(mesh, triton_interpret, reorder):
    """Sharded Triton-kernel SpMM == single-device reference SpMM, for K
    and M. reorder=True gives the shallow-halo ppermute fast path;
    reorder=False the deep-halo all_gather fallback."""
    cav = BrickCavity3D(nx=6, ny=6, nz=6)
    dp = _triton(cav, reorder=reorder)
    single = Pencil.from_problem(cav, block=8, kernel="ref", dtype=jnp.float32)
    n = cav.n_edges
    n_pad_g = dp.D * dp.L * dp.b
    X = jax.random.normal(jax.random.PRNGKey(0), (n_pad_g, 4), jnp.float32)
    X = X.at[n:].set(0.0)
    perm = dp.perm if reorder else np.arange(n)
    Xs_np = np.zeros((single.n_padded, 4), np.float32)
    Xs_np[perm] = np.asarray(X[:n])
    for which, mm in (("K", single.K_mm), ("M", single.M_mm)):
        Y_single = np.asarray(mm(jnp.asarray(Xs_np)))[:n]
        Y_dist = np.asarray(spmm_dist(dp, mesh, X, which=which))[:n]
        np.testing.assert_allclose(
            Y_dist, Y_single[perm], rtol=2e-5, atol=2e-5
        )


def test_sharded_union_km_shares_one_exchange(mesh, triton_interpret):
    """KM_mm on the Triton pencil returns (K@X, M@X) matching the separate
    applies bit-for-bit."""
    from jax.sharding import PartitionSpec as P

    cav = RectCavity2D(nx=16, ny=16)
    dp = _triton(cav)
    n_pad_g = dp.D * dp.L * dp.b
    X = jax.random.normal(jax.random.PRNGKey(1), (n_pad_g, 3), jnp.float32)

    mapped = jax.shard_map(
        lambda p, Xl: p.KM_mm(Xl),
        mesh=mesh,
        in_specs=(dp.partition_specs(), P(dp.axis, None)),
        out_specs=(P(dp.axis, None), P(dp.axis, None)),
        check_vma=False,
    )
    KX, MX = jax.jit(mapped)(dp, X)
    Kr = spmm_dist(dp, mesh, X, which="K")
    Mr = spmm_dist(dp, mesh, X, which="M")
    np.testing.assert_array_equal(np.asarray(KX), np.asarray(Kr))
    np.testing.assert_array_equal(np.asarray(MX), np.asarray(Mr))


def test_dist_lobpcg_union(mesh, triton_interpret):
    """Full distributed eigensolve on the Triton kernel vs dense oracle
    (f32: tol at the single-precision floor for this size)."""
    cav = RectCavity2D(nx=16, ny=16)
    dp = _triton(cav)
    res = lobpcg_dist(dp, mesh, nev=4, maxiter=80, tol=1e-5,
                      precond_alpha=10.0)
    dense = scipy.linalg.eigh(
        cav.K.toarray(), cav.M.toarray(), eigvals_only=True
    )
    discrete = np.sort(dense[dense > 1e-8])[:4]
    assert res.converged, f"residuals {res.residuals}"
    np.testing.assert_allclose(res.eigenvalues, discrete, rtol=1e-4)


def test_mesh_topology_report(mesh):
    """Hosts-major mesh ordering + link-class report (SURVEY §5.8): on the
    single-host simulated mesh every neighbor link is intra-host; across
    hosts the dcn count is (hosts - 1)."""
    from maxwell_tpu.dist import mesh_topology_report

    rep = mesh_topology_report(mesh)
    assert rep["devices"] == D
    assert rep["neighbor_links"] == D - 1
    assert rep["dcn_links"] == len(rep["dcn_link_positions"])
    assert rep["ici_links"] + rep["dcn_links"] == D - 1
    assert rep["hosts"] >= 1
