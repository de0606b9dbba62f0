"""Shift-invert Lanczos for interior eigenmodes near a target frequency
(SURVEY.md §2 C10, §3.4; BASELINE.json config 3).

Pipeline: factor K - sigma*M ONCE on host (scipy splu — numeric sparse LU;
the reference-class equivalent of its sparse factorization path), ship the
factors to the device as level-scheduled triangular solves
(maxwell_tpu.kernels.tri_solve), then run the standard Lanczos driver on the
M-self-adjoint operator

    OP x = P (K - sigma M)^-1 M x

whose eigenvalues theta map to lambda = sigma + 1/theta; modes nearest sigma
converge first (SURVEY.md §3.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from maxwell_tpu.kernels.tri_solve import SparseLUDevice
from maxwell_tpu.solvers.lanczos import lanczos
from maxwell_tpu.solvers.operator import Pencil
from maxwell_tpu.solvers.results import EigenResult


from maxwell_tpu.utils.precision import fp32_true

def _si_apply(pencil: Pencil, lu_dev: SparseLUDevice, x: jax.Array) -> jax.Array:
    t = pencil.M_mm(x)
    z = jnp.zeros_like(x)
    z = z.at[: lu_dev.n].set(lu_dev.solve(t[: lu_dev.n]))
    return pencil.project(z)


def _shifted_mv(pencil, sigma, z):
    Kz, Mz = pencil.KM_mm(z)
    return Kz - sigma * Mz


def _si_apply_iterative(
    pencil, sigma, inner_tol, inner_iters, x: jax.Array
) -> jax.Array:
    """Matrix-free shift-invert apply: MINRES on the symmetric-indefinite
    K - sigma*M (SURVEY.md §7.5 option (c)). Works with any pencil —
    including the assembly-free stencil operators."""
    from maxwell_tpu.solvers.minres import minres

    t = pencil.M_mm(x)
    A_mv = jax.tree_util.Partial(_shifted_mv, pencil, sigma)
    z = minres(A_mv, t, tol=inner_tol, maxiter=inner_iters, dot=pencil.dot_vv)
    return pencil.project(z)


def build_shift_invert_op(
    pencil: Pencil, sigma: float, backend: str = "auto", KM=None
):
    """Factor K - sigma*M on host; return a Partial device apply.

    backend: "ldlt" (native C++ LDL^T, maxwell_tpu/native), "splu" (scipy
    SuperLU with partial pivoting), "iterative" (matrix-free MINRES inner
    solve — no factorization, works with stencil pencils), or "auto" (ldlt
    with splu fallback on a zero pivot or missing toolchain).
    KM: optional (K, M) host scipy matrices to factor (skips the device
    layout's to_csr round-trip — drivers that still hold the assembled
    problem should pass these).
    """
    if backend == "iterative":
        return jax.tree_util.Partial(
            _si_apply_iterative, pencil, sigma, 1e-11, 400
        )
    if KM is not None:
        K, M = sp.csr_matrix(KM[0]), sp.csr_matrix(KM[1])
    else:
        K = pencil.K.to_csr()
        M = (
            pencil.M.to_csr()
            if pencil.M is not None
            else sp.eye(K.shape[0], format="csr")
        )
    A = (K - sigma * M).tocsc()

    if backend in ("auto", "ldlt"):
        try:
            from maxwell_tpu.kernels.tri_solve import SparseLDLTDevice

            dev = SparseLDLTDevice.factor(A)
            return jax.tree_util.Partial(_si_apply, pencil, dev)
        except (RuntimeError, ZeroDivisionError):
            if backend == "ldlt":
                raise
    lu = spla.splu(A)
    lu_dev = SparseLUDevice.from_splu(lu)
    return jax.tree_util.Partial(_si_apply, pencil, lu_dev)


@fp32_true
def shift_invert_lanczos(
    pencil: Pencil,
    sigma: float,
    nev: int = 5,
    maxiter: int = 60,
    tol: float = 1e-8,
    key: jax.Array | None = None,
    backend: str = "auto",
    KM=None,
) -> EigenResult:
    """Find the nev eigenvalues of K x = lambda M x closest to sigma."""
    apply_op = build_shift_invert_op(pencil, sigma, backend=backend, KM=KM)
    return lanczos(
        pencil,
        nev=nev,
        maxiter=maxiter,
        tol=tol,
        key=key,
        mode="shift_invert",
        apply_op=apply_op,
        sigma=sigma,
    )
