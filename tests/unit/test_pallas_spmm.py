"""Blocked-ELL SpMM: the Triton kernel (interpret mode on the CPU) and the
XLA reference against scipy f64, plus the one place the apply is chosen
(kernels/spmm.resolve_kernel, and per call kernels/spmm.choose_apply). The
compiled kernel runs on the card in the `gpu`-marked test and in
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from maxwell_tpu.kernels import spmm
from maxwell_tpu.kernels.spmm import bsr_matmat_triton, resolve_kernel
from maxwell_tpu.problems import BrickCavity3D, RectCavity2D
from maxwell_tpu.sparse.bsr import BSRMatrix, bsr_matmat_ref
from maxwell_tpu.sparse.reorder import PermutedProblem

APPLIES = {
    "ref": bsr_matmat_ref,
    "triton": lambda A, X: bsr_matmat_triton(A, X, interpret=True),
}


@pytest.fixture(scope="module")
def fem_bsr():
    cav = RectCavity2D(nx=16, ny=16)
    return BSRMatrix.from_csr(cav.K, block=8, dtype=jnp.float32)


@pytest.fixture(scope="module")
def brick():
    cav = BrickCavity3D(nx=4, ny=4, nz=3)
    return {"3d": cav.K.tocsr(), "rcm": PermutedProblem(cav).K.tocsr()}


def _check(Y, K, X, n, dtype):
    """Y[:n] against the scipy f64 product, relative to ||K||_inf ||X||_max
    (the sums run in another order than scipy's)."""
    ref = K @ np.asarray(X, np.float64)[:n]
    scale = abs(K).sum(axis=1).max() * np.abs(np.asarray(X)).max()
    tol = 1e-6 if dtype == jnp.float32 else 1e-13
    err = np.abs(np.asarray(Y, np.float64)[:n] - ref).max()
    assert err <= tol * scale, f"rel err {err / scale:.2e}"


def test_pallas_spmm_matches_ref(fem_bsr):
    A = fem_bsr
    X = jax.random.normal(jax.random.PRNGKey(0), (A.n_padded, 8), jnp.float32)
    Y = bsr_matmat_triton(A, X, interpret=True)
    np.testing.assert_allclose(
        np.asarray(Y), np.asarray(bsr_matmat_ref(A, X)), rtol=1e-5, atol=1e-5
    )


def test_pallas_spmm_wide_block(fem_bsr):
    A = fem_bsr
    X = jax.random.normal(jax.random.PRNGKey(1), (A.n_padded, 16), jnp.float32)
    Y = bsr_matmat_triton(A, X, interpret=True)
    np.testing.assert_allclose(
        np.asarray(Y), np.asarray(bsr_matmat_ref(A, X)), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("impl", ["ref", "triton"])
@pytest.mark.parametrize("order", ["3d", "rcm"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("m", [1, 8, 24])
@pytest.mark.parametrize("b", [4, 8])
def test_spmm_vs_scipy(brick, impl, order, dtype, m, b):
    K = brick[order]
    n = K.shape[0]
    A = BSRMatrix.from_csr(K, block=b, align_slots=4, dtype=dtype)
    rng = np.random.default_rng(b * 100 + m)
    X = np.zeros((A.n_padded, m))
    X[:n] = rng.standard_normal((n, m))
    Y = APPLIES[impl](A, jnp.asarray(X, dtype))
    assert Y.shape == (A.n_padded, m) and Y.dtype == dtype
    _check(Y, K, X, n, dtype)


@pytest.mark.parametrize("impl", ["ref", "triton"])
def test_spmm_halo_taller_x(impl):
    """X taller than A's row space (the distributed halo-extended local
    buffer): cols index past A's own rows, rows past them stay unread."""
    L, H, b, m = 40, 8, 4, 3
    rng = np.random.default_rng(7)
    # rectangular (own rows) x (own + halo columns), as blocked-ELL
    C = sp.random(L * b, (L + 2 * H) * b, density=0.05, random_state=3)
    Cb = sp.csr_matrix(C).tobsr(blocksize=(b, b))
    S = int(np.diff(Cb.indptr).max())
    blocks = np.zeros((L, S, b, b))
    cols = np.zeros((L, S), np.int32)
    for r in range(L):
        lo, hi = Cb.indptr[r], Cb.indptr[r + 1]
        blocks[r, : hi - lo] = Cb.data[lo:hi]
        cols[r, : hi - lo] = Cb.indices[lo:hi]
    A = BSRMatrix(
        blocks=jnp.asarray(blocks), cols=jnp.asarray(cols), n=L * b
    )
    X = rng.standard_normal(((L + 2 * H + 1) * b, m))
    Y = APPLIES[impl](A, jnp.asarray(X))
    assert Y.shape == (L * b, m)
    ref = C @ X[: (L + 2 * H) * b]
    np.testing.assert_allclose(np.asarray(Y), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "platform, want", [("cpu", "ref"), ("gpu", "triton")]
)
def test_auto_kernel_per_platform(platform, want):
    assert resolve_kernel("auto", platform) == want
    assert resolve_kernel("ref", platform) == "ref"


def test_auto_kernel_follows_first_device(monkeypatch):
    class _Dev:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev()])
    assert resolve_kernel() == "triton"


@pytest.mark.parametrize("kernel", ["triton", "union", "pallas", "bogus"])
def test_kernel_rejected_on_cpu(kernel):
    """An explicit GPU kernel on the CPU, or a removed/unknown name, is an
    error — never a silent fallback."""
    from maxwell_tpu.solvers.operator import Pencil

    with pytest.raises(ValueError):
        resolve_kernel(kernel, "cpu")
    with pytest.raises(ValueError):
        Pencil.from_problem(RectCavity2D(nx=4, ny=4), kernel=kernel)


def test_triton_rejects_non_pow2_block():
    cav = RectCavity2D(nx=6, ny=6)
    A = BSRMatrix.from_csr(cav.K, block=3, dtype=jnp.float32)
    X = jnp.ones((A.n_padded, 2), jnp.float32)
    with pytest.raises(ValueError):
        bsr_matmat_triton(A, X, interpret=True)


def _abstract_bsr(n_brows, slots, b, dtype=jnp.float32):
    """A BSRMatrix of ShapeDtypeStructs: shapes to reason about without
    allocating them."""
    return BSRMatrix(
        blocks=jax.ShapeDtypeStruct((n_brows, slots, b, b), dtype),
        cols=jax.ShapeDtypeStruct((n_brows, slots), jnp.int32),
        n=n_brows * b,
    )


@pytest.mark.parametrize(
    "b, m, want",
    [(4, 1, "ref"), (8, 1, "ref"), (4, 2, "triton"), (4, 8, "triton"),
     (8, 24, "triton"), (3, 24, "ref"), (6, 8, "ref")],
)
def test_gpu_apply_choice_by_width_and_block(b, m, want):
    """The GPU apply sends single vectors to XLA (where the kernel is
    slower) and blocks the kernel cannot take to XLA too."""
    A = _abstract_bsr(1000, 27, b)
    assert spmm.choose_apply(A, jax.ShapeDtypeStruct((1000 * b, m),
                                                     jnp.float32)) == want


@pytest.mark.parametrize(
    "n_brows, slots, b, x_rows, m",
    [
        (2_000_000, 72, 4, 8_000_000, 8),  # blocks: 2.3e9 entries
        (1_000, 27, 4, 4_000, 2**20),  # X and Y: 4.2e9 entries
    ],
)
def test_triton_int32_offset_guard(n_brows, slots, b, x_rows, m):
    """Operands whose flat offsets pass 2^31 go to XLA on the GPU path, and
    the kernel itself refuses them instead of wrapping its int32 offsets."""
    A = _abstract_bsr(n_brows, slots, b)
    X = jax.ShapeDtypeStruct((x_rows, m), jnp.float32)
    assert "2^31" in spmm.triton_unsupported(A, x_rows, m)
    assert spmm.choose_apply(A, X) == "ref"
    with pytest.raises(ValueError, match="2\\^31"):
        jax.eval_shape(
            lambda A, X: bsr_matmat_triton(A, X, interpret=True), A, X
        )


def test_triton_offsets_fit_just_below_limit():
    A = _abstract_bsr(1_000_000, 64, 4)  # 1.02e9 block entries
    assert spmm.triton_unsupported(A, 4_000_000, 24) is None


@pytest.mark.parametrize("m, rows", [(1, 512), (8, 512), (24, 128), (96, 64)])
def test_tile_rows(m, rows):
    mp = int(2 ** np.ceil(np.log2(m)))
    P = spmm._tile_rows(4, mp)
    assert P == rows and P % 4 == 0 and P & (P - 1) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_triton_compiled_on_gpu(gpu_device, brick, dtype):
    """The kernel as compiled for the card, against scipy f64."""
    K = brick["rcm"]
    n = K.shape[0]
    A = BSRMatrix.from_csr(K, block=4, align_slots=4, dtype=dtype)
    X = np.zeros((A.n_padded, 8))
    X[:n] = np.random.default_rng(0).standard_normal((n, 8))
    Y = bsr_matmat_triton(A, jnp.asarray(X, dtype))
    assert list(Y.devices())[0].platform == "gpu"
    _check(Y, K, X, n, dtype)
