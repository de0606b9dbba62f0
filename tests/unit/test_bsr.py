"""Blocked-ELL (tiled BSR) container tests vs scipy (SURVEY.md §4 unit tier)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from maxwell_tpu.problems import RectCavity2D
from maxwell_tpu.sparse.bsr import BSRMatrix, bsr_matmat_ref, bsr_matvec_ref


@pytest.fixture(scope="module")
def random_csr():
    rng = np.random.default_rng(42)
    A = sp.random(203, 203, density=0.03, random_state=42, format="csr")
    A = A + A.T  # symmetric-ish structure like FEM
    return A.tocsr()


@pytest.mark.parametrize("block", [4, 8, 16])
def test_csr_bsr_roundtrip(random_csr, block):
    B = BSRMatrix.from_csr(random_csr, block=block, dtype=jnp.float64)
    back = B.to_csr()
    assert abs(back - random_csr).max() < 1e-12
    assert B.slots * B.b % 128 == 0, "contraction dim must be 128-aligned"


def test_spmv_vs_scipy(random_csr):
    B = BSRMatrix.from_csr(random_csr, block=8, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(random_csr.shape[0])
    y_ref = random_csr @ x
    xp = B.pad_vec(jnp.asarray(x))
    y = np.asarray(B.unpad_vec(bsr_matvec_ref(B, xp)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-10, atol=1e-12)


def test_spmm_vs_scipy(random_csr):
    B = BSRMatrix.from_csr(random_csr, block=8, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((random_csr.shape[0], 7))
    Y_ref = random_csr @ X
    Xp = B.pad_vec(jnp.asarray(X))
    Y = np.asarray(B.unpad_vec(bsr_matmat_ref(B, Xp)))
    np.testing.assert_allclose(Y, Y_ref, rtol=1e-10, atol=1e-12)


def test_padding_invariant(random_csr):
    """Zero-padded entries stay zero through matvec."""
    B = BSRMatrix.from_csr(random_csr, block=16, dtype=jnp.float64)
    x = B.pad_vec(jnp.ones(B.n, dtype=jnp.float64))
    y = bsr_matvec_ref(B, x)
    assert np.all(np.asarray(y[B.n :]) == 0.0)


def test_fem_matrix_blocks():
    cav = RectCavity2D(nx=10, ny=10)
    B = BSRMatrix.from_csr(cav.K, block=8, dtype=jnp.float64)
    assert abs(B.to_csr() - cav.K).max() < 1e-12
