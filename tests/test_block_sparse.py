import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from ortools_tpu.ops.block_sparse import BlockSparseMatrix, auto_block_shape


@pytest.mark.parametrize("m,n,density,block", [
    (10, 17, 0.3, (8, 128)),
    (100, 250, 0.02, (8, 128)),
    (257, 129, 0.05, (32, 128)),
    (5, 5, 1.0, (8, 128)),
])
def test_matvec_matches_scipy(m, n, density, block):
    rng = np.random.default_rng(42)
    a = sp.random(m, n, density=density, random_state=np.random.RandomState(1),
                  format="csr")
    bsm = BlockSparseMatrix.from_scipy(a, block_shape=block, dtype=jnp.float64)
    x = rng.standard_normal(n)
    y = bsm.unpad_y(bsm.matvec(bsm.pad_x(x)))
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-12, atol=1e-12)


def test_transpose_matvec():
    a = sp.random(50, 80, density=0.05, random_state=np.random.RandomState(3),
                  format="csr")
    at = BlockSparseMatrix.from_scipy(sp.csr_matrix(a.T), dtype=jnp.float64)
    y = np.random.default_rng(0).standard_normal(50)
    x = at.unpad_y(at.matvec(at.pad_x(y)))
    np.testing.assert_allclose(np.asarray(x), a.T @ y, rtol=1e-12, atol=1e-12)


def test_matmat():
    a = sp.random(40, 30, density=0.1, random_state=np.random.RandomState(5),
                  format="csr")
    bsm = BlockSparseMatrix.from_scipy(a, dtype=jnp.float64)
    x = np.random.default_rng(1).standard_normal((30, 7))
    xp = bsm.pad_x(x)
    y = bsm.matmat(xp)[: a.shape[0]]
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-12, atol=1e-12)


def test_to_dense_roundtrip():
    a = sp.random(33, 65, density=0.08, random_state=np.random.RandomState(7),
                  format="csr")
    bsm = BlockSparseMatrix.from_scipy(a, dtype=jnp.float64)
    np.testing.assert_allclose(bsm.to_dense(), a.toarray(), rtol=0, atol=0)


def test_block_padding_multiple():
    a = sp.random(64, 256, density=0.02, random_state=np.random.RandomState(9))
    bsm = BlockSparseMatrix.from_scipy(a, pad_blocks_to_multiple_of=8,
                                       dtype=jnp.float64)
    assert bsm.num_blocks % 8 == 0
    x = np.random.default_rng(2).standard_normal(256)
    y = bsm.unpad_y(bsm.matvec(bsm.pad_x(x)))
    np.testing.assert_allclose(np.asarray(y), a @ x, rtol=1e-12, atol=1e-12)


def test_empty_matrix():
    a = sp.csr_matrix((8, 16))
    bsm = BlockSparseMatrix.from_scipy(a, dtype=jnp.float64)
    y = bsm.unpad_y(bsm.matvec(bsm.pad_x(np.ones(16))))
    np.testing.assert_allclose(np.asarray(y), np.zeros(8))


def test_auto_block_shape():
    assert auto_block_shape(1000, 1000, 100_000) == (128, 128)
    assert auto_block_shape(1000, 1000, 10_000) == (32, 128)
    assert auto_block_shape(10_000, 10_000, 10_000) == (8, 128)


def test_block_transpose_exact_and_grid_symmetric():
    a = sp.random(140, 300, density=0.05,
                  random_state=np.random.RandomState(3), format="csr")
    bsm = BlockSparseMatrix.from_scipy(a, dtype=jnp.float64)
    bst = bsm.block_transpose()
    # grid symmetry: same stored block count, swapped shapes
    assert bst.num_blocks == bsm.num_blocks
    assert bst.block_shape == (bsm.block_shape[1], bsm.block_shape[0])
    assert bst.shape == (300, 140)
    assert bst.padded_shape == (bsm.padded_shape[1], bsm.padded_shape[0])
    y = np.random.default_rng(4).standard_normal(140)
    out = bst.unpad_y(bst.matvec(bst.pad_x(y)))
    np.testing.assert_allclose(np.asarray(out), a.T @ y, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(bst.to_dense(), a.T.toarray(), atol=0)
