"""Block-sparse constraint matrices for device SpMV/SpMM.

This is the accelerator replacement for the reference's sparse-matrix layer
(``ortools/lp_data/sparse.h:64`` SparseMatrix, ``ortools/pdlp`` Eigen CSC) and
for the Sharder's nnz-mass partitioning (``ortools/pdlp/sharder.h:149-165``):

- The logical m×n matrix is padded to M×N (multiples of the block shape) and
  tiled into (bm, bn) dense blocks; only nonzero blocks are stored, in a
  block-COO layout sorted by (block_row, block_col):
      data:       f32/f64 [num_blocks, bm, bn]
      block_rows: int32   [num_blocks]
      block_cols: int32   [num_blocks]
- All shapes are static (num_blocks padded up), so everything jits once.
- ``matmat`` (and ``matvec`` by default) lower to a gather + batched
  block matmul + segment-sum in XLA; SpMM carries a scenario/node batch
  axis through the same block product.  With a block-row pointer
  attached (``with_row_ptr``), 1-D ``matvec`` runs the Triton block-row
  kernel instead (ops/spmv_triton.py): no gathered or per-block
  intermediates in device memory, no atomics, a fixed summation order.
- For multi-chip execution the *block list* is the unit of sharding (the
  analogue of the Sharder's mass-balanced shards): blocks are padded to a
  multiple of the mesh axis size and partitioned contiguously; each device
  computes a full-length partial product that is combined with ``psum``
  (see ortools_tpu/pdlp/solver.py).

The transpose is stored explicitly as its own BlockSparseMatrix, mirroring
``ortools/pdlp/sharded_quadratic_program.h:56-66`` which keeps A and Aᵀ.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


def _ceil_to(x: int, k: int) -> int:
    return -(-x // k) * k


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BlockSparseMatrix:
    """Static-shape block-COO sparse matrix living on device."""

    data: jax.Array  # [num_blocks, bm, bn]
    block_rows: jax.Array  # int32 [num_blocks]
    block_cols: jax.Array  # int32 [num_blocks]
    shape: Tuple[int, int]  # logical (m, n)
    padded_shape: Tuple[int, int]  # (M, N), multiples of block shape
    num_real_blocks: int  # blocks before padding
    # Block-row pointer (int32 [M/bm + 1]) over blocks sorted by block row;
    # when present, 1-D matvec runs the Triton kernel (ops/spmv_triton.py).
    row_ptr: Optional[jax.Array] = None

    # -- pytree protocol (shape metadata is static) ---------------------
    def tree_flatten(self):
        return (
            (self.data, self.block_rows, self.block_cols, self.row_ptr),
            (self.shape, self.padded_shape, self.num_real_blocks),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, brows, bcols, row_ptr = children
        shape, padded_shape, nreal = aux
        return cls(data, brows, bcols, shape, padded_shape, nreal, row_ptr)

    # -- properties -----------------------------------------------------
    @property
    def block_shape(self) -> Tuple[int, int]:
        return (int(self.data.shape[1]), int(self.data.shape[2]))

    @property
    def num_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz_dense(self) -> int:
        """Stored (padded) element count — the bandwidth cost of one pass."""
        return self.num_blocks * self.block_shape[0] * self.block_shape[1]

    # -- construction ---------------------------------------------------
    @staticmethod
    def from_scipy(
        a: sp.spmatrix,
        block_shape: Tuple[int, int] = (8, 128),
        dtype=jnp.float32,
        pad_blocks_to_multiple_of: int = 1,
        padded_shape: Optional[Tuple[int, int]] = None,
    ) -> "BlockSparseMatrix":
        """``padded_shape`` overrides the default round-up-to-block padding —
        used to make A and its separately-stored transpose agree on padded
        vector lengths (each dim must be a multiple of the block dim)."""
        m, n = a.shape
        bm, bn = block_shape
        if padded_shape is not None:
            mm, nn = padded_shape
            assert mm % bm == 0 and nn % bn == 0, (padded_shape, block_shape)
            assert mm >= m and nn >= n, (padded_shape, a.shape)
        else:
            mm, nn = _ceil_to(max(m, 1), bm), _ceil_to(max(n, 1), bn)
        coo = sp.coo_matrix(a)
        br = coo.row // bm
        bc = coo.col // bn
        key = br.astype(np.int64) * (nn // bn) + bc
        uniq, inv = np.unique(key, return_inverse=True)
        nblocks = max(1, len(uniq))
        nblocks_padded = _ceil_to(nblocks, max(1, pad_blocks_to_multiple_of))
        data = np.zeros((nblocks_padded, bm, bn), dtype=np.float64)
        if len(uniq):
            np.add.at(
                data,
                (inv, coo.row % bm, coo.col % bn),
                coo.data,
            )
            block_rows = (uniq // (nn // bn)).astype(np.int32)
            block_cols = (uniq % (nn // bn)).astype(np.int32)
        else:
            block_rows = np.zeros(1, dtype=np.int32)
            block_cols = np.zeros(1, dtype=np.int32)
        if nblocks_padded > len(block_rows):
            pad = nblocks_padded - len(block_rows)
            # Padding blocks are all-zero and point at (0, 0): harmless adds.
            block_rows = np.concatenate([block_rows, np.zeros(pad, np.int32)])
            block_cols = np.concatenate([block_cols, np.zeros(pad, np.int32)])
        return BlockSparseMatrix(
            data=jnp.asarray(data, dtype=dtype),
            block_rows=jnp.asarray(block_rows),
            block_cols=jnp.asarray(block_cols),
            shape=(m, n),
            padded_shape=(mm, nn),
            num_real_blocks=nblocks,
        )

    def transpose_scipy(self, a: sp.spmatrix, **kw) -> "BlockSparseMatrix":
        """Build Aᵀ as its own block matrix (same options)."""
        return BlockSparseMatrix.from_scipy(sp.csr_matrix(a).T, **kw)

    def block_transpose(self) -> "BlockSparseMatrix":
        """Aᵀ at block shape (bn, bm) by transposing each stored block.

        The (bn, bm) tiling of Aᵀ is grid-symmetric to the (bm, bn) tiling
        of A — tile (J, I) of Aᵀ is exactly tile (I, J) of A transposed —
        so the transpose has the SAME number of stored blocks and zero
        extra fill-in.  (Re-tiling Aᵀ at (bm, bn) instead fragments each
        block across up to bn/bm block-rows; on the 4M-nnz bench LP that
        inflated the Aᵀ stream ~16x.)  Mirrors the reference's explicitly
        stored transpose (ortools/pdlp/sharded_quadratic_program.h:56-66).
        The real blocks are re-sorted by their new block row; padding
        blocks stay at the end.
        """
        nreal = self.num_real_blocks
        perm = jnp.asarray(np.concatenate([
            np.argsort(np.asarray(self.block_cols)[:nreal], kind="stable"),
            np.arange(nreal, self.num_blocks),
        ]))
        return BlockSparseMatrix(
            data=jnp.transpose(self.data[perm], (0, 2, 1)),
            block_rows=self.block_cols[perm],
            block_cols=self.block_rows[perm],
            shape=(self.shape[1], self.shape[0]),
            padded_shape=(self.padded_shape[1], self.padded_shape[0]),
            num_real_blocks=nreal,
        )

    def with_row_ptr(self) -> "BlockSparseMatrix":
        """Attach the block-row pointer, so 1-D matvec runs the Triton
        kernel (blocks must be sorted by block row)."""
        from ortools_tpu.ops.spmv_triton import block_row_ptr

        ptr = block_row_ptr(np.asarray(self.block_rows),
                            self.num_real_blocks,
                            self.padded_shape[0] // self.block_shape[0])
        return dataclasses.replace(self, row_ptr=jnp.asarray(ptr))

    # -- padded vector helpers -------------------------------------------
    def pad_x(self, x: np.ndarray | jax.Array, value: float = 0.0) -> jax.Array:
        """Pad a length-n vector (or [n, k] matrix) to N."""
        n, nn = self.shape[1], self.padded_shape[1]
        return _pad_to(x, n, nn, value, self.dtype)

    def pad_y(self, y: np.ndarray | jax.Array, value: float = 0.0) -> jax.Array:
        m, mm = self.shape[0], self.padded_shape[0]
        return _pad_to(y, m, mm, value, self.dtype)

    def unpad_y(self, y: jax.Array) -> jax.Array:
        return y[..., : self.shape[0]] if y.ndim == 1 else y[: self.shape[0]]

    def unpad_x(self, x: jax.Array) -> jax.Array:
        return x[..., : self.shape[1]] if x.ndim == 1 else x[: self.shape[1]]

    # -- products --------------------------------------------------------
    def matvec(self, x: jax.Array) -> jax.Array:
        """A @ x with x padded to N; returns padded length-M vector."""
        if self.row_ptr is not None and x.ndim == 1:
            from ortools_tpu.ops.spmv_triton import block_spmv

            return block_spmv(self.data, self.block_cols, self.row_ptr, x,
                              self.padded_shape[0])
        return _block_matvec(
            self.data, self.block_rows, self.block_cols, x,
            self.padded_shape[0],
        )

    def matmat(self, x: jax.Array) -> jax.Array:
        """A @ X with X padded [N, k]; returns [M, k]; k is the scenario /
        B&B-node batch axis."""
        return _block_matmat(
            self.data, self.block_rows, self.block_cols, x,
            self.padded_shape[0],
        )

    # -- conversion back -------------------------------------------------
    def to_dense(self) -> np.ndarray:
        bm, bn = self.block_shape
        mm, nn = self.padded_shape
        out = np.zeros((mm, nn), dtype=np.asarray(self.data).dtype)
        data = np.asarray(self.data)
        br = np.asarray(self.block_rows)
        bc = np.asarray(self.block_cols)
        for i in range(self.num_real_blocks):
            out[br[i] * bm : (br[i] + 1) * bm, bc[i] * bn : (bc[i] + 1) * bn] += data[i]
        return out[: self.shape[0], : self.shape[1]]


def _pad_to(v, logical: int, padded: int, value: float, dtype) -> jax.Array:
    v = jnp.asarray(v, dtype=dtype)
    if v.shape[0] == padded:
        return v
    assert v.shape[0] == logical, (v.shape, logical, padded)
    pad_width = [(0, padded - logical)] + [(0, 0)] * (v.ndim - 1)
    return jnp.pad(v, pad_width, constant_values=value)


@functools.partial(jax.jit, static_argnames=("m_padded",))
def _block_matvec(data, block_rows, block_cols, x, m_padded: int):
    bm, bn = data.shape[1], data.shape[2]
    xb = x.reshape(-1, bn)[block_cols]  # [nb, bn]
    # HIGHEST: a reduced-precision product (TF32 on a GPU keeps about
    # three decimal digits) caps achievable residuals far above the
    # 1e-4..1e-8 termination tolerances
    prod = jnp.einsum("bij,bj->bi", data, xb,
                      precision=jax.lax.Precision.HIGHEST)  # [nb, bm]
    y = jax.ops.segment_sum(prod, block_rows, num_segments=m_padded // bm)
    return y.reshape(m_padded)


@functools.partial(jax.jit, static_argnames=("m_padded",))
def _block_matmat(data, block_rows, block_cols, x, m_padded: int):
    bm, bn = data.shape[1], data.shape[2]
    k = x.shape[1]
    xb = x.reshape(-1, bn, k)[block_cols]  # [nb, bn, k]
    prod = jnp.einsum(
        "bij,bjk->bik", data, xb,
        preferred_element_type=data.dtype,
        precision=jax.lax.Precision.HIGHEST,  # see _block_matvec
    )  # [nb, bm, k]
    y = jax.ops.segment_sum(prod, block_rows, num_segments=m_padded // bm)
    return y.reshape(m_padded, k)


def auto_block_shape(m: int, n: int, nnz: int, dtype=jnp.float32) -> Tuple[int, int]:
    """Pick a block shape trading padding waste vs lane alignment.

    Sparse, scattered matrices want small blocks (8×128 is the f32 tile
    minimum); denser matrices can afford larger tiles for fewer gather
    indices.  Heuristic: density above 5% → (128, 128); above 0.5% →
    (32, 128); else (8, 128).
    """
    density = nnz / max(1, m * n)
    if density > 0.05:
        return (128, 128)
    if density > 0.005:
        return (32, 128)
    return (8, 128)
