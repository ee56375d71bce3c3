"""Block-row SpMV through Pallas on the Triton route.

One program owns one block row (and a slice of its rows): it walks that
row's stored blocks, found through a block-row pointer computed on the
host, loads each block's x segment, multiplies and accumulates in
registers, and stores its y rows once.  No atomics, no intermediates in
device memory, and a fixed summation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def block_row_ptr(block_rows: np.ndarray, num_real_blocks: int,
                  num_block_rows: int) -> np.ndarray:
    """CSR-style pointer over blocks sorted by block row: the blocks of
    block row r are ``[ptr[r], ptr[r+1])``.  Padding blocks past
    ``num_real_blocks`` are left out."""
    br = np.asarray(block_rows)[:num_real_blocks]
    if br.size and np.any(np.diff(br) < 0):
        raise ValueError("blocks must be sorted by block row")
    return np.searchsorted(br, np.arange(num_block_rows + 1),
                           side="left").astype(np.int32)


def _rows_per_program(bm: int, bn: int) -> int:
    # ~512 elements per loaded tile: enough programs to fill the SMs even
    # when block rows are few, small enough to stay in registers.
    return max(1, min(bm, 512 // bn))


def _kernel(ptr_ref, cols_ref, data_ref, x_ref, y_ref, *, tm, bm, bn):
    r = pl.program_id(0)
    c = pl.program_id(1)
    start = ptr_ref[r]
    end = ptr_ref[r + 1]

    def body(b, acc):
        col = cols_ref[b]
        xs = x_ref[pl.ds(col * bn, bn)]
        blk = data_ref[b, pl.ds(c * tm, tm), :]
        return acc + blk * xs[None, :]

    acc = lax.fori_loop(start, end, body,
                        jnp.zeros((tm, bn), data_ref.dtype))
    y_ref[pl.ds(r * bm + c * tm, tm)] = jnp.sum(acc, axis=1)


@functools.partial(jax.jit, static_argnames=("m_padded", "interpret"))
def block_spmv(data, block_cols, row_ptr, x, m_padded: int,
               interpret: bool = False):
    """y = A x for block-COO ``data`` [nb, bm, bn] sorted by block row."""
    bm, bn = data.shape[1], data.shape[2]
    tm = _rows_per_program(bm, bn)
    nbr = m_padded // bm
    return pl.pallas_call(
        functools.partial(_kernel, tm=tm, bm=bm, bn=bn),
        out_shape=jax.ShapeDtypeStruct((m_padded,), data.dtype),
        grid=(nbr, bm // tm),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=2, num_stages=3),
        interpret=interpret,
        name="block_spmv",
    )(row_ptr, block_cols, data, x)
