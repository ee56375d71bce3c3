"""Device SpMV: the block path and the Triton block-row kernel against
scipy, the block-row pointer, and the choice of path.

On the CPU the Triton kernel runs in interpret mode; the test marked
``gpu`` compiles it for the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from ortools_tpu.ops.block_sparse import BlockSparseMatrix
from ortools_tpu.ops.spmv_triton import block_row_ptr, block_spmv

SHAPES = [
    (300, 500, 0.02, (8, 128)),
    (1000, 700, 0.005, (8, 128)),
    (900, 1100, 0.002, (32, 128)),
    (17, 5, 0.5, (8, 128)),
    (128, 20000, 0.001, (8, 128)),  # many block columns
    (50, 60, 0.0, (8, 128)),  # empty matrix
]


def _layouts(m, n, density, block_shape, seed):
    a = sp.random(m, n, density=density, format="csr",
                  random_state=np.random.RandomState(seed))
    bsm = BlockSparseMatrix.from_scipy(a, block_shape=block_shape,
                                       dtype=jnp.float32)
    return a, bsm, bsm.block_transpose()


def _triton(mat: BlockSparseMatrix, v: np.ndarray) -> np.ndarray:
    mat = mat.with_row_ptr()
    return np.asarray(block_spmv(mat.data, mat.block_cols, mat.row_ptr,
                                 mat.pad_x(v), mat.padded_shape[0],
                                 interpret=True))


def _xla(mat: BlockSparseMatrix, v: np.ndarray) -> np.ndarray:
    return np.asarray(mat.matvec(mat.pad_x(v)))


@pytest.mark.parametrize("path", ["xla", "triton"])
@pytest.mark.parametrize("op", ["Ax", "ATy"])
@pytest.mark.parametrize("m,n,density,block_shape", SHAPES)
def test_spmv_matches_scipy(m, n, density, block_shape, op, path):
    a, bsm, bst = _layouts(m, n, density, block_shape, seed=m + n)
    rng = np.random.default_rng(1)
    if op == "Ax":
        mat, ref, v = bsm, a, rng.standard_normal(n)
    else:
        mat, ref, v = bst, a.T.tocsr(), rng.standard_normal(m)
    y = (_xla if path == "xla" else _triton)(mat, v)
    exact = ref @ v
    assert y.shape == (mat.padded_shape[0],)
    assert np.all(y[ref.shape[0]:] == 0.0)
    bound = 1e-5 * (abs(ref) @ np.abs(v)) + 1e-30
    assert np.all(np.abs(y[: ref.shape[0]] - exact) <= bound)


def test_block_row_pointer_spans_each_row():
    a, bsm, _ = _layouts(300, 500, 0.02, (8, 128), seed=3)
    br = np.asarray(bsm.block_rows)
    ptr = block_row_ptr(br, bsm.num_real_blocks, bsm.padded_shape[0] // 8)
    assert ptr[0] == 0 and ptr[-1] == bsm.num_real_blocks
    for r in range(len(ptr) - 1):
        assert np.all(br[ptr[r]:ptr[r + 1]] == r)


def test_block_row_pointer_skips_padding_blocks():
    a = sp.random(64, 256, density=0.02, format="csr",
                  random_state=np.random.RandomState(9))
    bsm = BlockSparseMatrix.from_scipy(a, pad_blocks_to_multiple_of=12)
    assert bsm.num_blocks > bsm.num_real_blocks
    ptr = block_row_ptr(np.asarray(bsm.block_rows), bsm.num_real_blocks, 8)
    assert ptr[-1] == bsm.num_real_blocks


def test_block_row_pointer_rejects_unsorted_blocks():
    with pytest.raises(ValueError):
        block_row_ptr(np.array([0, 2, 1], np.int32), 3, 3)


def test_block_transpose_sorts_by_block_row():
    _, bsm, bst = _layouts(200, 900, 0.01, (8, 128), seed=4)
    rows = np.asarray(bst.block_rows)[: bst.num_real_blocks]
    assert np.all(np.diff(rows) >= 0)
    assert bst.row_ptr is None and bst.with_row_ptr().row_ptr is not None


def test_matvec_dispatches_on_row_ptr(monkeypatch):
    """With a row pointer, 1-D matvec runs the kernel; 2-D matmat and a
    matrix without the pointer stay on the XLA block path."""
    from ortools_tpu.ops import spmv_triton

    calls = []

    def fake(data, cols, ptr, x, m_padded):
        calls.append(m_padded)
        return block_spmv(data, cols, ptr, x, m_padded, interpret=True)

    monkeypatch.setattr(spmv_triton, "block_spmv", fake)
    a, bsm, _ = _layouts(100, 300, 0.05, (8, 128), seed=5)
    x = bsm.pad_x(np.random.default_rng(0).standard_normal(300))
    y_k = np.asarray(bsm.with_row_ptr().matvec(x))
    assert calls == [bsm.padded_shape[0]]
    np.testing.assert_allclose(y_k, np.asarray(bsm.matvec(x)), rtol=1e-5,
                               atol=1e-5)
    assert len(calls) == 1
    xm = jnp.stack([x, 2 * x], axis=1)
    np.asarray(bsm.with_row_ptr().matmat(xm))
    assert len(calls) == 1


def test_build_device_problem_attaches_kernel_only_when_asked():
    from ortools_tpu.models.generators import block_random_lp
    from ortools_tpu.pdlp import solver as S
    from ortools_tpu.pdlp.params import PdhgParams

    qp = block_random_lp(256, 256, num_blocks=32, seed=0)
    params = PdhgParams(dtype=jnp.float32)
    plain = S.build_device_problem(qp, params)
    assert plain.a.row_ptr is None and plain.at.row_ptr is None
    fused = S.build_device_problem(qp, params, spmv_kernel=True)
    assert fused.a.row_ptr is not None and fused.at.row_ptr is not None
    bm = plain.a.block_shape[0]
    assert fused.a.row_ptr.shape == (plain.a.padded_shape[0] // bm + 1,)


def test_single_device_solve_picks_path_from_device(monkeypatch):
    """pdlp.solve asks utils.device once per build: on the CPU it keeps the
    XLA path, on an accelerator it attaches the kernel."""
    from ortools_tpu.models.generators import block_random_lp
    from ortools_tpu.pdlp import solver as S
    from ortools_tpu.pdlp.params import PdhgParams

    seen = []
    build = S.build_device_problem

    def spy(*args, spmv_kernel=False, **kw):
        seen.append(spmv_kernel)
        return build(*args, **kw)

    monkeypatch.setattr(S, "build_device_problem", spy)
    qp = block_random_lp(128, 256, num_blocks=8, seed=1)
    params = PdhgParams(dtype=jnp.float32, iteration_limit=64)
    S.solve(qp, params)
    assert seen == [False]
    monkeypatch.setattr(S, "is_accelerator", lambda: True)
    S.solve(qp, params)
    assert seen == [False, True]


def test_pdlp_solve_through_kernel_matches_highs(monkeypatch):
    """End to end with the kernel in interpret mode."""
    import functools

    from scipy.optimize import linprog

    from ortools_tpu.models.lp import QuadraticProgram
    from ortools_tpu.ops import spmv_triton
    from ortools_tpu.pdlp import solver as S
    from ortools_tpu.pdlp.params import PdhgParams

    monkeypatch.setattr(spmv_triton, "block_spmv", functools.partial(
        block_spmv, interpret=True))
    monkeypatch.setattr(S, "is_accelerator", lambda: True)
    rng = np.random.default_rng(5)
    m, n = 6, 10
    aa = rng.standard_normal((m, n))
    x_feas = np.clip(rng.standard_normal(n), 0, 1)
    qp = QuadraticProgram(
        objective_vector=rng.standard_normal(n),
        constraint_matrix=sp.csr_matrix(aa),
        constraint_lower=aa @ x_feas - 0.5,
        constraint_upper=np.full(m, np.inf),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
    )
    res = S.solve(qp, PdhgParams(dtype=jnp.float32,
                                 eps_optimal_absolute=1e-4,
                                 eps_optimal_relative=1e-4,
                                 iteration_limit=20_000))
    ref = linprog(qp.objective_vector, A_ub=-aa, b_ub=-qp.constraint_lower,
                  bounds=[(0, 1)] * n, method="highs")
    assert ref.status == 0
    assert res.primal_objective == pytest.approx(ref.fun, abs=5e-3)


def test_batched_and_sharded_builds_keep_xla_path():
    from ortools_tpu.models.generators import block_random_lp
    from ortools_tpu.pdlp import solver as S
    from ortools_tpu.pdlp.params import PdhgParams

    qp = block_random_lp(256, 256, num_blocks=32, seed=2)
    prob = S.build_device_problem(qp, PdhgParams(dtype=jnp.float32),
                                  pad_blocks_to_multiple_of=4)
    assert prob.a.row_ptr is None
    spec = S._problem_specs(prob, "shards")
    assert spec.a.row_ptr is None


@pytest.mark.gpu
def test_kernel_compiled_for_gpu_matches_xla(gpu):
    a, bsm, bst = _layouts(2000, 3000, 0.01, (8, 128), seed=7)
    rng = np.random.default_rng(2)
    for mat, v in ((bsm, rng.standard_normal(3000)),
                   (bst, rng.standard_normal(2000))):
        k = mat.with_row_ptr()
        y_k = np.asarray(k.matvec(k.pad_x(v)))
        y_x = np.asarray(dataclasses.replace(k, row_ptr=None).matvec(
            k.pad_x(v)))
        np.testing.assert_allclose(y_k, y_x, rtol=1e-5, atol=1e-5)
    assert jax.default_backend() == "gpu"
