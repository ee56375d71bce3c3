"""Restarted adaptive primal-dual hybrid gradient (PDLP) on an accelerator.

Capability parity: ``ortools/pdlp/primal_dual_hybrid_gradient.{h,cc}`` —
the reference's first-order LP/QP solver (SURVEY §2.1, §3.2) — re-designed
for XLA on a GPU:

- the inner loop (2 SpMVs + ~10 elementwise vector ops + 4 reductions per
  iteration, reference ``TakeAdaptiveStep`` primal_dual_hybrid_gradient.cc:2295)
  runs fully on device under ``jit`` (``lax.fori_loop`` over iterations,
  ``lax.while_loop`` for the adaptive step-size search);
- the host syncs only at *major iterations* (every
  ``termination_check_frequency`` steps, reference default 64) to read
  scalar stats, decide restarts, and check termination — mirroring
  ``MajorIterationAndTerminationCheck`` (:2128);
- the reference's Sharder thread parallelism (sharder.h:34) becomes block
  sharding of the constraint matrix over a ``jax.sharding.Mesh`` with
  ``psum`` combining partial SpMV products (see solve() with
  params.num_shards > 1 / mesh argument);
- problem data is block-sparse with static shapes (ops/block_sparse.py), so
  the whole solve compiles once per (shape, dtype).

Algorithmic semantics reproduced (SURVEY Appendix A.1-A.3):
- two-sided constraint dual prox with exact sign structure;
- reduced costs absorbed on finite variable bounds, remainder = dual
  residual; dual objective computed with sign-splitting so 0·inf never
  occurs (iteration_stats.cc:294-316);
- adaptive step size: accept iff step <= movement/interaction, with
  reduction/growth exponents 0.3/0.6 on the total attempt count
  (:2330-2371);
- primal weight update w <- exp(0.5 log(Δdual/Δprimal) + 0.5 log w)
  on restarts (:1983-2011);
- restart-to-average with step-size-weighted averages; averages restart
  empty after each restart (ShardedWeightedAverage semantics).

Deviations from the reference:
- the default ADAPTIVE_HEURISTIC restart triggers on the weighted KKT
  error (cuPDLP scheme, same 0.1/0.9 reduction constants); the reference's
  trust-region localized-duality-gap rule is available as
  RestartStrategy.ADAPTIVE_KKT via pdlp/trust_region.py.
Infeasibility certificates (``_check_infeasibility``, below) and
feasibility polishing (``_try_feasibility_polishing``) ARE implemented,
mirroring TryFeasibilityPolishing (:2442) / iteration_stats.h:68.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ortools_tpu.models.lp import QuadraticProgram
from ortools_tpu.ops.block_sparse import BlockSparseMatrix, auto_block_shape
from ortools_tpu.pdlp.params import OptimalityNorm, PdhgParams, RestartStrategy
from ortools_tpu.utils.device import is_accelerator
from ortools_tpu.utils.status import TerminationReason


# ---------------------------------------------------------------------------
# Device problem representation
# ---------------------------------------------------------------------------


class DeviceProblem(NamedTuple):
    """Scaled, padded problem living on device.

    Scaling convention: A' = D_r A D_c, x = D_c x', y = D_r y',
    c' = D_c c, bounds scaled accordingly.  ``orig_*`` arrays are the
    padded original-space data used for residual/objective computation
    (residuals are always reported in the original space, like the
    reference's ComputeConvergenceInformation).
    """

    a: BlockSparseMatrix  # scaled A'  (M x N padded)
    at: BlockSparseMatrix  # scaled A'^T
    c: jax.Array  # scaled objective [N]
    q: jax.Array  # scaled diagonal objective [N] (zeros for LP)
    var_lb: jax.Array  # scaled [N]
    var_ub: jax.Array
    con_lb: jax.Array  # scaled [M]
    con_ub: jax.Array
    orig_c: jax.Array
    orig_q: jax.Array
    orig_var_lb: jax.Array
    orig_var_ub: jax.Array
    orig_con_lb: jax.Array
    orig_con_ub: jax.Array
    row_scale: jax.Array  # D_r [M]
    col_scale: jax.Array  # D_c [N]
    norm_b: jax.Array  # scalar: norm of finite combined constraint bounds
    norm_c: jax.Array  # scalar: norm of objective vector


class PdhgState(NamedTuple):
    x: jax.Array  # scaled primal [N]
    y: jax.Array  # scaled dual [M]
    ax: jax.Array  # A'x' [M]
    aty: jax.Array  # A'^T y' [N]
    step_size: jax.Array  # eta (scalar)
    primal_weight: jax.Array  # omega (scalar)
    x_sum: jax.Array  # step-size-weighted sum for the average
    y_sum: jax.Array
    sum_weights: jax.Array
    x_restart: jax.Array  # iterate at last restart (for distance traveled)
    y_restart: jax.Array
    num_steps: jax.Array  # int32: total step attempts (accepted + rejected)
    num_accepted: jax.Array  # int32
    kkt_passes: jax.Array  # cumulative KKT matrix passes (1 = A and A^T)
    # Malitsky-Pock linesearch state: ratio of the last two primal step
    # sizes (theta in arXiv:1608.08883); 1.0 and unused under the
    # adaptive rule.
    step_ratio: jax.Array


@dataclasses.dataclass
class SolveResult:
    termination_reason: TerminationReason
    primal_solution: np.ndarray  # original space, length n
    dual_solution: np.ndarray  # original space, length m
    reduced_costs: np.ndarray  # original space, length n
    primal_objective: float
    dual_objective: float
    primal_residual: float  # norm per params.optimality_norm, original space
    dual_residual: float
    relative_gap: float
    iterations: int
    kkt_matrix_passes: float
    solve_time_sec: float
    iteration_stats: List[dict]

    @property
    def objective_value(self) -> float:
        return self.primal_objective


# ---------------------------------------------------------------------------
# Host-side preprocessing: rescaling (Ruiz + L2) and device upload
# ---------------------------------------------------------------------------


def _ruiz_and_l2_rescale(
    a: sp.csr_matrix, ruiz_iters: int, l2: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Compute D_r, D_c such that D_r A D_c is well scaled.

    Ruiz L-inf equilibration (reference sharded_optimization_utils.h:94):
    repeatedly divide each row/col by sqrt of its max |entry|.  Then one
    pass of L2 scaling (divide by sqrt of the row/col L2 norm, :103).
    """
    m, n = a.shape
    d_r = np.ones(m)
    d_c = np.ones(n)
    if m == 0 or n == 0 or a.nnz == 0:
        return d_r, d_c
    work = sp.csr_matrix(a, copy=True).astype(np.float64)
    work.eliminate_zeros()
    for _ in range(ruiz_iters):
        abs_w = abs(work)
        row_max = abs_w.max(axis=1).toarray().ravel()
        col_max = abs_w.max(axis=0).toarray().ravel()
        r = np.sqrt(np.where(row_max > 0, row_max, 1.0))
        c = np.sqrt(np.where(col_max > 0, col_max, 1.0))
        d_r /= r
        d_c /= c
        work = sp.diags(1.0 / r) @ work @ sp.diags(1.0 / c)
    if l2:
        sq = work.multiply(work)
        row_norm = np.sqrt(np.asarray(sq.sum(axis=1)).ravel())
        col_norm = np.sqrt(np.asarray(sq.sum(axis=0)).ravel())
        r = np.sqrt(np.where(row_norm > 0, row_norm, 1.0))
        c = np.sqrt(np.where(col_norm > 0, col_norm, 1.0))
        d_r /= r
        d_c /= c
    return d_r, d_c


def build_device_problem(
    qp: QuadraticProgram, params: PdhgParams,
    pad_blocks_to_multiple_of: int = 1,
    row_pad_multiple: int = 128, col_pad_multiple: int = 128,
    spmv_kernel: bool = False,
) -> DeviceProblem:
    """Scale, pad and upload ``qp``.  ``spmv_kernel`` attaches block-row
    pointers so the single-device matvecs run the Triton kernel."""
    qp = qp.as_minimization()
    m, n = qp.num_constraints, qp.num_variables
    a = sp.csr_matrix(qp.constraint_matrix).astype(np.float64)
    if params.l_inf_ruiz_iterations > 0 or params.l2_norm_rescaling:
        d_r, d_c = _ruiz_and_l2_rescale(
            a, params.l_inf_ruiz_iterations, params.l2_norm_rescaling
        )
    else:
        d_r, d_c = np.ones(m), np.ones(n)
    a_scaled = sp.diags(d_r) @ a @ sp.diags(d_c)

    block = params.block_shape or auto_block_shape(m, n, a.nnz)
    dtype = params.dtype
    # Pad both logical dims to multiples of 128 so A (blocks bm x 128) and
    # its stored transpose (also bm x 128 blocks) agree on padded vector
    # lengths: A is (M, N), A^T is (N, M).
    def _lcm(x, y):
        return x * y // math.gcd(x, y)

    mm = -(-max(m, 1) // _lcm(128, row_pad_multiple)) * _lcm(
        128, row_pad_multiple)
    nn = -(-max(n, 1) // _lcm(128, col_pad_multiple)) * _lcm(
        128, col_pad_multiple)
    dev_a = BlockSparseMatrix.from_scipy(
        a_scaled, block_shape=block, dtype=dtype,
        pad_blocks_to_multiple_of=pad_blocks_to_multiple_of,
        padded_shape=(mm, nn),
    )
    # Aᵀ as the per-block transpose of A at block shape (bn, bm): grid
    # symmetry gives the same block count as A with zero extra fill-in
    # (see BlockSparseMatrix.block_transpose), so both SpMV passes stream
    # the same number of bytes.
    dev_at = dev_a.block_transpose()
    if spmv_kernel:
        dev_a, dev_at = dev_a.with_row_ptr(), dev_at.with_row_ptr()

    def padv(v, fill, size):
        out = np.full(size, fill, dtype=np.float64)
        out[: len(v)] = v
        return jnp.asarray(out, dtype=dtype)

    q = qp.objective_matrix_diagonal
    q = np.zeros(n) if q is None else np.asarray(q, dtype=np.float64)

    # Padded variables are fixed at 0 with zero cost; padded constraints are
    # free ([-inf, inf]) so they never generate duals or residuals.
    prob = DeviceProblem(
        a=dev_a,
        at=dev_at,
        c=padv(qp.objective_vector * d_c, 0.0, nn),
        q=padv(q * d_c * d_c, 0.0, nn),
        var_lb=padv(qp.variable_lower / d_c, 0.0, nn),
        var_ub=padv(qp.variable_upper / d_c, 0.0, nn),
        con_lb=padv(qp.constraint_lower * d_r, -np.inf, mm),
        con_ub=padv(qp.constraint_upper * d_r, np.inf, mm),
        orig_c=padv(qp.objective_vector, 0.0, nn),
        orig_q=padv(q, 0.0, nn),
        orig_var_lb=padv(qp.variable_lower, 0.0, nn),
        orig_var_ub=padv(qp.variable_upper, 0.0, nn),
        orig_con_lb=padv(qp.constraint_lower, -np.inf, mm),
        orig_con_ub=padv(qp.constraint_upper, np.inf, mm),
        row_scale=padv(d_r, 1.0, mm),
        col_scale=padv(d_c, 1.0, nn),
        norm_b=jnp.asarray(
            _combined_bounds_norm(qp.constraint_lower, qp.constraint_upper),
            dtype=dtype,
        ),
        norm_c=jnp.asarray(
            float(np.linalg.norm(qp.objective_vector)), dtype=dtype
        ),
    )
    return prob


def _combined_bounds_norm(lo: np.ndarray, hi: np.ndarray) -> float:
    bv = np.maximum(
        np.where(np.isfinite(lo), np.abs(lo), 0.0),
        np.where(np.isfinite(hi), np.abs(hi), 0.0),
    )
    return float(np.linalg.norm(bv))


# ---------------------------------------------------------------------------
# Device kernels: power iteration, PDHG step, stats
# ---------------------------------------------------------------------------


def _make_power_iter(params: PdhgParams, psum: Optional[Callable] = None):
    """sigma_max(A) by power iteration on A^T A (reference
    sharded_optimization_utils.h:179)."""
    steps = params.power_iteration_steps

    def power_iter(prob: DeviceProblem, v0: jax.Array) -> jax.Array:
        mv = _make_matvecs(prob.a, prob.at, psum)

        def body(_, v):
            w = mv.rmatvec(mv.matvec(v))
            return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

        v = jax.lax.fori_loop(0, steps, body, v0 / jnp.linalg.norm(v0))
        return jnp.sqrt(jnp.linalg.norm(mv.rmatvec(mv.matvec(v))))

    return power_iter


class _Matvecs(NamedTuple):
    matvec: Callable[[jax.Array], jax.Array]
    rmatvec: Callable[[jax.Array], jax.Array]


class Comm2D(NamedTuple):
    """2-D (row x col) mesh communication spec for the SpMV pair.

    Device (r, c) holds the blocks of A whose rows fall in row-range r and
    cols in col-range c (equal contiguous ranges).  Iterate vectors stay
    full-length replicated in the PDHG body (all elementwise math and dots
    are then mesh-oblivious); the matvec communicates only SEGMENTS:

        y = all_gather_row( psum_col( A_rc @ x[c-range] ) )
        x = all_gather_col( psum_row( A_rc^T @ y[r-range] ) )

    — per-device collective volume is seg_m + seg_m*(R-1)/R instead of the
    1-D path's full-length psum over all devices (SURVEY §5 long-context
    analogue; reference Sharder's 2-sided products, sharder.h:237)."""

    row_axis: str
    col_axis: str
    seg_m: int  # padded rows per row range
    seg_n: int  # padded cols per col range


def _make_matvecs(
    a: BlockSparseMatrix, at: BlockSparseMatrix, psum
) -> _Matvecs:
    """SpMV closures.  ``psum`` selects the parallel mode: None (single
    device), a psum callable (1-D block sharding: each device holds a slice
    of the block list, full-length partials psum-combined — the device
    analogue of the reference Sharder's per-thread shards +
    ParallelSumOverShards), or a Comm2D (row x col partition)."""
    if psum is None:
        return _Matvecs(a.matvec, at.matvec)
    if isinstance(psum, Comm2D):
        comm = psum

        def mv(x):
            c = jax.lax.axis_index(comm.col_axis)
            x_c = jax.lax.dynamic_slice(x, (c * comm.seg_n,), (comm.seg_n,))
            y_r = jax.lax.psum(a.matvec(x_c), comm.col_axis)
            return jax.lax.all_gather(y_r, comm.row_axis, tiled=True)

        def rmv(y):
            r = jax.lax.axis_index(comm.row_axis)
            y_r = jax.lax.dynamic_slice(y, (r * comm.seg_m,), (comm.seg_m,))
            x_c = jax.lax.psum(at.matvec(y_r), comm.row_axis)
            return jax.lax.all_gather(x_c, comm.col_axis, tiled=True)

        return _Matvecs(mv, rmv)
    return _Matvecs(
        lambda x: psum(a.matvec(x)),
        lambda y: psum(at.matvec(y)),
    )


def _dual_prox(y_hat, sigma, con_lb, con_ub):
    """y' for two-sided constraints: y' = y_hat + sigma*l on the positive
    branch, y_hat + sigma*u on the negative branch, else 0 (SURVEY §3.2;
    keeps exact sign structure so the dual objective never sees 0*inf)."""
    pos = y_hat + sigma * con_lb  # -inf when l = -inf -> branch disabled
    neg = y_hat + sigma * con_ub  # +inf when u = +inf -> branch disabled
    return jnp.where(pos > 0, pos, jnp.where(neg < 0, neg, 0.0))


def _make_iteration(params: PdhgParams, psum: Optional[Callable] = None):
    """Build the jittable single-iteration function.

    ``prob`` is an explicit argument (not a closure) so the same function
    works under shard_map with the matrix blocks sharded over the mesh.
    The step rule follows ``params.linesearch_rule``: the adaptive rule
    (reference TakeAdaptiveStep) or Malitsky-Pock (TakeMalitskyPockStep).
    """
    if params.linesearch_rule == "malitsky_pock":
        return _make_mp_iteration(params, psum)
    reduction_exp = params.step_size_reduction_exponent
    growth_exp = params.step_size_growth_exponent
    max_attempts = params.max_step_attempts

    def iteration(prob: DeviceProblem, state: PdhgState) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at, psum)
        dtype = prob.c.dtype
        tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
        grad = prob.c + prob.q * state.x - state.aty

        def attempt_cond(carry):
            accepted, attempts, *_ = carry
            return jnp.logical_and(~accepted, attempts < max_attempts)

        def attempt_body(carry):
            _, attempts, step, num_steps, _, _, _ = carry
            omega = state.primal_weight
            tau = step / omega
            sigma = step * omega
            x_cand = jnp.clip(state.x - tau * grad, prob.var_lb, prob.var_ub)
            ax_mid = mv.matvec(2.0 * x_cand - state.x)  # SpMV
            y_hat = state.y - sigma * ax_mid
            y_cand = _dual_prox(y_hat, sigma, prob.con_lb, prob.con_ub)
            dx = x_cand - state.x
            dy = y_cand - state.y
            movement = 0.5 * (
                omega * jnp.vdot(dx, dx) + jnp.vdot(dy, dy) / omega
            )
            # A dx = (A(2x'-x) - Ax)/2; for QPs the quadratic objective
            # contributes 1/2 dx^T Q dx to the nonlinearity (without it the
            # step is unconditionally accepted when A dx = 0 and the
            # iteration oscillates).
            interaction = jnp.abs(
                jnp.vdot(dy, ax_mid - state.ax)
            ) * 0.5 + 0.5 * jnp.vdot(dx, prob.q * dx)
            limit = jnp.where(
                interaction > 0, movement / jnp.maximum(interaction, tiny),
                jnp.asarray(np.inf, dtype),
            )
            accepted = step <= limit
            k = (num_steps + 1).astype(dtype)
            first = (1.0 - k ** (-reduction_exp)) * limit
            second = (1.0 + k ** (-growth_exp)) * step
            new_step = jnp.minimum(first, second)
            # Guard against a zero/NaN step killing the solve.
            new_step = jnp.where(
                jnp.isfinite(new_step) & (new_step > 0), new_step, step * 0.5
            )
            return (accepted, attempts + 1, new_step, num_steps + 1,
                    x_cand, y_cand, ax_mid)

        init = (
            jnp.asarray(False),
            jnp.asarray(0, jnp.int32),
            state.step_size,
            state.num_steps,
            state.x,
            state.y,
            state.ax,
        )
        accepted, attempts, new_step, num_steps, x_new, y_new, ax_mid = (
            jax.lax.while_loop(attempt_cond, attempt_body, init)
        )
        # On acceptance: A x_new = (A(2x'-x) + A x)/2; fresh A^T y (SpMV).
        ax_new = 0.5 * (ax_mid + state.ax)
        aty_new = mv.rmatvec(y_new)  # SpMV
        weight = state.step_size
        return PdhgState(
            x=x_new,
            y=y_new,
            ax=ax_new,
            aty=aty_new,
            step_size=new_step,
            primal_weight=state.primal_weight,
            x_sum=state.x_sum + weight * x_new,
            y_sum=state.y_sum + weight * y_new,
            sum_weights=state.sum_weights + weight,
            x_restart=state.x_restart,
            y_restart=state.y_restart,
            num_steps=num_steps,
            num_accepted=state.num_accepted + 1,
            kkt_passes=state.kkt_passes
            + 0.5 * (attempts.astype(dtype) + 1.0),
            step_ratio=state.step_ratio,
        )

    return iteration


def _make_mp_iteration(params: PdhgParams, psum: Optional[Callable] = None):
    """Malitsky-Pock linesearch (reference primal_dual_hybrid_gradient.cc
    :2211 TakeMalitskyPockStep; arXiv:1608.08883).

    One primal prox per outer iteration; the dual linesearch scales the
    candidate step by 0.7 until
        omega * tau * ||A^T(y+ - y)|| <= 0.99 * ||y+ - y||.
    A x+ is recovered from A(extrapolated) by linearity (no extra SpMV).
    Deviation noted: the reference's nonsymmetric average adds the
    pre-step primal iterate on the first accumulation; here the shared
    step-weighted average is used for both primal and dual (one weight
    accumulator), which stays a convex combination of iterates."""
    downscaling = params.mp_step_downscaling
    contraction = params.mp_contraction
    interpolation = params.mp_interpolation
    max_attempts = max(params.max_step_attempts, 60)

    def iteration(prob: DeviceProblem, state: PdhgState) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at, psum)
        dtype = prob.c.dtype
        tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
        omega = state.primal_weight
        grad = prob.c + prob.q * state.x - state.aty
        tau = state.step_size / omega
        x_cand = jnp.clip(state.x - tau * grad, prob.var_lb, prob.var_ub)
        dx = x_cand - state.x
        dilating = 1.0 + interpolation * (
            jnp.sqrt(1.0 + state.step_ratio) - 1.0)
        tau0 = tau * dilating

        def cond(carry):
            accepted, attempts, *_ = carry
            return jnp.logical_and(~accepted, attempts < max_attempts)

        def body(carry):
            _, attempts, tau_new, _, _, _, _ = carry
            theta = tau_new / jnp.maximum(tau, tiny)
            sigma = omega * omega * tau_new
            ax_e = mv.matvec(x_cand + theta * dx)  # SpMV
            y_hat = state.y - sigma * ax_e
            y_cand = _dual_prox(y_hat, sigma, prob.con_lb, prob.con_ub)
            aty_cand = mv.rmatvec(y_cand)  # SpMV
            dy_norm = jnp.sqrt(jnp.vdot(y_cand - state.y,
                                        y_cand - state.y))
            dprod_norm = jnp.sqrt(jnp.vdot(aty_cand - state.aty,
                                           aty_cand - state.aty))
            accepted = (omega * tau_new * dprod_norm
                        <= contraction * dy_norm)
            next_tau = jnp.where(accepted, tau_new, downscaling * tau_new)
            return (accepted, attempts + 1, next_tau, theta, y_cand,
                    ax_e, aty_cand)

        init = (jnp.asarray(False), jnp.asarray(0, jnp.int32), tau0,
                state.step_ratio, state.y, state.ax, state.aty)
        accepted, attempts, tau_acc, theta, y_new, ax_e, aty_new = (
            jax.lax.while_loop(cond, body, init)
        )
        # A x_cand from A(x_cand + theta dx) and A x by linearity.
        ax_new = (ax_e + theta * state.ax) / (1.0 + theta)
        weight = tau_acc
        return PdhgState(
            x=x_cand,
            y=y_new,
            ax=ax_new,
            aty=aty_new,
            step_size=tau_acc * omega,
            primal_weight=omega,
            x_sum=state.x_sum + weight * x_cand,
            y_sum=state.y_sum + weight * y_new,
            sum_weights=state.sum_weights + weight,
            x_restart=state.x_restart,
            y_restart=state.y_restart,
            num_steps=state.num_steps + attempts,
            num_accepted=state.num_accepted + 1,
            kkt_passes=state.kkt_passes + attempts.astype(dtype),
            step_ratio=theta,
        )

    return iteration


def _make_run_major(params: PdhgParams, psum: Optional[Callable] = None):
    iteration = _make_iteration(params, psum)
    freq = params.termination_check_frequency

    def run_major(prob: DeviceProblem, state: PdhgState) -> PdhgState:
        return jax.lax.fori_loop(
            0, freq, lambda _, s: iteration(prob, s), state
        )

    return run_major


def _norm(v: jax.Array, norm: OptimalityNorm) -> jax.Array:
    if norm == OptimalityNorm.L_INF:
        return jnp.max(jnp.abs(v)) if v.size else jnp.asarray(0.0, v.dtype)
    return jnp.sqrt(jnp.vdot(v, v))


def _iterate_stats(prob: DeviceProblem, x, y, ax, aty,
                   norm: OptimalityNorm) -> dict:
    """Residuals/objectives of one (scaled-space) iterate, computed in the
    ORIGINAL problem space (reference iteration_stats.cc:180-316)."""
    inv_row = 1.0 / prob.row_scale
    inv_col = 1.0 / prob.col_scale
    x_o = prob.col_scale * x
    y_o = prob.row_scale * y
    ax_o = ax * inv_row
    aty_o = aty * inv_col

    primal_viol = jnp.maximum(prob.orig_con_lb - ax_o, 0.0) + jnp.maximum(
        ax_o - prob.orig_con_ub, 0.0
    )
    r = prob.orig_c + prob.orig_q * x_o - aty_o  # primal gradient
    lb_finite = jnp.isfinite(prob.orig_var_lb)
    ub_finite = jnp.isfinite(prob.orig_var_ub)
    reduced_costs = jnp.where(
        r > 0,
        jnp.where(lb_finite, r, 0.0),
        jnp.where(ub_finite, r, 0.0),
    )
    dual_viol = r - reduced_costs

    # Objective-gap reductions run compensated (df32) in f32: the gap
    # criterion at 1e-6 relative sits right at f32 summation noise for
    # large n (ops/df32.py; ROADMAP "selective df32" item).
    if x_o.dtype == jnp.float32:
        from ortools_tpu.ops.df32 import sum_df32 as _sm, vdot_df32 as _vd
    else:
        _vd, _sm = jnp.vdot, jnp.sum
    primal_obj = _vd(prob.orig_c, x_o) + 0.5 * _vd(prob.orig_q, x_o * x_o)
    # Dual objective: constraint-bound term l^T[y]+ - u^T[y]- plus the
    # variable-bound term for absorbed reduced costs, minus the quadratic
    # correction; sign-split with `where` so 0*inf never appears.
    con_term = _sm(
        jnp.where(y_o > 0, prob.orig_con_lb * y_o, 0.0)
        + jnp.where(y_o < 0, prob.orig_con_ub * y_o, 0.0)
    )
    var_term = _sm(
        jnp.where(reduced_costs > 0, prob.orig_var_lb * reduced_costs, 0.0)
        + jnp.where(reduced_costs < 0, prob.orig_var_ub * reduced_costs, 0.0)
    )
    dual_obj = con_term + var_term - 0.5 * _vd(prob.orig_q, x_o * x_o)

    # A *valid* lower bound on the optimum from y alone: the exact
    # Lagrangian dual value  con_term(y) + sum_i min_{x_i in [lb,ub]}
    # (r0_i x_i + q_i x_i^2 / 2)  with r0 = c - A^T y.  Unlike
    # dual_objective above (which drops wrong-sign reduced costs as
    # "residuals", reference iteration_stats.cc:180-236), this is safe to
    # prune on even for unconverged iterates: entries whose minimum is
    # -inf propagate -inf.  Used by mip/branch_and_bound node pruning.
    r0 = prob.orig_c - aty_o
    q = prob.orig_q
    lin_term = jnp.where(r0 > 0, r0 * prob.orig_var_lb, 0.0) + jnp.where(
        r0 < 0, r0 * prob.orig_var_ub, 0.0
    )
    xq = jnp.clip(-r0 / jnp.where(q > 0, q, 1.0), prob.orig_var_lb,
                  prob.orig_var_ub)
    quad_term = r0 * xq + 0.5 * q * xq * xq
    dual_bound = con_term + jnp.sum(jnp.where(q > 0, quad_term, lin_term))

    return dict(
        primal_objective=primal_obj,
        dual_objective=dual_obj,
        dual_bound=dual_bound,
        primal_residual=_norm(primal_viol, norm),
        dual_residual=_norm(dual_viol, norm),
        reduced_costs=reduced_costs,
    )


def _infeasibility_stats(prob: DeviceProblem, x_r, y_r,
                         mv: "_Matvecs") -> dict:
    """Certificate quality of candidate rays (reference
    iteration_stats.h:68 ComputeInfeasibilityInformation).

    Primal ray x_r proves DUAL infeasibility (unboundedness) when it is a
    recession direction with negative objective; dual ray y_r proves
    PRIMAL infeasibility when its residual vanishes and its objective is
    positive.  Rays are given in scaled space and unscaled here.
    """
    x_o = prob.col_scale * x_r
    y_o = prob.row_scale * y_r
    ax_o = mv.matvec(x_r) / prob.row_scale
    aty_o = mv.rmatvec(y_r) / prob.col_scale

    # -- primal ray: recession cone of constraints and variable bounds
    lb_fin_row = jnp.isfinite(prob.orig_con_lb)
    ub_fin_row = jnp.isfinite(prob.orig_con_ub)
    row_viol = jnp.maximum(
        jnp.where(lb_fin_row, -ax_o, 0.0), 0.0
    ) + jnp.maximum(jnp.where(ub_fin_row, ax_o, 0.0), 0.0)
    lb_fin = jnp.isfinite(prob.orig_var_lb)
    ub_fin = jnp.isfinite(prob.orig_var_ub)
    var_viol = jnp.maximum(jnp.where(lb_fin, -x_o, 0.0), 0.0) + jnp.maximum(
        jnp.where(ub_fin, x_o, 0.0), 0.0
    )
    max_primal_ray_infeas = jnp.maximum(
        jnp.max(row_viol) if row_viol.size else 0.0,
        jnp.max(var_viol) if var_viol.size else 0.0,
    )
    primal_ray_objective = jnp.vdot(prob.orig_c, x_o)
    ray_norm_x = jnp.max(jnp.abs(x_o)) if x_o.size else jnp.asarray(0.0)
    # a valid unboundedness ray of a convex QP needs Q x_r = 0
    max_quadratic_ray = jnp.max(jnp.abs(prob.orig_q * x_o))

    # -- dual ray: -A^T y absorbed on finite variable bounds
    r = -aty_o
    rc = jnp.where(r > 0, jnp.where(lb_fin, r, 0.0),
                   jnp.where(ub_fin, r, 0.0))
    dual_res = jnp.abs(r - rc)
    # wrong-sign duals at one-sided rows are residuals too
    wrong_sign = jnp.maximum(
        jnp.where(~lb_fin_row, y_o, 0.0), 0.0
    ) + jnp.maximum(jnp.where(~ub_fin_row, -y_o, 0.0), 0.0)
    max_dual_ray_infeas = jnp.maximum(
        jnp.max(dual_res) if dual_res.size else 0.0,
        jnp.max(wrong_sign) if wrong_sign.size else 0.0,
    )
    dual_ray_objective = (
        jnp.sum(jnp.where((y_o > 0) & lb_fin_row,
                          prob.orig_con_lb * y_o, 0.0))
        + jnp.sum(jnp.where((y_o < 0) & ub_fin_row,
                            prob.orig_con_ub * y_o, 0.0))
        + jnp.sum(jnp.where(rc > 0, prob.orig_var_lb * rc, 0.0))
        + jnp.sum(jnp.where(rc < 0, prob.orig_var_ub * rc, 0.0))
    )
    ray_norm_y = jnp.max(jnp.abs(y_o)) if y_o.size else jnp.asarray(0.0)
    return dict(
        max_primal_ray_infeasibility=max_primal_ray_infeas,
        primal_ray_objective=primal_ray_objective,
        ray_norm_x=ray_norm_x,
        max_quadratic_ray=max_quadratic_ray,
        max_dual_ray_infeasibility=max_dual_ray_infeas,
        dual_ray_objective=dual_ray_objective,
        ray_norm_y=ray_norm_y,
    )


def _make_compute_stats(params: PdhgParams,
                        psum: Optional[Callable] = None):
    norm = params.optimality_norm

    def compute_stats(prob: DeviceProblem, state: PdhgState) -> dict:
        mv = _make_matvecs(prob.a, prob.at, psum)
        ax_c, aty_c = state.ax, state.aty
        cur = _iterate_stats(prob, state.x, state.y, ax_c, aty_c, norm)
        w = jnp.maximum(state.sum_weights, 1e-30)
        x_avg = state.x_sum / w
        y_avg = state.y_sum / w
        has_avg = state.sum_weights > 0
        x_avg = jnp.where(has_avg, x_avg, state.x)
        y_avg = jnp.where(has_avg, y_avg, state.y)
        ax_avg = mv.matvec(x_avg)
        aty_avg = mv.rmatvec(y_avg)
        avg = _iterate_stats(prob, x_avg, y_avg, ax_avg, aty_avg, norm)
        omega = state.primal_weight

        def kkt(s):
            gap = s["primal_objective"] - s["dual_objective"]
            return jnp.sqrt(
                omega**2 * s["primal_residual"] ** 2
                + s["dual_residual"] ** 2 / omega**2
                + gap**2
            )

        # Seeded Gaussian random projections of the iterates (reference
        # SetRandomProjections, iteration_stats.cc:321-346) — cheap
        # convergence diagnostics recorded in the iteration log.
        projections = {}
        for seed in params.random_projection_seeds:
            kx = jax.random.normal(jax.random.PRNGKey(seed),
                                   state.x.shape, state.x.dtype)
            ky = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                   state.y.shape, state.y.dtype)
            nx = jnp.sqrt(jnp.asarray(state.x.shape[0], state.x.dtype))
            ny = jnp.sqrt(jnp.asarray(state.y.shape[0], state.y.dtype))
            projections[f"primal_{seed}"] = jnp.vdot(kx, state.x) / nx
            projections[f"dual_{seed}"] = jnp.vdot(ky, state.y) / ny

        out = dict(
            current={k: v for k, v in cur.items() if k != "reduced_costs"},
            average={k: v for k, v in avg.items() if k != "reduced_costs"},
            projections=projections,
            kkt_current=kkt(cur),
            kkt_average=kkt(avg),
            x_avg=x_avg,
            y_avg=y_avg,
            num_steps=state.num_steps,
            num_accepted=state.num_accepted,
            kkt_passes=state.kkt_passes + 1.0,  # this stats pass
            step_size=state.step_size,
            primal_weight=state.primal_weight,
            # infeasibility certificate candidates (reference uses the
            # iterate difference and the current iterate as rays)
            infeas_diff=_infeasibility_stats(
                prob, state.x - state.x_restart,
                state.y - state.y_restart, mv,
            ),
            infeas_current=_infeasibility_stats(prob, state.x, state.y, mv),
        )
        if params.restart_strategy == RestartStrategy.ADAPTIVE_HEURISTIC:
            from ortools_tpu.pdlp import trust_region as _tr

            out["tr_current"] = _tr.localized_gap(
                prob, state.x, state.y, ax_c, aty_c,
                state.x_restart, state.y_restart, omega,
            )._asdict()
            out["tr_average"] = _tr.localized_gap(
                prob, x_avg, y_avg, ax_avg, aty_avg,
                state.x_restart, state.y_restart, omega,
            )._asdict()
        return out

    return compute_stats


def _make_apply_restart(params: PdhgParams,
                        psum: Optional[Callable] = None):
    smoothing = params.primal_weight_update_smoothing

    def apply_restart(prob: DeviceProblem, state: PdhgState,
                      use_avg: jax.Array,
                      x_avg: jax.Array, y_avg: jax.Array) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at, psum)
        dtype = prob.c.dtype
        x_new = jnp.where(use_avg, x_avg, state.x)
        y_new = jnp.where(use_avg, y_avg, state.y)
        ax = mv.matvec(x_new)
        aty = mv.rmatvec(y_new)
        # Primal weight update from distance traveled since last restart
        # (reference ComputeNewPrimalWeight, :1983-2011).
        dp = jnp.linalg.norm(x_new - state.x_restart)
        dd = jnp.linalg.norm(y_new - state.y_restart)
        valid = (dp > 1e-30) & (dd > 1e-30) & jnp.isfinite(dp) & jnp.isfinite(dd)
        new_w = jnp.exp(
            smoothing * jnp.log(jnp.maximum(dd, 1e-30) / jnp.maximum(dp, 1e-30))
            + (1.0 - smoothing) * jnp.log(state.primal_weight)
        )
        omega = jnp.where(valid, new_w, state.primal_weight).astype(dtype)
        zeros_x = jnp.zeros_like(state.x)
        zeros_y = jnp.zeros_like(state.y)
        return PdhgState(
            x=x_new, y=y_new, ax=ax, aty=aty,
            step_size=state.step_size,
            primal_weight=omega,
            x_sum=zeros_x, y_sum=zeros_y,
            sum_weights=jnp.zeros_like(state.sum_weights),
            x_restart=x_new, y_restart=y_new,
            num_steps=state.num_steps,
            num_accepted=state.num_accepted,
            kkt_passes=state.kkt_passes + 1.0,
            step_ratio=state.step_ratio,
        )

    return apply_restart


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def _make_initial_state(params: PdhgParams, psum: Optional[Callable] = None):
    def initial_state(prob: DeviceProblem, sigma_max: jax.Array) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at, psum)
        dtype = prob.c.dtype
        n = prob.c.shape[0]
        m = prob.con_lb.shape[0]
        x0 = jnp.clip(jnp.zeros(n, dtype), prob.var_lb, prob.var_ub)
        y0 = jnp.zeros(m, dtype)
        # For QPs the curvature of Q also bounds the step (lam_max(diag q) =
        # max q); without constraints sigma_max(A) can be 0.
        curvature = jnp.maximum(sigma_max, jnp.max(prob.q))
        step0 = jnp.asarray(
            params.initial_step_size_scaling, dtype
        ) / jnp.maximum(curvature, 1e-30)
        if params.initial_primal_weight is not None:
            w0 = jnp.asarray(params.initial_primal_weight, dtype)
        else:
            # ||c|| / ||b|| when both positive else 1 (reference :1268).
            w0 = jnp.where(
                (prob.norm_c > 0) & (prob.norm_b > 0),
                prob.norm_c / jnp.maximum(prob.norm_b, 1e-30),
                jnp.asarray(1.0, dtype),
            )
        return PdhgState(
            x=x0,
            y=y0,
            ax=mv.matvec(x0),
            aty=mv.rmatvec(y0),
            step_size=step0.astype(dtype),
            primal_weight=w0.astype(dtype),
            x_sum=jnp.zeros(n, dtype),
            y_sum=jnp.zeros(m, dtype),
            sum_weights=jnp.asarray(0.0, dtype),
            x_restart=x0,
            y_restart=y0,
            num_steps=jnp.asarray(0, jnp.int32),
            num_accepted=jnp.asarray(0, jnp.int32),
            kkt_passes=jnp.asarray(1.0, dtype),
            step_ratio=jnp.asarray(1.0, dtype),
        )

    return initial_state


def _make_warm_state(params: PdhgParams, psum=None):
    """State from a given (x0, y0) start with inherited step/weight —
    the feasibility-polishing entry point (reference Solver ctor with
    starting solutions, primal_dual_hybrid_gradient.cc:2594-2599)."""

    def warm_state(prob: DeviceProblem, x0, y0, step, weight) -> PdhgState:
        mv = _make_matvecs(prob.a, prob.at, psum)
        dtype = prob.c.dtype
        x0 = jnp.clip(x0.astype(dtype), prob.var_lb, prob.var_ub)
        y0 = y0.astype(dtype)
        return PdhgState(
            x=x0,
            y=y0,
            ax=mv.matvec(x0),
            aty=mv.rmatvec(y0),
            step_size=step.astype(dtype),
            primal_weight=weight.astype(dtype),
            x_sum=jnp.zeros_like(x0),
            y_sum=jnp.zeros_like(y0),
            sum_weights=jnp.asarray(0.0, dtype),
            x_restart=x0,
            y_restart=y0,
            num_steps=jnp.asarray(0, jnp.int32),
            num_accepted=jnp.asarray(0, jnp.int32),
            kkt_passes=jnp.asarray(1.0, dtype),
            step_ratio=jnp.asarray(1.0, dtype),
        )

    return warm_state


def _check_optimality(stats: dict, prob_consts: dict, params: PdhgParams,
                      require: Tuple[str, ...] = ("gap", "primal", "dual"),
                      ) -> bool:
    """Optimality per the reference detailed criteria; ``require`` masks
    which parts must hold (feasibility polishing sets the others to
    infinity, primal_dual_hybrid_gradient.cc:2585/2656)."""
    eps_a = params.eps_optimal_absolute
    eps_r = params.eps_optimal_relative
    nb, nc = prob_consts["norm_b"], prob_consts["norm_c"]
    p, d = stats["primal_objective"], stats["dual_objective"]
    ok = True
    if "gap" in require:
        ok &= abs(p - d) <= eps_a + eps_r * (abs(p) + abs(d))
    if "primal" in require:
        ok &= stats["primal_residual"] <= eps_a + eps_r * nb
    if "dual" in require:
        ok &= stats["dual_residual"] <= eps_a + eps_r * nc
    return bool(ok)


def params_cache_key(params: PdhgParams) -> tuple:
    """Hashable identity of a PdhgParams for the jitted-function cache."""
    vals = []
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if isinstance(v, list):
            v = tuple(v)
        vals.append((f.name, v))
    return tuple(vals)


_SINGLE_FN_CACHE: dict = {}


def _single_device_fns(params: PdhgParams) -> dict:
    """Memoized jitted function bundle for the single-device path.

    Rebuilding closures per solve() call makes every call retrace (new
    function identities) — a cost every B&B workload that solves hundreds
    of LPs would pay per call.  One bundle per distinct params value; jit
    itself handles new problem shapes by retracing the SAME callable
    (compiled programs are reused per shape)."""
    key = params_cache_key(params)
    fns = _SINGLE_FN_CACHE.get(key)
    if fns is None:
        fns = dict(
            run_major=jax.jit(_make_run_major(params)),
            compute_stats=jax.jit(_make_compute_stats(params)),
            apply_restart=jax.jit(_make_apply_restart(params)),
            power_iter=jax.jit(_make_power_iter(params)),
            initial_state=jax.jit(_make_initial_state(params)),
            final_iterate=jax.jit(_make_final_iterate(
                params.optimality_norm)),
            warm_state=jax.jit(_make_warm_state(params)),
        )
        _SINGLE_FN_CACHE[key] = fns
    return fns


def solve(
    qp: QuadraticProgram,
    params: Optional[PdhgParams] = None,
    mesh: Optional[jax.sharding.Mesh] = None,
) -> SolveResult:
    """Solve an LP/QP with restarted adaptive PDHG.

    With ``mesh`` given (a 1-D jax Mesh), the constraint-matrix block list is
    sharded over the mesh axis and SpMV partials are psum-combined; vectors
    are replicated (the reference Sharder's design, SURVEY §2.15).
    """
    params = params or PdhgParams()
    perrs = params.validate()
    if perrs:
        return _invalid_result(qp, TerminationReason.INVALID_PARAMETER)
    errs = qp.validate()
    if errs:
        return _invalid_result(qp, TerminationReason.INVALID_PROBLEM)
    start = time.perf_counter()
    qp_min = qp.as_minimization()
    sign = -1.0 if qp.maximize else 1.0

    if params.presolve:
        return _solve_with_presolve(qp, params, mesh, start)

    if mesh is not None and len(mesh.shape) == 2:
        # 2-D row x col partition: segment collectives (Comm2D).
        prob, psum = build_2d_problem(qp_min, params, mesh)
        pspec = _problem_specs_2d(prob, *mesh.axis_names)
        P = jax.sharding.PartitionSpec

        def wrap(fn, n_args):
            sm = jax.shard_map(
                fn, mesh=mesh, in_specs=(pspec,) + (P(),) * n_args,
                out_specs=P(), check_vma=False,
            )
            return jax.jit(sm)
    elif mesh is not None:
        axis = params.mesh_axis
        psum = functools.partial(jax.lax.psum, axis_name=axis)
        prob = build_device_problem(
            qp_min, params, pad_blocks_to_multiple_of=mesh.devices.size
        )
        prob = _place_problem(prob, mesh, axis)
        pspec = _problem_specs(prob, axis)
        P = jax.sharding.PartitionSpec

        def wrap(fn, n_args):
            sm = jax.shard_map(
                fn, mesh=mesh, in_specs=(pspec,) + (P(),) * n_args,
                out_specs=P(), check_vma=False,
            )
            return jax.jit(sm)
    else:
        psum = None
        prob = build_device_problem(qp_min, params,
                                    spmv_kernel=is_accelerator())

    if psum is None:
        # Memoized bundle: repeated solve() calls (B&B nodes, batteries)
        # reuse the SAME jitted callables instead of retracing every call.
        fns = _single_device_fns(params)
        run_major = fns["run_major"]
        compute_stats = fns["compute_stats"]
        apply_restart = fns["apply_restart"]
        power_iter = fns["power_iter"]
        initial_state = fns["initial_state"]
        final_iterate = fns["final_iterate"]
        warm_state = fns["warm_state"]
    else:
        run_major = wrap(_make_run_major(params, psum), 1)
        compute_stats = wrap(_make_compute_stats(params, psum), 1)
        apply_restart = wrap(_make_apply_restart(params, psum), 4)
        power_iter = wrap(_make_power_iter(params, psum), 1)
        initial_state = wrap(_make_initial_state(params, psum), 1)
        final_iterate = wrap(
            _make_final_iterate(params.optimality_norm, psum), 2
        )
        warm_state = wrap(_make_warm_state(params, psum), 4)
    v0 = jax.random.normal(
        jax.random.PRNGKey(0), (prob.c.shape[0],), dtype=prob.c.dtype
    )
    sigma_max = power_iter(prob, v0)
    state = initial_state(prob, sigma_max)
    prob_consts = dict(
        norm_b=float(prob.norm_b), norm_c=float(prob.norm_c)
    )

    log: List[dict] = []
    reason = TerminationReason.ITERATION_LIMIT
    best = None  # (which, stats_dict, x, y) chosen at termination
    kkt_at_last_restart = math.inf
    last_candidate_kkt = math.inf
    normalized_gap_at_last_restart = math.inf
    normalized_gap_at_last_trial = math.inf
    iters_at_last_restart = 0
    iterations = 0
    next_polish = 16 * params.termination_check_frequency
    polish_work = 0  # polishing iterations, counted into kkt passes only

    def _zero_finite(v):
        return jnp.where(jnp.isfinite(v), jnp.zeros_like(v), v)

    def _polish_phase(pprob, pconsts, state0, budget, require):
        """Run the solver on a modified problem until the masked criteria
        hold; returns (x, y, iters) or None on budget/numerical failure."""
        st = state0
        it = 0
        kkt_last = math.inf
        while it < budget:
            st = run_major(pprob, st)
            it += params.termination_check_frequency
            stats_p = compute_stats(pprob, st)
            curp = {k: float(v) for k, v in stats_p["current"].items()}
            avgp = {k: float(v) for k, v in stats_p["average"].items()}
            kkt_c = float(stats_p["kkt_current"])
            kkt_a = float(stats_p["kkt_average"])
            if not math.isfinite(kkt_c):
                return None
            if _check_optimality(curp, pconsts, params, require):
                return st.x, st.y, it
            if _check_optimality(avgp, pconsts, params, require):
                return stats_p["x_avg"], stats_p["y_avg"], it
            cand = min(kkt_a, kkt_c)
            if math.isinf(kkt_last):
                kkt_last = cand
            elif cand <= params.sufficient_reduction_for_restart * kkt_last:
                st = apply_restart(pprob, st, jnp.asarray(kkt_a <= kkt_c),
                                   stats_p["x_avg"], stats_p["y_avg"])
                kkt_last = cand
        return None

    def _try_feasibility_polishing(stats, avg_stats):
        """Reference TryFeasibilityPolishing (:2442): gate on the
        objective gap, then primal polishing (zero objective) and dual
        polishing (finite bounds zeroed), both warm-started; accept only
        when the combined point passes the FULL criteria."""
        nonlocal polish_work
        if not _check_optimality(avg_stats, prob_consts, params, ("gap",)):
            return None
        budget = max(iterations // 8, params.termination_check_frequency)
        zero_c = jnp.zeros_like(prob.c)
        prob_p = prob._replace(c=zero_c, q=jnp.zeros_like(prob.q),
                               orig_c=jnp.zeros_like(prob.orig_c),
                               orig_q=jnp.zeros_like(prob.orig_q),
                               norm_c=jnp.zeros_like(prob.norm_c))
        consts_p = dict(norm_b=prob_consts["norm_b"], norm_c=0.0)
        st_p = warm_state(prob_p, stats["x_avg"],
                          jnp.zeros_like(state.y), state.step_size,
                          state.primal_weight)
        rp = _polish_phase(prob_p, consts_p, st_p, budget, ("primal",))
        if rp is None:
            return None
        polish_work += rp[2]
        prob_d = prob._replace(
            con_lb=_zero_finite(prob.con_lb),
            con_ub=_zero_finite(prob.con_ub),
            var_lb=_zero_finite(prob.var_lb),
            var_ub=_zero_finite(prob.var_ub),
            orig_con_lb=_zero_finite(prob.orig_con_lb),
            orig_con_ub=_zero_finite(prob.orig_con_ub),
            orig_var_lb=_zero_finite(prob.orig_var_lb),
            orig_var_ub=_zero_finite(prob.orig_var_ub),
            norm_b=jnp.zeros_like(prob.norm_b),
        )
        consts_d = dict(norm_b=0.0, norm_c=prob_consts["norm_c"])
        st_d = warm_state(prob_d, jnp.zeros_like(state.x), stats["y_avg"],
                          state.step_size, state.primal_weight)
        rd = _polish_phase(prob_d, consts_d, st_d, budget, ("dual",))
        if rd is None:
            return None
        polish_work += rd[2]
        x_pol, y_pol = rp[0], rd[1]
        st_f = warm_state(prob, x_pol, y_pol, state.step_size,
                          state.primal_weight)
        stats_f = compute_stats(prob, st_f)
        curf = {k: float(v) for k, v in stats_f["current"].items()}
        if _check_optimality(curf, prob_consts, params):
            return ("polished", curf, st_f.x, st_f.y)
        return None

    while True:
        if iterations >= params.iteration_limit:
            reason = TerminationReason.ITERATION_LIMIT
            break
        if time.perf_counter() - start > params.time_sec_limit:
            reason = TerminationReason.TIME_LIMIT
            break
        state = run_major(prob, state)
        iterations += params.termination_check_frequency
        stats = compute_stats(prob, state)
        cur = {k: float(v) for k, v in stats["current"].items()}
        avg = {k: float(v) for k, v in stats["average"].items()}
        kkt_cur = float(stats["kkt_current"])
        kkt_avg = float(stats["kkt_average"])
        kkt_passes = float(stats["kkt_passes"])
        if params.record_iteration_stats or params.verbosity >= 2:
            rec = dict(iteration=iterations, current=cur, average=avg,
                       kkt_current=kkt_cur, kkt_average=kkt_avg,
                       step_size=float(stats["step_size"]),
                       primal_weight=float(stats["primal_weight"]),
                       kkt_passes=kkt_passes)
            if stats.get("projections"):
                rec["point_metadata"] = {
                    k: float(v) for k, v in stats["projections"].items()}
            log.append(rec)
        if params.verbosity >= 2:
            print(
                f"iter={iterations} kkt_cur={kkt_cur:.3e} kkt_avg={kkt_avg:.3e}"
                f" pobj={cur['primal_objective']:.8e}"
                f" pres={cur['primal_residual']:.2e}"
                f" dres={cur['dual_residual']:.2e}"
                f" w={float(stats['primal_weight']):.2e}"
            )
        if not math.isfinite(kkt_cur):
            reason = TerminationReason.NUMERICAL_ERROR
            best = ("average", avg, stats["x_avg"], stats["y_avg"])
            break
        # Termination: check both current and average (reference checks all
        # candidate points).
        if _check_optimality(cur, prob_consts, params):
            reason = TerminationReason.OPTIMAL
            best = ("current", cur, state.x, state.y)
            break
        if _check_optimality(avg, prob_consts, params):
            reason = TerminationReason.OPTIMAL
            best = ("average", avg, stats["x_avg"], stats["y_avg"])
            break
        if kkt_passes >= params.kkt_matrix_pass_limit:
            reason = TerminationReason.KKT_MATRIX_PASS_LIMIT
            break

        if (params.use_feasibility_polishing
                and iterations >= next_polish):
            polished = _try_feasibility_polishing(stats, avg)
            next_polish *= 2
            if polished is not None:
                reason = TerminationReason.OPTIMAL
                best = polished
                break

        # Infeasibility certificates from candidate rays (reference
        # termination.h:74 kIterateTermination infeasibility branch).
        infeas_reason = None
        for key in ("infeas_diff", "infeas_current"):
            inf = {k: float(v) for k, v in stats[key].items()}
            ny, nx = inf["ray_norm_y"], inf["ray_norm_x"]
            if (ny > 0
                    and inf["max_dual_ray_infeasibility"]
                    <= params.eps_primal_infeasible * ny
                    and inf["dual_ray_objective"] > 0):
                infeas_reason = TerminationReason.PRIMAL_INFEASIBLE
                break
            if (nx > 0
                    and inf["max_primal_ray_infeasibility"]
                    <= params.eps_dual_infeasible * nx
                    and inf["max_quadratic_ray"]
                    <= params.eps_dual_infeasible * nx
                    and inf["primal_ray_objective"] < 0):
                infeas_reason = TerminationReason.DUAL_INFEASIBLE
                break
        if infeas_reason is not None:
            reason = infeas_reason
            best = ("current", cur, state.x, state.y)
            break

        # Restart decision (host scalars only).
        do_restart = False
        use_avg = kkt_avg <= kkt_cur
        cand_kkt = min(kkt_avg, kkt_cur)
        cand_norm_gap = None
        strat = params.restart_strategy
        if strat == RestartStrategy.EVERY_MAJOR_ITERATION:
            do_restart = True
        elif strat == RestartStrategy.ADAPTIVE_HEURISTIC:
            # Reference ChooseRestartToApply
            # (primal_dual_hybrid_gradient.cc:1904): candidates compared
            # by gap/radius^2; restart on sufficient reduction of
            # gap/radius vs the last restart, on necessary reduction with
            # the gap worsening since the last trial, or (forced) when
            # the averaging window spans half the iterations so far.
            tr_cur = {k: float(v) for k, v in stats["tr_current"].items()}
            tr_avg = {k: float(v) for k, v in stats["tr_average"].items()}
            use_avg = tr_avg["potential"] < tr_cur["potential"]
            cand = tr_avg if use_avg else tr_cur
            cand_norm_gap = cand["normalized_gap"]
            restart_len = iterations - iters_at_last_restart
            forced = restart_len >= iterations / 2
            if forced:
                do_restart = True
            elif math.isfinite(normalized_gap_at_last_restart):
                ratio = cand_norm_gap / max(
                    normalized_gap_at_last_restart, 1e-300
                )
                if ratio < params.sufficient_reduction_for_restart:
                    do_restart = True
                elif (ratio < params.necessary_reduction_for_restart
                      and cand_norm_gap > normalized_gap_at_last_trial):
                    do_restart = True
        elif strat == RestartStrategy.ADAPTIVE_KKT:
            if math.isinf(kkt_at_last_restart):
                kkt_at_last_restart = cand_kkt
            else:
                suff = cand_kkt <= (
                    params.sufficient_reduction_for_restart * kkt_at_last_restart
                )
                nec = cand_kkt <= (
                    params.necessary_reduction_for_restart * kkt_at_last_restart
                ) and cand_kkt > last_candidate_kkt
                long_interval = (
                    iterations - iters_at_last_restart
                    >= params.artificial_restart_threshold * iterations
                )
                do_restart = suff or nec or long_interval
        last_candidate_kkt = cand_kkt
        if do_restart:
            state = apply_restart(
                prob, state, jnp.asarray(use_avg),
                stats["x_avg"], stats["y_avg"],
            )
            kkt_at_last_restart = cand_kkt
            last_candidate_kkt = math.inf
            iters_at_last_restart = iterations
            if cand_norm_gap is not None:
                # reference re-evaluates at the new start point with the
                # new primal weight; the candidate's value is the same
                # quantity up to the weight update
                normalized_gap_at_last_restart = cand_norm_gap
                normalized_gap_at_last_trial = math.inf
            if params.verbosity >= 2:
                print(f"  restart(to_{'avg' if use_avg else 'cur'}) "
                      f"w={float(state.primal_weight):.3e}")
        elif cand_norm_gap is not None:
            if not math.isfinite(normalized_gap_at_last_restart):
                normalized_gap_at_last_restart = cand_norm_gap
            else:
                normalized_gap_at_last_trial = cand_norm_gap

    if best is None:
        # Terminated by a limit: report the better of current/average.
        stats = compute_stats(prob, state)
        cur = {k: float(v) for k, v in stats["current"].items()}
        avg = {k: float(v) for k, v in stats["average"].items()}
        if float(stats["kkt_average"]) < float(stats["kkt_current"]):
            best = ("average", avg, stats["x_avg"], stats["y_avg"])
        else:
            best = ("current", cur, state.x, state.y)

    which, bstats, x_dev, y_dev = best
    # Unscale and unpad; recompute reduced costs for the reported iterate.
    final = final_iterate(prob, x_dev, y_dev)
    n, m = qp.num_variables, qp.num_constraints
    x = np.asarray(final["x"], dtype=np.float64)[:n]
    y = np.asarray(final["y"], dtype=np.float64)[:m]
    rc = np.asarray(final["reduced_costs"], dtype=np.float64)[:n]

    pobj = sign * (bstats["primal_objective"] + qp_min.objective_constant)
    dobj = sign * (bstats["dual_objective"] + qp_min.objective_constant)
    denom = abs(pobj) + abs(dobj)
    rel_gap = abs(pobj - dobj) / (1.0 + denom)
    return SolveResult(
        termination_reason=reason,
        primal_solution=x,
        dual_solution=sign * y,
        reduced_costs=sign * rc,
        primal_objective=pobj,
        dual_objective=dobj,
        primal_residual=bstats["primal_residual"],
        dual_residual=bstats["dual_residual"],
        relative_gap=rel_gap,
        iterations=iterations,
        kkt_matrix_passes=float(state.kkt_passes),
        solve_time_sec=time.perf_counter() - start,
        iteration_stats=log,
    )


def _make_final_iterate(norm, psum=None):
    def final_iterate(prob: DeviceProblem, x, y) -> dict:
        mv = _make_matvecs(prob.a, prob.at, psum)
        s = _iterate_stats(prob, x, y, mv.matvec(x), mv.rmatvec(y), norm)
        return dict(
            x=prob.col_scale * x,
            y=prob.row_scale * y,
            reduced_costs=s["reduced_costs"],
        )

    return final_iterate


def _invalid_result(qp: QuadraticProgram, reason: TerminationReason) -> SolveResult:
    n, m = qp.num_variables, qp.num_constraints
    return SolveResult(
        termination_reason=reason,
        primal_solution=np.zeros(n),
        dual_solution=np.zeros(m),
        reduced_costs=np.zeros(n),
        primal_objective=math.nan,
        dual_objective=math.nan,
        primal_residual=math.nan,
        dual_residual=math.nan,
        relative_gap=math.nan,
        iterations=0,
        kkt_matrix_passes=0.0,
        solve_time_sec=0.0,
        iteration_stats=[],
    )


def _solve_with_presolve(qp: QuadraticProgram, params: PdhgParams,
                         mesh, start: float) -> SolveResult:
    """Presolve -> solve reduced -> postsolve (reference
    PreprocessSolver::PreprocessAndSolve with glop presolve, :1145)."""
    from ortools_tpu.glop.presolve import PresolveStatus, presolve

    qp_min = qp.as_minimization()
    sign = -1.0 if qp.maximize else 1.0
    pres = presolve(qp_min)
    if pres.status == PresolveStatus.PRIMAL_INFEASIBLE:
        res = _invalid_result(qp, TerminationReason.PRIMAL_INFEASIBLE)
        res.solve_time_sec = time.perf_counter() - start
        return res
    if pres.status == PresolveStatus.DUAL_INFEASIBLE:
        res = _invalid_result(qp, TerminationReason.DUAL_INFEASIBLE)
        res.solve_time_sec = time.perf_counter() - start
        return res
    sub_params = dataclasses.replace(params, presolve=False)
    reduced = pres.reduced
    if reduced.num_variables == 0:
        x = pres.postsolve(np.zeros(0))
        y, rc = pres.postsolve_duals(qp_min, x, np.zeros(0))
        obj = sign * qp_min.objective_value(x)
        return SolveResult(
            termination_reason=TerminationReason.OPTIMAL,
            primal_solution=x, dual_solution=sign * y,
            reduced_costs=sign * rc,
            primal_objective=obj, dual_objective=obj,
            primal_residual=0.0, dual_residual=0.0, relative_gap=0.0,
            iterations=0, kkt_matrix_passes=0.0,
            solve_time_sec=time.perf_counter() - start,
            iteration_stats=[],
        )
    sub = solve(reduced, sub_params, mesh=mesh)
    if sub.termination_reason not in (
        TerminationReason.OPTIMAL,
        TerminationReason.ITERATION_LIMIT,
        TerminationReason.TIME_LIMIT,
        TerminationReason.KKT_MATRIX_PASS_LIMIT,
    ):
        # infeasibility of the reduced problem implies the original's
        res = _invalid_result(qp, sub.termination_reason)
        res.solve_time_sec = time.perf_counter() - start
        return res
    x = pres.postsolve(sub.primal_solution)
    y, rc = pres.postsolve_duals(qp_min, x, sub.dual_solution)
    return dataclasses.replace(
        sub,
        primal_solution=x,
        dual_solution=sign * y,
        reduced_costs=sign * rc,
        # sub solved the min-sense reduced problem; report original sense
        primal_objective=sign * sub.primal_objective,
        dual_objective=sign * sub.dual_objective,
        solve_time_sec=time.perf_counter() - start,
    )


def _problem_specs(prob: DeviceProblem, axis: str) -> DeviceProblem:
    """PartitionSpec pytree for a DeviceProblem: matrix block lists sharded
    over ``axis``, everything else replicated (the reference Sharder's
    nnz-mass partition mapped onto the mesh, SURVEY §2.15)."""
    P = jax.sharding.PartitionSpec

    def mat(mspec: BlockSparseMatrix) -> BlockSparseMatrix:
        return BlockSparseMatrix(
            data=P(axis), block_rows=P(axis), block_cols=P(axis),
            shape=mspec.shape, padded_shape=mspec.padded_shape,
            num_real_blocks=mspec.num_real_blocks,
        )

    reps = {f: P() for f in DeviceProblem._fields if f not in ("a", "at")}
    return prob._replace(a=mat(prob.a), at=mat(prob.at), **reps)


def _place_problem(prob: DeviceProblem, mesh: jax.sharding.Mesh,
                   axis: str) -> DeviceProblem:
    specs = _problem_specs(prob, axis)
    return jax.tree_util.tree_map(
        lambda leaf, spec: jax.device_put(
            leaf, jax.sharding.NamedSharding(mesh, spec)
        ),
        prob, specs,
    )


def build_2d_problem(
    qp: QuadraticProgram, params: PdhgParams, mesh: jax.sharding.Mesh,
) -> Tuple[DeviceProblem, Comm2D]:
    """Partition A over a 2-D (row x col) mesh.

    Rows/cols are split into equal contiguous ranges (static shapes for
    shard_map); each mesh cell (r, c) stores its blocks with LOCAL indices,
    zero-padded to the max cell population (the nnz-mass unit is the
    uniform dense block, so padding is the only imbalance).  The stacked
    block arrays are sharded on their leading axis in mesh row-major
    order, so each device's shard_map slice IS its cell.

    Reference counterpart: the Sharder's mass-balanced matrix partition
    (sharder.h:149-165) extended to the 2-D row x col design of SURVEY §5's
    long-context analogue.
    """
    row_axis, col_axis = mesh.axis_names
    nr, nc = mesh.shape[row_axis], mesh.shape[col_axis]
    qpm = qp.as_minimization()
    bm, bn = params.block_shape or auto_block_shape(
        qpm.num_constraints, qpm.num_variables, qpm.num_nonzeros)
    base = build_device_problem(
        qpm, params,
        row_pad_multiple=nr * bm * (128 // math.gcd(128, bm)),
        col_pad_multiple=nc * bn * (128 // math.gcd(128, bn)),
    )
    mm, nn = base.a.padded_shape
    assert mm % (nr * bm) == 0 and nn % (nc * bn) == 0
    seg_m, seg_n = mm // nr, nn // nc
    rows_per_seg, cols_per_seg = seg_m // bm, seg_n // bn

    data = np.asarray(base.a.data)[: base.a.num_real_blocks]
    brow = np.asarray(base.a.block_rows)[: base.a.num_real_blocks]
    bcol = np.asarray(base.a.block_cols)[: base.a.num_real_blocks]
    cell_r = brow // rows_per_seg
    cell_c = bcol // cols_per_seg
    cell = cell_r * nc + cell_c
    counts = np.bincount(cell, minlength=nr * nc)
    nbmax = max(1, int(counts.max()))
    stacked = np.zeros((nr * nc * nbmax, bm, bn), dtype=data.dtype)
    srows = np.zeros(nr * nc * nbmax, dtype=np.int32)
    scols = np.zeros(nr * nc * nbmax, dtype=np.int32)
    order = np.argsort(cell, kind="stable")
    pos = 0
    for k in range(nr * nc):
        sel = order[pos: pos + counts[k]]
        pos += counts[k]
        off = k * nbmax
        stacked[off: off + len(sel)] = data[sel]
        srows[off: off + len(sel)] = brow[sel] % rows_per_seg
        scols[off: off + len(sel)] = bcol[sel] % cols_per_seg
    a2d = BlockSparseMatrix(
        data=jnp.asarray(stacked), block_rows=jnp.asarray(srows),
        block_cols=jnp.asarray(scols), shape=(seg_m, seg_n),
        padded_shape=(seg_m, seg_n), num_real_blocks=nbmax,
    )
    at2d = BlockSparseMatrix(
        data=jnp.transpose(a2d.data, (0, 2, 1)), block_rows=a2d.block_cols,
        block_cols=a2d.block_rows, shape=(seg_n, seg_m),
        padded_shape=(seg_n, seg_m), num_real_blocks=nbmax,
    )
    prob = base._replace(a=a2d, at=at2d)
    comm = Comm2D(row_axis=row_axis, col_axis=col_axis,
                  seg_m=seg_m, seg_n=seg_n)
    # Place: block arrays sharded over BOTH axes on the leading dim
    # (row-major cells), vectors replicated.
    specs = _problem_specs_2d(prob, row_axis, col_axis)
    prob = jax.tree_util.tree_map(
        lambda leaf, spec: jax.device_put(
            leaf, jax.sharding.NamedSharding(mesh, spec)),
        prob, specs,
    )
    return prob, comm


def _problem_specs_2d(prob: DeviceProblem, row_axis: str, col_axis: str
                      ) -> DeviceProblem:
    P = jax.sharding.PartitionSpec

    def mat(mspec: BlockSparseMatrix) -> BlockSparseMatrix:
        return BlockSparseMatrix(
            data=P((row_axis, col_axis)),
            block_rows=P((row_axis, col_axis)),
            block_cols=P((row_axis, col_axis)),
            shape=mspec.shape, padded_shape=mspec.padded_shape,
            num_real_blocks=mspec.num_real_blocks,
        )

    reps = {f: P() for f in DeviceProblem._fields if f not in ("a", "at")}
    return prob._replace(a=mat(prob.a), at=mat(prob.at), **reps)
