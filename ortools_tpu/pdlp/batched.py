"""Batched PDHG: solve many variants of one LP simultaneously (vmap).

The device replacement for the reference's one-LP-per-thread model:
branch-and-bound nodes differ from the root LP only in variable bounds, so
a batch of B node LPs is a leading axis over (var_lb, var_ub, state) with
the constraint matrix shared — SpMV becomes SpMM (one pass over the matrix
serves all B vectors), and one jitted program advances all B solves per step
(SURVEY §2.15 "Shared search tree" row; BASELINE north star).

Used by ortools_tpu.mip.branch_and_bound for node bounding and usable
directly for scenario batches (e.g. the batched-Netlib config).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ortools_tpu.models.lp import QuadraticProgram
from ortools_tpu.pdlp import solver as S
from ortools_tpu.pdlp.params import PdhgParams, RestartStrategy
from ortools_tpu.utils.status import TerminationReason


@dataclasses.dataclass
class BatchSolveResult:
    # All arrays have leading batch dim B.
    primal_objective: np.ndarray
    dual_objective: np.ndarray
    # Mathematically valid per-instance lower bound on the LP optimum
    # derived from the dual iterate alone (exact Lagrangian dual value;
    # -inf when the iterate certifies nothing).  Safe for B&B pruning even
    # when `optimal` is False.
    dual_bound: np.ndarray
    primal_residual: np.ndarray
    dual_residual: np.ndarray
    optimal: np.ndarray  # bool
    # Verified infeasibility certificates (reference termination.h:74):
    # primal_infeasible[i] — a dual ray proves instance i's LP infeasible.
    primal_infeasible: np.ndarray  # bool
    dual_infeasible: np.ndarray  # bool (unbounded LP)
    primal_solution: np.ndarray  # [B, n] original space
    dual_solution: np.ndarray  # [B, m]
    iterations: int


def _prob_axes(prob: S.DeviceProblem):
    """vmap in_axes for DeviceProblem: batched variable bounds, everything
    else shared."""
    ax = {f: None for f in S.DeviceProblem._fields}
    for f in ("var_lb", "var_ub", "orig_var_lb", "orig_var_ub"):
        ax[f] = 0
    none_mat = S.BlockSparseMatrix(
        data=None, block_rows=None, block_cols=None,
        shape=prob.a.shape, padded_shape=prob.a.padded_shape,
        num_real_blocks=prob.a.num_real_blocks,
    )
    none_mat_t = S.BlockSparseMatrix(
        data=None, block_rows=None, block_cols=None,
        shape=prob.at.shape, padded_shape=prob.at.padded_shape,
        num_real_blocks=prob.at.num_real_blocks,
    )
    ax["a"] = none_mat
    ax["at"] = none_mat_t
    return S.DeviceProblem(**ax)


def _select_state(mask_b: jax.Array, a: S.PdhgState, b: S.PdhgState) -> S.PdhgState:
    """Per-instance select between two batched states (mask [B])."""

    def sel(x, y):
        m = mask_b.reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(m, x, y)

    return jax.tree_util.tree_map(sel, a, b)


_BATCH_FN_CACHE: dict = {}


def _batched_fns(params: PdhgParams, prob: S.DeviceProblem) -> dict:
    """Memoized vmapped+jitted bundle.

    Rebuilding the closures per solve_batch call gives every call a fresh
    function identity → a full retrace (and, without a persistent
    compilation cache, an XLA recompile) per B&B batch.  Keyed by params value and the
    problem's static pytree metadata (the vmap in_axes tree embeds the
    matrix aux data)."""
    key = (
        S.params_cache_key(params),
        prob.a.shape, prob.a.padded_shape, prob.a.num_real_blocks,
        prob.at.shape, prob.at.padded_shape, prob.at.num_real_blocks,
    )
    fns = _BATCH_FN_CACHE.get(key)
    if fns is None:
        axes = _prob_axes(prob)
        fns = dict(
            run_major=jax.jit(jax.vmap(S._make_run_major(params),
                                       in_axes=(axes, 0))),
            compute_stats=jax.jit(jax.vmap(S._make_compute_stats(params),
                                           in_axes=(axes, 0))),
            apply_restart=jax.jit(jax.vmap(
                S._make_apply_restart(params),
                in_axes=(axes, 0, 0, 0, 0))),
            initial_state=jax.jit(jax.vmap(S._make_initial_state(params),
                                           in_axes=(axes, None))),
            final_iterate=jax.jit(jax.vmap(
                S._make_final_iterate(params.optimality_norm),
                in_axes=(axes, 0, 0))),
            power_iter=jax.jit(S._make_power_iter(params)),
            warm_mv=jax.jit(jax.vmap(
                lambda p, x, y: (p.a.matvec(x), p.at.matvec(y)),
                in_axes=(axes, 0, 0))),
        )
        _BATCH_FN_CACHE[key] = fns
    return fns


def solve_batch(
    qp: QuadraticProgram,
    var_lb_batch: np.ndarray,
    var_ub_batch: np.ndarray,
    params: Optional[PdhgParams] = None,
    warm_start_x: Optional[np.ndarray] = None,
    warm_start_y: Optional[np.ndarray] = None,
    deadline: float = math.inf,
) -> BatchSolveResult:
    """Solve B LPs sharing qp's matrix/objective but with per-instance
    variable bounds.  Bounds are in the ORIGINAL problem space.

    Warm starts (e.g. parent-node iterates in B&B) are original-space too.
    ``deadline`` (perf_counter time) is checked after every major-
    iteration dispatch; on expiry the call returns with whatever each
    instance has proven so far (unproven instances report their safe
    Lagrangian dual bound and optimal=False — callers never prune on
    those).
    """
    params = params or PdhgParams()
    qp = qp.as_minimization()
    bsz, n = var_lb_batch.shape
    assert var_ub_batch.shape == (bsz, n) == (bsz, qp.num_variables)

    prob = S.build_device_problem(qp, params)
    dtype = params.dtype
    nn = prob.c.shape[0]

    def pad_bounds(vb, fill):
        out = np.full((bsz, nn), fill, dtype=np.float64)
        out[:, :n] = vb
        return jnp.asarray(out, dtype=dtype)

    col_scale = np.asarray(prob.col_scale, dtype=np.float64)
    orig_lb = pad_bounds(var_lb_batch, 0.0)
    orig_ub = pad_bounds(var_ub_batch, 0.0)
    scaled_lb = pad_bounds(var_lb_batch / col_scale[:n], 0.0)
    scaled_ub = pad_bounds(var_ub_batch / col_scale[:n], 0.0)

    vprob = prob._replace(
        var_lb=scaled_lb, var_ub=scaled_ub,
        orig_var_lb=orig_lb, orig_var_ub=orig_ub,
    )
    fns = _batched_fns(params, prob)
    run_major = fns["run_major"]
    compute_stats = fns["compute_stats"]
    apply_restart = fns["apply_restart"]
    initial_state = fns["initial_state"]
    final_iterate = fns["final_iterate"]
    power_iter = fns["power_iter"]
    v0 = jax.random.normal(jax.random.PRNGKey(0), (nn,), dtype=dtype)
    sigma = power_iter(prob, v0)
    state = initial_state(vprob, sigma)
    if warm_start_x is not None:
        xw = np.zeros((bsz, nn))
        xw[:, :n] = np.clip(warm_start_x, var_lb_batch, var_ub_batch)
        xs = jnp.asarray(xw / col_scale[None, :], dtype=dtype)
        yw = np.zeros((bsz, prob.con_lb.shape[0]))
        if warm_start_y is not None:
            yw[:, : qp.num_constraints] = warm_start_y
        row_scale = np.asarray(prob.row_scale, dtype=np.float64)
        ys = jnp.asarray(yw / row_scale[None, :], dtype=dtype)
        ax, aty = fns["warm_mv"](vprob, xs, ys)
        state = state._replace(x=xs, y=ys, ax=ax, aty=aty,
                               x_restart=xs, y_restart=ys)

    norm_b = float(prob.norm_b)
    norm_c = float(prob.norm_c)
    eps_a, eps_r = params.eps_optimal_absolute, params.eps_optimal_relative

    def optimal_mask(st: dict) -> np.ndarray:
        p = np.asarray(st["primal_objective"], dtype=np.float64)
        d = np.asarray(st["dual_objective"], dtype=np.float64)
        pr = np.asarray(st["primal_residual"], dtype=np.float64)
        dr = np.asarray(st["dual_residual"], dtype=np.float64)
        return (
            (np.abs(p - d) <= eps_a + eps_r * (np.abs(p) + np.abs(d)))
            & (pr <= eps_a + eps_r * norm_b)
            & (dr <= eps_a + eps_r * norm_c)
        )

    iterations = 0
    done = np.zeros(bsz, dtype=bool)
    optimal = np.zeros(bsz, dtype=bool)
    primal_infeasible = np.zeros(bsz, dtype=bool)
    dual_infeasible = np.zeros(bsz, dtype=bool)
    kkt_at_restart = np.full(bsz, np.inf)
    last_cand_kkt = np.full(bsz, np.inf)
    iters_at_restart = np.zeros(bsz)
    # snapshot of the first iterate seen optimal, per instance
    best_x = [None] * bsz
    best_y = [None] * bsz
    best_stats = [None] * bsz

    while iterations < params.iteration_limit and not done.all():
        if time.perf_counter() > deadline:
            break
        state = run_major(vprob, state)
        iterations += params.termination_check_frequency
        stats = compute_stats(vprob, state)
        cur, avg = stats["current"], stats["average"]
        kkt_cur = np.asarray(stats["kkt_current"], dtype=np.float64)
        kkt_avg = np.asarray(stats["kkt_average"], dtype=np.float64)
        ok_cur = optimal_mask(cur) & ~done
        ok_avg = optimal_mask(avg) & ~done & ~ok_cur
        for which, ok in (("current", ok_cur), ("average", ok_avg)):
            for i in np.nonzero(ok)[0]:
                done[i] = True
                optimal[i] = True
                src = cur if which == "current" else avg
                best_stats[i] = {k: float(np.asarray(v)[i]) for k, v in src.items()}
                if which == "current":
                    best_x[i] = np.asarray(state.x[i])
                    best_y[i] = np.asarray(state.y[i])
                else:
                    best_x[i] = np.asarray(stats["x_avg"][i])
                    best_y[i] = np.asarray(stats["y_avg"][i])
        if done.all():
            break
        # Verified infeasibility certificates (reference termination.h:74):
        # check both candidate rays (iterate difference and current
        # iterate) per instance; a certified instance is done.
        eps_pi = params.eps_primal_infeasible
        eps_di = params.eps_dual_infeasible
        for key in ("infeas_diff", "infeas_current"):
            inf = {k: np.asarray(v, dtype=np.float64)
                   for k, v in stats[key].items()}
            ny, nx = inf["ray_norm_y"], inf["ray_norm_x"]
            pinf = ((ny > 0)
                    & (inf["max_dual_ray_infeasibility"] <= eps_pi * ny)
                    & (inf["dual_ray_objective"] > 0) & ~done)
            dinf = ((nx > 0)
                    & (inf["max_primal_ray_infeasibility"] <= eps_di * nx)
                    & (inf["max_quadratic_ray"] <= eps_di * nx)
                    & (inf["primal_ray_objective"] < 0) & ~done & ~pinf)
            for i in np.nonzero(pinf | dinf)[0]:
                done[i] = True
                primal_infeasible[i] = bool(pinf[i])
                dual_infeasible[i] = bool(dinf[i])
                best_stats[i] = {
                    k: float(np.asarray(v)[i]) for k, v in cur.items()
                }
                best_x[i] = np.asarray(state.x[i])
                best_y[i] = np.asarray(state.y[i])
        if done.all():
            break
        # vectorized restart decision (host numpy)
        use_avg = kkt_avg <= kkt_cur
        cand = np.minimum(kkt_avg, kkt_cur)
        if params.restart_strategy == RestartStrategy.ADAPTIVE_HEURISTIC:
            # vectorized form of the reference trust-region criterion
            # (solver.py host loop; primal_dual_hybrid_gradient.cc:1904)
            pot_avg = np.asarray(stats["tr_average"]["potential"],
                                 dtype=np.float64)
            pot_cur = np.asarray(stats["tr_current"]["potential"],
                                 dtype=np.float64)
            ng_avg = np.asarray(stats["tr_average"]["normalized_gap"],
                                dtype=np.float64)
            ng_cur = np.asarray(stats["tr_current"]["normalized_gap"],
                                dtype=np.float64)
            use_avg = pot_avg < pot_cur
            cand_ng = np.where(use_avg, ng_avg, ng_cur)
            forced = (iterations - iters_at_restart) >= iterations / 2
            fresh = np.isinf(kkt_at_restart)  # reused as ng_at_restart
            ratio = cand_ng / np.maximum(kkt_at_restart, 1e-300)
            nec = (ratio < params.necessary_reduction_for_restart) & (
                cand_ng > last_cand_kkt  # reused as ng_at_last_trial
            )
            do_restart = (
                forced
                | (~fresh
                   & ((ratio < params.sufficient_reduction_for_restart)
                      | nec))
            ) & ~done
            kkt_at_restart = np.where(fresh, cand_ng, kkt_at_restart)
            cand = cand_ng
        elif params.restart_strategy == RestartStrategy.ADAPTIVE_KKT:
            fresh = np.isinf(kkt_at_restart)
            kkt_at_restart = np.where(fresh, cand, kkt_at_restart)
            suff = cand <= params.sufficient_reduction_for_restart * kkt_at_restart
            nec = (
                cand <= params.necessary_reduction_for_restart * kkt_at_restart
            ) & (cand > last_cand_kkt)
            long_i = (iterations - iters_at_restart) >= (
                params.artificial_restart_threshold * iterations
            )
            do_restart = (~fresh) & (suff | nec | long_i) & ~done
        elif params.restart_strategy == RestartStrategy.EVERY_MAJOR_ITERATION:
            do_restart = ~done
        else:
            do_restart = np.zeros(bsz, dtype=bool)
        last_cand_kkt = cand
        if do_restart.any():
            restarted = apply_restart(
                vprob, state, jnp.asarray(use_avg),
                stats["x_avg"], stats["y_avg"],
            )
            state = _select_state(jnp.asarray(do_restart), restarted, state)
            kkt_at_restart = np.where(do_restart, cand, kkt_at_restart)
            last_cand_kkt = np.where(do_restart, np.inf, last_cand_kkt)
            iters_at_restart = np.where(do_restart, iterations, iters_at_restart)

    # Fill unfinished instances with their better candidate.
    stats = compute_stats(vprob, state)
    kkt_cur = np.asarray(stats["kkt_current"], dtype=np.float64)
    kkt_avg = np.asarray(stats["kkt_average"], dtype=np.float64)
    for i in range(bsz):
        if best_stats[i] is None:
            if kkt_avg[i] < kkt_cur[i]:
                src = stats["average"]
                best_x[i] = np.asarray(stats["x_avg"][i])
                best_y[i] = np.asarray(stats["y_avg"][i])
            else:
                src = stats["current"]
                best_x[i] = np.asarray(state.x[i])
                best_y[i] = np.asarray(state.y[i])
            best_stats[i] = {k: float(np.asarray(v)[i]) for k, v in src.items()}

    xs = jnp.asarray(np.stack(best_x))
    ys = jnp.asarray(np.stack(best_y))
    fin = final_iterate(vprob, xs, ys)
    x_orig = np.asarray(fin["x"], dtype=np.float64)[:, :n]
    y_orig = np.asarray(fin["y"], dtype=np.float64)[:, : qp.num_constraints]

    const = qp.objective_constant
    return BatchSolveResult(
        primal_objective=np.array(
            [s["primal_objective"] + const for s in best_stats]
        ),
        dual_objective=np.array(
            [s["dual_objective"] + const for s in best_stats]
        ),
        dual_bound=np.array(
            [s.get("dual_bound", -math.inf) + const for s in best_stats]
        ),
        primal_residual=np.array([s["primal_residual"] for s in best_stats]),
        dual_residual=np.array([s["dual_residual"] for s in best_stats]),
        optimal=optimal,
        primal_infeasible=primal_infeasible,
        dual_infeasible=dual_infeasible,
        primal_solution=x_orig,
        dual_solution=y_orig,
        iterations=iterations,
    )
