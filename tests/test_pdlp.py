"""PDHG solver tests: solver-as-oracle against scipy HiGHS + analytic QPs.

Mirrors the reference's test strategy (SURVEY §4): canned problems with
known optima, asserted to tolerance."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.optimize import linprog

from ortools_tpu.models.lp import QuadraticProgram, random_lp
from ortools_tpu.models.mps import read_mps
from ortools_tpu.pdlp import PdhgParams, solve
from ortools_tpu.pdlp.params import OptimalityNorm, RestartStrategy
from ortools_tpu.utils.status import TerminationReason

F64 = dict(dtype=jnp.float64)


def scipy_solve(qp: QuadraticProgram):
    """Reference LP solve via scipy HiGHS on the same model."""
    qp = qp.as_minimization()
    a = sp.csr_matrix(qp.constraint_matrix)
    rows_ub, rhs_ub = [], []
    rows_eq, rhs_eq = [], []
    for i in range(qp.num_constraints):
        lo, hi = qp.constraint_lower[i], qp.constraint_upper[i]
        row = a.getrow(i)
        if lo == hi:
            rows_eq.append(row)
            rhs_eq.append(lo)
        else:
            if np.isfinite(hi):
                rows_ub.append(row)
                rhs_ub.append(hi)
            if np.isfinite(lo):
                rows_ub.append(-row)
                rhs_ub.append(-lo)
    kw = {}
    if rows_ub:
        kw["A_ub"] = sp.vstack(rows_ub)
        kw["b_ub"] = np.array(rhs_ub)
    if rows_eq:
        kw["A_eq"] = sp.vstack(rows_eq)
        kw["b_eq"] = np.array(rhs_eq)
    res = linprog(
        qp.objective_vector,
        bounds=list(zip(qp.variable_lower, qp.variable_upper)),
        method="highs",
        **kw,
    )
    assert res.status == 0, res.message
    return res.fun + qp.objective_constant


def test_tiny_lp_exact():
    # min -x1 - 2 x2 s.t. x1 + x2 <= 4, x1 <= 2, 0 <= x <= 10
    # optimum at (0, 4), objective -8.
    qp = QuadraticProgram(
        objective_vector=np.array([-1.0, -2.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 0.0]])),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([4.0, 2.0]),
        variable_lower=np.zeros(2),
        variable_upper=np.full(2, 10.0),
    )
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - (-8.0)) < 1e-5
    np.testing.assert_allclose(r.primal_solution, [0.0, 4.0], atol=1e-4)
    # dual feasibility: c - A^T y - rc == 0 within tolerance
    resid = (
        qp.objective_vector
        - qp.constraint_matrix.T @ r.dual_solution
        - r.reduced_costs
    )
    assert np.abs(resid).max() < 1e-5


@pytest.mark.parametrize("seed,m,n,density", [
    (3, 60, 40, 0.3),
    (7, 30, 80, 0.2),
    (11, 100, 100, 0.05),
])
def test_random_inequality_lp_matches_scipy(seed, m, n, density):
    qp = random_lp(m, n, density=density, seed=seed)
    ref = scipy_solve(qp)
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-4 * (1 + abs(ref))


def test_equality_constraints():
    # transportation-style LP with equalities: sum x = 1 rows
    rng = np.random.default_rng(5)
    n = 30
    cost = rng.uniform(1, 10, size=n)
    a = sp.vstack([
        sp.csr_matrix(np.ones((1, n))),
        sp.random(10, n, density=0.3, random_state=np.random.RandomState(2)),
    ])
    qp = QuadraticProgram(
        objective_vector=cost,
        constraint_matrix=sp.csr_matrix(a),
        constraint_lower=np.concatenate([[1.0], np.full(10, -np.inf)]),
        constraint_upper=np.concatenate([[1.0], rng.uniform(1, 5, size=10)]),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
    )
    ref = scipy_solve(qp)
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-4 * (1 + abs(ref))


def test_two_sided_constraints():
    qp = random_lp(40, 30, density=0.3, seed=13)
    # make rows two-sided
    qp.constraint_lower = qp.constraint_upper - 2.0
    ref = scipy_solve(qp)
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-4 * (1 + abs(ref))


def test_maximization_mps_fixture():
    import os
    path = "/root/reference/ortools/linear_solver/testdata/maximization.mps"
    if not os.path.exists(path):
        pytest.skip("reference data not mounted")
    qp = read_mps(path)
    assert qp.maximize
    ref = scipy_solve(qp)  # minimized internally
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    # reported objective is in the original (max) sense
    assert abs(-r.primal_objective - ref) <= 1e-4 * (1 + abs(ref))


def test_box_qp_analytic():
    # min 1/2 ||x - a||^2 over [0, 1]^n (no constraints binding)
    # = min 1/2 x'qx + c x with q = 1, c = -a  -> x* = clip(a, 0, 1)
    a = np.array([-0.5, 0.3, 1.7, 0.9])
    n = 4
    qp = QuadraticProgram(
        objective_vector=-a,
        objective_matrix_diagonal=np.ones(n),
        objective_constant=0.5 * float(a @ a),
        constraint_matrix=sp.csr_matrix((1, n)),
        constraint_lower=np.array([-np.inf]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.zeros(n),
        variable_upper=np.ones(n),
    )
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    np.testing.assert_allclose(
        r.primal_solution, np.clip(a, 0, 1), atol=1e-4
    )
    assert abs(r.primal_objective - 0.5 * np.sum((np.clip(a, 0, 1) - a) ** 2)) < 1e-5


def test_constrained_qp_matches_kkt():
    # min 1/2||x||^2 s.t. sum x >= 4, n=4 -> x_i = 1, obj = 2
    n = 4
    qp = QuadraticProgram(
        objective_vector=np.zeros(n),
        objective_matrix_diagonal=np.ones(n),
        constraint_matrix=sp.csr_matrix(np.ones((1, n))),
        constraint_lower=np.array([4.0]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.full(n, -np.inf),
        variable_upper=np.full(n, np.inf),
    )
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    np.testing.assert_allclose(r.primal_solution, np.ones(n), atol=1e-4)
    assert abs(r.primal_objective - 2.0) < 1e-5


def test_iteration_limit():
    qp = random_lp(50, 50, density=0.2, seed=1)
    r = solve(qp, PdhgParams(iteration_limit=64, **F64))
    assert r.termination_reason in (
        TerminationReason.ITERATION_LIMIT,
        TerminationReason.OPTIMAL,  # unlikely but legal
    )
    assert r.iterations <= 128


def test_invalid_problem():
    qp = QuadraticProgram(
        objective_vector=np.zeros(2),
        constraint_matrix=sp.csr_matrix((1, 2)),
        constraint_lower=np.array([3.0]),
        constraint_upper=np.array([1.0]),  # crossed
        variable_lower=np.zeros(2),
        variable_upper=np.ones(2),
    )
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.INVALID_PROBLEM


def test_invalid_params():
    qp = random_lp(5, 5, density=0.5, seed=0)
    r = solve(qp, PdhgParams(termination_check_frequency=0, **F64))
    assert r.termination_reason == TerminationReason.INVALID_PARAMETER


def test_linf_norm_and_no_restarts():
    qp = random_lp(40, 30, density=0.3, seed=21)
    ref = scipy_solve(qp)
    r = solve(qp, PdhgParams(
        optimality_norm=OptimalityNorm.L_INF,
        restart_strategy=RestartStrategy.NO_RESTARTS,
        iteration_limit=20000,
        **F64,
    ))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-3 * (1 + abs(ref))


def test_f32_runs():
    # f32 is the device speed mode: looser tolerance, still converges on easy LPs
    qp = random_lp(30, 20, density=0.4, seed=2)
    ref = scipy_solve(qp)
    r = solve(qp, PdhgParams(
        dtype=jnp.float32,
        eps_optimal_absolute=1e-4,
        eps_optimal_relative=1e-4,
    ))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-2 * (1 + abs(ref))


def test_primal_infeasible_certificate():
    # x+y >= 4 and x+y <= -1: infeasible
    qp = QuadraticProgram(
        objective_vector=np.ones(2),
        constraint_matrix=sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 1.0]])),
        constraint_lower=np.array([4.0, -np.inf]),
        constraint_upper=np.array([np.inf, -1.0]),
        variable_lower=np.zeros(2),
        variable_upper=np.full(2, 10.0),
    )
    r = solve(qp, PdhgParams(iteration_limit=20000, **F64))
    assert r.termination_reason == TerminationReason.PRIMAL_INFEASIBLE


def test_dual_infeasible_certificate():
    # min -x with x unbounded above: primal unbounded
    qp = QuadraticProgram(
        objective_vector=np.array([-1.0]),
        constraint_matrix=sp.csr_matrix(np.array([[1.0]])),
        constraint_lower=np.array([0.0]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.zeros(1),
        variable_upper=np.array([np.inf]),
    )
    r = solve(qp, PdhgParams(iteration_limit=20000, **F64))
    assert r.termination_reason == TerminationReason.DUAL_INFEASIBLE


def test_free_variables_lp():
    # min x1 + x2 s.t. x1 + x2 >= 2, x free -> many optima, obj = 2
    qp = QuadraticProgram(
        objective_vector=np.array([1.0, 1.0]),
        constraint_matrix=sp.csr_matrix(np.ones((1, 2))),
        constraint_lower=np.array([2.0]),
        constraint_upper=np.array([np.inf]),
        variable_lower=np.full(2, -np.inf),
        variable_upper=np.full(2, np.inf),
    )
    r = solve(qp, PdhgParams(**F64))
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - 2.0) < 1e-5


def test_feasibility_polishing_solves():
    """use_feasibility_polishing: gate + polish phases return a point
    passing the full criteria (reference :2442 TryFeasibilityPolishing)."""
    qp = random_lp(100, 80, density=0.12, seed=41)
    ref = scipy_solve(qp)
    p = PdhgParams(dtype=jnp.float64, use_feasibility_polishing=True,
                   iteration_limit=100_000)
    r = solve(qp, p)
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-4 * (1 + abs(ref))
    # the returned point satisfies the residual tolerances
    assert r.primal_residual <= 1e-4 * (1 + abs(ref))


def test_malitsky_pock_rule_solves():
    """linesearch_rule='malitsky_pock' (reference TakeMalitskyPockStep)
    reaches the same optimum as the adaptive rule."""
    qp = random_lp(90, 70, density=0.12, seed=43)
    ref = scipy_solve(qp)
    p = PdhgParams(dtype=jnp.float64, linesearch_rule="malitsky_pock",
                   iteration_limit=200_000)
    r = solve(qp, p)
    assert r.termination_reason == TerminationReason.OPTIMAL
    assert abs(r.primal_objective - ref) <= 1e-4 * (1 + abs(ref))


def test_random_projection_point_metadata():
    """Iteration log records seeded Gaussian projections (reference
    SetRandomProjections, iteration_stats.cc:321-346)."""
    qp = random_lp(40, 30, density=0.2, seed=9)
    p = PdhgParams(dtype=jnp.float64, record_iteration_stats=True,
                   random_projection_seeds=(7, 42))
    r = solve(qp, p)
    assert r.iteration_stats
    md = r.iteration_stats[-1].get("point_metadata")
    assert md is not None
    assert set(md) == {"primal_7", "dual_7", "primal_42", "dual_42"}
    # deterministic across runs
    r2 = solve(qp, p)
    md2 = r2.iteration_stats[-1]["point_metadata"]
    assert md == md2
