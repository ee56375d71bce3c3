"""Solver-agnostic LP/MIP modeling front-end.

Capability parity: ``ortools/linear_solver`` — the MPSolver facade
(linear_solver.h:186) and the newer ``model_builder.py`` Python API — over
the framework's own backends:

- ``"pdlp"``  -> ortools_tpu.pdlp (first-order, on device)
- ``"glop"``  -> ortools_tpu.glop (host simplex; exact basic solutions)
- ``"mip"`` / ``"sat"`` -> ortools_tpu.mip batched branch-and-bound
  (selected automatically when integer variables are present)

Like the reference, the model is solver-independent: build once, solve with
any backend, read values/duals/reduced costs back through the solver object.
"""

from __future__ import annotations

import math
import numbers
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp

from ortools_tpu.models.lp import QuadraticProgram
from ortools_tpu.utils.status import MPSolverStatus

_NumberT = Union[int, float, np.integer, np.floating]


class LinearExpr:
    """Immutable-ish linear expression: sum coeff_i * var_i + offset."""

    __slots__ = ("coeffs", "offset")

    def __init__(self, coeffs: Optional[Dict[int, float]] = None,
                 offset: float = 0.0) -> None:
        self.coeffs: Dict[int, float] = coeffs or {}
        self.offset = float(offset)

    @staticmethod
    def of(e: Union["LinearExpr", "Variable", _NumberT]) -> "LinearExpr":
        if isinstance(e, LinearExpr):
            return e
        if isinstance(e, Variable):
            return LinearExpr({e.index: 1.0})
        if isinstance(e, numbers.Number):
            return LinearExpr({}, float(e))
        raise TypeError(f"not a linear expression: {e!r}")

    @staticmethod
    def sum(exprs: Sequence[Union["LinearExpr", "Variable", _NumberT]]
            ) -> "LinearExpr":
        out = LinearExpr()
        for e in exprs:
            out = out + LinearExpr.of(e)
        return out

    @staticmethod
    def weighted_sum(exprs, weights) -> "LinearExpr":
        out = LinearExpr()
        for e, w in zip(exprs, weights):
            out = out + LinearExpr.of(e) * w
        return out

    # -- arithmetic -----------------------------------------------------
    def __add__(self, other):
        o = LinearExpr.of(other)
        coeffs = dict(self.coeffs)
        for k, v in o.coeffs.items():
            coeffs[k] = coeffs.get(k, 0.0) + v
        return LinearExpr(coeffs, self.offset + o.offset)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (LinearExpr.of(other) * -1.0)

    def __rsub__(self, other):
        return LinearExpr.of(other) + (self * -1.0)

    def __mul__(self, k):
        if not isinstance(k, numbers.Number):
            raise TypeError("LinearExpr can only be multiplied by a constant")
        k = float(k)
        return LinearExpr({i: c * k for i, c in self.coeffs.items()},
                          self.offset * k)

    __rmul__ = __mul__

    def __truediv__(self, k):
        return self * (1.0 / float(k))

    def __neg__(self):
        return self * -1.0

    # -- comparisons build constraints ----------------------------------
    # The bounds are on the FULL expression (offset included);
    # add_linear_constraint folds the offset into the row bounds once.
    def __le__(self, other):
        return _BoundedExpr(self - LinearExpr.of(other), -math.inf, 0.0)

    def __ge__(self, other):
        return _BoundedExpr(self - LinearExpr.of(other), 0.0, math.inf)

    def __eq__(self, other):  # type: ignore[override]
        return _BoundedExpr(self - LinearExpr.of(other), 0.0, 0.0)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        terms = " + ".join(f"{c}*x{i}" for i, c in sorted(self.coeffs.items()))
        return f"LinearExpr({terms} + {self.offset})"


class _BoundedExpr:
    """expr within [lb, ub] (bounds exclude the expr's constant offset)."""

    def __init__(self, expr: LinearExpr, lb: float, ub: float) -> None:
        self.expr = expr
        self.lb = lb
        self.ub = ub


class Variable(LinearExpr):
    """A model variable; also usable directly as a LinearExpr."""

    __slots__ = ("model", "index")

    def __init__(self, model: "Model", index: int) -> None:
        self.model = model
        self.index = index
        # note: we do NOT call super().__init__; coeffs/offset are virtual

    @property
    def coeffs(self):  # type: ignore[override]
        return {self.index: 1.0}

    @property
    def offset(self):  # type: ignore[override]
        return 0.0

    @property
    def name(self) -> str:
        return self.model.var_names[self.index]

    @property
    def lower_bound(self) -> float:
        return self.model.var_lb[self.index]

    @lower_bound.setter
    def lower_bound(self, v: float) -> None:
        self.model.var_lb[self.index] = float(v)

    @property
    def upper_bound(self) -> float:
        return self.model.var_ub[self.index]

    @upper_bound.setter
    def upper_bound(self, v: float) -> None:
        self.model.var_ub[self.index] = float(v)

    @property
    def is_integer(self) -> bool:
        return self.model.var_is_integer[self.index]

    def __hash__(self):
        return hash((id(self.model), self.index))

    def __eq__(self, other):  # keep constraint-building semantics
        return LinearExpr.__eq__(self, other)

    def __repr__(self):
        return f"Variable({self.name})"


class LinearConstraint:
    def __init__(self, model: "Model", index: int) -> None:
        self.model = model
        self.index = index

    @property
    def name(self) -> str:
        return self.model.ct_names[self.index]

    @property
    def lower_bound(self) -> float:
        return self.model.ct_lb[self.index]

    @property
    def upper_bound(self) -> float:
        return self.model.ct_ub[self.index]


class Model:
    """Mutable LP/MIP model (parity: ModelBuilder / MPSolver model surface)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.var_lb: List[float] = []
        self.var_ub: List[float] = []
        self.var_is_integer: List[bool] = []
        self.var_names: List[str] = []
        self.ct_lb: List[float] = []
        self.ct_ub: List[float] = []
        self.ct_names: List[str] = []
        self.ct_coeffs: List[Dict[int, float]] = []
        self.objective = LinearExpr()
        self.maximize_flag = False

    # -- variables ------------------------------------------------------
    def new_var(self, lb: float = -math.inf, ub: float = math.inf,
                is_integer: bool = False, name: str = "") -> Variable:
        idx = len(self.var_lb)
        self.var_lb.append(float(lb))
        self.var_ub.append(float(ub))
        self.var_is_integer.append(bool(is_integer))
        self.var_names.append(name or f"x{idx}")
        return Variable(self, idx)

    def new_num_var(self, lb: float, ub: float, name: str = "") -> Variable:
        return self.new_var(lb, ub, False, name)

    def new_int_var(self, lb: float, ub: float, name: str = "") -> Variable:
        return self.new_var(lb, ub, True, name)

    def new_bool_var(self, name: str = "") -> Variable:
        return self.new_var(0.0, 1.0, True, name)

    @property
    def num_variables(self) -> int:
        return len(self.var_lb)

    @property
    def num_constraints(self) -> int:
        return len(self.ct_lb)

    # -- constraints ----------------------------------------------------
    def add(self, ct: _BoundedExpr, name: str = "") -> LinearConstraint:
        if isinstance(ct, bool):
            raise TypeError(
                "constraint is a plain bool — use <=, >=, == on expressions"
            )
        if not isinstance(ct, _BoundedExpr):
            raise TypeError(f"not a linear constraint: {ct!r}")
        return self.add_linear_constraint(ct.expr, ct.lb, ct.ub, name)

    def add_linear_constraint(
        self,
        expr: Union[LinearExpr, Variable],
        lb: float = -math.inf,
        ub: float = math.inf,
        name: str = "",
    ) -> LinearConstraint:
        e = LinearExpr.of(expr)
        idx = len(self.ct_lb)
        self.ct_lb.append(float(lb) - e.offset)
        self.ct_ub.append(float(ub) - e.offset)
        self.ct_names.append(name or f"c{idx}")
        self.ct_coeffs.append(dict(e.coeffs))
        return LinearConstraint(self, idx)

    # -- objective ------------------------------------------------------
    def minimize(self, expr: Union[LinearExpr, Variable, _NumberT]) -> None:
        self.objective = LinearExpr.of(expr)
        self.maximize_flag = False

    def maximize(self, expr: Union[LinearExpr, Variable, _NumberT]) -> None:
        self.objective = LinearExpr.of(expr)
        self.maximize_flag = True

    # -- export ---------------------------------------------------------
    def to_qp(self) -> QuadraticProgram:
        n = self.num_variables
        m = self.num_constraints
        c = np.zeros(n)
        for i, v in self.objective.coeffs.items():
            c[i] = v
        rows, cols, vals = [], [], []
        for r, coeffs in enumerate(self.ct_coeffs):
            for i, v in coeffs.items():
                rows.append(r)
                cols.append(i)
                vals.append(v)
        a = sp.csr_matrix(
            (np.asarray(vals, dtype=np.float64),
             (np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64))),
            shape=(m, n),
        )
        return QuadraticProgram(
            objective_vector=c,
            constraint_matrix=a,
            constraint_lower=np.asarray(self.ct_lb, dtype=np.float64),
            constraint_upper=np.asarray(self.ct_ub, dtype=np.float64),
            variable_lower=np.asarray(self.var_lb, dtype=np.float64),
            variable_upper=np.asarray(self.var_ub, dtype=np.float64),
            objective_constant=self.objective.offset,
            maximize=self.maximize_flag,
            integrality=np.asarray(self.var_is_integer, dtype=bool),
            variable_names=list(self.var_names),
            constraint_names=list(self.ct_names),
            name=self.name,
        )

    def export_to_mps_string(self) -> str:
        from ortools_tpu.models.mps import write_mps

        return write_mps(self.to_qp())

    @staticmethod
    def import_from_mps_file(path: str) -> "Model":
        from ortools_tpu.models.mps import read_mps

        return Model.from_qp(read_mps(path))

    @staticmethod
    def from_qp(qp: QuadraticProgram) -> "Model":
        mdl = Model(qp.name)
        n, m = qp.num_variables, qp.num_constraints
        names = qp.variable_names or [f"x{j}" for j in range(n)]
        integ = qp.integrality if qp.integrality is not None else [False] * n
        for j in range(n):
            mdl.new_var(qp.variable_lower[j], qp.variable_upper[j],
                        bool(integ[j]), names[j])
        csr = sp.csr_matrix(qp.constraint_matrix)
        cnames = qp.constraint_names or [f"c{i}" for i in range(m)]
        for i in range(m):
            coeffs = {
                int(csr.indices[k]): float(csr.data[k])
                for k in range(csr.indptr[i], csr.indptr[i + 1])
            }
            idx = len(mdl.ct_lb)
            mdl.ct_lb.append(float(qp.constraint_lower[i]))
            mdl.ct_ub.append(float(qp.constraint_upper[i]))
            mdl.ct_names.append(cnames[i])
            mdl.ct_coeffs.append(coeffs)
        obj = LinearExpr(
            {j: float(qp.objective_vector[j]) for j in range(n)
             if qp.objective_vector[j] != 0.0},
            qp.objective_constant,
        )
        if qp.maximize:
            mdl.maximize(obj)
        else:
            mdl.minimize(obj)
        return mdl


class Solver:
    """Solve a Model with a named backend (parity: MPSolver dispatch,
    linear_solver.cc:1539)."""

    def __init__(self, solver_id: str = "pdlp") -> None:
        self.solver_id = solver_id.lower()
        self._values: Optional[np.ndarray] = None
        self._duals: Optional[np.ndarray] = None
        self._reduced_costs: Optional[np.ndarray] = None
        self._objective: float = math.nan
        self._best_bound: float = math.nan
        self._status = MPSolverStatus.NOT_SOLVED

    def solve(self, model: Model, **params) -> MPSolverStatus:
        qp = model.to_qp()
        has_int = bool(np.any(qp.integrality)) if qp.integrality is not None else False
        backend = self.solver_id
        if backend in ("sat", "mip", "cp_sat", "cbc", "scip") or (
            backend == "auto" and has_int
        ):
            return self._solve_mip(qp, **params)
        if has_int and backend in ("pdlp", "glop", "auto"):
            # LP backends solve the relaxation only if explicitly asked;
            # default to the MIP path like MPSolver with an integer model.
            return self._solve_mip(qp, **params)
        if backend == "glop":
            return self._solve_glop(qp, **params)
        return self._solve_pdlp(qp, **params)

    # -- backends -------------------------------------------------------
    def _solve_pdlp(self, qp: QuadraticProgram, **kw) -> MPSolverStatus:
        import jax
        import jax.numpy as jnp

        from ortools_tpu.pdlp import PdhgParams, solve as pdlp_solve
        from ortools_tpu.utils.status import TerminationReason

        # f64 when the backend supports it (CPU with x64), else f32
        dtype = (jnp.float64 if jax.config.read("jax_enable_x64")
                 else jnp.float32)
        params = kw.pop("pdhg_params", None) or PdhgParams(
            dtype=dtype, **kw
        )
        r = pdlp_solve(qp, params)
        self._values = r.primal_solution
        self._duals = r.dual_solution
        self._reduced_costs = r.reduced_costs
        self._objective = r.primal_objective
        self._best_bound = r.dual_objective
        if r.termination_reason == TerminationReason.OPTIMAL:
            self._status = MPSolverStatus.OPTIMAL
        elif r.termination_reason in (
            TerminationReason.ITERATION_LIMIT,
            TerminationReason.TIME_LIMIT,
            TerminationReason.KKT_MATRIX_PASS_LIMIT,
        ):
            # FEASIBLE only when the returned iterate actually satisfies
            # the constraints to tolerance (MPSolver semantics: FEASIBLE
            # means "usable solution").  An arbitrary unconverged iterate
            # is NOT_SOLVED.
            scale = 1.0 + max(
                float(np.max(np.abs(qp.constraint_lower[
                    np.isfinite(qp.constraint_lower)]), initial=0.0)),
                float(np.max(np.abs(qp.constraint_upper[
                    np.isfinite(qp.constraint_upper)]), initial=0.0)),
            )
            if r.primal_residual <= 1e-4 * scale:
                self._status = MPSolverStatus.FEASIBLE
            else:
                self._status = MPSolverStatus.NOT_SOLVED
        elif r.termination_reason == TerminationReason.PRIMAL_INFEASIBLE:
            self._status = MPSolverStatus.INFEASIBLE
        elif r.termination_reason == TerminationReason.DUAL_INFEASIBLE:
            self._status = MPSolverStatus.UNBOUNDED
        else:
            self._status = MPSolverStatus.ABNORMAL
        return self._status

    def _solve_glop(self, qp: QuadraticProgram, **kw) -> MPSolverStatus:
        from ortools_tpu.glop import simplex

        res = simplex.solve(qp, **kw)
        self._values = res.primal_solution
        self._duals = res.dual_solution
        self._reduced_costs = res.reduced_costs
        self._objective = res.objective_value
        self._best_bound = res.objective_value
        self._status = res.status
        return self._status

    def _solve_mip(self, qp: QuadraticProgram, **kw) -> MPSolverStatus:
        from ortools_tpu.mip import branch_and_bound

        res = branch_and_bound.solve(qp, **kw)
        self._values = res.solution
        self._duals = np.zeros(qp.num_constraints)
        self._reduced_costs = np.zeros(qp.num_variables)
        self._objective = res.objective_value
        self._best_bound = res.best_bound
        self._status = res.status
        return self._status

    # -- accessors ------------------------------------------------------
    def value(self, expr: Union[LinearExpr, Variable, _NumberT]) -> float:
        assert self._values is not None, "solve() first"
        e = LinearExpr.of(expr)
        return e.offset + sum(
            c * self._values[i] for i, c in e.coeffs.items()
        )

    def values(self, variables: Sequence[Variable]) -> np.ndarray:
        return np.array([self.value(v) for v in variables])

    @property
    def objective_value(self) -> float:
        return self._objective

    @property
    def best_objective_bound(self) -> float:
        return self._best_bound

    def dual_value(self, ct: LinearConstraint) -> float:
        assert self._duals is not None, "solve() first"
        return float(self._duals[ct.index])

    def reduced_cost(self, var: Variable) -> float:
        assert self._reduced_costs is not None, "solve() first"
        return float(self._reduced_costs[var.index])
