"""Feasibility jump: weighted-violation local search over linear models.

Capability parity: ``ortools/sat/feasibility_jump.h:48`` +
``constraint_violation.h:33-270`` (LinearIncrementalEvaluator / LsEvaluator)
— the violation-guided jump heuristic of Luteberget & Sartor 2023 that the
reference runs in its parallel portfolio.  SURVEY §2.15 calls this the
component most directly suited to a vector machine: violation evaluation is a sparse
matrix-vector product and move scoring is columnwise arithmetic.

Round-1 implementation is vectorized numpy on the host with incremental
activity maintenance (the reference's O(Δ) update, constraint_violation.h:57);
the same arrays are the substrate for a jax/batched-seed version.

The model must be *linear-representable*: bool_or/bool_and/at_most_one/
exactly_one and linear constraints; enforcement literals are folded into
big-M rows (exact when the literals hold, vacuous otherwise — every FJ
output is re-verified by the caller).  ``extract_linear_system`` returns
None otherwise and the caller falls back to the DFS engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ortools_tpu.sat import model_ir as ir


@dataclasses.dataclass
class LinearSystem:
    a: sp.csr_matrix  # [m, n]
    row_lb: np.ndarray
    row_ub: np.ndarray
    var_lb: np.ndarray  # finite (FJ needs bounded vars)
    var_ub: np.ndarray


def _lit_expr(lit: int) -> Tuple[int, int, int]:
    """literal -> (var, coeff, offset) so that value = coeff*x + offset."""
    v = ir.literal_index(lit)
    return (v, 1, 0) if lit >= 0 else (v, -1, 1)


def extract_linear_system(model: ir.CpModelIR) -> Optional[LinearSystem]:
    n = len(model.variables)
    var_lb = np.zeros(n)
    var_ub = np.zeros(n)
    for i, v in enumerate(model.variables):
        d = v.domain
        lo, hi = d.min(), d.max()
        if lo <= -(2**40) or hi >= 2**40:
            return None  # unbounded vars: FJ needs finite box
        var_lb[i], var_ub[i] = lo, hi

    rows: List[Dict[int, float]] = []
    lbs: List[float] = []
    ubs: List[float] = []

    def append_row(coeffs: Dict[int, float], lo: float, hi: float,
                   enf: List[int]) -> None:
        """Append the row, big-M folding enforcement literals
        (constraint_violation.h big-M handling).  With litval_l =
        c_l x_l + o_l and deficiency D = sum_l (1 - litval_l) >= 0, the
        enforced row relaxes to  a.x <= hi + M_hi D  and
        a.x >= lo - M_lo D  with the hull-excess big-Ms — exact when all
        literals hold, vacuous otherwise."""
        if lo <= -(2.0**40):
            lo = -np.inf
        if hi >= 2.0**40:
            hi = np.inf
        if not enf:
            rows.append(coeffs)
            lbs.append(lo)
            ubs.append(hi)
            return
        amin = amax = 0.0
        for v, c in coeffs.items():
            l, u = var_lb[v], var_ub[v]
            amin += min(c * l, c * u)
            amax += max(c * l, c * u)
        terms = [_lit_expr(lit) for lit in enf]
        k_enf = len(terms)
        sum_off = float(sum(o for _, _, o in terms))
        if np.isfinite(hi):
            m_hi = max(0.0, amax - hi)
            folded = dict(coeffs)
            for v, c, _ in terms:
                folded[v] = folded.get(v, 0.0) + m_hi * c
            rows.append(folded)
            lbs.append(-np.inf)
            ubs.append(hi + m_hi * (k_enf - sum_off))
        if np.isfinite(lo):
            m_lo = max(0.0, lo - amin)
            folded = dict(coeffs)
            for v, c, _ in terms:
                folded[v] = folded.get(v, 0.0) - m_lo * c
            rows.append(folded)
            lbs.append(lo - m_lo * (k_enf - sum_off))
            ubs.append(np.inf)

    for ct in model.constraints:
        a = ct.args
        k = ct.kind
        if k in ("bool_or", "at_most_one", "exactly_one", "bool_and"):
            coeffs: Dict[int, float] = {}
            offset = 0
            for lit in a.literals:
                v, c, off = _lit_expr(lit)
                coeffs[v] = coeffs.get(v, 0.0) + c
                offset += off
            if k == "bool_or":
                lo, hi = 1 - offset, np.inf
            elif k == "at_most_one":
                lo, hi = -np.inf, 1 - offset
            elif k == "exactly_one":
                lo, hi = 1 - offset, 1 - offset
            else:  # bool_and: all true
                nlit = len(a.literals)
                lo, hi = nlit - offset, nlit - offset
        elif k == "linear":
            coeffs = {v: float(c) for v, c in zip(a.vars, a.coeffs)}
            dom = a.domain
            lo = float(dom.min()) if not dom.is_empty() else 1.0
            hi = float(dom.max()) if not dom.is_empty() else 0.0
        else:
            return None
        append_row(coeffs, float(lo), float(hi),
                   list(ct.enforcement_literals))

    if not rows:
        return None
    r_idx, c_idx, vals = [], [], []
    for i, coeffs in enumerate(rows):
        for v, c in coeffs.items():
            r_idx.append(i)
            c_idx.append(v)
            vals.append(c)
    a_mat = sp.csr_matrix(
        (vals, (r_idx, c_idx)), shape=(len(rows), n)
    )
    return LinearSystem(
        a=a_mat,
        row_lb=np.asarray(lbs),
        row_ub=np.asarray(ubs),
        var_lb=var_lb,
        var_ub=var_ub,
    )


def feasibility_jump(
    system: LinearSystem,
    x0: Optional[np.ndarray] = None,
    max_moves: int = 200_000,
    seed: int = 1,
    perturb_every: int = 2000,
    deadline: float = None,
    max_cand_vars: int = 256,
) -> Optional[np.ndarray]:
    """Search for an integer point with zero violation.  Returns the point
    or None if the move budget (or ``deadline``, perf_counter time) is
    exhausted."""
    import time as _time

    rng = np.random.default_rng(seed)
    a = sp.csc_matrix(system.a)
    m, n = a.shape
    lb, ub = system.var_lb, system.var_ub
    rlo, rhi = system.row_lb, system.row_ub
    x = (np.clip(np.round(x0), lb, ub) if x0 is not None
         else np.clip(np.round(lb + rng.random(n) * (ub - lb)), lb, ub))
    act = system.a @ x
    weights = np.ones(m)

    def viol(act_v):
        return np.maximum(rlo - act_v, 0.0) + np.maximum(act_v - rhi, 0.0)

    violations = viol(act)
    total = float(weights @ violations)
    moves = 0
    while moves < max_moves:
        if total <= 1e-9:
            return x.astype(np.int64)
        if deadline is not None and (moves & 0xFF) == 0 \
                and _time.perf_counter() > deadline:
            return None
        # candidate variables: union over (up to 16) violated rows
        bad_rows = np.nonzero(violations > 1e-9)[0]
        sel_rows = (bad_rows if len(bad_rows) <= 16
                    else rng.choice(bad_rows, size=16, replace=False))
        cand_vars = np.unique(np.concatenate([
            system.a.indices[system.a.indptr[r]:system.a.indptr[r + 1]]
            for r in sel_rows
        ]))
        if len(cand_vars) > max_cand_vars:
            cand_vars = rng.choice(cand_vars, size=max_cand_vars,
                                   replace=False)
        best_move = None
        best_delta = 0.0
        for j in cand_vars:
            c0, c1 = a.indptr[j], a.indptr[j + 1]
            rows_j = a.indices[c0:c1]
            coefs_j = a.data[c0:c1]
            w_j = weights[rows_j]
            act_j = act[rows_j]
            # candidate target values for x_j: make each incident row hit
            # its nearest bound, plus the box bounds
            base = act_j - coefs_j * x[j]
            with np.errstate(divide="ignore", invalid="ignore"):
                v_lo = (rlo[rows_j] - base) / coefs_j
                v_hi = (rhi[rows_j] - base) / coefs_j
            cands = np.concatenate([
                np.floor(v_lo), np.ceil(v_lo), np.floor(v_hi), np.ceil(v_hi),
                [lb[j], ub[j], x[j] - 1, x[j] + 1],
            ])
            cands = np.unique(np.clip(cands[np.isfinite(cands)], lb[j], ub[j]))
            cands = cands[cands != x[j]]
            if len(cands) == 0:
                continue
            # score all candidates: violation of incident rows at each value
            new_act = base[None, :] + np.outer(cands, coefs_j)
            new_viol = (np.maximum(rlo[rows_j][None, :] - new_act, 0.0)
                        + np.maximum(new_act - rhi[rows_j][None, :], 0.0))
            cur_v = (np.maximum(rlo[rows_j] - act_j, 0.0)
                     + np.maximum(act_j - rhi[rows_j], 0.0))
            delta = (w_j[None, :] * (cur_v[None, :] - new_viol)).sum(axis=1)
            k = int(np.argmax(delta))
            if best_move is None or delta[k] > best_delta:
                best_delta = float(delta[k])
                best_move = (int(j), float(cands[k]))
        moves += 1
        plateau_ok = (
            best_move is not None
            and best_delta > -1e-9
            and rng.random() < 0.3
        )
        if best_move is None or (best_delta <= 1e-12 and not plateau_ok):
            # local minimum: bump weights of violated rows (additive, like
            # the reference's weight update) and occasionally kick
            weights[bad_rows] += 1.0
            total = float(weights @ violations)
            if moves % perturb_every == 0:
                j = int(rng.integers(0, n))
                newv = float(rng.integers(int(lb[j]), int(ub[j]) + 1))
                dx = newv - x[j]
                if dx != 0:
                    c0, c1 = a.indptr[j], a.indptr[j + 1]
                    act[a.indices[c0:c1]] += a.data[c0:c1] * dx
                    x[j] = newv
                    violations = viol(act)
                    total = float(weights @ violations)
            continue
        j, newv = best_move
        c0, c1 = a.indptr[j], a.indptr[j + 1]
        rows_j = a.indices[c0:c1]
        act[rows_j] += a.data[c0:c1] * (newv - x[j])
        x[j] = newv
        violations[rows_j] = (
            np.maximum(rlo[rows_j] - act[rows_j], 0.0)
            + np.maximum(act[rows_j] - rhi[rows_j], 0.0)
        )
        total = float(weights @ violations)
    return None
