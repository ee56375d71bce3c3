"""MIPLIB-easy-like battery: 20 synthetic structured MIPs vs HiGHS.

BASELINE.md target: ">= 80% of MIPLIB-easy matched to or-tools objectives".
The real MIPLIB set is not shipped; this battery is the stand-in declared
in SURVEY §6 — six structured families at the 100-1000 binary scale
(ortools_tpu/models/mip_generators.py), solved by the batched-PDHG
branch-and-bound with root cuts + pseudo-costs, objective-matched against
scipy.optimize.milp (HiGHS).

Prints ONE JSON line:
  {"metric": "miplib_like_matched_frac", "value": ..., "unit": "frac",
   "vs_baseline": value/0.8, ...}

Usage: python bench_miplib.py [scale] [time_limit_per_instance_sec]
"""

import json
import math
import sys
import time

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp


def main():
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    tlim = float(sys.argv[2]) if len(sys.argv) > 2 else 120.0

    from ortools_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    from ortools_tpu.mip.branch_and_bound import solve as mip_solve
    from ortools_tpu.models.mip_generators import miplib_like_battery
    from ortools_tpu.utils.status import MPSolverStatus

    battery = miplib_like_battery(scale=scale)
    results = []
    for qp in battery:
        t0 = time.perf_counter()
        r = mip_solve(qp, max_nodes=20_000, node_batch_size=64,
                      time_limit_sec=tlim)
        dt = time.perf_counter() - t0
        qpm = qp.as_minimization()
        sign = -1.0 if qp.maximize else 1.0
        c = qpm.objective_vector
        integ = np.asarray(qpm.integrality, dtype=float)
        s = milp(
            c,
            constraints=LinearConstraint(
                qpm.constraint_matrix, qpm.constraint_lower,
                qpm.constraint_upper),
            bounds=Bounds(qpm.variable_lower, qpm.variable_upper),
            integrality=integ,
            options={"time_limit": tlim},
        )
        # r.objective_value is in the ORIGINAL sense; sign converts it to
        # the minimization sense that scipy milp reports.  Our solution is
        # re-verified against the instance independently of solver status
        # (feasibility + integrality), so "matched" also credits solutions
        # strictly BETTER than HiGHS-at-the-time-limit.
        ours_min = math.nan
        if (r.status in (MPSolverStatus.OPTIMAL, MPSolverStatus.FEASIBLE)
                and not math.isnan(r.objective_value)):
            x = r.solution
            ax = qpm.constraint_matrix @ x
            rs = 1.0 + np.maximum(
                np.abs(np.where(np.isfinite(qpm.constraint_lower),
                                qpm.constraint_lower, 0.0)),
                np.abs(np.where(np.isfinite(qpm.constraint_upper),
                                qpm.constraint_upper, 0.0)))
            feas = (
                (ax >= qpm.constraint_lower - 1e-6 * rs).all()
                and (ax <= qpm.constraint_upper + 1e-6 * rs).all()
                and (x >= qpm.variable_lower - 1e-9).all()
                and (x <= qpm.variable_upper + 1e-9).all()
                and (np.abs(x[integ > 0] - np.round(x[integ > 0]))
                     <= 1e-6).all()
            )
            if feas:
                ours_min = sign * r.objective_value
        ref = s.fun if s.status in (0, 1) and s.fun is not None else math.nan
        # matched = at least as good as the reference answer (both are
        # subject to the same time limit), or equal within tolerance.
        matched = (
            not math.isnan(ours_min) and not math.isnan(ref)
            and ours_min <= ref + 1e-4 * (1.0 + abs(ref))
        )
        results.append({
            "name": qp.name,
            "n_bin": int(np.asarray(qpm.integrality).sum()),
            "status": str(r.status.name),
            "obj": None if math.isnan(ours_min) else round(ours_min, 6),
            "highs_obj": None if math.isnan(ref) else round(ref, 6),
            "matched": bool(matched),
            "nodes": r.num_nodes,
            "sec": round(dt, 1),
        })
        print(f"# {qp.name}: ours={results[-1]['obj']} "
              f"highs={results[-1]['highs_obj']} matched={matched} "
              f"nodes={r.num_nodes} {dt:.1f}s", file=sys.stderr)

    frac = sum(r["matched"] for r in results) / len(results)
    print(json.dumps({
        "metric": "miplib_like_matched_frac",
        "value": round(frac, 3),
        "unit": "frac",
        "vs_baseline": round(frac / 0.8, 3),
        "scale": scale,
        "time_limit_sec": tlim,
        "total_nodes": sum(r["nodes"] for r in results),
        "instances": results,
    }))


if __name__ == "__main__":
    main()
