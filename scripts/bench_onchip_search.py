"""On-chip search benchmark: the CP/MIP stack's two device entry points.

Two measurements on the GPU, each with a host baseline, written to
artifacts/SEARCH_ONCHIP.json and printed as one JSON line:

A. **Batched node-LP PDHG** (pdlp/batched.py; reference role: the node
   re-solves of sat/linear_programming_constraint.h:442, recast as a
   batch axis): 256 B&B-style node LPs (random binary fixings of
   increasing depth) solved in batches of 64, warm-started from the root
   iterate, deadline-disciplined.  Metric: node LPs per second on the
   chip vs the host dual-simplex backend on the identical node list.

B. **Device feasibility jump** (sat/fj_device.py; reference role:
   feasibility_jump.h:48 multi-seed portfolio): objective-descent mode
   on a set-cover instance — time to the first verified cover cheaper
   than the greedy cover, device (64 vmapped seeds) vs the host numpy
   FJ (sat/feasibility_jump.py) hunting the same cutoff.

Run on a machine with a GPU:
    python scripts/bench_onchip_search.py
"""

import json
import math
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_node_lps():
    """Node-LP throughput in the regime each backend is built for.

    The host warm dual simplex owns SMALL node LPs (the battery's
    choose_backend routes those to it: ~3700 nodes/s on a 10-row
    knapsack).  The batched-PDHG backend exists for LARGE node LPs,
    where a dense-tableau simplex is out of range and a cold
    interior-ish solve per node would dominate the tree: here a
    25.6k-var multicommodity LP relaxation with B&B-style bound
    fixings, 64 nodes advancing per jitted dispatch."""
    import jax
    import jax.numpy as jnp

    from ortools_tpu.models.generators import multicommodity_flow_lp
    from ortools_tpu.pdlp.batched import solve_batch
    from ortools_tpu.pdlp.params import PdhgParams

    qp = multicommodity_flow_lp(120, 800, 32, seed=1).as_minimization()
    n = qp.num_variables
    rng = np.random.default_rng(0)
    params = PdhgParams(
        dtype=jnp.float32,
        eps_optimal_absolute=1e-4,
        eps_optimal_relative=1e-4,
        iteration_limit=60_000,
    )

    # root LP
    lb0 = np.asarray(qp.variable_lower, dtype=np.float64)
    ub0 = np.asarray(qp.variable_upper, dtype=np.float64)
    t0 = time.perf_counter()
    root = solve_batch(qp, lb0[None], ub0[None], params)
    root_time = time.perf_counter() - t0
    x_root = root.primal_solution[0]
    y_root = root.dual_solution[0]

    # 256 node-style bound variations: fix `depth` random binaries at
    # their rounded root value (what a B&B frontier at that depth
    # looks like)
    n_nodes, batch = 128, 64
    lbs = np.repeat(lb0[None], n_nodes, axis=0)
    ubs = np.repeat(ub0[None], n_nodes, axis=0)
    for i in range(n_nodes):
        depth = 1 + int(rng.integers(0, 12))
        fix = rng.choice(n, size=depth, replace=False)
        # B&B-style bound changes that keep the parent point feasible:
        # pin the chosen flows at their root values (rounding them
        # breaks the equality rows of flow conservation and produces
        # infeasible-or-degenerate nodes that converge to nothing)
        v = np.maximum(0.0, x_root[fix])
        lbs[i, fix] = v
        ubs[i, fix] = v

    warm_x = np.repeat(x_root[None], batch, axis=0)
    warm_y = np.repeat(y_root[None], batch, axis=0)
    t0 = time.perf_counter()
    n_opt = 0
    n_inf = 0
    for s in range(0, n_nodes, batch):
        r = solve_batch(qp, lbs[s:s + batch], ubs[s:s + batch], params,
                        warm_start_x=warm_x, warm_start_y=warm_y,
                        deadline=time.perf_counter() + 240.0)
        n_opt += int(r.optimal.sum())
        n_inf += int(r.primal_infeasible.sum())
    dt = time.perf_counter() - t0
    device_nodes_per_sec = n_nodes / dt

    # host baseline at this scale: the Python revised simplex, cold
    # (the native dense small-LP core is range-gated far below this
    # size; the battery would have no host path here at all)
    from ortools_tpu.glop.simplex import RevisedSimplex
    from ortools_tpu.utils.status import MPSolverStatus
    import dataclasses as _dc

    t0 = time.perf_counter()
    host_opt = 0
    host_deadline = time.perf_counter() + 120.0
    host_nodes = 0
    for i in range(n_nodes):
        if time.perf_counter() > host_deadline:
            break
        try:
            sx = RevisedSimplex(qp)
            sx.set_variable_bounds(lbs[i], ubs[i])
            st = sx.primal_solve(max_iterations=20_000,
                                 deadline=host_deadline)
            host_opt += st == MPSolverStatus.OPTIMAL
        except Exception:
            pass
        host_nodes += 1
    host_dt = time.perf_counter() - t0
    host_nodes_per_sec = host_nodes / host_dt if host_dt > 0 else 0.0

    return {
        "instance": qp.name,
        "n_vars": int(n),
        "n_rows": int(qp.num_constraints),
        "n_nodes": n_nodes,
        "batch": batch,
        "root_solve_sec": round(root_time, 3),
        "device_nodes_per_sec": round(device_nodes_per_sec, 2),
        "device_wall_sec": round(dt, 2),
        "device_optimal": n_opt,
        "device_infeasible": n_inf,
        "host_backend": "python revised simplex (cold; the native small-LP core is range-gated far below this size)",
        "host_nodes_per_sec": round(host_nodes_per_sec, 2),
        "host_nodes_run": host_nodes,
        "host_optimal": host_opt,
        "speedup_vs_host": round(device_nodes_per_sec
                                 / max(host_nodes_per_sec, 1e-9), 2),
    }


def bench_device_fj():
    from ortools_tpu.mip.heuristics import detect_set_cover
    from ortools_tpu.models.mip_generators import set_cover
    from ortools_tpu.sat.fj_device import (
        device_feasibility_jump, objective_descent_system)
    from ortools_tpu.sat.feasibility_jump import (
        LinearSystem, feasibility_jump)

    qp = set_cover(250, 100, seed=2).as_minimization()
    sc = detect_set_cover(qp)
    assert sc is not None
    rows_of_col, cols_of_row, cost = sc
    a = sp.csr_matrix(qp.constraint_matrix)
    rlo = qp.constraint_lower
    rhi = qp.constraint_upper

    # greedy cover cost = the bar; hunt anything 1% cheaper
    cc = np.zeros(len(cols_of_row), dtype=np.int64)
    chosen = []
    covered = np.zeros(len(cols_of_row), dtype=bool)
    at = a.T.tocsr()
    while not covered.all():
        gains = at @ (~covered).astype(float)
        scorev = np.where(gains > 0, cost / np.maximum(gains, 1e-9), np.inf)
        j = int(np.argmin(scorev))
        chosen.append(j)
        covered[rows_of_col[j]] = True
        cc[rows_of_col[j]] += 1
    greedy_cost = float(cost[chosen].sum())
    cutoff = greedy_cost * 0.99
    x_greedy = np.zeros(qp.num_variables)
    x_greedy[chosen] = 1.0

    a2, lb2, ub2 = objective_descent_system(a, rlo, rhi, cost, cutoff)

    # device: 64 seeds, jitted rounds
    t0 = time.perf_counter()
    res = device_feasibility_jump(
        a2, lb2, ub2, n_seeds=64, steps_per_round=128, max_rounds=60,
        seed=1, x0=x_greedy, deadline=time.perf_counter() + 120.0)
    dev_dt = time.perf_counter() - t0
    dev_found = bool(res.solutions)
    dev_cost = (float(cost @ res.solutions[0]) if dev_found else None)

    # host numpy FJ on the same system + cutoff
    sys_h = LinearSystem(a=sp.csr_matrix(a2), row_lb=lb2, row_ub=ub2,
                         var_lb=np.zeros(qp.num_variables),
                         var_ub=np.ones(qp.num_variables))
    t0 = time.perf_counter()
    host_deadline = t0 + 120.0
    x_h = None
    for s in range(8):  # the host runs seeds sequentially
        x_h = feasibility_jump(sys_h, x0=x_greedy, seed=s,
                               deadline=host_deadline)
        if x_h is not None:
            break
        if time.perf_counter() > host_deadline:
            break
    host_dt = time.perf_counter() - t0
    host_found = x_h is not None
    host_cost = float(cost @ x_h) if host_found else None

    return {
        "instance": qp.name,
        "greedy_cost": round(greedy_cost, 6),
        "cutoff": round(cutoff, 6),
        "device_found": dev_found,
        "device_cost": None if dev_cost is None else round(dev_cost, 6),
        "device_sec": round(dev_dt, 2),
        "device_moves_per_sec": round(res.moves_per_second, 1),
        "device_seeds": 64,
        "host_found": host_found,
        "host_cost": None if host_cost is None else round(host_cost, 6),
        "host_sec": round(host_dt, 2),
        "device_beats_host": bool(
            dev_found and (not host_found or dev_dt < host_dt)),
    }


def main():
    import jax

    out = {
        "metric": "onchip_search",
        "devices": [str(d) for d in jax.devices()],
        "node_lp_pdhg": bench_node_lps(),
        "feasibility_jump": bench_device_fj(),
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "SEARCH_ONCHIP.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
