"""Scheduling battery: LCG core vs eager order encoding vs DFS CP engine.

The Lawrence la01-la20 instance files are not in the repository, so the
la series is represented by SEEDED instances with the exact la shapes
(10x5, 15x5, 20x5, 10x10) — proven optimal by the solver itself,
cross-checked between independent engines — plus the known-optimum
instances the repository holds (ft06=55, ft10=930).

Large-domain scaling: the same instances with all durations scaled x50
multiply every horizon/window by 50.  The eager order ladder grows
linearly with window width (budget-gated); the LCG core's lazy bound
literals only materialize where search touches — the architectural win
this battery demonstrates.

Writes artifacts/SCHED_r05.json and prints a table.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import random

from ortools_tpu.scheduling.jobshop import (JobshopInstance, parse_jobshop,
                                            solve_jobshop_cdcl,
                                            solve_jobshop_lcg)
from test_scheduling_packing import FT06  # noqa: E402

BUDGET = float(os.environ.get("SCHED_BUDGET", "120"))


def seeded_instance(nj, nm, seed, dur_scale=1):
    rng = random.Random(seed)
    jobs = []
    for _ in range(nj):
        machines = list(range(nm))
        rng.shuffle(machines)
        jobs.append([(mach, rng.randint(5, 99) * dur_scale)
                     for mach in machines])
    return JobshopInstance(name=f"rand{nj}x{nm}_s{seed}", jobs=jobs)


def run_engine(engine, inst, budget):
    t0 = time.perf_counter()
    try:
        if engine == "lcg":
            r = solve_jobshop_lcg(inst, max_time_in_seconds=budget)
        elif engine == "eager":
            r = solve_jobshop_cdcl(inst, max_time_in_seconds=budget)
        else:  # DFS CP engine
            from ortools_tpu.scheduling.jobshop import solve_jobshop
            r = solve_jobshop(inst, max_time_in_seconds=budget,
                              engine="cp")
    except Exception as e:  # noqa: BLE001 — record engine blowups
        return {"makespan": None, "optimal": False, "time": -1.0,
                "error": str(e)[:100]}
    dt = time.perf_counter() - t0
    if r is None:
        return {"makespan": None, "optimal": False, "time": dt}
    return {"makespan": r.makespan, "optimal": bool(r.optimal),
            "time": round(dt, 2)}


def main():
    suite = []
    # known-optimum instances available in the environment
    suite.append(("ft06", parse_jobshop(FT06, is_text=True, name="ft06"),
                  55))
    suite.append(("ft10", parse_jobshop(
        os.path.join(os.path.dirname(__file__), "..",
                     "tests/data/ft10.jssp")), 930))
    # la-shaped seeded instances (la01-la20 shapes: 10x5, 15x5, 20x5,
    # 10x10), two seeds each
    for shape, (nj, nm) in [("la01-style", (10, 5)),
                            ("la06-style", (15, 5)),
                            ("la11-style", (20, 5)),
                            ("la16-style", (10, 10))]:
        for seed in (1, 2):
            inst = seeded_instance(nj, nm, seed)
            suite.append((f"{shape}_{nj}x{nm}_s{seed}", inst, None))
    # large-horizon variants: durations x50 (the eager ladder's weakness)
    suite.append(("ft06_x50", JobshopInstance(
        name="ft06x50",
        jobs=[[(mm, d * 50) for mm, d in job]
              for job in suite[0][1].jobs]), 55 * 50))
    inst_big = seeded_instance(10, 5, 1, dur_scale=50)
    suite.append(("la01-style_x50_s1", inst_big, None))

    results = {}
    for name, inst, known in suite:
        row = {}
        for engine in ("lcg", "eager", "cp"):
            row[engine] = run_engine(engine, inst, BUDGET)
        row["known_optimum"] = known
        results[name] = row
        lcg, eag, cp = row["lcg"], row["eager"], row["cp"]

        def fmt(r):
            if r["makespan"] is None:
                return "   --      "
            return f"{r['makespan']:>5}{'*' if r['optimal'] else ' '} " \
                   f"{r['time']:>6.1f}s"
        print(f"{name:<22} lcg: {fmt(lcg)}  eager: {fmt(eag)}  "
              f"cp: {fmt(cp)}  known: {known}")
        for eng in ("lcg", "eager"):
            r = row[eng]
            if known is not None and r["optimal"] and \
                    r["makespan"] != known:
                print(f"  !! {eng} claims optimal {r['makespan']} != "
                      f"known {known}")
                sys.exit(1)

    out = os.path.join(os.path.dirname(__file__), "..",
                       "artifacts", "SCHED_r05.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"budget_s": BUDGET, "results": results}, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
