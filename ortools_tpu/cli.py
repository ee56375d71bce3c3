"""Command-line front-end.

Capability parity: ``ortools/linear_solver/solve.cc`` (MPS/LP solve CLI,
flags at solve.cc:78-112) and ``ortools/sat/sat_runner.cc`` scoped to:

    python -m ortools_tpu solve --input model.mps [--solver pdlp|glop|sat]
        [--time_limit SEC] [--params k=v,...] [--sol_file out.sol]

Prints the standard status / objective / walltime block and optionally
writes a .sol file (MIPLIB format: objective comment + name value lines).
"""

from __future__ import annotations

import argparse
import sys
import time


def _cmd_solve(args: argparse.Namespace) -> int:
    from ortools_tpu.linear_solver import Model, Solver

    t0 = time.perf_counter()
    model = Model.import_from_mps_file(args.input)
    parse_time = time.perf_counter() - t0
    solver = Solver(args.solver)
    kw = {}
    if args.time_limit is not None and args.solver == "pdlp":
        kw["time_sec_limit"] = args.time_limit
    t0 = time.perf_counter()
    status = solver.solve(model, **kw)
    solve_time = time.perf_counter() - t0
    print(f"Model:    {model.name or args.input} "
          f"({model.num_variables} vars, {model.num_constraints} rows)")
    print(f"Solver:   {args.solver}")
    print(f"Status:   {status.name}")
    print(f"Objective: {solver.objective_value:.10g}")
    print(f"Parse time: {parse_time:.3f}s  Solve time: {solve_time:.3f}s")
    if args.sol_file:
        with open(args.sol_file, "w") as f:
            f.write(f"=obj= {solver.objective_value:.17g}\n")
            for j, name in enumerate(model.var_names):
                f.write(f"{name} {solver._values[j]:.17g}\n")
        print(f"Solution written to {args.sol_file}")
    return 0 if status.name in ("OPTIMAL", "FEASIBLE") else 1


def _cmd_bench(args: argparse.Namespace) -> int:
    import runpy

    sys.argv = ["bench.py"]
    runpy.run_path("bench.py", run_name="__main__")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ortools_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("solve", help="solve an MPS model")
    ps.add_argument("--input", required=True)
    ps.add_argument("--solver", default="pdlp",
                    choices=["pdlp", "glop", "sat", "mip", "auto"])
    ps.add_argument("--time_limit", type=float, default=None)
    ps.add_argument("--sol_file", default=None)
    ps.set_defaults(fn=_cmd_solve)
    pb = sub.add_parser("bench", help="run the benchmark")
    pb.set_defaults(fn=_cmd_bench)
    args = p.parse_args(argv)
    from ortools_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
