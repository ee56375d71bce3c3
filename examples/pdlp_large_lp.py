"""PDLP at scale: sharded solve of a multi-commodity-flow LP
(parity: pdlp/samples/simple_pdlp_program + BASELINE config 5 shape).

On one GPU this runs the single-device path; with 8 virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8) it exercises the
block-sharded mesh path."""

import jax
import jax.numpy as jnp

from ortools_tpu.models.generators import multicommodity_flow_lp
from ortools_tpu.parallel import make_mesh
from ortools_tpu.pdlp import PdhgParams, solve


def main():
    qp = multicommodity_flow_lp(num_nodes=30, num_arcs=120,
                                num_commodities=4, seed=1)
    print(f"LP: {qp.num_constraints} rows x {qp.num_variables} cols, "
          f"{qp.num_nonzeros} nnz")
    params = PdhgParams(
        dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32,
        eps_optimal_absolute=1e-6, eps_optimal_relative=1e-6,
        iteration_limit=200_000,
    )
    mesh = make_mesh() if jax.device_count() > 1 else None
    result = solve(qp, params, mesh=mesh)
    print(f"Status: {result.termination_reason.name}")
    print(f"Objective: {result.primal_objective:.6f} "
          f"(gap {result.relative_gap:.2e}, "
          f"{result.iterations} iterations, "
          f"{result.solve_time_sec:.1f}s, "
          f"{jax.device_count()} device(s))")
    return result


if __name__ == "__main__":
    main()
