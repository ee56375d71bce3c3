"""At-scale PDHG benchmark (10M nnz — BASELINE config 5 shape).

Complements bench.py at a size where the matrix no longer fits in the
GPU's L2 cache.  Prints one JSON line.
"""

import json
import time

from bench import cpu_baseline_iters_per_sec

M = N = 131072
NUM_BLOCKS = 10240
BLOCK = (8, 128)
MAJORS = 8
REPS = 2


def main():
    import jax
    import jax.numpy as jnp

    from ortools_tpu.models.generators import block_random_lp
    from ortools_tpu.pdlp import solver as S
    from ortools_tpu.pdlp.params import PdhgParams

    qp = block_random_lp(M, N, num_blocks=NUM_BLOCKS, block_shape=BLOCK,
                         seed=1)
    params = PdhgParams(dtype=jnp.float32, block_shape=BLOCK)
    prob = S.build_device_problem(qp, params)
    _major = S._make_run_major(params)

    @jax.jit
    def run_block(prob_, state_):
        return jax.lax.fori_loop(0, MAJORS,
                                 lambda _, s: _major(prob_, s), state_)

    power_iter = jax.jit(S._make_power_iter(params))
    initial_state = jax.jit(S._make_initial_state(params))
    sigma = power_iter(prob, jax.random.normal(
        jax.random.PRNGKey(1), (prob.c.shape[0],), dtype=prob.c.dtype))
    state = initial_state(prob, sigma)

    state = jax.block_until_ready(run_block(prob, state))
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run_block(prob, state))
        best = min(best, time.perf_counter() - t0)
    ips = MAJORS * params.termination_check_frequency / best
    cpu = cpu_baseline_iters_per_sec(qp, iters=16)
    print(json.dumps({
        "metric": "pdhg_large_iterations_per_sec_per_chip",
        "value": round(ips, 2),
        "unit": "iter/s",
        "vs_baseline": round(ips / cpu, 2),
        "baseline_cpu_iter_per_sec": round(cpu, 3),
        "problem": {"m": M, "n": N, "nnz": int(qp.num_nonzeros)},
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
