"""Device-side feasibility jump: vmapped multi-seed weighted-violation
local search over binary linear systems.

Capability parity: ``ortools/sat/feasibility_jump.h:48`` +
``constraint_violation.h:33-270`` — the violation-guided jump heuristic
(Luteberget & Sartor 2023) that the reference runs as several portfolio
workers with different seeds.  SURVEY §2.15 calls feasibility jump the
component most directly suited to a vector machine; this module is that
claim made real:

- S seeds advance **simultaneously** (a vmapped batch axis), each doing
  steepest-descent flips on its own weighted violation landscape;
- each step scores **every** variable flip of every seed at once — the
  score tensor ``[S, m, n]`` is a broadcast + clip + weighted reduction
  that XLA fuses into a single pass; there is no per-variable host loop;
- ``rounds × steps`` run inside one jitted ``lax.scan`` dispatch, so the
  host pays one dispatch and one sync per round, not per move;
- weights bump additively on plateaus exactly like the reference's
  ``UpdateViolatedConstraintWeights``, and a per-seed PRNG drives
  random plateau acceptance and restarts (jax.random, folded per step).

Scope: binary variables only (the battery's set-cover / knapsack /
packing instances).  General-integer models stay on the host version
(sat/feasibility_jump.py); every solution found here is RE-VERIFIED on
the host before anyone calls it an incumbent (A.9 contract).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np

_BIG = 1e9


@dataclasses.dataclass
class DeviceFjResult:
    """Feasible 0/1 points found (host-verified), plus step statistics."""

    solutions: List[np.ndarray]
    rounds_run: int
    moves_per_second: float
    wall_time_sec: float


def _np_f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def device_feasibility_jump(
    a,  # scipy sparse or dense [m, n]
    row_lb: np.ndarray,
    row_ub: np.ndarray,
    n_seeds: int = 64,
    steps_per_round: int = 128,
    max_rounds: int = 50,
    seed: int = 0,
    x0: Optional[np.ndarray] = None,
    deadline: float = math.inf,
    stop_after: int = 1,
    plateau_prob: float = 0.3,
) -> DeviceFjResult:
    """Run the multi-seed device FJ until `stop_after` verified feasible
    points are found, `max_rounds` rounds elapse, or `deadline`
    (perf_counter time) passes.

    To search for an IMPROVING solution rather than any feasible one,
    append the objective cutoff row ``c.x <= ub - eps`` to (a, row_lb,
    row_ub) before calling — the reference's objective mode does exactly
    this (feasibility_jump.h "decrease the objective of an already
    feasible solution").
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    a_d = _np_f32(np.asarray(a.todense()) if hasattr(a, "todense") else a)
    m, n = a_d.shape
    rlo = _np_f32(np.where(np.isfinite(row_lb), row_lb, -_BIG))
    rhi = _np_f32(np.where(np.isfinite(row_ub), row_ub, _BIG))

    A = jnp.asarray(a_d)  # [m, n]
    RLO = jnp.asarray(rlo)
    RHI = jnp.asarray(rhi)

    def viol(act):  # [..., m]
        return jnp.maximum(RLO - act, 0.0) + jnp.maximum(act - RHI, 0.0)

    def one_step(state, key):
        x, act, w = state  # x [n], act [m], w [m]
        delta = 1.0 - 2.0 * x  # flip direction per variable, [n]
        # score every flip: new activity [m, n] = act[:,None] + A * delta
        new_act = act[:, None] + A * delta[None, :]
        new_v = (jnp.maximum(RLO[:, None] - new_act, 0.0)
                 + jnp.maximum(new_act - RHI[:, None], 0.0))
        cur_v = viol(act)  # [m]
        gain = jnp.einsum("m,mn->n", w, cur_v[:, None] - new_v,
                          precision=lax.Precision.HIGHEST)
        j = jnp.argmax(gain)
        best = gain[j]
        k_plateau, k_kick = jax.random.split(key)
        take_plateau = (best > -1e-6) & (
            jax.random.uniform(k_plateau) < plateau_prob)
        do_move = (best > 1e-6) | take_plateau
        # apply the flip where chosen
        x2 = x.at[j].set(jnp.where(do_move, 1.0 - x[j], x[j]))
        act2 = jnp.where(do_move, act + A[:, j] * delta[j], act)
        # plateau with no move: bump violated-row weights (additive,
        # reference UpdateViolatedConstraintWeights) and kick one
        # random variable to escape
        bump = jnp.where(do_move, 0.0, 1.0)
        w2 = w + bump * (cur_v > 1e-6)
        jk = jax.random.randint(k_kick, (), 0, n)
        kick = (~do_move)
        x3 = x2.at[jk].set(jnp.where(kick, 1.0 - x2[jk], x2[jk]))
        act3 = jnp.where(kick, act2 + A[:, jk] * (1.0 - 2.0 * x2[jk]),
                         act2)
        return (x3, act3, w2), None

    def run_round(x, act, w, key):
        keys = jax.random.split(key, steps_per_round)
        (x, act, w), _ = lax.scan(one_step, (x, act, w), keys)
        return x, act, w

    @jax.jit
    def round_all(xs, acts, ws, keys):
        return jax.vmap(run_round)(xs, acts, ws, keys)

    root = jax.random.PRNGKey(seed)
    if x0 is not None:
        base = jnp.asarray(_np_f32(np.clip(np.round(x0), 0, 1)))
        flips = jax.random.bernoulli(
            jax.random.fold_in(root, 1), 0.1, (n_seeds, n))
        xs = jnp.where(flips, 1.0 - base[None, :], base[None, :])
    else:
        xs = jax.random.bernoulli(
            jax.random.fold_in(root, 2), 0.5, (n_seeds, n)
        ).astype(jnp.float32)
    acts = jnp.einsum("mn,sn->sm", A, xs, precision=lax.Precision.HIGHEST)
    ws = jnp.ones((n_seeds, m), dtype=jnp.float32)

    solutions: List[np.ndarray] = []
    seen: set = set()
    t0 = time.perf_counter()
    rounds = 0
    for r in range(max_rounds):
        if time.perf_counter() > deadline:
            break
        keys = jax.random.split(jax.random.fold_in(root, 100 + r), n_seeds)
        xs, acts, ws = round_all(xs, acts, ws, keys)
        # per-seed total violation; reading it waits for the round
        tot = np.asarray(
            jnp.sum(jnp.maximum(RLO[None] - acts, 0.0)
                    + jnp.maximum(acts - RHI[None], 0.0), axis=1))
        rounds += 1
        if (tot <= 1e-4).any():
            xs_h = np.asarray(xs)
            for s in np.nonzero(tot <= 1e-4)[0]:
                x_cand = np.round(xs_h[s]).astype(np.float64)
                # host-side re-verification (A.9 contract)
                act_h = a_d.astype(np.float64) @ x_cand
                if ((act_h >= row_lb - 1e-6).all()
                        and (act_h <= row_ub + 1e-6).all()):
                    key_b = x_cand.tobytes()
                    if key_b not in seen:
                        seen.add(key_b)
                        solutions.append(x_cand)
            if len(solutions) >= stop_after:
                break
    dt = time.perf_counter() - t0
    moves = rounds * steps_per_round * n_seeds
    return DeviceFjResult(
        solutions=solutions,
        rounds_run=rounds,
        moves_per_second=moves / max(dt, 1e-9),
        wall_time_sec=dt,
    )


def objective_descent_system(
    a, row_lb, row_ub, c: np.ndarray, cutoff: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Append the objective cutoff row ``c.x <= cutoff`` (the reference's
    FJ objective mode): any zero-violation point strictly improves."""
    import scipy.sparse as sp

    a_s = sp.csr_matrix(a)
    row = sp.csr_matrix(np.asarray(c, dtype=np.float64)[None, :])
    a2 = sp.vstack([a_s, row], format="csr")
    lb2 = np.concatenate([row_lb, [-np.inf]])
    ub2 = np.concatenate([row_ub, [cutoff]])
    return a2, lb2, ub2
