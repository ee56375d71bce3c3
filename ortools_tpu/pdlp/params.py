"""PDHG solver parameters.

Capability parity: ``ortools/pdlp/solvers.proto`` (PrimalDualHybridGradientParams
and TerminationCriteria).  Defaults reproduce the reference's proto defaults
(solvers.proto:102-395) except where noted:

- restart strategy: both adaptive schemes are implemented.
  ADAPTIVE_HEURISTIC evaluates the reference's trust-region "localized
  duality gap" criterion (primal_dual_hybrid_gradient.cc:1904,
  pdlp/trust_region.py, exercised in tests/test_trust_region.py);
  ADAPTIVE_KKT restarts on the weighted KKT error (the cuPDLP scheme,
  PAPERS.md arXiv:2312.14832) with the same sufficient/necessary
  reduction constants, and is this package's default.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import jax.numpy as jnp


class RestartStrategy(enum.Enum):
    NO_RESTARTS = 1
    EVERY_MAJOR_ITERATION = 2
    ADAPTIVE_KKT = 3  # adaptive restart on weighted KKT error (cuPDLP)
    # reference default: trust-region localized-duality-gap criterion
    # (primal_dual_hybrid_gradient.cc:1904, pdlp/trust_region.py)
    ADAPTIVE_HEURISTIC = 4


class OptimalityNorm(enum.Enum):
    L_INF = 1
    L2 = 2


@dataclasses.dataclass
class PdhgParams:
    # -- termination criteria (solvers.proto:52-172) ---------------------
    eps_optimal_absolute: float = 1.0e-6
    eps_optimal_relative: float = 1.0e-6
    eps_primal_infeasible: float = 1.0e-8
    eps_dual_infeasible: float = 1.0e-8
    optimality_norm: OptimalityNorm = OptimalityNorm.L2
    time_sec_limit: float = math.inf
    iteration_limit: int = 2**31 - 1
    kkt_matrix_pass_limit: float = math.inf

    # -- main loop (solvers.proto:316-326) -------------------------------
    termination_check_frequency: int = 64
    # Default measured on the random-LP battery (r2): ADAPTIVE_KKT solves
    # in 1-3x fewer iterations than the reference's ADAPTIVE_HEURISTIC
    # (consistent with the cuPDLP papers); the trust-region heuristic is
    # available for reference-parity runs.
    restart_strategy: RestartStrategy = RestartStrategy.ADAPTIVE_KKT
    sufficient_reduction_for_restart: float = 0.1
    necessary_reduction_for_restart: float = 0.9
    # artificial restart when the current restart interval exceeds this
    # fraction of all iterations so far (cuPDLP-style; keeps restart
    # lengths in check on hard instances).
    artificial_restart_threshold: float = 0.36

    # -- primal weight (solvers.proto:332-343) ---------------------------
    primal_weight_update_smoothing: float = 0.5
    initial_primal_weight: Optional[float] = None

    # -- rescaling (solvers.proto:367-371) -------------------------------
    l_inf_ruiz_iterations: int = 5
    l2_norm_rescaling: bool = True
    # glop-style LP presolve (reference presolve_options.use_glop,
    # default off like the reference)
    presolve: bool = False

    # -- step size (solvers.proto:184-189, 395) --------------------------
    adaptive_step_size: bool = True
    step_size_reduction_exponent: float = 0.3
    step_size_growth_exponent: float = 0.6
    initial_step_size_scaling: float = 1.0
    max_step_attempts: int = 40  # cap on rejected retries per iteration
    power_iteration_steps: int = 40

    # -- device placement -------------------------------------------------
    dtype: jnp.dtype = jnp.float32
    block_shape: Optional[Tuple[int, int]] = None  # None = auto
    num_shards: int = 1  # mesh axis size for the sharded path
    mesh_axis: str = "shards"
    # Linesearch rule (reference solvers.proto:248): "adaptive"
    # (ADAPTIVE_LINESEARCH_RULE, default) or "malitsky_pock"
    # (arXiv:1608.08883, reference TakeMalitskyPockStep :2211).
    linesearch_rule: str = "adaptive"
    mp_step_downscaling: float = 0.7  # solvers.proto MalitskyPockParams
    mp_contraction: float = 0.99
    mp_interpolation: float = 1.0
    # Feasibility polishing (reference use_feasibility_polishing,
    # solvers.proto:478 / primal_dual_hybrid_gradient.cc:2442): once the
    # objective gap is met, solve primal- and dual-feasibility
    # subproblems warm-started from the average iterate.
    use_feasibility_polishing: bool = False

    # -- logging ----------------------------------------------------------
    verbosity: int = 0
    record_iteration_stats: bool = False
    # Seeds for Gaussian random projections of the iterates recorded as
    # point metadata in the iteration log (reference
    # random_projection_seeds, solvers.proto:403).
    random_projection_seeds: Tuple[int, ...] = ()

    def validate(self) -> list[str]:
        errs = []
        if self.eps_optimal_absolute < 0 or self.eps_optimal_relative < 0:
            errs.append("eps_optimal must be >= 0")
        if self.termination_check_frequency <= 0:
            errs.append("termination_check_frequency must be positive")
        if not (0 <= self.primal_weight_update_smoothing <= 1):
            errs.append("primal_weight_update_smoothing must be in [0,1]")
        if self.l_inf_ruiz_iterations < 0 or self.l_inf_ruiz_iterations > 100:
            errs.append("l_inf_ruiz_iterations must be in [0,100]")
        if not (0 < self.sufficient_reduction_for_restart <= 1):
            errs.append("sufficient_reduction_for_restart must be in (0,1]")
        if not (self.sufficient_reduction_for_restart
                <= self.necessary_reduction_for_restart <= 1):
            errs.append("necessary_reduction_for_restart must be in "
                        "[sufficient_reduction_for_restart, 1]")
        if self.iteration_limit < 0:
            errs.append("iteration_limit must be >= 0")
        return errs
