"""ortools_tpu — an accelerator-native combinatorial-optimization framework.

A from-scratch rebuild of the capabilities of Google OR-Tools v9.7
(reference surveyed in SURVEY.md) designed for JAX on a GPU:

- ``ortools_tpu.pdlp``    — first-order LP/QP solver (restarted PDHG), the
  numerically dense core.  SpMV and vector ops run as XLA/Pallas programs
  over block-partitioned sparse matrices on a ``jax.sharding.Mesh``.
  (capability parity target: ``ortools/pdlp``)
- ``ortools_tpu.glop``    — host simplex + LP presolve (parity target:
  ``ortools/glop``; control-heavy, kept on host by design, see SURVEY §2.15).
- ``ortools_tpu.mip``     — batched branch-and-bound MIP over PDHG node LPs
  with vectorized bound propagation (parity target: CP-SAT's MIP path).
- ``ortools_tpu.sat``     — CP-SAT-compatible modeling layer + vectorized
  propagation + feasibility-jump local search (parity target: ``ortools/sat``).
- ``ortools_tpu.graph``   — max-flow / min-cost-flow / shortest paths /
  assignment (parity target: ``ortools/graph``).
- ``ortools_tpu.linear_solver`` — solver-agnostic LP/MIP front-end
  (parity target: ``ortools/linear_solver`` MPSolver / model_builder).
- ``ortools_tpu.models``  — model IRs (LP/QP, CP) + MPS/LP-format I/O
  (parity target: ``ortools/lp_data``).
- ``ortools_tpu.ops``     — device kernels: block-sparse SpMV/SpMM,
  scans, deterministic reductions.
- ``ortools_tpu.parallel``— mesh/sharding layer (the device equivalent
  of ``ortools/pdlp/sharder.h`` and CP-SAT's portfolio threading).
"""

__version__ = "0.1.0"

from ortools_tpu.utils.status import (  # noqa: F401
    TerminationReason,
    SolveStatus,
)
