"""Synthetic problem generators for tests and benchmarks.

The reference ships canned fixture problems (pdlp/test_util.h) and benchmark
*parsers* but no generators; for device benchmarking we need scale-controllable
instances with block-friendly sparsity (BASELINE.md configs 2 and 5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ortools_tpu.models.lp import QuadraticProgram


def block_random_lp(
    m: int,
    n: int,
    num_blocks: int,
    block_shape: Tuple[int, int] = (8, 128),
    seed: int = 0,
) -> QuadraticProgram:
    """Random LP whose nonzeros are dense (bm, bn) blocks at random block
    positions — zero padding waste in BlockSparseMatrix form, so benchmarks
    measure the kernel, not the packing heuristic.

    Feasibility by construction: A x0 <= b with margin; 0 <= x <= 10.
    """
    bm, bn = block_shape
    assert m % bm == 0 and n % bn == 0
    gm, gn = m // bm, n // bn
    rng = np.random.default_rng(seed)
    num_blocks = min(num_blocks, gm * gn)
    cells = rng.choice(gm * gn, size=num_blocks, replace=False)
    brows, bcols = cells // gn, cells % gn
    rows = (brows[:, None, None] * bm
            + np.arange(bm)[None, :, None]
            + np.zeros(bn, np.int64)[None, None, :]).ravel()
    cols = (bcols[:, None, None] * bn
            + np.zeros(bm, np.int64)[None, :, None]
            + np.arange(bn)[None, None, :]).ravel()
    vals = rng.standard_normal(num_blocks * bm * bn) / np.sqrt(bn)
    a = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    x0 = rng.uniform(0.0, 5.0, size=n)
    b = a @ x0 + rng.uniform(0.1, 1.0, size=m)
    return QuadraticProgram(
        objective_vector=rng.standard_normal(n),
        constraint_matrix=a,
        constraint_lower=np.full(m, -np.inf),
        constraint_upper=b,
        variable_lower=np.zeros(n),
        variable_upper=np.full(n, 10.0),
        name=f"block_random_lp_{m}x{n}_{num_blocks}b",
    )


def multicommodity_flow_lp(
    num_nodes: int,
    num_arcs: int,
    num_commodities: int,
    seed: int = 0,
) -> QuadraticProgram:
    """Synthetic multi-commodity min-cost flow LP (BASELINE config 5).

    Variables: flow[k, a] per commodity k and arc a.  Constraints:
    per-commodity flow conservation (equality rows) + joint arc capacities
    (inequality rows).  Structure: block-diagonal incidence blocks plus a
    wide capacity band — the canonical large sparse LP shape.
    """
    rng = np.random.default_rng(seed)
    # random connected-ish digraph
    tails = rng.integers(0, num_nodes, size=num_arcs)
    heads = (tails + 1 + rng.integers(0, num_nodes - 1, size=num_arcs)) % num_nodes
    n = num_commodities * num_arcs
    rows, cols, vals = [], [], []
    b_eq = np.zeros(num_commodities * num_nodes)
    for k in range(num_commodities):
        base_r = k * num_nodes
        base_c = k * num_arcs
        rows.extend(base_r + tails)
        cols.extend(base_c + np.arange(num_arcs))
        vals.extend(np.ones(num_arcs))
        rows.extend(base_r + heads)
        cols.extend(base_c + np.arange(num_arcs))
        vals.extend(-np.ones(num_arcs))
        src, dst = rng.choice(num_nodes, size=2, replace=False)
        demand = float(rng.uniform(1.0, 5.0))
        b_eq[base_r + src] = demand
        b_eq[base_r + dst] = -demand
    # capacity rows: sum_k flow[k,a] <= cap_a
    cap_rows = num_commodities * num_nodes + np.repeat(
        np.arange(num_arcs), num_commodities
    )
    cap_cols = (
        np.tile(np.arange(num_commodities) * num_arcs, num_arcs)
        + np.repeat(np.arange(num_arcs), num_commodities)
    )
    rows.extend(cap_rows)
    cols.extend(cap_cols)
    vals.extend(np.ones(len(cap_rows)))
    m = num_commodities * num_nodes + num_arcs
    a = sp.csr_matrix(
        (np.asarray(vals, dtype=np.float64), (np.asarray(rows), np.asarray(cols))),
        shape=(m, n),
    )
    caps = rng.uniform(2.0, 20.0, size=num_arcs)
    lo = np.concatenate([b_eq, np.full(num_arcs, -np.inf)])
    hi = np.concatenate([b_eq, caps])
    cost = rng.uniform(1.0, 10.0, size=n)
    return QuadraticProgram(
        objective_vector=cost,
        constraint_matrix=a,
        constraint_lower=lo,
        constraint_upper=hi,
        variable_lower=np.zeros(n),
        variable_upper=np.full(n, np.inf),
        name=f"mcf_{num_nodes}n_{num_arcs}a_{num_commodities}k",
    )
