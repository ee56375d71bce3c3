"""TSP helper algorithms.

Capability parity: ``ortools/graph`` — hamiltonian_path.h (Held-Karp DP),
christofides.h (1.5-approx for metric TSP), one_tree_lower_bound.h
(Held-Karp 1-tree bound via subgradient ascent).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def held_karp_tsp(dist: np.ndarray, start: int = 0
                  ) -> Tuple[float, List[int]]:
    """Exact TSP tour by Held-Karp DP, O(2^n n^2).  n <= ~18.

    The DP over subsets is expressed as dense numpy updates per subset
    size (the same table layout vectorizes on device for batched instances).
    """
    n = dist.shape[0]
    assert n <= 20, "Held-Karp is exponential; use routing for larger n"
    full = 1 << n
    inf = np.inf
    dp = np.full((full, n), inf)
    parent = np.full((full, n), -1, dtype=np.int64)
    dp[1 << start, start] = 0.0
    for mask in range(full):
        if not (mask >> start) & 1:
            continue
        row = dp[mask]
        for last in range(n):
            if row[last] == inf or not (mask >> last) & 1:
                continue
            base = row[last]
            for nxt in range(n):
                if (mask >> nxt) & 1:
                    continue
                nm = mask | (1 << nxt)
                cand = base + dist[last, nxt]
                if cand < dp[nm, nxt]:
                    dp[nm, nxt] = cand
                    parent[nm, nxt] = last
    best_cost = inf
    best_last = -1
    last_mask = full - 1
    for last in range(n):
        if last == start and n > 1:
            continue
        c = dp[last_mask, last] + dist[last, start]
        if c < best_cost:
            best_cost = c
            best_last = last
    tour = []
    mask, last = last_mask, best_last
    while last != -1:
        tour.append(last)
        nlast = parent[mask, last]
        mask ^= 1 << last
        last = nlast
    tour.reverse()
    return float(best_cost), tour


def christofides_tsp(dist: np.ndarray) -> Tuple[float, List[int]]:
    """Christofides 1.5-approximation for symmetric metric TSP:
    MST + MINIMUM perfect matching on odd-degree nodes (graph/matching.py:
    exact via the MIP path up to 30 odd nodes, greedy + 2-exchange beyond)
    + Eulerian circuit + shortcutting."""
    from ortools_tpu.graph.components import (
        eulerian_path,
        minimum_spanning_tree,
    )
    from ortools_tpu.graph.matching import min_weight_perfect_matching

    n = dist.shape[0]
    if n == 1:
        return 0.0, [0]
    edges = [(i, j, float(dist[i, j]))
             for i in range(n) for j in range(i + 1, n)]
    mst = minimum_spanning_tree(n, edges)
    deg = np.zeros(n, dtype=np.int64)
    mst_edges = []
    for k in mst:
        a, b, _ = edges[k]
        deg[a] += 1
        deg[b] += 1
        mst_edges.append((a, b))
    odd = np.nonzero(deg % 2 == 1)[0]
    match_edges = []
    if len(odd):
        match_edges = min_weight_perfect_matching(
            dist.astype(float), [int(v) for v in odd])
    multi = mst_edges + match_edges
    circuit = eulerian_path(n, multi)
    assert circuit is not None
    seen = set()
    tour = []
    for v in circuit:
        if v not in seen:
            seen.add(v)
            tour.append(v)
    cost = sum(float(dist[a, b]) for a, b in zip(tour, tour[1:] + [tour[0]]))
    return cost, tour


def one_tree_lower_bound(dist: np.ndarray, iterations: int = 100
                         ) -> float:
    """Held-Karp 1-tree lower bound with subgradient ascent on node
    potentials (reference one_tree_lower_bound.h)."""
    from ortools_tpu.graph.components import minimum_spanning_tree

    n = dist.shape[0]
    if n < 3:
        return float(dist[0, 1] * 2) if n == 2 else 0.0
    pi = np.zeros(n)
    best = -np.inf
    step = float(dist[np.isfinite(dist)].mean()) / n + 1.0
    for it in range(iterations):
        mod = dist + pi[:, None] + pi[None, :]
        # MST over nodes 1..n-1
        edges = [(i, j, float(mod[i, j]))
                 for i in range(1, n) for j in range(i + 1, n)]
        mst = minimum_spanning_tree(n - 1 + 1, edges)
        deg = np.zeros(n, dtype=np.int64)
        w = 0.0
        for k in mst:
            a, b, c = edges[k]
            deg[a] += 1
            deg[b] += 1
            w += c
        # add the two cheapest arcs from node 0
        order = np.argsort(mod[0, 1:])[:2] + 1
        for j in order:
            w += float(mod[0, j])
            deg[j] += 1
        deg[0] = 2
        bound = w - 2.0 * float(pi.sum())
        best = max(best, bound)
        grad = deg - 2
        if not np.any(grad):
            break
        pi = pi + step * grad
        step *= 0.95
    return float(best)
