"""Vehicle-routing model + search.

Capability parity: ``ortools/constraint_solver/routing.h:250`` (RoutingModel)
scoped to round 1:

- transit/demand callbacks, per-vehicle arc costs, dimensions with
  capacities and cumul bounds (time windows), disjunctions (optional
  visits with penalty);
- first solution: PATH_CHEAPEST_ARC (greedy append, reference
  routing_enums.proto:38) or PARALLEL_CHEAPEST_INSERTION;
- improvement: 2-opt (intra-route, vectorized delta evaluation over the
  full matrix — the numpy stand-in for the device move-batch design),
  Or-opt relocate (intra + inter route), inter-route exchange, with
  feasibility re-checked through dimension prefix sums (the role of the
  reference's PathState filters, constraint_solveri.h:3072);
- metaheuristic: greedy descent or GUIDED_LOCAL_SEARCH (penalized arc
  costs, routing_enums.proto:130).

The heavy neighborhoods operate on numpy arrays of routes; this layer is
deliberately host-side (the reference's is too), with the CP layer
available for certification via sat.add_circuit on small instances.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ortools_tpu.routing.index_manager import RoutingIndexManager


class FirstSolutionStrategy(enum.Enum):
    """Reference: routing_enums.proto:38-100 (same member numbering)."""

    AUTOMATIC = 0
    PATH_CHEAPEST_ARC = 3
    PARALLEL_CHEAPEST_INSERTION = 8
    LOCAL_CHEAPEST_INSERTION = 9
    SAVINGS = 10
    SWEEP = 11


class LocalSearchMetaheuristic(enum.Enum):
    """Reference: routing_enums.proto:130-140."""

    AUTOMATIC = 0
    GREEDY_DESCENT = 1
    GUIDED_LOCAL_SEARCH = 2
    SIMULATED_ANNEALING = 3
    TABU_SEARCH = 4


@dataclasses.dataclass
class RoutingSearchParameters:
    first_solution_strategy: FirstSolutionStrategy = (
        FirstSolutionStrategy.AUTOMATIC
    )
    local_search_metaheuristic: LocalSearchMetaheuristic = (
        LocalSearchMetaheuristic.AUTOMATIC
    )
    time_limit_seconds: float = 5.0
    solution_limit: int = 2**31
    gls_penalty_factor: float = 0.1
    log_search: bool = False
    # local-search operator depth: 1 = round-3 set (2-opt + relocate-1),
    # 2 = full catalogue (+ Or-opt chains 2-3, cross-exchange,
    # make-active/make-inactive).  Kept as a knob for ablation.
    ls_operator_level: int = 2
    # CP-SAT certification (reference routing_sat.cc role): after local
    # search, re-solve small supported models exactly through the CP
    # stack, warm-started from the LS solution; the result replaces the
    # LS solution when it is at least as good.  0 disables; otherwise
    # the share of the time budget reserved for certification.
    cp_sat_certification_share: float = 0.0


def _sa_accept(delta: float, temp: float) -> float:
    import math as _math

    try:
        return _math.exp(-delta / max(temp, 1e-9))
    except OverflowError:
        return 0.0


def default_routing_search_parameters() -> RoutingSearchParameters:
    return RoutingSearchParameters()


@dataclasses.dataclass
class _Dimension:
    name: str
    evaluator_index: int
    slack_max: int
    capacities: List[int]
    fix_start_cumul_to_zero: bool
    cumul_lb: Dict[int, int] = dataclasses.field(default_factory=dict)
    cumul_ub: Dict[int, int] = dataclasses.field(default_factory=dict)
    span_cost_coefficient: int = 0
    breaks_per_vehicle: Dict[int, list] = dataclasses.field(
        default_factory=dict)

    def set_cumul_var_range(self, index: int, lo: int, hi: int) -> None:
        self.cumul_lb[index] = lo
        self.cumul_ub[index] = hi

    # reference-style accessor object
    def cumul_var(self, index: int) -> int:
        return index

    CumulVar = cumul_var
    SetCumulVarRange = set_cumul_var_range

    def set_global_span_cost_coefficient(self, coeff: int) -> None:
        self.span_cost_coefficient = int(coeff)

    SetGlobalSpanCostCoefficient = set_global_span_cost_coefficient

    def set_break_intervals_of_vehicle(self, breaks, vehicle: int) -> None:
        """Breaks the vehicle must take during its route (reference
        routing.h:2849 SetBreakIntervalsOfVehicle); scheduled along fixed
        routes by routing/breaks.py."""
        self.breaks_per_vehicle[int(vehicle)] = list(breaks)

    SetBreakIntervalsOfVehicle = set_break_intervals_of_vehicle


class Assignment:
    """Solution container (reference Assignment, scoped to route reading)."""

    def __init__(self, model: "RoutingModel", routes: List[List[int]],
                 objective: int) -> None:
        self._model = model
        self._routes = routes  # internal indices, start..end per vehicle
        self._objective = objective
        self._next: Dict[int, int] = {}
        for r in routes:
            for a, b in zip(r, r[1:]):
                self._next[a] = b

    def objective_value(self) -> int:
        return self._objective

    ObjectiveValue = objective_value

    def value(self, next_of_index: int) -> int:
        return self._next[next_of_index]

    Value = value

    def routes(self) -> List[List[int]]:
        return [list(r) for r in self._routes]


class ResourceGroup:
    """Reference routing.h ResourceGroup: resources with per-dimension
    start/end cumul windows; one resource per active vehicle."""

    def __init__(self, model: "RoutingModel") -> None:
        self._model = model
        self.resources: List[tuple] = []

    def add_resource(self, dimension_name: str,
                     start_window: Sequence[int],
                     end_window: Sequence[int]) -> int:
        """Add a resource imposing ``start_window``/``end_window`` (lo,
        hi) on the named dimension's start/end cumul of the vehicle that
        claims it.  Returns the resource index."""
        self.resources.append((str(dimension_name),
                               (int(start_window[0]), int(start_window[1])),
                               (int(end_window[0]), int(end_window[1]))))
        return len(self.resources) - 1

    AddResource = add_resource


class RoutingModel:
    def __init__(self, manager: RoutingIndexManager) -> None:
        self.manager = manager
        self._callbacks: List[Callable[[int, int], int]] = []
        self._unary_callbacks: Dict[int, Callable[[int], int]] = {}
        self._arc_cost_evaluator: Optional[int] = None
        self._vehicle_cost_evaluators: Dict[int, int] = {}
        self._dimensions: Dict[str, _Dimension] = {}
        self._disjunctions: List[Tuple[List[int], int]] = []
        self._pd_pairs: List[Tuple[int, int]] = []
        self._resource_groups: List[ResourceGroup] = []
        self._fixed_vehicle_cost = [0] * manager.num_vehicles
        self._closed = False
        self._initial_routes: Optional[List[List[int]]] = None

    # -- callbacks -------------------------------------------------------
    def register_transit_callback(self, fn: Callable[[int, int], int]) -> int:
        self._callbacks.append(fn)
        return len(self._callbacks) - 1

    RegisterTransitCallback = register_transit_callback

    def register_unary_transit_callback(self, fn: Callable[[int], int]) -> int:
        idx = self.register_transit_callback(lambda f, t: fn(f))
        self._unary_callbacks[idx] = fn
        return idx

    RegisterUnaryTransitCallback = register_unary_transit_callback

    def set_arc_cost_evaluator_of_all_vehicles(self, cb_index: int) -> None:
        self._arc_cost_evaluator = cb_index

    SetArcCostEvaluatorOfAllVehicles = set_arc_cost_evaluator_of_all_vehicles

    def set_arc_cost_evaluator_of_vehicle(self, cb_index: int,
                                          vehicle: int) -> None:
        self._vehicle_cost_evaluators[vehicle] = cb_index

    SetArcCostEvaluatorOfVehicle = set_arc_cost_evaluator_of_vehicle

    def set_fixed_cost_of_all_vehicles(self, cost: int) -> None:
        self._fixed_vehicle_cost = [int(cost)] * self.manager.num_vehicles

    SetFixedCostOfAllVehicles = set_fixed_cost_of_all_vehicles

    # -- dimensions ------------------------------------------------------
    def add_dimension(self, evaluator_index: int, slack_max: int,
                      capacity: int, fix_start_cumul_to_zero: bool,
                      name: str) -> bool:
        return self.add_dimension_with_vehicle_capacity(
            evaluator_index, slack_max,
            [capacity] * self.manager.num_vehicles,
            fix_start_cumul_to_zero, name,
        )

    AddDimension = add_dimension

    def add_dimension_with_vehicle_capacity(
        self, evaluator_index: int, slack_max: int,
        vehicle_capacities: Sequence[int], fix_start_cumul_to_zero: bool,
        name: str,
    ) -> bool:
        self._dimensions[name] = _Dimension(
            name=name,
            evaluator_index=evaluator_index,
            slack_max=int(slack_max),
            capacities=[int(c) for c in vehicle_capacities],
            fix_start_cumul_to_zero=fix_start_cumul_to_zero,
        )
        return True

    AddDimensionWithVehicleCapacity = add_dimension_with_vehicle_capacity

    def get_dimension_or_die(self, name: str) -> _Dimension:
        return self._dimensions[name]

    GetDimensionOrDie = get_dimension_or_die

    # -- disjunctions ----------------------------------------------------
    def add_disjunction(self, indices: Sequence[int], penalty: int) -> None:
        self._disjunctions.append(([int(i) for i in indices], int(penalty)))

    AddDisjunction = add_disjunction

    # -- pickup & delivery ----------------------------------------------
    def add_pickup_and_delivery(self, pickup: int, delivery: int) -> None:
        """Same vehicle must visit pickup before delivery (reference
        routing.h AddPickupAndDelivery)."""
        self._pd_pairs.append((int(pickup), int(delivery)))

    AddPickupAndDelivery = add_pickup_and_delivery

    def _pd_ok(self, routes: List[List[int]]) -> bool:
        if not self._pd_pairs:
            return True
        where = {}
        for v, r in enumerate(routes):
            for pos, node in enumerate(r):
                where[node] = (v, pos)
        for p, d in self._pd_pairs:
            wp, wd = where.get(p), where.get(d)
            if wp is None and wd is None:
                continue  # both dropped
            if wp is None or wd is None:
                return False  # split pair
            if wp[0] != wd[0] or wp[1] >= wd[1]:
                return False
        return True

    # -- resource groups ---------------------------------------------------
    def add_resource_group(self) -> "ResourceGroup":
        """Resource group (reference routing.h ResourceGroup): each
        vehicle with a non-empty route must claim exactly one resource of
        the group (a resource serves at most one vehicle); a claimed
        resource imposes start/end cumul windows on a dimension."""
        g = ResourceGroup(self)
        self._resource_groups.append(g)
        return g

    AddResourceGroup = add_resource_group

    def _resource_route_ok(self, route, vehicle, dims, resource) -> bool:
        """Is the route feasible with the resource's start/end windows
        temporarily imposed on the vehicle's start/end cumuls?"""
        dim_name, (slo, shi), (elo, ehi) = resource
        d = self._dimensions[dim_name]
        mgr = self.manager
        si, ei = mgr.vehicle_start(vehicle), mgr.vehicle_end(vehicle)
        start_lb = d.cumul_lb.get(si, 0)
        if max(start_lb, slo) > shi:
            return False
        saved = [(si, d.cumul_lb.get(si), d.cumul_ub.get(si)),
                 (ei, d.cumul_lb.get(ei), d.cumul_ub.get(ei))]
        d.cumul_lb[si] = max(slo, d.cumul_lb.get(si, slo))
        d.cumul_ub[si] = min(shi, d.cumul_ub.get(si, shi))
        d.cumul_lb[ei] = max(elo, d.cumul_lb.get(ei, elo))
        d.cumul_ub[ei] = min(ehi, d.cumul_ub.get(ei, ehi))
        try:
            return self._route_feasible(route, vehicle, dims)
        finally:
            for key, lo0, hi0 in saved:
                if lo0 is None:
                    d.cumul_lb.pop(key, None)
                else:
                    d.cumul_lb[key] = lo0
                if hi0 is None:
                    d.cumul_ub.pop(key, None)
                else:
                    d.cumul_ub[key] = hi0

    def _resources_ok(self, routes, dims) -> bool:
        """Every group admits an injective vehicle -> resource assignment
        (bipartite matching by Kuhn's algorithm; groups are small)."""
        for g in self._resource_groups:
            active = [v for v, r in enumerate(routes) if r]
            if len(active) > len(g.resources):
                return False
            ok = {v: [ri for ri, res in enumerate(g.resources)
                      if self._resource_route_ok(routes[v], v, dims, res)]
                  for v in active}
            match: Dict[int, int] = {}  # resource -> vehicle

            def try_assign(v, seen) -> bool:
                for ri in ok[v]:
                    if ri in seen:
                        continue
                    seen.add(ri)
                    if ri not in match or try_assign(match[ri], seen):
                        match[ri] = v
                        return True
                return False

            for v in active:
                if not try_assign(v, set()):
                    return False
        return True

    # -- index helpers ---------------------------------------------------
    def start(self, vehicle: int) -> int:
        return self.manager.vehicle_start(vehicle)

    Start = start

    def end(self, vehicle: int) -> int:
        return self.manager.vehicle_end(vehicle)

    End = end

    def is_end(self, index: int) -> bool:
        return index >= self.manager.num_nodes + self.manager.num_vehicles

    IsEnd = is_end

    def next_var(self, index: int) -> int:
        """In this implementation NextVar(i) is identified by i itself;
        Assignment.value(next_var(i)) returns the successor index."""
        return index

    NextVar = next_var

    # -- cost helpers ----------------------------------------------------
    def _cost_cb(self, vehicle: int) -> Callable[[int, int], int]:
        idx = self._vehicle_cost_evaluators.get(vehicle,
                                                self._arc_cost_evaluator)
        assert idx is not None, "set an arc cost evaluator first"
        return self._callbacks[idx]

    def _build_matrices(self):
        mgr = self.manager
        n = mgr.get_number_of_indices()
        node_of = np.array([mgr.index_to_node(i) for i in range(n)])
        # per-vehicle cost matrix over *nodes* (usually shared)
        nn = mgr.num_nodes
        unique_nodes = sorted(set(node_of.tolist()))
        cost = {}
        for v in range(mgr.num_vehicles):
            cb = self._cost_cb(v)
            mat = np.zeros((mgr.num_nodes, mgr.num_nodes), dtype=np.int64)
            for a in unique_nodes:
                for b in unique_nodes:
                    mat[a, b] = cb(a, b)
            cost[v] = mat
        dims = []
        for d in self._dimensions.values():
            cb = self._callbacks[d.evaluator_index]
            mat = np.zeros((mgr.num_nodes, mgr.num_nodes), dtype=np.int64)
            unary = self._unary_callbacks.get(d.evaluator_index)
            for a in unique_nodes:
                if unary is not None:
                    mat[a, :] = unary(a)
                else:
                    for b in unique_nodes:
                        mat[a, b] = cb(a, b)
            dims.append((d, mat))
        return node_of, cost, dims

    # -- solving ---------------------------------------------------------
    def solve_with_parameters(
        self, params: Optional[RoutingSearchParameters] = None
    ) -> Optional[Assignment]:
        params = params or default_routing_search_parameters()
        deadline = time.perf_counter() + params.time_limit_seconds
        mgr = self.manager
        node_of, cost, dims = self._build_matrices()
        nn = mgr.num_nodes

        visits = [i for i in range(nn)
                  if i not in set(mgr._starts) | set(mgr._ends)]
        optional: Dict[int, int] = {}
        for idxs, pen in self._disjunctions:
            for i in idxs:
                optional[i] = pen

        if self._initial_routes is not None:
            routes0 = [list(r) for r in self._initial_routes]
            placed = {i for r in routes0 for i in r}
            dropped0 = [i for i in visits if i not in placed]
            if any(i not in optional for i in dropped0):
                return None
            for v, r in enumerate(routes0):
                if not self._route_feasible(r, v, dims):
                    return None
            if not self._pd_ok(routes0) or \
                    not self._resources_ok(routes0, dims):
                return None
            result = (routes0, dropped0)
        elif self._pd_pairs:
            result = self._first_solution_pd(visits, cost, dims, optional)
        else:
            strat = params.first_solution_strategy
            if strat == FirstSolutionStrategy.SAVINGS:
                result = self._fs_savings(visits, cost, dims, optional)
            elif strat == FirstSolutionStrategy.SWEEP:
                result = self._fs_sweep(visits, cost, dims, optional)
            elif strat == FirstSolutionStrategy.LOCAL_CHEAPEST_INSERTION:
                result = self._fs_local_cheapest_insertion(
                    visits, cost, dims, optional)
            else:
                result = None
            if result is None:
                result = self._first_solution(visits, cost, dims,
                                              optional)
        if result is None:
            # no heuristic start: the exact CP path may still find one
            # (reference routing_sat.cc role as a fallback solver)
            if params.cp_sat_certification_share > 0:
                from ortools_tpu.routing.sat_path import (
                    certify_hetero, certify_lazy_sec, solve_with_cp_sat)

                budget = max(1.0, params.time_limit_seconds
                             * params.cp_sat_certification_share)
                cert = certify_lazy_sec(self, time_limit_sec=budget)
                if cert is None:
                    cert = certify_hetero(self, time_limit_sec=budget)
                if cert is None:
                    cert = solve_with_cp_sat(self, time_limit_sec=budget)
                if cert is not None:
                    return cert[0]
            return None
        routes, dropped = result
        best = self._improve(routes, dropped, cost, dims, optional,
                             params, deadline)
        if best is None:
            return None
        routes, dropped = best
        if not self._resources_ok(routes, dims):
            # the search never reached a resource-consistent assignment
            return None
        # to internal-index routes
        internal = []
        for v, r in enumerate(routes):
            internal.append(
                [mgr.vehicle_start(v)] + list(r) + [mgr.vehicle_end(v)]
            )
        obj = self._objective(routes, dropped, cost, optional)
        if params.cp_sat_certification_share > 0:
            # exact certification through the CP stack (reference
            # routing_sat.cc role); keeps the LS solution unless the CP
            # solve matches or improves it
            from ortools_tpu.routing.sat_path import (
                certify_hetero, certify_lazy_sec, solve_with_cp_sat)

            budget = max(1.0, params.time_limit_seconds
                         * params.cp_sat_certification_share)
            cert = certify_lazy_sec(self, time_limit_sec=budget,
                                    warm_routes=routes)
            if cert is None:
                cert = certify_hetero(self, time_limit_sec=budget,
                                      warm_routes=routes)
            if cert is None:
                cert = solve_with_cp_sat(self, time_limit_sec=budget,
                                         warm_routes=routes)
            if cert is not None and cert[0].objective_value() <= obj:
                return cert[0]
        return Assignment(self, internal, obj)

    SolveWithParameters = solve_with_parameters

    def solve(self) -> Optional[Assignment]:
        return self.solve_with_parameters()

    Solve = solve

    def solve_from_routes(self, routes_by_vehicle: List[List[int]],
                          params: Optional[RoutingSearchParameters] = None
                          ) -> Optional[Assignment]:
        """Warm-started solve from given routes (node lists per vehicle,
        without depots) — the reference's SolveFromAssignmentWithParameters
        (routing.cc:2530)."""
        self._initial_routes = [list(r) for r in routes_by_vehicle]
        try:
            return self.solve_with_parameters(params)
        finally:
            self._initial_routes = None

    SolveFromRoutes = solve_from_routes

    def _first_solution_pd(self, visits, cost, dims, optional):
        """Joint pair insertion, then singles (parity: the reference's
        pickup-and-delivery-aware first solution strategies)."""
        mgr = self.manager
        nv = mgr.num_vehicles
        pair_nodes = {n for pr in self._pd_pairs for n in pr}
        pairs = [pr for pr in self._pd_pairs
                 if pr[0] in visits or pr[1] in visits]
        singles = [i for i in visits if i not in pair_nodes]
        routes: List[List[int]] = [[] for _ in range(nv)]

        def route_cost(v, r):
            seq = [mgr._starts[v]] + r + [mgr._ends[v]]
            return sum(int(cost[v][a, b]) for a, b in zip(seq, seq[1:]))

        dropped = []
        for p, d in pairs:
            best = None
            for v in range(nv):
                r = routes[v]
                base = route_cost(v, r)
                for i in range(len(r) + 1):
                    for j in range(i, len(r) + 1):
                        cand = r[:i] + [p] + r[i:j] + [d] + r[j:]
                        if not self._route_feasible(cand, v, dims):
                            continue
                        delta = route_cost(v, cand) - base
                        if best is None or delta < best[0]:
                            best = (delta, v, cand)
            if best is None:
                if p in optional and d in optional:
                    dropped.extend([p, d])
                    continue
                return None
            _, v, cand = best
            routes[v] = cand
        # singles via cheapest insertion with pd order preserved trivially
        for i in sorted(singles):
            best = None
            for v in range(nv):
                r = routes[v]
                base = route_cost(v, r)
                for pos in range(len(r) + 1):
                    cand = r[:pos] + [i] + r[pos:]
                    if not self._route_feasible(cand, v, dims):
                        continue
                    delta = route_cost(v, cand) - base
                    if i in optional and delta >= optional[i]:
                        continue
                    if best is None or delta < best[0]:
                        best = (delta, v, cand)
            if best is None:
                if i in optional:
                    dropped.append(i)
                    continue
                return None
            _, v, cand = best
            routes[v] = cand
        return routes, dropped

    # -- internals -------------------------------------------------------
    def _route_feasible(self, route: List[int], vehicle: int, dims) -> bool:
        mgr = self.manager
        start_node = mgr._starts[vehicle]
        end_node = mgr._ends[vehicle]
        for d, mat in dims:
            cap = d.capacities[vehicle]
            cumul = 0
            prev = start_node
            lo = d.cumul_lb.get(mgr.vehicle_start(vehicle))
            if lo is not None and not d.fix_start_cumul_to_zero:
                cumul = lo
            for i in route + [None]:
                node = end_node if i is None else i
                cumul += int(mat[prev, node])
                idx = mgr.vehicle_end(vehicle) if i is None else i
                lo = d.cumul_lb.get(idx)
                hi = d.cumul_ub.get(idx)
                if lo is not None and cumul < lo:
                    if d.slack_max == 0:
                        return False  # cannot wait
                    cumul = lo  # wait (slack) until the window opens
                if hi is not None and cumul > hi:
                    return False
                if cumul > cap:
                    return False
                prev = node
        return True

    def _objective(self, routes, dropped, cost, optional) -> int:
        mgr = self.manager
        total = 0
        for v, r in enumerate(routes):
            if not r and mgr._starts[v] == mgr._ends[v]:
                continue  # empty route: no cost
            prev = mgr._starts[v]
            if r:
                total += self._fixed_vehicle_cost[v]
            for i in r:
                total += int(cost[v][prev, i])
                prev = i
            total += int(cost[v][prev, mgr._ends[v]])
        for i in dropped:
            total += optional[i]
        return total

    def _first_solution(self, visits, cost, dims, optional):
        mgr = self.manager
        nv = mgr.num_vehicles
        routes: List[List[int]] = [[] for _ in range(nv)]
        unassigned = list(visits)
        # greedy cheapest insertion across all vehicles
        progress = True
        while unassigned and progress:
            progress = False
            best = None  # (delta, visit, vehicle, pos)
            for i in unassigned:
                for v in range(nv):
                    r = routes[v]
                    s_node = mgr._starts[v]
                    e_node = mgr._ends[v]
                    seq = [s_node] + r + [e_node]
                    for pos in range(len(r) + 1):
                        a, b = seq[pos], seq[pos + 1]
                        delta = (int(cost[v][a, i]) + int(cost[v][i, b])
                                 - int(cost[v][a, b]))
                        if i in optional and delta >= optional[i]:
                            continue  # dropping is cheaper than inserting
                        if best is None or delta < best[0]:
                            cand = r[:pos] + [i] + r[pos:]
                            if self._route_feasible(cand, v, dims):
                                best = (delta, i, v, pos)
            if best is not None:
                _, i, v, pos = best
                routes[v] = routes[v][:pos] + [i] + routes[v][pos:]
                unassigned.remove(i)
                progress = True
        dropped = []
        mandatory_left = [i for i in unassigned if i not in optional]
        if mandatory_left:
            # cheapest-insertion dead-ended (e.g. unbalanced loads);
            # retry bin-packing style: hardest (largest-demand) visits
            # first, any feasible position, cheapest among them
            ffd = self._first_solution_ffd(visits, cost, dims, optional)
            if ffd is not None:
                return ffd
            # last tier: pack the MANDATORY visits only (optional nodes
            # can crowd out mandatory ones under tight capacities), then
            # re-insert optionals greedily where still feasible
            mandatory = [i for i in visits if i not in optional]
            ffd = self._first_solution_ffd(mandatory, cost, dims, {})
            if ffd is None:
                return None
            routes2, _ = ffd
            dropped2 = []
            for i in sorted((j for j in visits if j in optional),
                            key=lambda j: -optional[j]):
                best = None
                for v in range(nv):
                    r = routes2[v]
                    seq = [mgr._starts[v]] + r + [mgr._ends[v]]
                    for pos in range(len(r) + 1):
                        a, b = seq[pos], seq[pos + 1]
                        delta = (int(cost[v][a, i]) + int(cost[v][i, b])
                                 - int(cost[v][a, b]))
                        if delta >= optional[i]:
                            continue
                        if best is not None and delta >= best[0]:
                            continue
                        cand = r[:pos] + [i] + r[pos:]
                        if self._route_feasible(cand, v, dims):
                            best = (delta, v, pos)
                if best is None:
                    dropped2.append(i)
                else:
                    _, v, pos = best
                    routes2[v] = routes2[v][:pos] + [i] + routes2[v][pos:]
            return routes2, dropped2
        for i in unassigned:
            dropped.append(i)
        return routes, dropped

    def _first_solution_ffd(self, visits, cost, dims, optional):
        mgr = self.manager
        nv = mgr.num_vehicles
        routes: List[List[int]] = [[] for _ in range(nv)]
        # order visits by total dimension demand, decreasing
        def demand_key(i):
            tot = 0
            for d, mat in dims:
                tot += int(mat[i].max())
            return -tot

        dropped = []
        for i in sorted(visits, key=demand_key):
            best = None
            for v in range(nv):
                r = routes[v]
                seq = [mgr._starts[v]] + r + [mgr._ends[v]]
                for pos in range(len(r) + 1):
                    a, b = seq[pos], seq[pos + 1]
                    delta = (int(cost[v][a, i]) + int(cost[v][i, b])
                             - int(cost[v][a, b]))
                    if best is not None and delta >= best[0]:
                        continue
                    cand = r[:pos] + [i] + r[pos:]
                    if self._route_feasible(cand, v, dims):
                        best = (delta, v, pos)
            if best is None:
                if i in optional:
                    dropped.append(i)
                    continue
                return None
            _, v, pos = best
            routes[v] = routes[v][:pos] + [i] + routes[v][pos:]
        return routes, dropped

    # -- first-solution catalogue (routing_enums.proto:38-100) -----------

    def _fs_local_cheapest_insertion(self, visits, cost, dims, optional):
        """LOCAL_CHEAPEST_INSERTION: visits inserted one by one (model
        order) at the cheapest feasible position found so far — O(n) per
        visit vs the O(n^2) global scan of parallel cheapest insertion."""
        mgr = self.manager
        nv = mgr.num_vehicles
        routes: List[List[int]] = [[] for _ in range(nv)]
        dropped: List[int] = []
        for i in visits:
            best = None
            for v in range(nv):
                r = routes[v]
                seq = [mgr._starts[v]] + r + [mgr._ends[v]]
                for pos in range(len(r) + 1):
                    a, b = seq[pos], seq[pos + 1]
                    delta = (int(cost[v][a, i]) + int(cost[v][i, b])
                             - int(cost[v][a, b]))
                    if i in optional and delta >= optional[i]:
                        continue
                    if best is not None and delta >= best[0]:
                        continue
                    cand = r[:pos] + [i] + r[pos:]
                    if self._route_feasible(cand, v, dims):
                        best = (delta, v, pos)
            if best is None:
                if i in optional:
                    dropped.append(i)
                    continue
                return None
            _, v, pos = best
            routes[v] = routes[v][:pos] + [i] + routes[v][pos:]
        return routes, dropped

    def _fs_savings(self, visits, cost, dims, optional):
        """SAVINGS (Clarke-Wright): every visit starts in its own route;
        route pairs merge end-to-start in decreasing order of
        s(i, j) = c(i, end) + c(start, j) - c(i, j), capacity/window
        checked by the route filter on the merged candidate."""
        mgr = self.manager
        nv = mgr.num_vehicles
        if nv == 0 or not visits:
            return None
        # seed: each visit alone (only nv routes can survive; extras are
        # merged or dropped below).  Use vehicle-0 matrices for savings
        # ranking (the classic homogeneous-fleet formulation); final
        # feasibility uses the true per-vehicle data.
        c0 = cost[0]
        s0, e0 = mgr._starts[0], mgr._ends[0]
        singles = [i for i in visits]
        routes: List[List[int]] = [[i] for i in singles]
        savings = []
        for i in singles:
            for j in singles:
                if i != j:
                    s = int(c0[i, e0]) + int(c0[s0, j]) - int(c0[i, j])
                    savings.append((s, i, j))
        savings.sort(key=lambda t: -t[0])
        route_of = {i: k for k, i in enumerate(singles)}
        for s, i, j in savings:
            ri, rj = route_of[i], route_of[j]
            if ri == rj:
                continue
            # merge only tail(i) -> head(j)
            if routes[ri][-1] != i or routes[rj][0] != j:
                continue
            merged = routes[ri] + routes[rj]
            if not self._route_feasible(merged, 0, dims):
                continue
            routes[ri] = merged
            for x in routes[rj]:
                route_of[x] = ri
            routes[rj] = []
        built = [r for r in routes if r]
        # assign the built routes to vehicles, largest first; leftovers
        # go through cheapest insertion / drop
        built.sort(key=len, reverse=True)
        out: List[List[int]] = [[] for _ in range(nv)]
        leftover: List[int] = []
        vi = 0
        for r in built:
            placed = False
            while vi < nv:
                if self._route_feasible(r, vi, dims):
                    out[vi] = r
                    vi += 1
                    placed = True
                    break
                vi += 1
            if not placed:
                leftover.extend(r)
        dropped: List[int] = []
        for i in leftover:
            best = None
            for v in range(nv):
                r = out[v]
                seq = [mgr._starts[v]] + r + [mgr._ends[v]]
                for pos in range(len(r) + 1):
                    a, b = seq[pos], seq[pos + 1]
                    delta = (int(cost[v][a, i]) + int(cost[v][i, b])
                             - int(cost[v][a, b]))
                    if best is not None and delta >= best[0]:
                        continue
                    cand = r[:pos] + [i] + r[pos:]
                    if self._route_feasible(cand, v, dims):
                        best = (delta, v, pos)
            if best is None:
                if i in optional:
                    dropped.append(i)
                    continue
                return None
            _, v, pos = best
            out[v] = out[v][:pos] + [i] + out[v][pos:]
        return out, dropped

    def _fs_sweep(self, visits, cost, dims, optional):
        """SWEEP: cluster visits by polar angle around the depot, then
        build each cluster's route by cheapest insertion.  Node
        coordinates are not available (only cost callbacks), so angles
        are recovered from distances via the two-landmark embedding
        x ~ d(depot, i), y ~ d(A, i) - d(B, i) with far-apart landmarks
        A, B — exact up to reflection for Euclidean data, a serviceable
        proxy otherwise."""
        import math as _math

        mgr = self.manager
        nv = mgr.num_vehicles
        if nv == 0 or not visits:
            return None
        c0 = cost[0]
        dep = mgr._starts[0]
        a_lm = max(visits, key=lambda i: int(c0[dep, i]))
        b_lm = max(visits, key=lambda i: int(c0[a_lm, i]))
        ang = {}
        for i in visits:
            x = float(c0[a_lm, i]) - float(c0[b_lm, i])
            y = float(c0[dep, i])
            ang[i] = _math.atan2(y, x)
        order = sorted(visits, key=lambda i: ang[i])
        # contiguous angular slices, one per vehicle
        k = max(1, (len(order) + nv - 1) // nv)
        routes: List[List[int]] = [[] for _ in range(nv)]
        leftover: List[int] = []
        for v in range(nv):
            cluster = order[v * k:(v + 1) * k]
            for i in cluster:
                r = routes[v]
                seq = [mgr._starts[v]] + r + [mgr._ends[v]]
                best = None
                for pos in range(len(r) + 1):
                    a, b = seq[pos], seq[pos + 1]
                    delta = (int(cost[v][a, i]) + int(cost[v][i, b])
                             - int(cost[v][a, b]))
                    if best is not None and delta >= best[0]:
                        continue
                    cand = r[:pos] + [i] + r[pos:]
                    if self._route_feasible(cand, v, dims):
                        best = (delta, pos)
                if best is None:
                    leftover.append(i)
                else:
                    routes[v] = r[:best[1]] + [i] + r[best[1]:]
        dropped: List[int] = []
        for i in leftover:
            best = None
            for v in range(nv):
                r = routes[v]
                seq = [mgr._starts[v]] + r + [mgr._ends[v]]
                for pos in range(len(r) + 1):
                    a, b = seq[pos], seq[pos + 1]
                    delta = (int(cost[v][a, i]) + int(cost[v][i, b])
                             - int(cost[v][a, b]))
                    if best is not None and delta >= best[0]:
                        continue
                    cand = r[:pos] + [i] + r[pos:]
                    if self._route_feasible(cand, v, dims):
                        best = (delta, v, pos)
            if best is None:
                if i in optional:
                    dropped.append(i)
                    continue
                return None
            _, v, pos = best
            routes[v] = routes[v][:pos] + [i] + routes[v][pos:]
        return routes, dropped

    def _route_cost(self, v: int, r: List[int], cost) -> int:
        """True cost of one route (the per-route term of _objective)."""
        mgr = self.manager
        if not r and mgr._starts[v] == mgr._ends[v]:
            return 0
        total = self._fixed_vehicle_cost[v] if r else 0
        prev = mgr._starts[v]
        for i in r:
            total += int(cost[v][prev, i])
            prev = i
        total += int(cost[v][prev, mgr._ends[v]])
        return total

    def _improve(self, routes, dropped, cost, dims, optional, params,
                 deadline):
        """Local search over the route set.

        Reference roles: the LocalSearchOperator/PathOperator zoo
        (constraint_solveri.h:912-1300), LocalSearchFilter incremental
        feasibility (:1756), and the GLS / tabu / SA metaheuristic
        monitors (routing_enums.proto:130-140).  Redesigned around
        per-route incremental evaluation: the objective is separable by
        route, so a move touching k routes costs O(route length * k),
        never O(model); route feasibility is memoized (the filter role —
        (vehicle, route) feasibility is solve-invariant)."""
        import random as _random

        mgr = self.manager
        meta = params.local_search_metaheuristic
        use_gls = meta == LocalSearchMetaheuristic.GUIDED_LOCAL_SEARCH
        use_sa = meta == LocalSearchMetaheuristic.SIMULATED_ANNEALING
        use_tabu = meta == LocalSearchMetaheuristic.TABU_SEARCH
        rng = _random.Random(12421)
        penalties: Dict[Tuple[int, int], int] = {}
        has_global_filters = bool(self._pd_pairs) or bool(
            self._resource_groups)
        feas_cache: Dict[Tuple[int, Tuple[int, ...]], bool] = {}

        def feas(v: int, r: List[int]) -> bool:
            key = (v, tuple(r))
            val = feas_cache.get(key)
            if val is None:
                val = self._route_feasible(r, v, dims)
                if len(feas_cache) < 300_000:
                    feas_cache[key] = val
            return val

        def rc(v: int, r: List[int]) -> int:
            return self._route_cost(v, r, cost)

        def penal(v, a, b):
            c = int(cost[v][a, b])
            if use_gls:
                c += int(params.gls_penalty_factor
                         * penalties.get((a, b), 0))
            return c

        cur = [list(r) for r in routes]
        cur_dropped = list(dropped)
        cur_cost = [rc(v, r) for v, r in enumerate(cur)]
        drop_pen = sum(optional[i] for i in cur_dropped)
        best_routes = [list(r) for r in cur]
        best_dropped = list(cur_dropped)
        best_obj = sum(cur_cost) + drop_pen

        node_penalty: Dict[int, int] = {}
        for idxs, pen in self._disjunctions:
            for i in idxs:
                node_penalty[i] = pen

        def global_ok(changes: Dict[int, List[int]]) -> bool:
            if not has_global_filters:
                return True
            trial = [changes.get(v, cur[v]) for v in range(len(cur))]
            return self._pd_ok(trial) and self._resources_ok(trial, dims)

        def commit(changes: Dict[int, List[int]],
                   drop_add: Optional[int] = None,
                   drop_rm: Optional[int] = None) -> bool:
            """Feasibility-check + true-delta-check + apply.  Returns
            True when the move strictly improved the true objective."""
            nonlocal drop_pen
            for v, r in changes.items():
                if not feas(v, r):
                    return False
            if not global_ok(changes):
                return False
            delta = 0
            new_costs = {}
            for v, r in changes.items():
                new_costs[v] = rc(v, r)
                delta += new_costs[v] - cur_cost[v]
            if drop_add is not None:
                delta += optional.get(drop_add, node_penalty.get(
                    drop_add, 0))
            if drop_rm is not None:
                delta -= optional.get(drop_rm, node_penalty.get(
                    drop_rm, 0))
            if delta >= 0:
                return False
            for v, r in changes.items():
                cur[v] = r
                cur_cost[v] = new_costs[v]
            if drop_add is not None:
                cur_dropped.append(drop_add)
                drop_pen += optional.get(drop_add,
                                         node_penalty.get(drop_add, 0))
            if drop_rm is not None:
                cur_dropped.remove(drop_rm)
                drop_pen -= optional.get(drop_rm,
                                         node_penalty.get(drop_rm, 0))
            return True

        def two_opt_pass() -> bool:
            improved = False
            for v in range(len(cur)):
                r = cur[v]
                n = len(r)
                if n < 2:
                    continue
                seq = [mgr._starts[v]] + r + [mgr._ends[v]]
                i = 0
                while i < n - 1:
                    j = i + 1
                    hit = False
                    while j < n:
                        a, b = seq[i], seq[i + 1]
                        c, d = seq[j + 1], seq[j + 2]
                        if (penal(v, a, c) + penal(v, b, d)
                                - penal(v, a, b) - penal(v, c, d)) < 0:
                            cand = r[:i] + r[i:j + 1][::-1] + r[j + 1:]
                            if commit({v: cand}):
                                r = cur[v]
                                n = len(r)
                                seq = ([mgr._starts[v]] + r
                                       + [mgr._ends[v]])
                                improved = True
                                hit = True
                                break
                        j += 1
                    i = 0 if hit else i + 1
            return improved

        def or_opt_pass(seg_len: int) -> bool:
            for v1 in range(len(cur)):
                r1 = cur[v1]
                s1_node, e1_node = mgr._starts[v1], mgr._ends[v1]
                seq1 = [s1_node] + r1 + [e1_node]
                for pos1 in range(len(r1) - seg_len + 1):
                    seg = r1[pos1:pos1 + seg_len]
                    a, b = seq1[pos1], seq1[pos1 + seg_len + 1]
                    gain = (penal(v1, a, seg[0])
                            + penal(v1, seg[-1], b) - penal(v1, a, b))
                    if gain <= 0:
                        continue  # removing this segment frees nothing
                    removed = r1[:pos1] + r1[pos1 + seg_len:]
                    for v2 in range(len(cur)):
                        base2 = removed if v2 == v1 else cur[v2]
                        seq2 = ([mgr._starts[v2]] + base2
                                + [mgr._ends[v2]])
                        for pos2 in range(len(base2) + 1):
                            if v2 == v1 and pos2 == pos1:
                                continue
                            c, d = seq2[pos2], seq2[pos2 + 1]
                            add = (penal(v2, c, seg[0])
                                   + penal(v2, seg[-1], d)
                                   - penal(v2, c, d))
                            if add >= gain and v2 == v1:
                                continue
                            r2 = base2[:pos2] + seg + base2[pos2:]
                            changes = ({v1: r2} if v2 == v1
                                       else {v1: removed, v2: r2})
                            if commit(changes):
                                return True
            return False

        def cross_exchange_pass() -> bool:
            nv = len(cur)
            for v1 in range(nv):
                for v2 in range(v1 + 1, nv):
                    for l1 in (1, 2):
                        for l2 in (1, 2):
                            r1, r2 = cur[v1], cur[v2]
                            for p1 in range(len(r1) - l1 + 1):
                                s1 = r1[p1:p1 + l1]
                                for p2 in range(len(r2) - l2 + 1):
                                    s2 = r2[p2:p2 + l2]
                                    n1 = r1[:p1] + s2 + r1[p1 + l1:]
                                    n2 = r2[:p2] + s1 + r2[p2 + l2:]
                                    if commit({v1: n1, v2: n2}):
                                        return True
            return False

        def make_active_pass() -> bool:
            for node in list(cur_dropped):
                for v in range(len(cur)):
                    r = cur[v]
                    for pos in range(len(r) + 1):
                        if commit({v: r[:pos] + [node] + r[pos:]},
                                  drop_rm=node):
                            return True
            return False

        def make_inactive_pass() -> bool:
            for v in range(len(cur)):
                r = cur[v]
                for pos, node in enumerate(r):
                    if node not in node_penalty:
                        continue
                    if commit({v: r[:pos] + r[pos + 1:]},
                              drop_add=node):
                        return True
            return False

        if getattr(params, "ls_operator_level", 2) <= 1:
            operators = [two_opt_pass, lambda: or_opt_pass(1)]
        else:
            operators = [two_opt_pass,
                         lambda: or_opt_pass(1),
                         lambda: or_opt_pass(2),
                         lambda: or_opt_pass(3),
                         cross_exchange_pass,
                         make_active_pass,
                         make_inactive_pass]

        # ---- metaheuristic monitors (stall handlers) -------------------
        sa_temp = [max(1.0, 0.02 * best_obj)]
        tabu_until: Dict[int, int] = {}
        tabu_iter = [0]
        tenure = max(4, (sum(len(r) for r in cur) or 1) // 4)

        def record_best() -> None:
            nonlocal best_obj, best_routes, best_dropped
            obj = sum(cur_cost) + drop_pen
            if obj < best_obj:
                best_obj = obj
                best_routes = [list(r) for r in cur]
                best_dropped = list(cur_dropped)

        def restore_best() -> None:
            nonlocal drop_pen
            cur[:] = [list(r) for r in best_routes]
            cur_dropped[:] = list(best_dropped)
            for v in range(len(cur)):
                cur_cost[v] = rc(v, cur[v])
            drop_pen = sum(optional[i] for i in cur_dropped)

        def sa_kick() -> None:
            """Perturb: random segment relocation (double-bridge style on
            single routes); Metropolis acceptance happens at the NEXT
            stall by comparing against the recorded best."""
            nonzero = [v for v in range(len(cur)) if len(cur[v]) >= 2]
            if not nonzero:
                return
            for _ in range(1 + rng.randrange(2)):
                v = rng.choice(nonzero)
                r = cur[v]
                if len(r) >= 4 and rng.random() < 0.5:
                    # double bridge
                    p = sorted(rng.sample(range(1, len(r)), 3))
                    cand = (r[:p[0]] + r[p[1]:p[2]] + r[p[0]:p[1]]
                            + r[p[2]:])
                else:
                    i = rng.randrange(len(r))
                    node = r[i]
                    rest = r[:i] + r[i + 1:]
                    j = rng.randrange(len(rest) + 1)
                    cand = rest[:j] + [node] + rest[j:]
                if feas(v, cand) and global_ok({v: cand}):
                    cur[v] = cand
                    cur_cost[v] = rc(v, cand)

        def tabu_step() -> bool:
            """Apply the best non-tabu relocate even if worsening
            (aspiration: tabu allowed when it would beat the best)."""
            tabu_iter[0] += 1
            it = tabu_iter[0]
            best_move = None  # (delta, v1, pos1, v2, pos2, node)
            for v1 in range(len(cur)):
                r1 = cur[v1]
                for pos1, node in enumerate(r1):
                    removed = r1[:pos1] + r1[pos1 + 1:]
                    for v2 in range(len(cur)):
                        base2 = removed if v2 == v1 else cur[v2]
                        for pos2 in range(len(base2) + 1):
                            if v2 == v1 and pos2 == pos1:
                                continue
                            r2 = base2[:pos2] + [node] + base2[pos2:]
                            changes = ({v1: r2} if v2 == v1
                                       else {v1: removed, v2: r2})
                            delta = sum(
                                rc(v, r) - cur_cost[v]
                                for v, r in changes.items())
                            is_tabu = tabu_until.get(node, 0) > it
                            aspire = (sum(cur_cost) + drop_pen + delta
                                      < best_obj)
                            if is_tabu and not aspire:
                                continue
                            if best_move is None or delta < best_move[0]:
                                if all(feas(v, r)
                                       for v, r in changes.items())                                         and global_ok(changes):
                                    best_move = (delta, changes, node)
            if best_move is None:
                return False
            _, changes, node = best_move
            nonlocal_drop = None
            for v, r in changes.items():
                cur[v] = r
                cur_cost[v] = rc(v, r)
            del nonlocal_drop
            tabu_until[node] = it + tenure
            return True

        stalls = 0
        while time.perf_counter() < deadline:
            improved = False
            for op in operators:
                if time.perf_counter() >= deadline:
                    break
                if op():
                    improved = True
            record_best()
            if improved:
                stalls = 0
                continue
            stalls += 1
            if use_gls:
                worst = None
                for v, r in enumerate(cur):
                    seq = [mgr._starts[v]] + r + [mgr._ends[v]]
                    for a, b in zip(seq, seq[1:]):
                        util = cost[v][a, b] / (
                            1 + penalties.get((a, b), 0))
                        if worst is None or util > worst[0]:
                            worst = (util, a, b)
                if worst is None:
                    break
                penalties[(worst[1], worst[2])] = (
                    penalties.get((worst[1], worst[2]), 0) + 1)
            elif use_sa:
                # Metropolis on the current local optimum
                obj = sum(cur_cost) + drop_pen
                delta = obj - best_obj
                if delta > 0 and rng.random() >= _sa_accept(
                        delta, sa_temp[0]):
                    restore_best()
                sa_temp[0] = max(1e-6, sa_temp[0] * 0.92)
                sa_kick()
            elif use_tabu:
                if not tabu_step():
                    break
                if stalls > 200:
                    break
            else:
                break
        record_best()
        return best_routes, best_dropped

    def __str__(self):
        return (f"RoutingModel({self.manager.num_nodes} nodes, "
                f"{self.manager.num_vehicles} vehicles)")
