"""Trust-region subproblems for PDLP's adaptive-heuristic restarts.

Capability parity: ``ortools/pdlp/trust_region.{h,cc}`` —
``SolveTrustRegion`` (trust_region.h:59) minimizes a linear objective over
a box-constrained Euclidean ball, and ``ComputeLocalizedLagrangianBounds``
(trust_region.h:170) evaluates the "localized duality gap" used by the
ADAPTIVE_HEURISTIC restart rule (primal_dual_hybrid_gradient.cc:1904).

The reference finds the exact ball multiplier by median search; here the
monotone scalar equation phi(lambda) = r^2 is solved by vectorized
bisection (60 iterations => ~1e-18 relative bracket), which is exact to
floating point for the restart decision's purposes and maps to the device as a
fixed-trip-count fori_loop over pure vector ops.

All computation is in the solver's scaled space, matching the reference
(which runs the restart logic on the working, rescaled QP).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TrustRegionResult(NamedTuple):
    primal_delta_objective: jax.Array  # gx . dx  (<= 0)
    dual_delta_objective: jax.Array  # gy . dy   (>= 0)
    gap: jax.Array  # dual_delta - primal_delta >= 0


def solve_joint_trust_region(gx, gy, x, y, lb, ub, ylb, yub, omega, radius,
                             num_bisections: int = 60) -> TrustRegionResult:
    """min gx.(x'-x) - gy.(y'-y)  s.t.  x' in [lb,ub], y' in [ylb,yub],
    (omega/2)||x'-x||^2 + (1/(2 omega))||y'-y||^2 <= radius^2.

    Solution: d(lambda) = clip(-g / (2 lambda w), box) with lambda >= 0 the
    ball multiplier; phi(lambda) = sum w d^2 is decreasing, solve
    phi(lambda) = r^2 by bisection (lambda = 0 when the box optimum is
    already inside the ball)."""
    dtype = gx.dtype
    g = jnp.concatenate([gx, -gy])
    z = jnp.concatenate([x, y])
    lo = jnp.concatenate([lb, ylb]) - z
    hi = jnp.concatenate([ub, yub]) - z
    # clamp: the center must lie inside the box (guard roundoff)
    lo = jnp.minimum(lo, 0.0)
    hi = jnp.maximum(hi, 0.0)
    w = jnp.concatenate([
        jnp.full_like(gx, omega / 2.0),
        jnp.full_like(gy, 1.0 / (2.0 * omega)),
    ])
    r2 = radius * radius

    def phi(lam):
        d = jnp.clip(-g / (2.0 * lam * w), lo, hi)
        return jnp.sum(w * d * d), d

    # lambda upper bound: |d| <= |g|/(2 lam w) => phi <= q / (4 lam^2)
    # with q = sum g^2 / w; phi(lam_hi) <= r^2.
    q = jnp.sum(g * g / w)
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    lam_hi = jnp.sqrt(q) / (2.0 * jnp.maximum(radius, tiny)) + tiny
    # box optimum (lambda -> 0): full move toward the favorable bound
    d0 = jnp.where(g > 0, lo, jnp.where(g < 0, hi, 0.0))
    phi0 = jnp.sum(w * d0 * d0)

    def body(_, lam_pair):
        lam_lo, lam_up = lam_pair
        mid = jnp.sqrt(lam_lo * lam_up)  # log-space bisection
        val, _ = phi(mid)
        return jnp.where(val > r2, mid, lam_lo), jnp.where(
            val > r2, lam_up, mid
        )

    lam_lo0 = lam_hi * jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-12, dtype)
    lam_lo, lam_up = jax.lax.fori_loop(
        0, num_bisections, body, (lam_lo0, lam_hi)
    )
    _, d_ball = phi(lam_up)
    use_box = phi0 <= r2
    d = jnp.where(use_box, d0, d_ball)

    n = gx.shape[0]
    primal_delta = jnp.vdot(gx, d[:n])
    dual_delta = jnp.vdot(gy, d[n:])
    return TrustRegionResult(
        primal_delta_objective=primal_delta,
        dual_delta_objective=dual_delta,
        gap=dual_delta - primal_delta,
    )


def dual_bounds(con_lb, con_ub):
    """The dual variable domain per row (PDLP saddle-point formulation):
    [0, inf) when only the lower bound is finite, (-inf, 0] when only the
    upper is, free for ranged rows, {0} when both are infinite."""
    lb_fin = jnp.isfinite(con_lb)
    ub_fin = jnp.isfinite(con_ub)
    # finite u forbids nothing below; infinite u forces y >= 0 (and vice
    # versa); both infinite collapses to {0}
    ylb = jnp.where(ub_fin, -jnp.inf, 0.0)
    yub = jnp.where(lb_fin, jnp.inf, 0.0)
    return ylb, yub


def dual_subgradient(con_lb, con_ub, y, ax):
    """Reference DualSubgradientCoefficient
    (sharded_optimization_utils.h:149): l when y > 0, u when y < 0; at
    y == 0 the finite bound if only one is finite, clip(ax, l, u) if both
    are, 0 if none."""
    lb_fin = jnp.isfinite(con_lb)
    ub_fin = jnp.isfinite(con_ub)
    at_zero = jnp.where(
        lb_fin & ub_fin, jnp.clip(ax, con_lb, con_ub),
        jnp.where(lb_fin, con_lb, jnp.where(ub_fin, con_ub, 0.0)),
    )
    return jnp.where(y > 0, con_lb, jnp.where(y < 0, con_ub, at_zero))


class LocalizedGap(NamedTuple):
    radius: jax.Array
    gap: jax.Array
    normalized_gap: jax.Array  # gap / radius
    potential: jax.Array  # gap / radius^2 (candidate comparison)


def localized_gap(prob, x, y, ax, aty, x_start, y_start,
                  omega) -> LocalizedGap:
    """Localized duality gap of iterate (x, y) at radius = its omega-norm
    distance from the restart start point (all scaled space); reference
    ComputeLocalizedBoundsAtCurrent/Average
    (primal_dual_hybrid_gradient.cc:1804-1835)."""
    dx = x - x_start
    dy = y - y_start
    radius = jnp.sqrt(
        0.5 * omega * jnp.vdot(dx, dx) + 0.5 / omega * jnp.vdot(dy, dy)
    )
    gx = prob.c + prob.q * x - aty
    s = dual_subgradient(prob.con_lb, prob.con_ub, y, ax)
    gy = s - ax
    ylb, yub = dual_bounds(prob.con_lb, prob.con_ub)
    safe_radius = jnp.maximum(radius, jnp.finfo(x.dtype).tiny)
    tr = solve_joint_trust_region(
        gx, gy, x, y, prob.var_lb, prob.var_ub, ylb, yub, omega, safe_radius
    )
    return LocalizedGap(
        radius=radius,
        gap=tr.gap,
        normalized_gap=tr.gap / safe_radius,
        potential=tr.gap / (safe_radius * safe_radius),
    )
