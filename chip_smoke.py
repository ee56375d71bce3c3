"""Prove on one GPU that the PDLP device path runs and gives right answers.

    python chip_smoke.py           # one GPU: device, spmv, lp, batch, mip
    python chip_smoke.py --multi   # four GPUs: the MCF LP on meshes (4,), (2, 2)

Each phase prints one line; any failure raises, so the script exits
non-zero and never prints the last line, which is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
There is no CPU fallback: the device phase fails unless JAX's default
backend is the GPU.

References: scipy f64 CSR products for the SpMV, scipy HiGHS
(``linprog``/``milp``) for objectives, and primal/dual residuals
recomputed in f64 on the host.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The LPs of the lp phase: the bench LP (4.2M nnz in dense blocks) and a
# multicommodity-flow LP with 1M nnz, 28,300 x 345,600.
BENCH_LP = dict(m=16384, n=16384, num_blocks=4096)
MCF_LP = (200, 2700, 128)
# The battery's largest set cover: its LP relaxations feed the batch phase.
SET_COVER = dict(n=400, m=150, density=0.04, seed=3)
# The mip phase solves the battery's first set cover to proven optimality:
# the largest one takes HiGHS about 235 s alone on a CPU core, and
# mip.solve ends FEASIBLE on it within 120 s.
MIP_SET_COVER = dict(n=150, m=60, seed=1)
BATCH = 64
SPMV_REPS = 50


def _log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


@contextlib.contextmanager
def compile_seconds():
    """Seconds XLA spent compiling in the block (a one-element list,
    filled as compilations finish)."""
    import jax

    total = [0.0]

    def listener(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            total[0] += duration

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield total
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)


# ---------------------------------------------------------------------------
# Host references
# ---------------------------------------------------------------------------


def highs_lp(qp) -> float:
    from scipy.optimize import linprog

    qp = qp.as_minimization()
    a = sp.csr_matrix(qp.constraint_matrix)
    lo, hi = qp.constraint_lower, qp.constraint_upper
    eq = lo == hi
    up = ~eq & np.isfinite(hi)
    dn = ~eq & np.isfinite(lo)
    a_ub = sp.vstack([a[up], -a[dn]], format="csr")
    b_ub = np.concatenate([hi[up], -lo[dn]])
    res = linprog(qp.objective_vector, A_ub=a_ub, b_ub=b_ub,
                  A_eq=a[eq], b_eq=lo[eq],
                  bounds=np.stack([qp.variable_lower, qp.variable_upper], 1),
                  method="highs")
    if res.status != 0:
        raise RuntimeError(f"HiGHS failed on {qp.name}: {res.message}")
    return float(res.fun) + qp.objective_constant


def _bounds_norm(lo: np.ndarray, hi: np.ndarray) -> float:
    return float(np.linalg.norm(np.maximum(
        np.where(np.isfinite(lo), np.abs(lo), 0.0),
        np.where(np.isfinite(hi), np.abs(hi), 0.0))))


def host_residuals(qp, x: np.ndarray, y: np.ndarray) -> tuple:
    """(primal, dual) L2 residuals of a minimization LP, in f64, relative
    to 1 + ||b|| and 1 + ||c||: row and bound violations of x; the part of
    c - Aᵀy no finite bound absorbs, and duals of the wrong sign."""
    a = sp.csr_matrix(qp.constraint_matrix)
    lo, hi = qp.constraint_lower, qp.constraint_upper
    lb, ub = qp.variable_lower, qp.variable_upper
    c = qp.objective_vector
    ax = a @ x
    with np.errstate(invalid="ignore"):
        p = np.concatenate([
            np.maximum(lo - ax, 0.0) + np.maximum(ax - hi, 0.0),
            np.maximum(lb - x, 0.0) + np.maximum(x - ub, 0.0)])
    r = c - a.T @ y
    d_var = np.where(r > 0, np.where(np.isfinite(lb), 0.0, r),
                     np.where(np.isfinite(ub), 0.0, r))
    d_sign = np.where(y > 0, np.where(np.isfinite(lo), 0.0, y),
                      np.where(np.isfinite(hi), 0.0, y))
    primal = np.linalg.norm(p) / (1.0 + _bounds_norm(lo, hi))
    dual = (np.linalg.norm(np.concatenate([d_var, d_sign]))
            / (1.0 + np.linalg.norm(c)))
    return float(primal), float(dual)


def host_objectives(qp, x: np.ndarray, y: np.ndarray, dtype) -> tuple:
    """Primal and dual objectives in f64 from the data rounded to
    ``dtype``, as the device holds it."""
    a = sp.csr_matrix(qp.constraint_matrix)
    c = np.asarray(qp.objective_vector, dtype).astype(np.float64)
    lo = np.asarray(qp.constraint_lower, dtype).astype(np.float64)
    hi = np.asarray(qp.constraint_upper, dtype).astype(np.float64)
    lb, ub = qp.variable_lower, qp.variable_upper
    r = qp.objective_vector - a.T @ y
    rc = np.where(r > 0, np.where(np.isfinite(lb), r, 0.0),
                  np.where(np.isfinite(ub), r, 0.0))
    with np.errstate(invalid="ignore"):  # inf * 0 in the unused branch
        dual = (np.sum(np.where(y > 0, lo * y, 0.0))
                + np.sum(np.where(y < 0, hi * y, 0.0))
                + np.sum(np.where(rc > 0, lb * rc, 0.0))
                + np.sum(np.where(rc < 0, ub * rc, 0.0)))
    return float(c @ x), float(dual)


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device(count: int) -> dict:
    import jax

    from ortools_tpu.utils.device import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}")
    devs = jax.devices()
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(devs)}")
    cache = enable_compile_cache()
    _log("device", f"{nvidia_smi()} | jax {jax.__version__} | "
         f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} | "
         f"compile cache {cache}")
    d = devs[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def _check_rows(name: str, y: np.ndarray, ref: sp.csr_matrix,
                v64: np.ndarray) -> None:
    """Per row ``|y - ref v| <= 1e-5 (|ref| |v|)_i`` against scipy f64."""
    exact = ref @ v64
    bound = 1e-5 * (abs(ref) @ np.abs(v64))
    bad = np.abs(y - exact) > bound
    if bad.any():
        i = int(np.argmax(np.abs(y - exact) - bound))
        raise AssertionError(
            f"{name}: {int(bad.sum())} rows off, row {i}: "
            f"{y[i]!r} vs {exact[i]!r} (bound {bound[i]:.3g})")


def _spmv_us(matvec, x, reps: int) -> float:
    """µs per SpMV: ``reps`` chained in one jitted loop, best of 3."""
    import jax

    @jax.jit
    def chained(x):
        def body(_, x):
            # the scalar factor keeps each product live in the loop
            return x * (1.0 + 1e-30 * matvec(x)[0])
        return jax.lax.fori_loop(0, reps, body, x)

    chained(x).block_until_ready()
    best = np.inf
    for _ in range(3):
        t = time.perf_counter()
        chained(x).block_until_ready()
        best = min(best, time.perf_counter() - t)
    return best / reps * 1e6


def spmv_check(a_csr: sp.spmatrix, dtype, block_shape=None,
               reps: int = SPMV_REPS, seed: int = 0) -> dict:
    """A·x and Aᵀ·y on the solver's own layout against scipy f64 CSR;
    returns µs per SpMV.  On a GPU the Triton kernel is the solver's path,
    and the XLA block path is checked and timed beside it."""
    import dataclasses

    import jax

    from ortools_tpu.ops.block_sparse import (BlockSparseMatrix,
                                              auto_block_shape)
    from ortools_tpu.utils.device import is_accelerator

    a_csr = sp.csr_matrix(a_csr)
    m, n = a_csr.shape
    bs = block_shape or auto_block_shape(m, n, a_csr.nnz)
    a = BlockSparseMatrix.from_scipy(a_csr, block_shape=bs, dtype=dtype)
    at = a.block_transpose()
    if is_accelerator():
        a, at = a.with_row_ptr(), at.with_row_ptr()
    rng = np.random.default_rng(seed)
    out = {}
    for name, mat, ref, v in (
            ("A", a, a_csr, rng.standard_normal(n)),
            ("At", at, a_csr.T.tocsr(), rng.standard_normal(m))):
        vd = mat.pad_x(v.astype(dtype))
        v64 = np.asarray(v.astype(dtype), np.float64)
        paths = [("", mat)]
        if mat.row_ptr is not None:
            paths.append(("xla_", dataclasses.replace(mat, row_ptr=None)))
        for tag, mm in paths:
            y = np.asarray(jax.jit(mm.matvec)(vd), np.float64)
            _check_rows(f"{tag}{name}·v", y[: ref.shape[0]], ref, v64)
            out[f"{tag}{name}_us"] = _spmv_us(mm.matvec, vd, reps)
    out["blocks"] = a.num_blocks
    out["block_shape"] = a.block_shape
    out["matrix_mb"] = a.nnz_dense * np.dtype(dtype).itemsize / 1e6
    return out


def phase_spmv() -> None:
    from ortools_tpu.models.generators import (block_random_lp,
                                               multicommodity_flow_lp)

    parts = []
    for name, qp in (("bench", block_random_lp(**BENCH_LP, seed=0)),
                     ("mcf", multicommodity_flow_lp(*MCF_LP, seed=0))):
        r = spmv_check(qp.constraint_matrix, np.float32)
        parts.append(
            f"{name} {r['blocks']} {r['block_shape']} blocks "
            f"{r['matrix_mb']:.1f} MB: Triton A·x {r['A_us']:.1f} us "
            f"Aᵀ·y {r['At_us']:.1f} us, XLA A·x {r['xla_A_us']:.1f} us "
            f"Aᵀ·y {r['xla_At_us']:.1f} us")
    _log("spmv", "f32 within 1e-5 (|A||x|)_i of scipy f64 on both paths: "
         + "; ".join(parts))


def solve_and_check(qp, dtype, eps: float, ref_obj: float, obj_tol: float,
                    mesh=None) -> dict:
    """pdlp.solve to ``eps`` relative; require OPTIMAL, the objective
    within ``obj_tol`` of ``ref_obj``, host f64 residuals within 10·eps,
    and the device's objectives equal to their host recomputation."""
    from ortools_tpu.pdlp import solver as S
    from ortools_tpu.pdlp.params import PdhgParams
    from ortools_tpu.utils.status import TerminationReason

    params = PdhgParams(dtype=dtype, eps_optimal_relative=eps,
                        eps_optimal_absolute=eps)
    qp_min = qp.as_minimization()
    t = time.perf_counter()
    S.build_device_problem(qp_min, params)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    with compile_seconds() as comp:
        res = S.solve(qp, params, mesh=mesh)
    wall = time.perf_counter() - t
    if res.termination_reason != TerminationReason.OPTIMAL:
        raise AssertionError(f"{qp.name}: {res.termination_reason.name} "
                             f"after {res.iterations} iterations")
    d_obj = rel_diff(res.primal_objective, ref_obj)
    if d_obj > obj_tol:
        raise AssertionError(f"{qp.name}: objective {res.primal_objective!r}"
                             f" vs HiGHS {ref_obj!r} (rel {d_obj:.3g})")
    pres, dres = host_residuals(qp_min, res.primal_solution,
                                res.dual_solution)
    if pres > 10 * eps or dres > 10 * eps:
        raise AssertionError(f"{qp.name}: host residuals primal {pres:.3g} "
                             f"dual {dres:.3g} above {10 * eps:g}")
    # The device's f32 objectives are compensated (ops/df32.py) sums
    # rounded to f32 once; a contracted or reassociated two_prod shows here.
    p_host, d_host = host_objectives(qp_min, res.primal_solution,
                                     res.dual_solution, dtype)
    obj_rounding = 1e-6 if np.dtype(dtype) == np.float32 else 1e-12
    for what, dev, host in (("primal", res.primal_objective, p_host),
                            ("dual", res.dual_objective, d_host)):
        if rel_diff(dev, host) > obj_rounding:
            raise AssertionError(f"{qp.name}: device {what} objective "
                                 f"{dev!r} vs host f64 {host!r}")
    return dict(iterations=res.iterations, wall_s=wall, build_s=build_s,
                compile_s=comp[0], objective=res.primal_objective,
                obj_rel=d_obj, primal_res=pres, dual_res=dres)


def _fmt_lp(tag: str, r: dict) -> str:
    return (f"{tag}: {r['iterations']} it, solve {r['wall_s']:.2f} s "
            f"(compile {r['compile_s']:.2f} s), build {r['build_s']:.2f} s, "
            f"obj {r['objective']:.10g} (rel {r['obj_rel']:.2g}), "
            f"res {r['primal_res']:.2g}/{r['dual_res']:.2g}")


def mcf_with_reference():
    from ortools_tpu.models.generators import multicommodity_flow_lp

    t = time.perf_counter()
    qp = multicommodity_flow_lp(*MCF_LP, seed=0)
    ref = highs_lp(qp)
    return qp, ref, time.perf_counter() - t


def phase_lp() -> None:
    qp, ref, t_ref = mcf_with_reference()
    r32 = solve_and_check(qp, np.float32, 1e-4, ref, 1e-3)
    r64 = solve_and_check(qp, np.float64, 1e-6, ref, 1e-5)
    _log("lp", f"{qp.name} HiGHS {ref:.10g} ({t_ref:.1f} s); "
         + _fmt_lp("f32 1e-4", r32) + "; " + _fmt_lp("f64 1e-6", r64))


def fixed_variants(qp, count: int, seed: int = 0) -> tuple:
    """``count`` bound sets of a covering LP, each fixing 3 variables to 1
    and 3 to 0, resampled until every row keeps a variable not fixed to
    0 (so every variant stays feasible)."""
    rng = np.random.default_rng(seed)
    a = sp.csr_matrix(qp.constraint_matrix)
    n = qp.num_variables
    lbs = np.tile(qp.variable_lower, (count, 1))
    ubs = np.tile(qp.variable_upper, (count, 1))
    for i in range(count):
        while True:
            pick = rng.choice(n, 6, replace=False)
            ub = np.array(qp.variable_upper)
            ub[pick[3:]] = 0.0
            if ((a @ ub) >= qp.constraint_lower).all():
                break
        lbs[i, pick[:3]] = 1.0
        ubs[i] = ub
    return lbs, ubs


def batch_check(qp, count: int, sample: int, eps: float = 1e-4,
                obj_tol: float = 1e-3) -> dict:
    import dataclasses

    from ortools_tpu.pdlp.batched import solve_batch
    from ortools_tpu.pdlp.params import PdhgParams

    lbs, ubs = fixed_variants(qp, count)
    params = PdhgParams(dtype=np.float32, eps_optimal_relative=eps,
                        eps_optimal_absolute=eps)
    t = time.perf_counter()
    with compile_seconds() as comp:
        res = solve_batch(qp, lbs, ubs, params)
    wall = time.perf_counter() - t
    if not res.optimal.all():
        raise AssertionError(f"{int((~res.optimal).sum())} of {count} "
                             "batched LPs not optimal")
    worst = 0.0
    for i in np.random.default_rng(1).choice(count, sample, replace=False):
        ref = highs_lp(dataclasses.replace(
            qp, variable_lower=lbs[i], variable_upper=ubs[i]))
        d = rel_diff(float(res.primal_objective[i]), ref)
        if d > obj_tol:
            raise AssertionError(f"batch LP {i}: {res.primal_objective[i]!r}"
                                 f" vs HiGHS {ref!r} (rel {d:.3g})")
        worst = max(worst, d)
    return dict(iterations=res.iterations, wall_s=wall, compile_s=comp[0],
                worst_rel=worst)


def phase_batch() -> None:
    import dataclasses

    from ortools_tpu.models.mip_generators import set_cover

    qp = set_cover(**SET_COVER)
    r = batch_check(dataclasses.replace(qp, integrality=None), BATCH, 8)
    _log("batch", f"{BATCH} fixed variants of {qp.name}: all OPTIMAL in "
         f"{r['iterations']} it, {r['wall_s']:.2f} s (compile "
         f"{r['compile_s']:.2f} s); 8 sampled within rel "
         f"{r['worst_rel']:.2g} of HiGHS")


def mip_check(qp, time_limit: float) -> dict:
    """mip.solve with ``device_fj="auto"``; the incumbent must pass the
    solution checker and match HiGHS ``milp`` within the MIP gap.  Returns
    the device feasibility jump's calls as (backend, rounds) pairs."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    from ortools_tpu.mip import branch_and_bound as bb
    from ortools_tpu.sat import fj_device
    from ortools_tpu.utils.status import MPSolverStatus

    calls = []
    run_fj = fj_device.device_feasibility_jump

    def counted(*args, **kw):
        import jax

        res = run_fj(*args, **kw)
        calls.append((jax.default_backend(), res.rounds_run))
        return res

    fj_device.device_feasibility_jump = counted
    try:
        params = bb.MipParams(device_fj="auto", time_limit_sec=time_limit)
        t = time.perf_counter()
        res = bb.solve(qp, params)
        wall = time.perf_counter() - t
    finally:
        fj_device.device_feasibility_jump = run_fj
    if res.status != MPSolverStatus.OPTIMAL:
        raise AssertionError(f"{qp.name}: MIP status {res.status.name}")
    qpm = qp.as_minimization()
    x = res.solution
    integ = np.asarray(qpm.integrality, bool)
    if not (bb._check_feasible(qpm, x, 1e-6)
            and np.all(np.abs(x[integ] - np.round(x[integ])) <= 1e-6)):
        raise AssertionError(f"{qp.name}: incumbent fails the checker")
    ref = milp(qpm.objective_vector,
               constraints=LinearConstraint(qpm.constraint_matrix,
                                            qpm.constraint_lower,
                                            qpm.constraint_upper),
               bounds=Bounds(qpm.variable_lower, qpm.variable_upper),
               integrality=integ.astype(float))
    if ref.status != 0:
        raise RuntimeError(f"HiGHS milp failed: {ref.message}")
    ours = float(qpm.objective_vector @ x)
    gap = params.abs_gap + params.rel_gap * (1.0 + abs(ref.fun))
    if abs(ours - ref.fun) > gap:
        raise AssertionError(f"{qp.name}: MIP objective {ours!r} vs HiGHS "
                             f"{ref.fun!r} (gap {gap:.3g})")
    return dict(objective=ours, highs=float(ref.fun), nodes=res.num_nodes,
                wall_s=wall, fj_calls=calls)


def phase_mip() -> None:
    from ortools_tpu.models.mip_generators import set_cover

    qp = set_cover(**MIP_SET_COVER)
    r = mip_check(qp, time_limit=120.0)
    rounds = sum(k for b, k in r["fj_calls"] if b == "gpu")
    if rounds == 0:
        raise AssertionError(f"device feasibility jump did not run on the "
                             f"GPU: {r['fj_calls']}")
    _log("mip", f"{qp.name}: OPTIMAL {r['objective']:.10g} = HiGHS "
         f"{r['highs']:.10g} within gap, {r['nodes']} nodes, "
         f"{r['wall_s']:.2f} s, device FJ {rounds} rounds on GPU")


def phase_multi() -> None:
    from ortools_tpu.parallel import make_mesh

    qp, ref, t_ref = mcf_with_reference()
    single = solve_and_check(qp, np.float32, 1e-4, ref, 1e-3)
    parts = [_fmt_lp("1 GPU", single)]
    for shape, names in (((4,), ("shards",)), ((2, 2), ("rows", "cols"))):
        mesh = make_mesh(shape, names)
        r = solve_and_check(qp, np.float32, 1e-4, ref, 1e-3, mesh=mesh)
        d = rel_diff(r["objective"], single["objective"])
        if d > 1e-3:
            raise AssertionError(f"mesh {shape}: objective {r['objective']!r}"
                                 f" vs one GPU {single['objective']!r}")
        parts.append(_fmt_lp(f"mesh {shape}", r))
    _log("multi", f"{qp.name} HiGHS {ref:.10g} ({t_ref:.1f} s); "
         + "; ".join(parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    device = phase_device(4 if args.multi else 1)
    if args.multi:
        phase_multi()
    else:
        phase_spmv()
        phase_lp()
        phase_batch()
        phase_mip()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
