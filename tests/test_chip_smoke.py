"""chip_smoke.py: refuses to run without a GPU, and its host-side checks
catch what they are meant to catch (the phases run on the card)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    proc = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _small_lp():
    from ortools_tpu.models.generators import multicommodity_flow_lp

    return multicommodity_flow_lp(20, 120, 4, seed=0)


def test_host_residuals_zero_at_highs_optimum():
    from scipy.optimize import linprog

    qp = _small_lp()
    a = sp.csr_matrix(qp.constraint_matrix)
    eq = qp.constraint_lower == qp.constraint_upper
    res = linprog(qp.objective_vector, A_ub=a[~eq],
                  b_ub=qp.constraint_upper[~eq], A_eq=a[eq],
                  b_eq=qp.constraint_lower[eq], bounds=(0, None),
                  method="highs")
    y = np.zeros(qp.num_constraints)
    # HiGHS marginals are d(obj)/d(b); PDLP's duals have the same sign.
    y[eq] = res.eqlin.marginals
    y[~eq] = res.ineqlin.marginals
    p, d = cs.host_residuals(qp, res.x, y)
    assert p < 1e-9 and d < 1e-9
    p_obj, d_obj = cs.host_objectives(qp, res.x, y, np.float64)
    assert cs.rel_diff(p_obj, res.fun) < 1e-9
    assert cs.rel_diff(d_obj, res.fun) < 1e-7


def test_host_residuals_flag_violations():
    qp = _small_lp()
    x = np.zeros(qp.num_variables)
    y = np.zeros(qp.num_constraints)
    p, d = cs.host_residuals(qp, x, y)
    assert p > 1e-3  # demands unmet
    assert d == 0.0  # costs are positive and x >= 0 absorbs them
    y[-1] = 1.0  # a positive dual on a <= row has the wrong sign
    assert cs.host_residuals(qp, x, y)[1] > 0


@pytest.mark.parametrize("dtype,eps,tol", [(np.float32, 1e-4, 1e-3),
                                           (np.float64, 1e-6, 1e-5)])
def test_lp_check_on_small_mcf(dtype, eps, tol):
    qp = _small_lp()
    r = cs.solve_and_check(qp, dtype, eps, cs.highs_lp(qp), tol)
    assert r["iterations"] > 0 and r["compile_s"] >= 0.0


def test_lp_check_rejects_wrong_reference():
    qp = _small_lp()
    with pytest.raises(AssertionError, match="HiGHS"):
        cs.solve_and_check(qp, np.float64, 1e-6, 2 * cs.highs_lp(qp), 1e-5)


def test_fixed_variants_stay_feasible():
    from ortools_tpu.models.mip_generators import set_cover

    qp = set_cover(60, 30, seed=2)
    lbs, ubs = cs.fixed_variants(qp, 16)
    a = sp.csr_matrix(qp.constraint_matrix)
    assert np.all(lbs <= ubs)
    assert np.all((lbs == 1).sum(1) == 3) and np.all((ubs == 0).sum(1) == 3)
    for ub in ubs:
        assert np.all(a @ ub >= qp.constraint_lower)


def test_batch_check_on_small_set_cover():
    from ortools_tpu.models.mip_generators import set_cover

    qp = dataclasses.replace(set_cover(60, 30, seed=2), integrality=None)
    r = cs.batch_check(qp, 8, 3)
    assert r["worst_rel"] <= 1e-3


def test_spmv_check_on_small_lp():
    qp = _small_lp()
    r = cs.spmv_check(qp.constraint_matrix, np.float32, reps=2)
    assert r["A_us"] > 0 and r["At_us"] > 0 and r["blocks"] > 0


def test_mip_check_on_small_set_cover():
    from ortools_tpu.models.mip_generators import set_cover

    r = cs.mip_check(set_cover(40, 20, seed=1), time_limit=60.0)
    assert r["objective"] == pytest.approx(r["highs"], rel=1e-4)
    assert r["fj_calls"] == []  # "auto" keeps the device FJ off the CPU
