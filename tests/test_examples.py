"""The examples run end to end on the XLA executor (tiny sizes, CPU)."""

import os
import sys

import numpy as np

EX = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EX)


def test_cg_solver_example(rng):
    import cg_solver
    import dasp_tpu
    csr = cg_solver.build_spd(512, rng)
    op = dasp_tpu.SpMVOperator(csr, dtype="f32")
    b = rng.standard_normal(csr.n_rows)
    x, rnorm, iters = cg_solver.cg_solve(op, b, tol=1e-5, maxiter=300)
    r = b - csr.spmv(np.asarray(x))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4


def test_pagerank_example(rng):
    import pagerank
    import dasp_tpu
    csr = pagerank.build_transition(1500, rng)
    op = dasp_tpu.SpMVOperator(csr, dtype="f32")
    r = pagerank.pagerank(op, iters=30)
    assert r.shape == (csr.n_rows,)
    rh = np.full(csr.n_rows, 1.0 / csr.n_rows)
    for _ in range(30):
        rh = 0.85 * csr.spmv(rh) + 0.15 / csr.n_rows
        rh = rh / rh.sum()
    rh = 0.85 * csr.spmv(rh) + 0.15 / csr.n_rows
    assert np.abs(r - rh).max() / np.abs(rh).max() < 1e-3
    # the jitted loop is cached per (damping, iters) and reused
    np.testing.assert_array_equal(pagerank.pagerank(op, iters=30), r)


def test_cg_solver_dd(rng):
    """dd (f32x2) CG reaches fp64-grade residuals where f32 CG stalls."""
    import cg_solver
    import dasp_tpu
    csr = cg_solver.build_spd(512, rng)
    op = dasp_tpu.SpMVOperator(csr, dtype="f64")
    x_true = rng.standard_normal(csr.n_rows)
    b = csr.spmv(x_true)
    x, rnorm, iters = cg_solver.cg_solve_dd(op, b, maxiter=400)
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    # f32 stalls ~1e-4 here; dd reaches ~2e-8 (limited by the
    # residual tolerance x conditioning, not precision)
    assert err < 1e-6, (err, int(iters))
