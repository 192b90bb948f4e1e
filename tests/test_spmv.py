"""Golden tests: packed SpMV vs the CPU CSR oracle, for every dtype path.

This plays the role of the reference's (disabled) ``verify_new`` comparison
against cuSPARSE (``main_f64.cu:3-16``): f64 tolerance 1e-5, half/bf16
tolerance loose (reference uses 1.0 absolute, ``main_f16.cu:10``).
"""

import numpy as np
import pytest

from dasp_tpu import SpMVOperator
from dasp_tpu.sparse import (CSRMatrix, fem_like, mixed_categories,
                             powerlaw_like, random_csr)


CASES = {
    "mixed": lambda rng: mixed_categories(700, rng),
    "fem": lambda rng: fem_like(500, 30, rng),
    "powerlaw": lambda rng: powerlaw_like(600, 1.8, 5000, rng),
    "all_short": lambda rng: random_csr(
        900, 900, rng.integers(0, 5, size=900), rng),
}


@pytest.mark.parametrize("name", ["mixed", "fem", "powerlaw", "all_short"])
@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
def test_spmv_golden(rng, check_golden, name, dtype):
    csr = CASES[name](rng)
    tol = {"f32": (1e-5, 1e-5), "f64": (1e-9, 1e-9), "bf16": (0.05, 0.05)}
    rtol, atol = tol[dtype]
    check_golden(csr, rng, dtype, rtol, atol)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_spmv_long_rows_only(rng, check_golden, dtype):
    csr = random_csr(6, 4000,
                     np.array([256, 300, 1000, 2048, 257, 4000]), rng)
    check_golden(csr, rng, dtype, 1e-5 if dtype == "f32" else 1e-9, 1e-5)


def test_spmv_empty_matrix(rng):
    csr = random_csr(50, 50, np.zeros(50, dtype=np.int64), rng)
    op = SpMVOperator(csr, dtype="f32")
    y = op(rng.standard_normal(50))
    np.testing.assert_array_equal(y, np.zeros(50))


def test_spmv_identity(rng):
    n = 300
    csr = CSRMatrix(n, n, np.arange(n + 1, dtype=np.int64),
                    np.arange(n, dtype=np.int32), np.ones(n))
    x = rng.standard_normal(n)
    op = SpMVOperator(csr, dtype="f32")
    np.testing.assert_allclose(op(x), x.astype(np.float32), rtol=1e-6)


def test_f64_precision_beats_f32(rng):
    """dd-f64 must deliver accuracy far beyond plain f32 accumulation on an
    ill-conditioned sum (large cancellation)."""
    n = 4096
    csr = random_csr(1, n, np.array([n]), rng)
    # Values that cancel: +big, -big pairs plus small residuals.
    v = np.zeros(n)
    v[0::2] = 1e7
    v[1::2] = -1e7
    v[1] += 1.0
    csr.values = v
    x = np.ones(n)
    golden = csr.spmv(x)
    y64 = SpMVOperator(csr, dtype="f64")(x)
    assert abs(y64[0] - golden[0]) < 1e-6


def test_matmat_interface_parity(rng):
    """matmat(X) equals one SpMV per column of X."""
    from dasp_tpu.sparse import mixed_categories
    import dasp_tpu
    csr = mixed_categories(300, rng)
    X = rng.standard_normal((csr.n_cols, 2))
    G = np.stack([csr.spmv(X[:, j]) for j in range(2)], axis=1)
    scale = np.maximum(np.abs(G), 1.0)
    op = dasp_tpu.SpMVOperator(csr, dtype="f32")
    np.testing.assert_allclose(op.matmat(X) / scale, G / scale,
                               rtol=2e-5, atol=2e-5)
