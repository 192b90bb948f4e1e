"""Test configuration: run JAX on 8 virtual CPU devices, so packing, the
executor and the multi-device sharding path are all testable without an
accelerator (standard JAX practice; SURVEY.md §4).  The suite runs on the
CPU even on a host with a GPU: the platform is fixed before the backend
initializes.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

from dasp_tpu.utils import enable_compile_cache

enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# Golden tolerances per dtype, on the error scaled by max(|golden|, 1).
TOL = {"f32": 1e-5, "bf16": 0.05, "f64": 1e-9}


def mass_of(csr, x):
    """|A| |x| per row: the scale of a backward-error check.  A long row
    whose products cancel carries ~eps * sum|a_i x_i| of rounding error in
    any f32 accumulation order, however small its result."""
    from dasp_tpu.sparse import CSRMatrix
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                     np.abs(csr.values)).spmv(np.abs(np.asarray(x)))


def assert_golden(y, want, tol, mass=None):
    """Error scaled by max(|want|, 1), or by max(mass, 1) where the
    row's absolute mass is given (backward error)."""
    scale = np.maximum(np.abs(want) if mass is None else mass, 1.0)
    np.testing.assert_allclose(np.asarray(y, dtype=np.float64) / scale,
                               want / scale, rtol=tol, atol=tol)


@pytest.fixture
def check_golden():
    """check(csr, rng, dtype, rtol, atol): SpMVOperator vs the golden."""
    from dasp_tpu import SpMVOperator, golden

    def check(csr, rng, dtype, rtol, atol):
        x = rng.standard_normal(csr.n_cols)
        want = golden(csr, x, dtype)
        y = SpMVOperator(csr, dtype=dtype)(x)
        scale = np.maximum(np.abs(want), 1.0)
        np.testing.assert_allclose(y / scale, want / scale,
                                   rtol=rtol, atol=atol)
    return check
